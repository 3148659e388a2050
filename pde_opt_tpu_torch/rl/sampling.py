"""The learners' random draws, from one ``torch.Generator``.

Every draw a learner makes goes through a :class:`Sampler`: the Gaussian
and Gumbel noise of each rollout step, each epoch's permutation, the
replay's sample indices and the explore coins.  A caller (a test) can hand
in a sampler of its own that returns prescribed draws.  All draws are made
on the generator's device, so none crosses from the host.
"""

from __future__ import annotations

import torch

__all__ = ["Sampler"]


class Sampler:
    """Draws from ``generator`` on ``generator.device``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def normal(self, shape, dtype=torch.float32):
        return torch.randn(shape, generator=self.generator, device=self.device, dtype=dtype)

    def uniform(self, shape, dtype=torch.float32):
        """``U[0, 1)``."""
        return torch.rand(shape, generator=self.generator, device=self.device, dtype=dtype)

    def gumbel(self, shape, dtype=torch.float32):
        """Standard Gumbel noise: ``argmax(logits + gumbel)`` samples the
        categorical (the draw JAX's ``random.categorical`` makes)."""
        tiny = torch.finfo(dtype).tiny
        u = self.uniform(shape, dtype).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    def randint(self, high: int, shape):
        """Integers in ``[0, high)``; ``high`` is a host int."""
        return torch.randint(0, high, shape, generator=self.generator, device=self.device)

    def permutation(self, n: int):
        """A random permutation of ``range(n)`` (sorting uniform keys)."""
        return torch.argsort(self.uniform((n,)))
