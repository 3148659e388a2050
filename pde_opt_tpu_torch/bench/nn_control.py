"""A neural-network control of the CH macro, trained through the macro's
gradient (PyTorch port of the JAX bench's ``run_train_grad_128``, the
reference's ``optimize_nn`` workload).

Each env's field ``u`` (B, H, W) gives two features, its mean minus 0.5 and
its variance; a 2 -> hidden -> 1 net (tanh, then a sigmoid) maps them to
``kappa`` in ``[kappa_min, kappa_min + kappa_span]``; the loss is
``sum((macro(u, kappa) - 0.5)**2)``.  Its gradient with respect to the net's
parameters runs through the macro's backward (kernel K3 on CUDA tensors,
the plain backward on CPU tensors).  The parameters are named as the JAX
dict's keys (``w1`` (2, hidden), ``b1``, ``w2`` (hidden, 1), ``b2``), so
:func:`pde_opt_tpu_torch.rl.nets.params_from_numpy` loads the JAX values.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..utils.device import resolve_device

__all__ = ["KappaControlNet", "field_features", "nn_control_loss"]


def field_features(u: torch.Tensor, center: float = 0.5) -> torch.Tensor:
    """``(B, 2)``: each env's mean minus ``center`` and its variance."""
    return torch.stack([u.mean(dim=(-2, -1)) - center,
                        u.var(dim=(-2, -1), correction=0)], dim=-1)


class KappaControlNet(nn.Module):
    """``kappa = kappa_min + kappa_span * sigmoid(tanh(f @ w1 + b1) @ w2 + b2)``
    for the features ``f`` of :func:`field_features`.

    Initialised as the JAX bench does it: ``w1``, ``w2`` from ``0.5 N(0,
    1)`` (drawn from ``generator``, seed 0 on the CPU when none is given),
    zero biases.
    """

    def __init__(self, hidden: int = 32, *, kappa_min: float = 0.002,
                 kappa_span: float = 0.008, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(0) if generator is None else generator

        def normal(*shape):
            x = 0.5 * torch.randn(shape, generator=gen, device=gen.device)
            return nn.Parameter(x.to(device))

        self.w1 = normal(2, hidden)
        self.b1 = nn.Parameter(torch.zeros(hidden, device=device))
        self.w2 = normal(hidden, 1)
        self.b2 = nn.Parameter(torch.zeros(1, device=device))
        self.kappa_min, self.kappa_span = float(kappa_min), float(kappa_span)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(field_features(u) @ self.w1 + self.b1)
        return self.kappa_min + self.kappa_span * torch.sigmoid(h @ self.w2 + self.b2)[:, 0]


def nn_control_loss(net: KappaControlNet, macro: Callable, u: torch.Tensor,
                    target: float = 0.5) -> torch.Tensor:
    """``sum((macro(u, net(u)) - target)**2)`` over every env and pixel."""
    return ((macro(u, net(u)) - target) ** 2).sum()
