"""The vmap rule of the port's fleet-wide ``autograd.Function``s.

Each macro, the fused rhs and the dense solve's product take a whole fleet
at once: their leading tensor axis is the env axis.  Under
:func:`torch.func.vmap` (the env's per-env stepping) a per-env call sees
one env; its rule :func:`fold_vmap` moves the vmapped axis of each tensor
input to the front, folds it into the env axis and calls the Function once
for all of them, so a fleet step stays one kernel launch (or one product),
neither one launch an env nor PyTorch's per-sample fallback.  The Function's
own backward runs on the folded tensors, so gradients through a per-env
step reach the same kernels as through a batched one.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["fold_vmap"]


def _fold(t: torch.Tensor, dim, n: int) -> torch.Tensor:
    """``t`` (the vmapped axis at ``dim``, or none) as ``(n * rows, ...)``."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def fold_vmap(apply: Callable, info, in_dims: Sequence, n_tensors: int, *args):
    """A Function's ``vmap`` staticmethod body: the first ``n_tensors`` of
    ``args`` are the fleet-wide tensors (env axis first, each of them
    batched or not), the rest pass through.  Returns ``(out, out_dims)``
    with every output's vmapped axis at 0."""
    n = info.batch_size
    if any(isinstance(d, int) for d in in_dims[n_tensors:]):
        raise ValueError("only the fleet-wide tensors may be vmapped: a table or "
                         "matrix is shared by every env")
    folded = [_fold(a, d, n) for a, d in zip(args[:n_tensors], in_dims[:n_tensors])]
    out = apply(*folded, *args[n_tensors:])
    if isinstance(out, tuple):
        return tuple(o.reshape(n, -1, *o.shape[1:]) for o in out), (0,) * len(out)
    return out.reshape(n, -1, *out.shape[1:]), 0
