"""Scalar minimization over parameter trees (PyTorch port of
:mod:`pde_opt_tpu.optim.minimize`).

``torch.optim.LBFGS`` with a strong-Wolfe line search and ``torch.optim.Adam``
take the places of optax's L-BFGS and Adam.  The stop rules are the JAX
package's: L-BFGS stops at a non-finite loss or when the loss changes by
less than ``rtol·|loss| + atol`` between steps; Adam runs its step budget
unless ``rtol``/``atol`` are set.  Losses differentiate in reverse mode
through the rollout (checkpointed in :func:`pde_opt_tpu_torch.ops.integrate.integrate`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..utils import ptree

__all__ = ["minimize_lbfgs", "minimize_adam", "MinimizeResult"]


class MinimizeResult(NamedTuple):
    params: Any
    loss: torch.Tensor
    steps: int
    converged: bool


def _trainable(params):
    """A copy of ``params`` whose inexact leaves are fresh leaf tensors that
    require grad, and the list of those leaves."""
    params = ptree.tree_map(
        lambda x: None if x is None
        else torch.as_tensor(x).detach().clone().requires_grad_(), params)
    return params, ptree.tree_leaves(params)


def _detached(params):
    return ptree.tree_map(lambda x: None if x is None else x.detach(), params)


def minimize_lbfgs(
    fn: Callable,
    params,
    args=(),
    max_steps: int = 100,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    memory_size: int = 10,
    verbose: bool = False,
) -> MinimizeResult:
    """Minimize ``fn(params, *args)`` with L-BFGS and a strong-Wolfe line search.

    One optimizer step is one L-BFGS iteration; ``loss`` is the value at the
    parameters that step started from, as in the JAX package.
    """
    args = tuple(args)
    params, leaves = _trainable(params)
    # One iteration per step, up to 25 line-search evaluations beside the
    # first (torch caps the line search at max_eval - 1); zero tolerances,
    # so the stop rule below is the only one.
    opt = torch.optim.LBFGS(leaves, lr=1.0, max_iter=1, max_eval=26,
                            history_size=memory_size, line_search_fn="strong_wolfe",
                            tolerance_grad=0.0, tolerance_change=0.0)

    def closure():
        opt.zero_grad(set_to_none=True)
        value = fn(params, *args)
        value.backward()
        return value

    prev_value = math.inf
    value = torch.tensor(math.inf)
    converged = False
    step = 0
    for step in range(1, max_steps + 1):
        value = opt.step(closure).detach()
        v = float(value)
        if verbose:
            print(f"[LBFGS] step={step} loss={v:.6e}")
        if not math.isfinite(v):
            break
        if abs(prev_value - v) < rtol * abs(v) + atol:
            converged = True
            break
        prev_value = v
    return MinimizeResult(params=_detached(params), loss=value, steps=step,
                          converged=converged)


def minimize_adam(
    fn: Callable,
    params,
    args=(),
    max_steps: int = 100,
    learning_rate: float = 1e-2,
    rtol: float = 0.0,
    atol: float = 0.0,
    verbose: bool = False,
) -> MinimizeResult:
    """Minimize ``fn(params, *args)`` with Adam (fixed step budget).

    ``torch.optim.Adam``'s defaults (betas 0.9/0.999, eps 1e-8) and update
    ``lr·m̂/(√v̂ + eps)`` are optax's.  The loop reads no value back from
    the device unless ``verbose`` or a tolerance asks for it.
    """
    args = tuple(args)
    params, leaves = _trainable(params)
    opt = torch.optim.Adam(leaves, lr=learning_rate)
    prev_value = math.inf
    value = torch.tensor(math.inf)
    converged = False
    step = 0
    for step in range(1, max_steps + 1):
        opt.zero_grad(set_to_none=True)
        value = fn(params, *args)
        value.backward()
        opt.step()
        value = value.detach()
        if verbose:
            print(f"[Adam] step={step} loss={float(value):.6e}")
        if rtol or atol:
            v = float(value)
            if abs(prev_value - v) < rtol * abs(v) + atol:
                converged = True
                break
            prev_value = v
    return MinimizeResult(params=_detached(params), loss=value, steps=step,
                          converged=converged)
