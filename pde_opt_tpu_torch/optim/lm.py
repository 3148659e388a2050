"""Levenberg-Marquardt for small parameter vectors (PyTorch port of
:mod:`pde_opt_tpu.optim.lm`).

Fits few-coefficient parameterizations (Legendre expansions, scalar physics
constants) by differentiating through the rollout.  The Jacobian of the
flattened residual with respect to the flat parameter vector is built in
forward mode, :func:`torch.func.jacfwd` through the rollout (p tangents
batched by :func:`torch.func.vmap`), which also returns the residual.  The
normal equations ``(JᵀJ + λ·diag(JᵀJ))δ = Jᵀr`` are solved densely (p is
small), the diagonal floored at 1e-12.  λ follows the accept/reject
schedule: ×``lambda_up`` on each rejected try (up to ``max_damping_tries``),
÷``lambda_down`` on acceptance (floored at 1e-12).  The loop runs on the
host and reads each tried step's loss.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd

from ..utils import ptree

__all__ = ["least_squares_lm", "least_squares_lm_jitted", "LMResult"]


class LMResult(NamedTuple):
    params: torch.Tensor  # flat optimized parameters
    loss: torch.Tensor
    steps: int
    converged: bool


def _flat_residual(residual_fn: Callable, theta: torch.Tensor, *args) -> torch.Tensor:
    """The leaves of ``residual_fn(theta, *args)`` raveled into one vector;
    a python number (the reference's ``reg`` of 0.0) is one element."""
    leaves = ptree.tree_leaves(residual_fn(theta, *args))
    return torch.cat([torch.as_tensor(x, dtype=theta.dtype, device=theta.device).reshape(-1)
                      if not torch.is_tensor(x) else x.reshape(-1) for x in leaves])


def _lm_step(theta, r, J, lam: float) -> torch.Tensor:
    jtj = J.T @ J
    diag = torch.diagonal(jtj)
    diag = torch.where(diag.abs() < 1e-12, torch.full_like(diag, 1e-12), diag)
    delta = torch.linalg.solve(jtj + lam * torch.diag(diag), J.T @ r)
    return theta - delta


def least_squares_lm(residual_fn: Callable, theta0, args=(), max_steps: int = 100,
                     rtol: float = 1e-8, atol: float = 1e-8, lambda0: float = 1e-3,
                     lambda_up: float = 4.0, lambda_down: float = 3.0,
                     max_damping_tries: int = 15, verbose: bool = False) -> LMResult:
    """Minimize ``0.5·‖residual_fn(theta, *args)‖²`` over a flat ``theta0``.

    ``residual_fn`` may return any tree of tensors and numbers; its leaves
    are flattened into one residual vector, so the reference's
    ``(batch_residuals, reg)`` contributes ``reg`` as one more element.
    ``args`` are passed through as real arguments (the data), not closed
    over.  The run converges when a step improves the loss by less than
    ``rtol·|loss| + atol``; a step that no damping up to the last try
    improves is a stall and reports ``converged=False``.  ``verbose``
    prints each iteration.
    """
    theta = torch.as_tensor(theta0).detach()
    args = tuple(args)

    def flat(th):
        return _flat_residual(residual_fn, th, *args)

    def with_residual(th):
        r = flat(th)
        return r, r

    def loss_of(th) -> float:
        with torch.no_grad():
            return float(0.5 * flat(th).pow(2).sum())

    lam = lambda0
    loss = loss_of(theta)
    converged = False
    step = 0
    for step in range(1, max_steps + 1):
        J, r = jacfwd(with_residual, has_aux=True)(theta)
        accepted = False
        loss_new = float("nan")
        # Escalate damping until the step shrinks into the trust region.
        for _ in range(max_damping_tries):
            theta_new = _lm_step(theta, r, J, lam)
            loss_new = loss_of(theta_new)
            if math.isfinite(loss_new) and loss_new < loss:
                accepted = True
                break
            lam *= lambda_up
        if verbose:
            print(f"[LM] step={step} loss={loss:.6e} -> {loss_new:.6e} "
                  f"lambda={lam:.2e} accepted={accepted}")
        if not accepted:
            converged = False               # a stall at maximum damping
            break
        improvement = loss - loss_new
        theta, loss = theta_new, loss_new
        lam = max(lam / lambda_down, 1e-12)
        if improvement < rtol * abs(loss) + atol:
            converged = True
            break
    return LMResult(params=theta, loss=torch.tensor(loss, dtype=theta.dtype), steps=step,
                    converged=converged)


def least_squares_lm_jitted(residual_fn: Callable, theta0, args=(), max_steps: int = 100,
                            rtol: float = 1e-8, atol: float = 1e-8, lambda0: float = 1e-3,
                            lambda_up: float = 4.0, lambda_down: float = 3.0,
                            max_damping_tries: int = 15) -> LMResult:
    """Counterpart of the JAX package's ``least_squares_lm_jitted``, whose
    whole solve is one jitted ``lax.while_loop``.  Eager PyTorch has no
    device-side loop, so this runs :func:`least_squares_lm`'s host loop
    without its print: it syncs once for each tried step (once an LM
    iteration when the first try is accepted) and does not stay on the
    device.  Same schedule and results: the same ``params``, ``steps`` and
    ``converged`` as the JAX function on the same input, a stall at maximum
    damping reporting ``converged=False``."""
    return least_squares_lm(residual_fn, theta0, args=args, max_steps=max_steps, rtol=rtol,
                            atol=atol, lambda0=lambda0, lambda_up=lambda_up,
                            lambda_down=lambda_down, max_damping_tries=max_damping_tries)
