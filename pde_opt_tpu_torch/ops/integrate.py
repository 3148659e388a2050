"""Fixed-step time integration (PyTorch port of :mod:`pde_opt_tpu.ops.integrate`).

:func:`evolve` advances a state by fixed substeps and returns the final
state; :func:`integrate` saves the solution at given times and is
differentiable in reverse mode either way:

* ``adjoint="forward"`` keeps every segment's autograd graph;
* ``adjoint="checkpoint"`` wraps each save segment in
  :func:`torch.utils.checkpoint.checkpoint`, so the backward pass re-runs a
  segment's forward to rebuild what it needs (the counterpart of the JAX
  package's ``jax.checkpoint`` segments).  With the fused macro stepper a
  segment's forward is one kernel launch, and its backward one launch of
  the backward kernel.

The adaptive PID integrator (``integrate_adaptive``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .steppers import AbstractStepper

__all__ = ["evolve", "integrate", "PIDController", "ConstantStepSize"]


class PIDController:
    """Adaptive step-size request.  The integrator it selects in the JAX package,
    ``integrate_adaptive``, is not ported yet, so it raises."""

    def __init__(self, rtol: float = 1e-4, atol: float = 1e-6):
        raise NotImplementedError(
            "PIDController selects the adaptive integrator integrate_adaptive "
            "(pde_opt_tpu/ops/integrate.py), which is not ported yet; see "
            "ROADMAP.md"
        )


class ConstantStepSize:
    """Fixed step-size request (the default; selects :func:`integrate`)."""


def evolve(stepper: AbstractStepper, rhs: Callable, y0, t0, dt, n_steps: int):
    """Advance ``n_steps`` fixed steps; return the final state only.

    A stepper may override the whole loop by defining
    ``evolve(rhs, y0, t0, dt, n_steps)`` — the hook the fused macro stepper
    uses to run all substeps in one kernel.  Otherwise this is a Python loop
    over ``stepper.step``, keeping the state's dtype.
    """
    own = getattr(stepper, "evolve", None)
    if own is not None:
        return own(rhs, y0, t0, dt, n_steps)
    y = y0
    for i in range(n_steps):
        y1, _ = stepper.step(rhs, y, t0 + i * dt, dt)
        y = y1.to(y.dtype)
    return y


def integrate(stepper: AbstractStepper, rhs: Callable, y0: torch.Tensor, ts,
              dt0: float, adjoint: str = "forward") -> torch.Tensor:
    """Fixed-step integration with solutions saved at ``ts``.

    Args:
        stepper: single-step integrator (or one with an ``evolve`` hook).
        rhs: ``rhs(y, t) -> dy/dt`` (batch axes ride along).
        y0: initial state at ``ts[0]``.
        ts: host 1D sequence of save times, strictly increasing.
        dt0: target step size.  Each save interval takes
            ``n = max(1, round(Δ/dt0))`` substeps of size ``Δ/n``, so save
            points are hit exactly.
        adjoint: ``"forward"`` or ``"checkpoint"`` (each save segment
            re-run in the backward pass instead of kept).

    Returns:
        Tensor of shape ``(len(ts), *y0.shape)`` with ``out[0] = y0``.
    """
    ts = np.asarray(ts, dtype=np.float64)
    if ts.ndim != 1 or len(ts) < 2:
        raise ValueError("ts must be a 1D array of at least two save times")
    deltas = np.diff(ts)
    if np.any(deltas <= 0):
        raise ValueError("ts must be strictly increasing")
    if adjoint not in ("forward", "checkpoint"):
        raise ValueError(f"unknown adjoint mode: {adjoint!r}")

    n_subs = np.maximum(1, np.round(deltas / dt0).astype(int))
    if len(set(n_subs.tolist())) == 1 and np.allclose(deltas, deltas[0]):
        # Uniform save grid: one substep size for every segment.
        dt_subs = [float(deltas[0]) / int(n_subs[0])] * len(deltas)
    else:
        dt_subs = [float(d) / int(n) for d, n in zip(deltas, n_subs)]

    ys = [y0]
    y = y0
    for t_start, dt_sub, n_sub in zip(ts[:-1], dt_subs, n_subs):
        args = (stepper, rhs, y, float(t_start), dt_sub, int(n_sub))
        if adjoint == "checkpoint":
            y = checkpoint(evolve, *args, use_reentrant=False)
        else:
            y = evolve(*args)
        ys.append(y)
    return torch.stack(ys, dim=0)
