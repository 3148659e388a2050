"""Time integration (PyTorch port of :mod:`pde_opt_tpu.ops.integrate`).

:func:`evolve` advances a state by fixed substeps and returns the final
state; :func:`integrate` saves the solution at given times.  It is
forward-differentiable (``adjoint="forward"`` under :mod:`torch.func`, as
Levenberg-Marquardt uses it) and reverse-differentiable either way:

* ``adjoint="forward"`` keeps every segment's autograd graph;
* ``adjoint="checkpoint"`` wraps each save segment in
  :func:`torch.utils.checkpoint.checkpoint`, so the backward pass re-runs a
  segment's forward to rebuild what it needs (the counterpart of the JAX
  package's ``jax.checkpoint`` segments).  With the fused macro stepper a
  segment's forward is one kernel launch, and its backward one launch of
  the backward kernel.

:func:`integrate_adaptive` is the adaptive integrator behind
:class:`PIDController`: an I-controller on an embedded error estimate, with
the solution saved at given times by linear interpolation.  Its step loop
runs on the host and reads each step's error norm, one device sync per
attempted step: it serves single-instance model solves, as in the JAX
package; fleets use the fixed-step :func:`evolve`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .steppers import AbstractStepper

__all__ = ["evolve", "integrate", "integrate_adaptive", "PIDController", "ConstantStepSize"]


class PIDController:
    """Adaptive step-size request: pass it as ``stepsize_controller`` to
    :meth:`PDEModel.solve` to select :func:`integrate_adaptive` with these
    tolerances."""

    def __init__(self, rtol: float = 1e-4, atol: float = 1e-6):
        self.rtol = rtol
        self.atol = atol


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


# ---------------------------------------------------------------------------
# Adaptive (PID-controlled) integrator
# ---------------------------------------------------------------------------

def _rms_norm(err, y0, y1, rtol, atol, batch_ndim: int = 0) -> torch.Tensor:
    """RMS of ``err`` scaled by ``atol + rtol·max(|y0|, |y1|)``; with
    ``batch_ndim`` leading batch axes, the norm of each instance and the
    largest of them (the strictest instance governs the shared step)."""
    ratio = err / (atol + rtol * torch.maximum(y0.abs(), y1.abs()))
    if batch_ndim:
        dims = tuple(range(batch_ndim, ratio.ndim))
        sq = ratio.pow(2).mean(dim=dims) if dims else ratio.pow(2)
        return sq.sqrt().max()
    return ratio.pow(2).mean().sqrt()


def _host_times(ts) -> np.ndarray:
    """``ts`` as a host array of its time dtype: its own float dtype, at
    least float32 (a list of python floats is float64)."""
    a = np.asarray(ts.detach().cpu().numpy() if torch.is_tensor(ts) else ts)
    return a.astype(np.result_type(a.dtype, np.float32))


def integrate_adaptive(stepper: AbstractStepper, rhs: Callable, y0, ts, dt0: float,
                       rtol: float = 1e-4, atol: float = 1e-6, max_steps: int = 1_000_000,
                       safety: float = 0.9, factor_min: float = 0.2, factor_max: float = 10.0,
                       return_stats: bool = False, batch_ndim: int = 0):
    """Adaptive-step integration with the solution saved at ``ts``.

    The I-controller diffrax's default ``PIDController`` reduces to: a step
    is accepted when the RMS-scaled error (:func:`_rms_norm`) is at most 1,
    and the next step is ``dt·clip(safety·err^(−1/(order+1)), factor_min,
    factor_max)``.  A non-finite error norm (a step that overflowed) is a
    rejection, and the next step is ``dt·factor_min``: the one place where
    this loop departs from the JAX integrator, whose step size turns NaN
    there and never recovers.  ``stepper.step`` must return an error
    estimate.  Save points inside an accepted step are written by linear
    interpolation
    between its ends.  Times are kept on the host in the time dtype of
    ``ts`` (at least float32), with a tolerance of ``32·eps·max(|ts|, 1)``
    for capturing save points and ending the loop; the state keeps
    ``y0``'s dtype.  With ``batch_ndim`` leading batch axes each instance's
    error norm is taken apart and the largest governs the shared step.  The
    loop ends at ``ts[-1]`` or after ``max_steps`` attempted steps; a save
    slot the loop did not reach holds zeros, except the last, which then
    holds the last state reached.

    Each attempted step reads its error norm on the host: one device sync
    a step.

    Returns ``ys`` of shape ``(len(ts), *y0.shape)``, and with
    ``return_stats`` also ``{"accepted_steps": n, "rejected_steps": m}``.
    """
    y0 = torch.as_tensor(y0)
    ts = _host_times(ts)
    T = ts.dtype.type
    E = np.float64 if y0.dtype == torch.float64 else np.float32  # the error norm's dtype
    n_save, t_final = len(ts), ts[-1]
    time_tol = T(T(32.0) * np.finfo(ts.dtype).eps * T(max(np.max(np.abs(ts)), T(1.0))))
    exponent = E(-1.0 / (stepper.order + 1.0))

    saves = [y0] + [None] * (n_save - 1)
    t, dt, y = T(ts[0]), T(dt0), y0
    save_idx, n_acc, n_rej = 1, 0, 0
    while t < T(t_final - time_tol) and n_acc + n_rej < max_steps:
        dt = min(dt, T(t_final - t))
        # t and dt reach the stepper as 0-d host tensors of the time dtype,
        # so its stage arithmetic rounds as the JAX integrator's does.
        y1, y_err = stepper.step(rhs, y, torch.tensor(t), torch.tensor(dt))
        if y_err is None:
            raise ValueError(f"{type(stepper).__name__} has no error estimate; "
                             "integrate_adaptive needs one (Heun, Tsit5)")
        y1 = y1.to(y.dtype)
        err = E(_rms_norm(y_err, y, y1, rtol, atol, batch_ndim).item())
        if np.isfinite(err):
            factor = np.clip(E(safety) * np.power(np.maximum(err, E(1e-16)), exponent),
                             E(factor_min), E(factor_max))
        else:
            # A step that overflowed: reject it and shrink by factor_min.  (The
            # JAX integrator's factor is NaN here, and so is every later dt.)
            factor = E(factor_min)
        if err <= 1.0:
            t_new = T(t + dt)
            while save_idx < n_save and ts[save_idx] <= T(t_new + T(2.0) * time_tol):
                theta = T((ts[save_idx] - t) / dt) if dt > 0 else T(0.0)
                theta = torch.full((), float(theta), dtype=y1.dtype, device=y1.device)
                saves[save_idx] = y + theta * (y1 - y)
                save_idx += 1
            t, y = t_new, y1
            n_acc += 1
        else:
            n_rej += 1
        dt = T(dt * factor)
    if save_idx < n_save:
        # Only when max_steps ran out: the last slot holds the last state.
        saves[-1] = y
    ys = torch.stack([torch.zeros_like(y0) if s is None else s for s in saves])
    if return_stats:
        return ys, {"accepted_steps": n_acc, "rejected_steps": n_rej}
    return ys
