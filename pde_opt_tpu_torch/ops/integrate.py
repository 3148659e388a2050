"""Fixed-step time integration (PyTorch port of ``evolve`` in
:mod:`pde_opt_tpu.ops.integrate`; the save-at and adaptive integrators are not
ported yet)."""

from __future__ import annotations

from typing import Callable

from .steppers import AbstractStepper

__all__ = ["evolve"]


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
