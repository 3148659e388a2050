"""Base equation protocol (PyTorch port of :mod:`pde_opt_tpu.models.base`).

An equation's ``rhs`` is a function of ``(state, t)`` that treats all
leading axes of ``state`` as batch axes.
"""

from __future__ import annotations


class BaseEquation:
    """Time-dependent PDE: ``d(state)/dt = rhs(state, t)``."""

    def rhs(self, state, t):
        """Right-hand side of the equation (batch axes lead, spatial trail)."""
        raise NotImplementedError("rhs method not implemented")


class TimeSplittingEquation(BaseEquation):
    """Equation with separable operators: ``d(state)/dt = A(state,t) + B(state,t)``.

    ``A`` is diagonal in Fourier space (handled exactly by the split-step
    exponential), ``B`` is pointwise in real space.
    """

    def A_terms(self, state, t):
        raise NotImplementedError("A_terms method not implemented")

    def B_terms(self, state, t):
        raise NotImplementedError("B_terms method not implemented")
