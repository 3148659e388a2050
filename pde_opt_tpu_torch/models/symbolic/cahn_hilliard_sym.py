"""Cahn-Hilliard manufactured-solution twins, 2D and 3D (PyTorch port of
:mod:`pde_opt_tpu.models.symbolic.cahn_hilliard_sym`): the conserved-flux
operator algebra over the generic MMS engine."""

from __future__ import annotations

from typing import Callable

import sympy as sp

from .base_sym_eq import BaseSymbolicEquation
from .mms import MMS, cahn_hilliard_operator

__all__ = ["SymbolicCahnHilliard2DPeriodic", "SymbolicCahnHilliard3DPeriodic"]


class _SymbolicCahnHilliard(BaseSymbolicEquation):
    def __init__(self, domain, kappa: float, mu_sym: Callable,
                 D_sym: Callable, u_star: sp.Expr, device=None):
        self.domain = domain
        self._mms = MMS(domain, u_star, cahn_hilliard_operator(kappa, mu_sym, D_sym),
                        device=device)

    def u_exact(self, t: float):
        return self._mms.u_exact(t)

    def rhs_exact(self, t: float):
        return self._mms.rhs_exact(t)


class SymbolicCahnHilliard2DPeriodic(_SymbolicCahnHilliard):
    """Exact RHS of u_t = ∇·(D(u)∇(μ(u) − κ∆u)) at a 2D manufactured u*;
    tensors on ``device`` (default: the card)."""


class SymbolicCahnHilliard3DPeriodic(_SymbolicCahnHilliard):
    """3D twin: same operator, u*(x, y, z, t) on a rank-3 Domain."""
