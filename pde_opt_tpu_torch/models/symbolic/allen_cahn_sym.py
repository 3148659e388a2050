"""Allen-Cahn manufactured-solution twin (PyTorch port of
:mod:`pde_opt_tpu.models.symbolic.allen_cahn_sym`): the equation's operator
algebra over the generic :class:`~pde_opt_tpu_torch.models.symbolic.mms.MMS`
engine."""

from __future__ import annotations

from typing import Callable

import sympy as sp

from .base_sym_eq import BaseSymbolicEquation
from .mms import MMS, allen_cahn_operator

__all__ = ["SymbolicAllenCahn2DPeriodic"]


class SymbolicAllenCahn2DPeriodic(BaseSymbolicEquation):
    """Exact RHS of u_t = −R(u)(μ(u) − κ∆u) at a manufactured u*(x, y, t);
    tensors on ``device`` (default: the card)."""

    def __init__(self, domain, kappa: float, mu_sym: Callable,
                 R_sym: Callable, u_star: sp.Expr, device=None):
        self.domain = domain
        self._mms = MMS(domain, u_star, allen_cahn_operator(kappa, mu_sym, R_sym),
                        device=device)

    def u_exact(self, t: float):
        return self._mms.u_exact(t)

    def rhs_exact(self, t: float):
        return self._mms.rhs_exact(t)
