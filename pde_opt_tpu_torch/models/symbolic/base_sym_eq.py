"""Base class for symbolic (sympy) manufactured-solution twins (PyTorch port
of :mod:`pde_opt_tpu.models.symbolic.base_sym_eq`).  Test-only, host-side."""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

__all__ = ["BaseSymbolicEquation"]


class BaseSymbolicEquation(ABC):
    """Exact solution + exact RHS of a PDE, derived symbolically."""

    @abstractmethod
    def u_exact(self, t: float) -> torch.Tensor:
        raise NotImplementedError

    @abstractmethod
    def rhs_exact(self, t: float) -> torch.Tensor:
        raise NotImplementedError
