"""Helpers (PyTorch port)."""

from .compat import check_equation_solver_compatibility, prepare_solver_params

__all__ = ["check_equation_solver_compatibility", "prepare_solver_params"]
