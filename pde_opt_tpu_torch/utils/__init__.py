"""Helpers (PyTorch port)."""

from . import ptree
from .compat import check_equation_solver_compatibility, prepare_solver_params

__all__ = ["ptree", "check_equation_solver_compatibility", "prepare_solver_params"]
