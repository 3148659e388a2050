"""Helpers (PyTorch port)."""

from . import ptree
from .compat import check_equation_solver_compatibility, prepare_solver_params
from .ptree import (
    combine,
    is_array_like,
    is_inexact_array_like,
    partition,
    ravel_params,
    tree_size,
)
from .initialization import (
    add_vortex_to_wavefunction,
    initialize_Psi,
    random_uniform_field,
    step_interface,
)
from .rl import density, detect_vortices, vortex_winding

__all__ = [
    "ptree",
    "check_equation_solver_compatibility",
    "prepare_solver_params",
    "partition",
    "combine",
    "is_array_like",
    "is_inexact_array_like",
    "ravel_params",
    "tree_size",
    "initialize_Psi",
    "add_vortex_to_wavefunction",
    "random_uniform_field",
    "step_interface",
    "density",
    "detect_vortices",
    "vortex_winding",
]
