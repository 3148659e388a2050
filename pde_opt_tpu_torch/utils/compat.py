"""Solver↔equation wiring contract (PyTorch port of
:mod:`pde_opt_tpu.utils.compat`): steppers declare
``required_equation_attrs`` and these helpers check and fill them."""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["check_equation_solver_compatibility", "prepare_solver_params"]


def check_equation_solver_compatibility(solver_type, equation_type) -> None:
    """Raise ``ValueError`` if ``equation_type`` lacks attrs ``solver_type`` needs."""
    required = getattr(solver_type, "required_equation_attrs", None)
    if not required:
        return
    missing = [a for a in required if not hasattr(equation_type, a)]
    if missing:
        raise ValueError(
            f"Equation type {equation_type.__name__} is missing required "
            f"attributes for solver {solver_type.__name__}: {missing}"
        )


def prepare_solver_params(
    solver_type, solver_parameters: Dict[str, Any], equation
) -> Dict[str, Any]:
    """Merge user solver parameters with equation-derived required attrs."""
    full = dict(solver_parameters)
    for attr in getattr(solver_type, "required_equation_attrs", ()) or ():
        full[attr] = getattr(equation, attr)
    return full
