"""Learnable coefficient functions (PyTorch port of the Legendre part of
:mod:`pde_opt_tpu.models.functions`)."""

from .legendre import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomials,
    legendre_from_numpy,
    legval,
)

__all__ = [
    "LegendrePolynomialExpansion",
    "DiffusionLegendrePolynomials",
    "ChemicalPotentialLegendrePolynomials",
    "LegendrePolynomials",
    "legendre_from_numpy",
    "legval",
]
