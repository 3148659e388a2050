"""Equations (PyTorch port)."""

from .advection_diffusion import AdvectionDiffusion2D
from .allen_cahn import (
    AllenCahn2DPeriodic,
    AllenCahn2DSmoothedBoundary,
    AllenCahn2DPeriodicButlerVolmer,
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
)
from .base import BaseEquation, TimeSplittingEquation
from . import functions
from .cahn_hilliard import (
    CahnHilliard2DPeriodic,
    CahnHilliard2DSmoothedBoundary,
    CahnHilliard3DPeriodic,
)
from .functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomialExpansion2D,
    LegendrePolynomials,
    Mixer2d,
    PeriodicCNN,
    legendre_from_numpy,
)
from .gross_pitaevskii import GPE2DTSControl, GPE2DTSRot
from .pde_model import PDEModel

__all__ = [
    "BaseEquation",
    "TimeSplittingEquation",
    "CahnHilliard2DPeriodic",
    "CahnHilliard3DPeriodic",
    "CahnHilliard2DSmoothedBoundary",
    "AdvectionDiffusion2D",
    "functions",
    "LegendrePolynomialExpansion",
    "LegendrePolynomialExpansion2D",
    "DiffusionLegendrePolynomials",
    "ChemicalPotentialLegendrePolynomials",
    "LegendrePolynomials",
    "legendre_from_numpy",
    "PeriodicCNN",
    "Mixer2d",
    "AllenCahn2DPeriodic",
    "AllenCahn2DSmoothedBoundary",
    "AllenCahn2DPeriodicButlerVolmer",
    "AllenCahn2DPeriodicButlerVolmerConstantCurrent",
    "AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent",
    "GPE2DTSControl",
    "GPE2DTSRot",
    "PDEModel",
]
