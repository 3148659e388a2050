"""Equations (PyTorch port)."""

from .allen_cahn import (
    AllenCahn2DPeriodic,
    AllenCahn2DPeriodicButlerVolmer,
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
)
from .base import BaseEquation, TimeSplittingEquation
from .cahn_hilliard import CahnHilliard2DPeriodic
from .gross_pitaevskii import GPE2DTSControl
from .pde_model import PDEModel

__all__ = [
    "BaseEquation",
    "TimeSplittingEquation",
    "CahnHilliard2DPeriodic",
    "AllenCahn2DPeriodic",
    "AllenCahn2DPeriodicButlerVolmer",
    "AllenCahn2DPeriodicButlerVolmerConstantCurrent",
    "AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent",
    "GPE2DTSControl",
    "PDEModel",
]
