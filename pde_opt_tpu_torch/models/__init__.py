"""Equations (PyTorch port)."""

from .allen_cahn import AllenCahn2DPeriodic
from .base import BaseEquation, TimeSplittingEquation
from .cahn_hilliard import CahnHilliard2DPeriodic
from .gross_pitaevskii import GPE2DTSControl
from .pde_model import PDEModel

__all__ = [
    "BaseEquation",
    "TimeSplittingEquation",
    "CahnHilliard2DPeriodic",
    "AllenCahn2DPeriodic",
    "GPE2DTSControl",
    "PDEModel",
]
