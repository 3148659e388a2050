"""Equations (PyTorch port)."""

from .base import BaseEquation
from .cahn_hilliard import CahnHilliard2DPeriodic
from .pde_model import PDEModel

__all__ = ["BaseEquation", "CahnHilliard2DPeriodic", "PDEModel"]
