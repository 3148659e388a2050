"""Equations (PyTorch port)."""

from .base import BaseEquation
from .cahn_hilliard import CahnHilliard2DPeriodic

__all__ = ["BaseEquation", "CahnHilliard2DPeriodic"]
