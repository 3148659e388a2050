"""Stencils, transforms, steppers and the fused macro (PyTorch port)."""

from .cas_spectral import (
    PolynomialMu,
    make_ch_cas_fused_macro,
    make_ch_cas_fused_macro_ep,
)
from .fused_spectral import ch_sif_macro_reference
from .integrate import ConstantStepSize, PIDController, evolve, integrate
from .steppers import FusedSemiImplicitSpectral, SemiImplicitFourierSpectral

__all__ = [
    "PolynomialMu",
    "make_ch_cas_fused_macro",
    "make_ch_cas_fused_macro_ep",
    "ch_sif_macro_reference",
    "evolve",
    "integrate",
    "ConstantStepSize",
    "PIDController",
    "FusedSemiImplicitSpectral",
    "SemiImplicitFourierSpectral",
]
