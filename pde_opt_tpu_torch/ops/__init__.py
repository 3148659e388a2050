"""Stencils, transforms, steppers and the fused macro (PyTorch port)."""

from .cas_spectral import (
    PolynomialMu,
    make_ac_cas_fused_macro,
    make_ch_cas_fused_macro,
    make_ch_cas_fused_macro_ep,
)
from .fused_spectral import ac_sif_macro_reference, ch_sif_macro_reference
from .gpe_cas import gpe_strang_fast_reference, make_gpe_strang_cas_macro
from .integrate import ConstantStepSize, PIDController, evolve, integrate
from .steppers import (
    FusedAllenCahnSpectral,
    FusedSemiImplicitSpectral,
    FusedStrangControl,
    SemiImplicitFourierSpectral,
    StrangSplitting,
)

__all__ = [
    "PolynomialMu",
    "make_ch_cas_fused_macro",
    "make_ch_cas_fused_macro_ep",
    "make_ac_cas_fused_macro",
    "make_gpe_strang_cas_macro",
    "ch_sif_macro_reference",
    "ac_sif_macro_reference",
    "gpe_strang_fast_reference",
    "evolve",
    "integrate",
    "ConstantStepSize",
    "PIDController",
    "FusedSemiImplicitSpectral",
    "FusedAllenCahnSpectral",
    "FusedStrangControl",
    "SemiImplicitFourierSpectral",
    "StrangSplitting",
]
