"""Stencils, transforms, steppers and the fused macro (PyTorch port)."""

from .bv_cas import LogRatioMu, SqrtJ0, bv_cc_reference, make_bv_cc_fused_macro
from .cas3d import ch3d_sif_macro_reference, make_ch3d_cas_macro
from .cas_mobility import (
    ch3d_mobility_macro_reference,
    ch_mobility_macro_reference,
    make_ch3d_mobility_cas_macro,
    make_ch_mobility_cas_macro,
)
from .cas_spectral import (
    PolynomialMu,
    make_ac_cas_fused_macro,
    make_ch_cas_fused_macro,
    make_ch_cas_fused_macro_ep,
)
from .fused import make_ch3d_rhs_fd_fused, make_ch_rhs_fd_fused
from .fused_spectral import (
    ac_sif_macro_reference,
    ch_sif_macro_reference,
    make_ac_sif_fused_macro,
    make_ch_sif_fused_macro,
)
from .gpe_cas import gpe_strang_fast_reference, make_gpe_strang_cas_macro
from .gpe_rot_fast import build_sweep_tensors, make_rot_adi_macro
from .integrate import ConstantStepSize, PIDController, evolve, integrate, integrate_adaptive
from .sbm_bv import make_sbm_bv_fused_macro, sbm_bv_reference
from .steppers import (
    RK4,
    DirectionalSplitting,
    Euler,
    FusedAllenCahnSpectral,
    FusedButlerVolmer,
    FusedSBMButlerVolmer,
    FusedMobilitySpectral,
    FusedRotatingSplitting,
    FusedSemiImplicitSpectral,
    FusedSemiImplicitSpectral3D,
    FusedStrangControl,
    SemiImplicitFourierSpectral,
    Heun,
    StrangSplitting,
    Tsit5,
)

__all__ = [
    "PolynomialMu",
    "LogRatioMu",
    "SqrtJ0",
    "make_ch_cas_fused_macro",
    "make_ch_cas_fused_macro_ep",
    "make_ac_cas_fused_macro",
    "make_ch_sif_fused_macro",
    "make_ac_sif_fused_macro",
    "make_gpe_strang_cas_macro",
    "make_rot_adi_macro",
    "build_sweep_tensors",
    "make_bv_cc_fused_macro",
    "make_sbm_bv_fused_macro",
    "make_ch_rhs_fd_fused",
    "make_ch3d_rhs_fd_fused",
    "make_ch3d_cas_macro",
    "make_ch_mobility_cas_macro",
    "make_ch3d_mobility_cas_macro",
    "ch3d_sif_macro_reference",
    "ch_mobility_macro_reference",
    "ch3d_mobility_macro_reference",
    "bv_cc_reference",
    "sbm_bv_reference",
    "ch_sif_macro_reference",
    "ac_sif_macro_reference",
    "gpe_strang_fast_reference",
    "evolve",
    "integrate",
    "integrate_adaptive",
    "ConstantStepSize",
    "PIDController",
    "FusedSemiImplicitSpectral",
    "FusedSemiImplicitSpectral3D",
    "FusedMobilitySpectral",
    "FusedAllenCahnSpectral",
    "FusedStrangControl",
    "SemiImplicitFourierSpectral",
    "StrangSplitting",
    "Euler",
    "Heun",
    "RK4",
    "Tsit5",
    "FusedButlerVolmer",
    "FusedSBMButlerVolmer",
    "DirectionalSplitting",
    "FusedRotatingSplitting",
]
