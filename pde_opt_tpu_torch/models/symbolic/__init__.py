"""Symbolic (sympy) manufactured-solution twins (PyTorch port of
:mod:`pde_opt_tpu.models.symbolic`): test-only and host-side.

One generic MMS engine (:mod:`pde_opt_tpu_torch.models.symbolic.mms`) plus
thin per-equation operator wrappers.  Needs sympy, which
``import pde_opt_tpu_torch`` never imports: ``models`` does not import this
package.
"""

from .base_sym_eq import BaseSymbolicEquation
from .mms import (
    MMS,
    advection_diffusion_operator,
    allen_cahn_operator,
    cahn_hilliard_operator,
    sym_div,
    sym_grad,
    sym_lap,
)
from .allen_cahn_sym import SymbolicAllenCahn2DPeriodic
from .cahn_hilliard_sym import (
    SymbolicCahnHilliard2DPeriodic,
    SymbolicCahnHilliard3DPeriodic,
)
from .advection_diffusion_sym import SymbolicAdvectionDiffusion2D

__all__ = [
    "BaseSymbolicEquation",
    "MMS",
    "sym_lap",
    "sym_div",
    "sym_grad",
    "allen_cahn_operator",
    "cahn_hilliard_operator",
    "advection_diffusion_operator",
    "SymbolicAllenCahn2DPeriodic",
    "SymbolicCahnHilliard2DPeriodic",
    "SymbolicCahnHilliard3DPeriodic",
    "SymbolicAdvectionDiffusion2D",
]
