"""pde_opt_tpu_torch — the PyTorch / CUDA port of :mod:`pde_opt_tpu`.

Module paths and public names mirror the JAX package, which stays the
reference the port is held against.  Ported so far: the flagship
Cahn-Hilliard control fleet (``envs.presets.make_cahn_hilliard_control_env``)
down to its fused cas macro, the training path through the same macro
(``PDEModel.optimize``/``train`` on ``FusedSemiImplicitSpectral`` through a
checkpointed ``integrate``), the Allen-Cahn and Gross-Pitaevskii control
fleets (``make_allen_cahn_control_env``, ``make_gpe_control_env``) and the
Butler-Volmer and smoothed-boundary Butler-Volmer charging fleets
(``make_butler_volmer_control_env``, ``make_sbm_butler_volmer_control_env``)
down to their fused macros, and the 3D and general-mobility Cahn-Hilliard
path (``CahnHilliard3DPeriodic``, ``FusedSemiImplicitSpectral3D``,
``FusedMobilitySpectral`` with the Legendre coefficient modules) down to the
fused FD rhs, which also serves ``derivs="pallas"``.  The fused CH and AC
steppers also take ``algo="dft"``, the packed-DFT macros.  The RL learners
(``rl``: PPO, DQN and DDPG with their nets) train on the fleets' device,
and the fleets take discrete action spaces.  The inverse-problem layer:
``PDEModel.train`` by Levenberg-Marquardt (``optim.lm``), the coefficient
nets (``PeriodicCNN``, ``Mixer2d``, the Legendre expansions in 1D and 2D)
and adaptive solves (``Tsit5`` under a ``PIDController``,
``integrate_adaptive``).  On CUDA tensors
the macros, the fused rhs and the CH backward run hand-written Hopper
kernels (``csrc/*.cu``): every Pallas kernel of the JAX package has its
counterpart.  The entry points build on
the card unless the caller passes ``device="cpu"``.  The package imports
torch and numpy, never jax.
"""

from . import envs, models, ops, optim, rl, utils
from .envs import (
    EnvState,
    VectorPDEEnv,
    make_allen_cahn_control_env,
    make_butler_volmer_control_env,
    make_cahn_hilliard_control_env,
    make_gpe_control_env,
    make_sbm_butler_volmer_control_env,
)
from .grid import Domain, Grid
from .models import CahnHilliard3DPeriodic, PDEModel
from .models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomialExpansion2D,
    Mixer2d,
    PeriodicCNN,
)
from .ops import (
    FusedMobilitySpectral,
    FusedSemiImplicitSpectral3D,
    PIDController,
    Tsit5,
    integrate,
    integrate_adaptive,
)
from .optim import least_squares_lm, least_squares_lm_jitted

__all__ = [
    "envs", "models", "ops", "optim", "rl", "utils",
    "Domain", "Grid", "PDEModel", "integrate", "integrate_adaptive", "Tsit5",
    "PIDController", "least_squares_lm", "least_squares_lm_jitted",
    "PeriodicCNN", "Mixer2d", "LegendrePolynomialExpansion",
    "LegendrePolynomialExpansion2D", "DiffusionLegendrePolynomials",
    "ChemicalPotentialLegendrePolynomials",
    "CahnHilliard3DPeriodic", "FusedSemiImplicitSpectral3D", "FusedMobilitySpectral",
    "EnvState", "VectorPDEEnv", "make_cahn_hilliard_control_env",
    "make_allen_cahn_control_env", "make_gpe_control_env",
    "make_butler_volmer_control_env", "make_sbm_butler_volmer_control_env",
]
