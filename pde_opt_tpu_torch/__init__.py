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
``integrate_adaptive``).  The rotating-frame GPE (``GPE2DTSRot``, the FFT
``DirectionalSplitting`` and its batched-matmul ADI
``FusedRotatingSplitting``, the stirring fleet ``make_gpe_rot_control_env``
with its vortex census) and smoothed-boundary geometry (``Shape``, the
smoothed-boundary Allen-Cahn, Cahn-Hilliard and Butler-Volmer equations,
``AdvectionDiffusion2D``).  On CUDA tensors the macros, the fused rhs and
the CH backward run hand-written Hopper kernels (``csrc/*.cu``): every
Pallas kernel of the JAX package has its counterpart.  The entry points
build on the card unless the caller passes ``device="cpu"``.  The package
imports torch and numpy, never jax.  The vector envs also step per env
(``vectorized_control=False``, the default, as in the JAX package), and
the edges are ported: the Gymnasium adapters ``PDEEnv`` and
``AdvectionDiffusionEnv`` (which import gymnasium when first touched),
checkpointing (``utils.checkpoint``) and the sympy MMS twins
(``models.symbolic``, ``utils.testing``; sympy is needed only there).
"""

from . import envs, models, ops, optim, rl, utils
from .envs import (
    EnvState,
    VectorPDEEnv,
    make_allen_cahn_control_env,
    make_butler_volmer_control_env,
    make_cahn_hilliard_control_env,
    make_gpe_control_env,
    make_gpe_rot_control_env,
    make_sbm_butler_volmer_control_env,
)
from .geometry import Shape
from .grid import Domain, Grid
from .models import (
    AdvectionDiffusion2D,
    AllenCahn2DPeriodic,
    AllenCahn2DPeriodicButlerVolmer,
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    AllenCahn2DSmoothedBoundary,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
    BaseEquation,
    CahnHilliard2DPeriodic,
    CahnHilliard2DSmoothedBoundary,
    CahnHilliard3DPeriodic,
    GPE2DTSControl,
    GPE2DTSRot,
    PDEModel,
    TimeSplittingEquation,
)
from .models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomialExpansion2D,
    Mixer2d,
    PeriodicCNN,
)
from .models.pde_model import OptimizationModel
from .ops import (
    RK4,
    DirectionalSplitting,
    Euler,
    FusedMobilitySpectral,
    FusedRotatingSplitting,
    FusedSemiImplicitSpectral3D,
    Heun,
    ImplicitEuler,
    PIDController,
    SemiImplicitFourierSpectral,
    StrangSplitting,
    Tsit5,
    evolve,
    integrate,
    integrate_adaptive,
)
from .optim import least_squares_lm, least_squares_lm_jitted

__all__ = [
    "envs", "models", "ops", "optim", "rl", "utils",
    # Core classes
    "PDEModel", "OptimizationModel", "EnvState", "VectorPDEEnv", "PDEEnv",
    "AdvectionDiffusionEnv",
    # Equations
    "BaseEquation", "TimeSplittingEquation", "AdvectionDiffusion2D",
    "AllenCahn2DPeriodic", "AllenCahn2DSmoothedBoundary",
    "AllenCahn2DPeriodicButlerVolmer", "AllenCahn2DPeriodicButlerVolmerConstantCurrent",
    "AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent",
    "CahnHilliard2DPeriodic", "CahnHilliard3DPeriodic", "CahnHilliard2DSmoothedBoundary",
    "GPE2DTSControl", "GPE2DTSRot",
    # Domains and shapes
    "Domain", "Grid", "Shape",
    # Functions
    "PeriodicCNN", "LegendrePolynomialExpansion", "LegendrePolynomialExpansion2D",
    "DiffusionLegendrePolynomials", "ChemicalPotentialLegendrePolynomials", "Mixer2d",
    # Solvers / integration
    "Euler", "Heun", "RK4", "Tsit5", "SemiImplicitFourierSpectral", "StrangSplitting",
    "DirectionalSplitting", "FusedRotatingSplitting", "FusedSemiImplicitSpectral3D",
    "FusedMobilitySpectral", "ImplicitEuler", "evolve", "integrate", "integrate_adaptive", "PIDController",
    "least_squares_lm", "least_squares_lm_jitted",
    # Env fleets
    "make_cahn_hilliard_control_env", "make_allen_cahn_control_env", "make_gpe_control_env",
    "make_gpe_rot_control_env", "make_butler_volmer_control_env",
    "make_sbm_butler_volmer_control_env",
]


def __getattr__(name):
    # The Gymnasium adapters, imported when first touched (they need
    # gymnasium; the rest of the package does not).
    if name in envs._GYM_NAMES:
        return getattr(envs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
