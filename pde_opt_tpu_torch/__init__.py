"""pde_opt_tpu_torch — the PyTorch / CUDA port of :mod:`pde_opt_tpu`.

Module paths and public names mirror the JAX package, which stays the
reference the port is held against.  Ported so far: the flagship
Cahn-Hilliard control fleet (``envs.presets.make_cahn_hilliard_control_env``)
down to its fused cas macro, and the training path through the same macro
(``PDEModel.optimize``/``train`` on ``FusedSemiImplicitSpectral`` through a
checkpointed ``integrate``).  On CUDA tensors the macro and its backward run
hand-written Hopper kernels (``csrc/ch_cas_macro.cu``).  The package imports
torch and numpy, never jax.
"""

from . import envs, models, ops, optim, utils
from .envs import EnvState, VectorPDEEnv, make_cahn_hilliard_control_env
from .grid import Domain, Grid
from .models import PDEModel
from .ops import integrate

__all__ = [
    "envs", "models", "ops", "optim", "utils",
    "Domain", "Grid", "PDEModel", "integrate",
    "EnvState", "VectorPDEEnv", "make_cahn_hilliard_control_env",
]
