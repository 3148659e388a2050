"""pde_opt_tpu_torch — the PyTorch / CUDA port of :mod:`pde_opt_tpu`.

Module paths and public names mirror the JAX package, which stays the
reference the port is held against.  Ported so far: the flagship
Cahn-Hilliard control fleet (``envs.presets.make_cahn_hilliard_control_env``)
down to its fused cas macro, whose CUDA tensors run a hand-written Hopper
kernel (``csrc/ch_cas_macro.cu``).  The package imports torch and numpy,
never jax.
"""

from . import envs, models, ops, utils
from .envs import EnvState, VectorPDEEnv, make_cahn_hilliard_control_env
from .grid import Domain, Grid

__all__ = [
    "envs", "models", "ops", "utils",
    "Domain", "Grid",
    "EnvState", "VectorPDEEnv", "make_cahn_hilliard_control_env",
]
