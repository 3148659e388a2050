"""Vectorized PDE control environments and the Gymnasium adapters
(PyTorch port).  ``PDEEnv`` and ``AdvectionDiffusionEnv`` import gymnasium
when first touched: the rest of the package does not need it."""

from .presets import (
    make_allen_cahn_control_env,
    make_butler_volmer_control_env,
    make_cahn_hilliard_control_env,
    make_gpe_control_env,
    make_gpe_rot_control_env,
    make_sbm_butler_volmer_control_env,
)
from .vector_env import EnvState, VectorPDEEnv, env_state_from_numpy, env_state_to_numpy

__all__ = [
    "EnvState",
    "VectorPDEEnv",
    "PDEEnv",
    "AdvectionDiffusionEnv",
    "env_state_from_numpy",
    "env_state_to_numpy",
    "make_cahn_hilliard_control_env",
    "make_allen_cahn_control_env",
    "make_gpe_control_env",
    "make_gpe_rot_control_env",
    "make_butler_volmer_control_env",
    "make_sbm_butler_volmer_control_env",
]


_GYM_NAMES = ("PDEEnv", "AdvectionDiffusionEnv")


def __getattr__(name):
    if name not in _GYM_NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    try:
        from . import gym_adapter
    except ModuleNotFoundError as e:
        if e.name != "gymnasium":
            raise
        raise ImportError(
            f"pde_opt_tpu_torch.envs.{name} needs gymnasium, which is not installed; "
            "the vector envs (VectorPDEEnv and the presets) do not"
        ) from e
    return getattr(gym_adapter, name)
