"""Vectorized PDE control environments (PyTorch port)."""

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
    "env_state_from_numpy",
    "env_state_to_numpy",
    "make_cahn_hilliard_control_env",
    "make_allen_cahn_control_env",
    "make_gpe_control_env",
    "make_gpe_rot_control_env",
    "make_butler_volmer_control_env",
    "make_sbm_butler_volmer_control_env",
]
