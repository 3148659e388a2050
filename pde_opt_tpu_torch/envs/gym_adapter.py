"""Gymnasium adapters (PyTorch port of :mod:`pde_opt_tpu.envs.gym_adapter`).

``PDEEnv`` keeps the JAX adapter's API (the reference ``PDEEnv`` for
SB3-style host training loops) and ``AdvectionDiffusionEnv`` its
``AdvectionDiffusion-v0`` env.  A step's work is
:func:`~pde_opt_tpu_torch.envs.vector_env.macro_step`, the same body the
vector env vmaps over its fleet in per-env mode, on the env's device (the
card unless the caller passes ``device="cpu"``).

The two are registered as ``pde_opt_tpu_torch/PDEEnv-v0`` and
``pde_opt_tpu_torch/AdvectionDiffusion-v0``: the JAX package registers the
bare ids, and each id resolves to its own package's class whichever is
imported first.  Importing this module imports gymnasium;
``pde_opt_tpu_torch`` and ``pde_opt_tpu_torch.envs`` import it only when
``PDEEnv`` or ``AdvectionDiffusionEnv`` is first touched.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import gymnasium as gym
import numpy as np
import torch
from gymnasium import spaces
from gymnasium.envs.registration import register, registry

from .. import grid as domains
from ..models.advection_diffusion import AdvectionDiffusion2D
from ..ops.steppers import RK4
from ..utils.compat import check_equation_solver_compatibility
from ..utils.device import resolve_device
from .vector_env import macro_step

__all__ = ["PDEEnv", "AdvectionDiffusionEnv"]

NAMESPACE = "pde_opt_tpu_torch"


def _register_once(env_id: str, entry_point: str):
    if env_id not in registry:
        register(id=env_id, entry_point=entry_point)


_register_once(f"{NAMESPACE}/PDEEnv-v0", "pde_opt_tpu_torch.envs.gym_adapter:PDEEnv")
_register_once(f"{NAMESPACE}/AdvectionDiffusion-v0",
               "pde_opt_tpu_torch.envs.gym_adapter:AdvectionDiffusionEnv")


def _host(x):
    """A tensor as a numpy array (anything else as it is)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


class PDEEnv(gym.Env):
    """Gymnasium RL environment controlling one PDE parameter.

    The constructor is the JAX adapter's, plus ``device`` (default: the
    card).  ``reset_func(domain[, seed])`` runs at reset and its field goes
    to ``device``; ``update_control_value`` runs on the host, as in the
    reference; a step is one :func:`macro_step` from the env's own time,
    with the old and new control values as f32 tensors on ``device``.
    ``state_to_observation_func`` and ``reward_function`` see the field
    tensor; observations come back as numpy arrays, rewards as floats.
    """

    metadata = {"render_modes": []}

    def __init__(
        self,
        equation_type,
        domain: domains.Domain,
        solver_type,
        end_time: float,
        step_dt: float,
        numeric_dt: float,
        state_to_observation_func: Callable,
        reward_function: Callable,
        reset_func: Callable,
        reset_control_value,
        update_control_value: Callable,
        update_control_parameter: Callable,
        action_space_config: Dict[str, Any],
        static_equation_parameters: Dict[str, Any],
        control_equation_parameter_name: str,
        solver_parameters: Dict[str, Any],
        device="cuda",
    ):
        super().__init__()
        self.equation_type = equation_type
        self.domain = domain
        self.solver_type = solver_type
        check_equation_solver_compatibility(solver_type, equation_type)

        self.end_time = end_time
        self.step_dt = step_dt
        self.numeric_dt = numeric_dt
        self.n_substeps = max(1, int(round(step_dt / numeric_dt)))
        self.dt_sub = step_dt / self.n_substeps
        self.reward_function = reward_function
        self.reset_func = reset_func
        self.state_to_observation_func = state_to_observation_func
        self.device = resolve_device(device)

        self.observation_space = spaces.Box(
            low=0.0, high=255.0, shape=(1, *self.domain.points), dtype=np.uint8
        )
        self._setup_action_space(action_space_config)

        self.reset_control_value = reset_control_value
        self.update_control_value = update_control_value
        self.update_control_parameter = update_control_parameter
        self.static_equation_parameters = static_equation_parameters
        self.control_equation_parameter_name = control_equation_parameter_name
        self.solver_parameters = solver_parameters

    def _setup_action_space(self, config: Dict[str, Any]):
        """Continuous Box, or Discrete with a mapping of offsets."""
        action_type = config.get("type", "continuous")
        if action_type == "discrete":
            num_actions = config.get("num_actions", 5)
            self.action_space = spaces.Discrete(num_actions)
            self._action_to_direction = config.get("action_mapping", {})
        else:
            action_shape = config.get("shape", (2,))
            low = config.get("low", -1.0)
            high = config.get("high", 1.0)
            self.action_space = spaces.Box(low=low, high=high, shape=action_shape)
            self._action_to_direction = None

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(_host(x), dtype=dtype, device=self.device)

    def _get_obs(self):
        return np.asarray(_host(self.state_to_observation_func(self._state)))

    def _get_info(self):
        return {}

    def _terminate(self):
        return self._time >= self.end_time

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            y0 = self.reset_func(self.domain, seed=seed)
        else:
            y0 = self.reset_func(self.domain)
        self._state = self._tensor(y0, self.domain.dtype)
        self._time = 0.0
        self._control_value = self.reset_control_value
        return self._get_obs(), self._get_info()

    def step(self, action):
        offset = (
            action
            if not self._action_to_direction
            else self._action_to_direction[int(action)]
        )
        old_cv = self._control_value
        self._control_value = self.update_control_value(offset, old_cv)

        self._state = macro_step(
            self, self._state, self._tensor(old_cv), self._tensor(self._control_value),
            self._tensor(self._time),
        )
        self._time += self.step_dt

        obs = self._get_obs()
        reward = float(self.reward_function(self._state))
        return obs, reward, self._terminate(), False, self._get_info()


class AdvectionDiffusionEnv(PDEEnv):
    """``AdvectionDiffusion-v0``: the agent steers a uniform advection
    velocity.

    The JAX adapter's keyword arguments (``reset_func,
    diffusion_coefficient, max_control_step, end_time, step_dt, numeric_dt,
    domain, field_dim, reward_function, discrete_action_space``) plus
    ``device``.  The control value is the 2-vector velocity ``(vx, vy)``;
    actions nudge it by up to ``max_control_step`` (continuous) or by fixed
    offsets (discrete 5-way: no-op / ±x / ±y).
    """

    def __init__(
        self,
        reset_func: Callable,
        diffusion_coefficient: float,
        max_control_step: float,
        end_time: float,
        step_dt: float,
        numeric_dt: float,
        domain: domains.Domain,
        field_dim: int = 1,
        reward_function: Callable = lambda x: 0.0,
        discrete_action_space: bool = False,
        device="cuda",
    ):
        m = float(max_control_step)
        if discrete_action_space:
            action_space_config = {
                "type": "discrete",
                "num_actions": 5,
                "action_mapping": {
                    0: np.array([0.0, 0.0], np.float32),
                    1: np.array([m, 0.0], np.float32),
                    2: np.array([-m, 0.0], np.float32),
                    3: np.array([0.0, m], np.float32),
                    4: np.array([0.0, -m], np.float32),
                },
            }
            update_control_value = lambda offset, old: np.asarray(old) + np.asarray(offset)
        else:
            action_space_config = {"type": "continuous", "shape": (2,),
                                   "low": -1.0, "high": 1.0}
            update_control_value = (
                lambda offset, old: np.asarray(old) + m * np.asarray(offset)
            )

        def update_control_parameter(old_cv, new_cv):
            # A uniform velocity field from the control 2-vector.
            return lambda t, X, Y: (new_cv[..., 0], new_cv[..., 1])

        def obs_fn(state):
            return torch.clamp(state * 255.0, 0, 255).to(torch.uint8)[None]

        device = resolve_device(device)
        super().__init__(
            equation_type=AdvectionDiffusion2D,
            domain=domain,
            solver_type=RK4,
            end_time=end_time,
            step_dt=step_dt,
            numeric_dt=numeric_dt,
            state_to_observation_func=obs_fn,
            reward_function=reward_function,
            reset_func=reset_func,
            reset_control_value=np.zeros(2, np.float32),
            update_control_value=update_control_value,
            update_control_parameter=update_control_parameter,
            action_space_config=action_space_config,
            static_equation_parameters={"diffusion_coeff": diffusion_coefficient,
                                        "device": device},
            control_equation_parameter_name="velocity",
            solver_parameters={},
            device=device,
        )
