"""Vectorized PDE control environments (PyTorch port of
:mod:`pde_opt_tpu.envs.vector_env`).

The whole fleet is one batched state and two functions:

    ``reset(generator)        -> (EnvState, obs)``
    ``step(state, actions)    -> (EnvState, obs, reward, terminated, truncated, info)``

A step advances the fleet one of two ways, as in the JAX package:

* ``vectorized_control=False`` (the default): per env, by
  :func:`torch.func.vmap` of one env's macro-step (control update, control
  parameter, equation, solver, substeps), each env from its own time
  ``state.t``.  The fused macros, the fused rhs and the dense solve's
  product fold the vmapped axis into their env axis, so a fleet step is
  still one kernel launch (one a substep for the fused rhs).
* ``vectorized_control=True``: every env through ONE batch-transparent
  equation; with the fused epilogue the macro kernel itself emits the
  per-env statistics and the observation.

PyTorch runs eagerly, so ``make_rollout`` is a Python loop of steps that
never synchronises with the device.

Differences from the JAX env, each forced by eager PyTorch:

* Randomness comes from ``torch.Generator``s.  ``reset(generator)`` keeps
  the generator and draws the auto-reset fields from it; ``EnvState`` holds
  no keys.
* ``step`` updates the state's tensors in place (the JAX step donates its
  state buffers) and returns the same ``EnvState``; a step that autograd
  records returns a new one.
* Auto-reset is branch-free: every step draws a fleet-wide reset field and
  selects it with ``torch.where`` for the envs that terminated.  The JAX
  ``lax.cond(terminated.any())`` would need a device-to-host sync per step
  in eager PyTorch; per-env results are the same either way.  Where the
  fleet's ``reset_func`` is an :func:`affine_normal_reset` and the fused
  epilogue observes at full size, one kernel pass on the card
  (:func:`~pde_opt_tpu_torch.ops.fleet_reset.fleet_reset`) does the
  selects and writes the next state in place, bit for bit as the torch
  selects do.
* A run resumes its auto-reset stream from a checkpoint of
  ``generator.get_state()``: :meth:`VectorPDEEnv.set_generator` hands the
  env a generator without drawing a fleet (the JAX state carries its keys).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import grid as domains
from ..ops.fleet_reset import fleet_reset, fleet_reset_refusal
from ..ops.integrate import evolve
from ..utils.compat import check_equation_solver_compatibility, prepare_solver_params
from ..utils.device import resolve_device
from ..utils.metrics import named_scope

__all__ = ["EnvState", "VectorPDEEnv", "affine_normal_reset", "env_state_from_numpy",
           "env_state_to_numpy"]


def _equation_and_solver(env, old_cv, new_cv):
    control_param = env.update_control_parameter(old_cv, new_cv)
    eq = env.equation_type(
        domain=env.domain,
        **{**env.static_equation_parameters, env.control_equation_parameter_name: control_param},
    )
    solver = env.solver_type(**prepare_solver_params(env.solver_type, env.solver_parameters, eq))
    return eq, solver


def macro_step(env, y, old_cv, new_cv, t0):
    """One RL macro-step of one env, or of a fleet through batch-transparent
    callables: control parameter, equation, solver, then ``env.n_substeps``
    substeps of ``env.dt_sub`` from time ``t0``.  Returns the new field.

    ``env`` is anything with the attributes :class:`VectorPDEEnv` and
    :class:`~pde_opt_tpu_torch.envs.gym_adapter.PDEEnv` keep from their
    constructors.  The per-env step of the vector env vmaps this over the
    fleet, and the gymnasium adapter calls it on one env: the body of the
    JAX package's ``_advance_single`` and ``PDEEnv``'s ``_step_core``.
    """
    eq, solver = _equation_and_solver(env, old_cv, new_cv)
    return evolve(solver, eq.rhs, y, t0, env.dt_sub, env.n_substeps)


class EnvState(NamedTuple):
    """Per-env state (leading axis = env batch), all tensors on one device."""

    y: torch.Tensor              # (B, *points) PDE field
    t: torch.Tensor              # (B,) float32 episode time
    control_value: torch.Tensor  # (B, ...) float32 current control value
    step_count: torch.Tensor     # (B,) int32
    done: torch.Tensor           # (B,) bool — episode ended at previous step


def env_state_from_numpy(state, device="cuda") -> EnvState:
    """An :class:`EnvState` from arrays: a mapping or any object with the
    fields ``y, t, control_value, step_count, done`` (e.g. the JAX package's
    ``EnvState``).  The JAX state's PRNG keys are not carried: the two
    packages' random streams differ."""
    def get(name):
        return state[name] if isinstance(state, dict) else getattr(state, name)

    device = resolve_device(device)
    return EnvState(*(torch.from_numpy(np.array(get(f))).to(device)
                      for f in EnvState._fields))


def env_state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """The state's tensors as a dict of numpy arrays (inverse of
    :func:`env_state_from_numpy`)."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in EnvState._fields}


def _per_env(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a (B,) mask to broadcast against ``like``'s trailing axes."""
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def _add_channel(obs: torch.Tensor) -> torch.Tensor:
    return obs[..., None, :, :]


def _normal_draw(domain, generator, n, dtype):
    """``n`` standard normal fields of the domain's shape from ``generator``."""
    return torch.randn((n, *domain.points), generator=generator, dtype=dtype,
                       device=generator.device)


def affine_normal_reset(affine, dtype=torch.float32) -> Callable:
    """A ``reset_func`` that sets each env to ``clamp(mean + noise z, lo,
    hi)`` of one standard normal field ``z``, ``affine = (mean, noise, lo,
    hi)``.  The function carries its tuple as ``reset_func.affine``: a fleet
    with such a reset and the fused epilogue at full size auto-resets in one
    pass on the card (:meth:`VectorPDEEnv._fleet_reset_refusal`), which
    observes the reset field as that epilogue observes a stepped one."""
    mean, noise, lo, hi = affine

    def reset_func(domain, generator, n):
        return torch.clamp(mean + noise * _normal_draw(domain, generator, n, dtype), lo, hi)

    reset_func.affine = tuple(affine)
    return reset_func


def _torch_auto_reset(env, state, terminated, y1, cv1, t1, steps1, obs):
    """The auto-reset in plain torch, for any fleet (the fleet-reset pass's
    twin): draw a fleet-wide reset and select it, its observation, the reset
    control and a zero clock and step count for the terminated envs.
    Returns ``((y, t, control_value, step_count, done), obs)`` of the next
    state; ``state`` is left to the caller to write."""
    reset_y = env.reset_func(env.domain, env._generator, y1.shape[0])
    y_next = torch.where(_per_env(terminated, y1), reset_y.to(y1.dtype), y1)
    cv_next = torch.where(_per_env(terminated, cv1), env._reset_cv.to(cv1.dtype), cv1)
    obs_reset = env.state_to_observation_func(reset_y)
    obs_next = torch.where(_per_env(terminated, obs), obs_reset, obs)
    t_next = torch.where(terminated, torch.zeros_like(t1), t1)
    steps_next = torch.where(terminated, torch.zeros_like(steps1), steps1)
    return (y_next, t_next, cv_next, steps_next, torch.zeros_like(terminated)), obs_next


class VectorPDEEnv:
    """Batched PDE control environment.

    Args mirror the JAX ``VectorPDEEnv``, with these contracts for the
    callables.  Whatever the mode:

        reset_func: ``(domain, generator, n) -> (n, *points)`` field, drawn
            on ``generator.device`` (the fleet's draw; the JAX env vmaps a
            per-env ``(domain, key)``).
        state_to_observation_func: ``(B, *points) -> obs``, the fleet.
        fused_epilogue: the JAX env's config (``obs_scale``, ``obs_offset``,
            ``obs_downsample``, ``stats_center``, ``reward_from_stats``,
            optional ``obs_transform`` and ``n_px``); needs
            ``vectorized_control=True``, as in JAX.
        device: where the fleet lives.

    With ``vectorized_control=False`` (the default, as in JAX) the step
    vmaps one env's macro-step, and these see ONE env:

        update_control_value: ``(offset (*action), cv) -> cv``.
        update_control_parameter: ``(old cv, new cv) -> parameter`` of one
            env, e.g. a scalar κ or a ``velocity(t, X, Y)`` callable; the
            equation, the stepper and ``rhs(y, t)`` see that env's field
            ``(*points)`` and its own time ``t`` (a 0-d tensor).
        reward_function: ``(*points) -> ()``.

    With ``vectorized_control=True`` they see the whole fleet, and must be
    batch-aware: ``update_control_value`` keeps the ``(B, ...)`` control's
    shape, ``update_control_parameter`` returns a parameter that broadcasts
    against ``(B, *points)`` fields (e.g. ``new[..., None, None]``), and
    ``reward_function`` maps ``(B, *points) -> (B,)``.  Each env's time is
    not passed: the equation must be time-autonomous.

    ``action_space_config`` is continuous (``{"type": "continuous",
    "shape", "low", "high"}``) or discrete (``{"type": "discrete",
    "num_actions", "action_mapping"}``: action ``i`` becomes the control
    offset ``action_mapping[i]``, looked up on the device for the whole
    fleet; no mapping gives zero offsets).
    """

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
        num_envs: int = 1,
        auto_reset: bool = True,
        vectorized_control: bool = False,
        fused_epilogue: Optional[Dict[str, Any]] = None,
        device="cuda",
    ):
        if fused_epilogue is not None and not vectorized_control:
            raise ValueError("fused_epilogue requires vectorized_control")
        self.equation_type = equation_type
        self.domain = domain
        self.solver_type = solver_type
        check_equation_solver_compatibility(solver_type, equation_type)

        self.end_time = float(end_time)
        self.step_dt = float(step_dt)
        self.numeric_dt = float(numeric_dt)
        self.n_substeps = max(1, int(round(self.step_dt / self.numeric_dt)))
        self.dt_sub = self.step_dt / self.n_substeps
        self.max_episode_steps = int(np.ceil(self.end_time / self.step_dt))

        self.state_to_observation_func = state_to_observation_func
        self.reward_function = reward_function
        self.reset_func = reset_func
        self.reset_control_value = reset_control_value
        self.update_control_value = update_control_value
        self.update_control_parameter = update_control_parameter
        self.static_equation_parameters = static_equation_parameters
        self.control_equation_parameter_name = control_equation_parameter_name
        self.solver_parameters = solver_parameters
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.vectorized_control = vectorized_control
        self.fused_epilogue = fused_epilogue
        self.device = resolve_device(device)
        # Built once: a host-to-device copy inside step() would make the
        # host wait for the device every step.
        reset_cv = torch.as_tensor(reset_control_value, dtype=torch.float32)
        self._reset_cv = reset_cv.to(self.device)
        # The fleet-reset pass takes the control as one f32 value.
        self._reset_cv_value = float(reset_cv) if reset_cv.ndim == 0 else None
        self._generator: Optional[torch.Generator] = None

        cfg = dict(action_space_config)
        self.action_type = cfg.get("type", "continuous")
        if self.action_type == "discrete":
            self.num_actions = cfg.get("num_actions", 5)
            mapping = cfg.get("action_mapping", {})
            # The offsets table lives on the device: step() looks actions up
            # there, with no host round trip.
            if mapping:
                table = np.stack([np.asarray(mapping[i], dtype=np.float32)
                                  for i in range(len(mapping))])
            else:
                table = np.zeros((self.num_actions, 1), np.float32)
            self._action_table = torch.from_numpy(table).to(self.device)
        else:
            self.action_shape = tuple(cfg.get("shape", (2,)))
            self.action_low = cfg.get("low", -1.0)
            self.action_high = cfg.get("high", 1.0)
        self.action_space_config = cfg

    # ------------------------------------------------------------------

    def _offsets(self, actions):
        """The fleet's control offsets: a discrete action's row of the
        table (looked up on the device), else the action itself."""
        if self.action_type == "discrete":
            return self._action_table.index_select(0, actions.reshape(-1).long())
        return actions

    @staticmethod
    def _check_control(new_cv, cv, B):
        if tuple(new_cv.shape) != tuple(cv.shape):
            raise ValueError(
                f"update_control_value produced shape {tuple(new_cv.shape)} "
                f"from a {tuple(cv.shape)} control (env batch {B}). "
                "The control value must keep its per-env shape; a common "
                "cause is broadcasting the raw (B, k) action offset against "
                "the (B,) control (use off[..., 0])."
            )

    @staticmethod
    def _check_shape(y1, y):
        if y1.shape != y.shape:
            raise ValueError(
                f"macro-step changed the state shape {tuple(y.shape)} -> "
                f"{tuple(y1.shape)} (check update_control_parameter)"
            )

    def _advance_batched(self, y, cv, actions, ep_cfg=None):
        """Whole-fleet macro-step through one batch-transparent equation.

        Returns ``(y1, new_cv, stats, obs)`` with ``ep_cfg`` (the
        ``fused_epilogue`` config), else ``(y1, new_cv)``.
        """
        new_cv = self.update_control_value(self._offsets(actions), cv)
        self._check_control(new_cv, cv, y.shape[0])
        B = y.shape[0]
        if ep_cfg is None:
            with named_scope("vector_env.stepper", B):
                y1 = macro_step(self, y, cv, new_cv, 0.0)
            self._check_shape(y1, y)
            return y1, new_cv
        eq, solver = _equation_and_solver(self, cv, new_cv)
        own = getattr(solver, "evolve_with_epilogue", None)
        if own is None:
            raise TypeError(
                f"{type(solver).__name__} does not support "
                "fused_epilogue (no evolve_with_epilogue hook)"
            )
        with named_scope("vector_env.stepper", B):
            y1, stats, obs = own(eq.rhs, y, 0.0, self.dt_sub, self.n_substeps, ep_cfg)
        self._check_shape(y1, y)
        return y1, new_cv, stats, obs

    def _advance_per_env(self, y, cv, actions, t):
        """The fleet's macro-step as :func:`torch.func.vmap` of one env's
        (the JAX env's ``vmap(_advance_single)``): each env its own control
        callables' call and its own start time ``t``.  Returns ``(y1,
        new_cv)``."""

        def one(y_i, cv_i, off_i, t_i):
            new_cv = self.update_control_value(off_i, cv_i)
            self._check_control(new_cv, cv_i, y.shape[0])
            return macro_step(self, y_i, cv_i, new_cv, t_i), new_cv

        offsets = self._offsets(actions)
        with named_scope("vector_env.stepper", y.shape[0]):
            y1, new_cv = torch.func.vmap(one)(y, cv, offsets, t)
        self._check_shape(y1, y)
        return y1, new_cv

    def _fleet_reset_refusal(self, state, terminated, y1, cv1, t1, steps1, obs):
        """Why the auto-reset of this step does not run as the fleet-reset
        pass, or None where it does: the rule reads only the env's reset
        function, its fused epilogue and the tensors it holds."""
        ep = self.fused_epilogue
        if getattr(self.reset_func, "affine", None) is None:
            return "the reset is not an affine_normal_reset"
        if ep is None:
            return "no fused epilogue"
        if ep.get("obs_downsample", 1) != 1 or ep.get("obs_offset", 0.0) != 0.0:
            return "the observation is pooled or offset"
        if self._reset_cv_value is None:
            return "the reset control is not one value an env"
        return fleet_reset_refusal(state, terminated, y1, cv1, t1, steps1, obs)

    def _auto_reset(self, state, terminated, y1, cv1, t1, steps1, obs):
        """Branch-free auto-reset: draw a fleet-wide reset and select it for
        the terminated envs.  Non-terminated envs keep ``y1``, ``cv1``,
        ``t1``, ``steps1`` and the step's own ``obs`` exactly.

        Returns ``(nxt, obs_next)``: ``nxt`` the next state's tensors in
        :class:`EnvState` order for :meth:`step` to write, or None where the
        fleet-reset pass has written them into ``state``."""
        if self._generator is None:
            raise RuntimeError("call reset(generator) before step()")
        B = y1.shape[0]
        with named_scope("vector_env.auto_reset", B):
            if self._fleet_reset_refusal(state, terminated, y1, cv1, t1, steps1, obs) is None:
                z = _normal_draw(self.domain, self._generator, B, y1.dtype)
                return None, fleet_reset(state, terminated, y1, z, obs, cv1, t1, steps1,
                                         self.reset_func.affine, self._reset_cv_value,
                                         self.fused_epilogue["obs_scale"])
            return _torch_auto_reset(self, state, terminated, y1, cv1, t1, steps1, obs)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def set_generator(self, generator: torch.Generator):
        """Feed every later auto-reset from ``generator``, drawing nothing
        now: the way to resume a run from a checkpoint, whose env state and
        ``generator.get_state()`` take the place of :meth:`reset`."""
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator is on {generator.device}, the fleet on {self.device}"
            )
        self._generator = generator

    def reset(self, generator: torch.Generator):
        """Reset all envs, drawing from ``generator`` (which also feeds every
        later auto-reset).  Returns ``(EnvState, obs)``."""
        self.set_generator(generator)
        # step() writes into the state's tensors: give them their own memory.
        return self._initial_state(self.reset_func(self.domain, generator,
                                                   self.num_envs).contiguous())

    def _initial_state(self, y0: torch.Tensor):
        """``(EnvState, obs)`` of fresh episodes from the fields ``y0``."""
        B = y0.shape[0]
        state = EnvState(
            y=y0,
            t=torch.zeros((B,), dtype=torch.float32, device=self.device),
            control_value=self._reset_cv.expand(B, *self._reset_cv.shape).clone(),
            step_count=torch.zeros((B,), dtype=torch.int32, device=self.device),
            done=torch.zeros((B,), dtype=torch.bool, device=self.device),
        )
        return state, self.state_to_observation_func(y0)

    def step(self, state: EnvState, actions):
        """Advance all envs one RL step.

        Writes the next state into ``state``'s tensors (the JAX step donates
        them; a step that autograd records makes new ones) and returns
        ``(state, obs, reward, terminated, truncated, info)``; ``info`` has ``diverged`` and, under auto-reset,
        ``final_observation``.
        """
        with named_scope("vector_env.step", state.y.shape[0]):
            actions = torch.as_tensor(actions, device=self.device)
            ep = self.fused_epilogue
            if ep is not None:
                # The fused macro emitted per-env [sum, sumsq, n_finite] and the
                # uint8 obs: reward and the divergence flag come from those
                # scalars, with no extra pass over the field.
                y1, cv1, stats, obs_k = self._advance_batched(
                    state.y, state.control_value, actions, ep_cfg=ep
                )
                n_px = ep.get("n_px") or (y1.shape[-2] * y1.shape[-1])
                s1, s2, cnt = stats[..., 0], stats[..., 1], stats[..., 2]
                diverged = cnt < (n_px - 0.5)
                reward = ep["reward_from_stats"](s1, s2, cnt, n_px)
                reward = torch.where(diverged, torch.zeros_like(reward), reward)
                obs = ep.get("obs_transform", _add_channel)(obs_k)
                if not self.auto_reset:
                    # The caller keeps stepping the fleet: scrub NaN fields.
                    y1 = torch.where(_per_env(diverged, y1), torch.zeros_like(y1), y1)
            else:
                if self.vectorized_control:
                    y1, cv1 = self._advance_batched(state.y, state.control_value, actions)
                    reward = self.reward_function(y1)
                    if tuple(reward.shape) != (y1.shape[0],):
                        raise ValueError(
                            f"reward_function returned shape {tuple(reward.shape)} for "
                            f"{y1.shape[0]} envs: with vectorized_control=True it maps the "
                            f"fleet {tuple(y1.shape)} to one reward an env, (B,)"
                        )
                else:
                    y1, cv1 = self._advance_per_env(state.y, state.control_value, actions,
                                                    state.t)
                    reward = torch.func.vmap(self.reward_function)(y1)
                # A non-finite field terminates (and, under auto_reset, resets)
                # that env without stalling the lockstep fleet.
                diverged = ~torch.isfinite(y1).reshape(y1.shape[0], -1).all(dim=1)
                reward = torch.where(diverged, torch.zeros_like(reward), reward)
                y1 = torch.where(_per_env(diverged, y1), torch.zeros_like(y1), y1)
                obs = self.state_to_observation_func(y1)
            t1 = state.t + self.step_dt
            steps1 = state.step_count + 1
            terminated = (t1 >= self.end_time - 1e-9) | diverged
            info = {"diverged": diverged}

            if self.auto_reset:
                nxt, obs_next = self._auto_reset(state, terminated, y1, cv1, t1, steps1, obs)
                info = {"final_observation": obs, "diverged": diverged}
                obs = obs_next
            else:
                nxt = (y1, t1, cv1, steps1, terminated)

            # In place, keeping each field's dtype (the JAX step's dtype pin),
            # unless the fleet-reset pass wrote the state already (nxt None).
            # A step that autograd records gets new tensors instead: writing
            # into the state would overwrite what the macro saved for its
            # backward (the state it read).
            if nxt is not None:
                if torch.is_grad_enabled() and any(t.requires_grad for t in nxt):
                    state = EnvState(*(src.to(dst.dtype) for dst, src in zip(state, nxt)))
                else:
                    for dst, src in zip(state, nxt):
                        dst.copy_(src)
            truncated = torch.zeros_like(terminated)
            return state, obs, reward, terminated, truncated, info

    def sample_actions(self, generator: torch.Generator):
        """Uniform random actions for the whole batch (integers in
        ``[0, num_actions)`` for a discrete space)."""
        if self.action_type == "discrete":
            return torch.randint(0, self.num_actions, (self.num_envs,), generator=generator,
                                 device=self.device)
        u = torch.rand((self.num_envs, *self.action_shape), generator=generator,
                       device=self.device)
        return self.action_low + (self.action_high - self.action_low) * u

    def make_rollout(self, policy_fn: Callable, n_steps: int):
        """An ``n_steps`` rollout: ``run(state, generator) -> (state, rewards,
        terminateds)`` with ``policy_fn(obs, generator) -> actions``.

        A Python loop of :meth:`step` that never waits for the device;
        ``rewards`` and ``terminateds`` are ``(n_steps, B)``.
        """

        def run(state: EnvState, generator: torch.Generator):
            with named_scope("vector_env.rollout", n_steps * state.y.shape[0]):
                # The obs a step returns IS the next state's observation.
                obs = self.state_to_observation_func(state.y)
                rewards, terms = [], []
                for _ in range(n_steps):
                    actions = policy_fn(obs, generator)
                    state, obs, reward, terminated, _, _ = self.step(state, actions)
                    rewards.append(reward)
                    terms.append(terminated)
                return state, torch.stack(rewards), torch.stack(terms)

        return run

    def rollout(self, state: EnvState, policy_fn: Callable, n_steps: int,
                generator: Optional[torch.Generator] = None):
        """Run ``n_steps`` (default generator: seed 0 on the fleet's device)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.make_rollout(policy_fn, n_steps)(state, generator)
