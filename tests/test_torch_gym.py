"""The port's Gymnasium adapters (``PDEEnv``, ``AdvectionDiffusionEnv``)
against the JAX package's, on the port's ids ``pde_opt_tpu_torch/PDEEnv-v0``
and ``pde_opt_tpu_torch/AdvectionDiffusion-v0``; and the port without
gymnasium and sympy.

A trajectory is held against JAX's from one numpy field and one action
list, in f64 on both sides (the fft stepper, as test_torch_env.py), to
1e-12."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import gymnasium as gym
import jax.numpy as jnp
import numpy as np
import torch

import pde_opt_tpu as jp
import pde_opt_tpu_torch as tp
from pde_opt_tpu.envs import gym_adapter as jgym
from pde_opt_tpu_torch.envs import gym_adapter as tgym

torch.set_num_threads(1)

N = 16
ROOT = Path(__file__).resolve().parents[1]


def _pde_envs(field, dtype=np.float64):
    """``PDEEnv`` in both packages (tests/test_env.py's configuration), each
    resetting to ``field``."""
    L = 0.01 * N
    box = ((-L / 2, L / 2), (-L / 2, L / 2))
    common = dict(end_time=0.03, step_dt=0.01, numeric_dt=0.001,
                  reset_control_value=0.002,
                  update_control_value=lambda off, old: float(
                      np.clip(old + 0.0005 * np.asarray(off)[0], 1e-4, 0.01)),
                  update_control_parameter=lambda old, new: new,
                  action_space_config={"type": "continuous", "shape": (1,)},
                  control_equation_parameter_name="kappa", solver_parameters={"A": 0.5})
    jenv = jgym.PDEEnv(
        equation_type=jp.CahnHilliard2DPeriodic, domain=jp.Domain((N, N), box, dtype=dtype),
        solver_type=jp.SemiImplicitFourierSpectral,
        state_to_observation_func=lambda y: np.clip(np.asarray(y) * 255, 0, 255).astype(
            np.uint8)[None],
        reward_function=lambda y: float(-jnp.var(y)),
        reset_func=lambda domain, seed=0: jnp.asarray(field),
        static_equation_parameters={"mu": lambda c: c**3 - c, "D": lambda c: jnp.ones_like(c),
                                    "derivs": "fd"},
        **common)
    tenv = tp.PDEEnv(
        equation_type=tp.CahnHilliard2DPeriodic,
        domain=tp.Domain((N, N), box, dtype=getattr(torch, np.dtype(dtype).name)),
        solver_type=tp.SemiImplicitFourierSpectral,
        state_to_observation_func=lambda y: torch.clamp(y * 255, 0, 255).to(torch.uint8)[None],
        reward_function=lambda y: float(-torch.var(y, correction=0)),
        reset_func=lambda domain, seed=0: field,
        static_equation_parameters={"mu": lambda c: c**3 - c, "D": torch.ones_like,
                                    "derivs": "fd", "device": "cpu"},
        device="cpu", **common)
    return jenv, tenv


def test_gym_pde_env_api():
    """tests/test_env.py::test_gym_pde_env_api on the port's PDEEnv."""
    L = 0.01 * N
    env = tp.PDEEnv(
        equation_type=tp.CahnHilliard2DPeriodic,
        domain=tp.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2))),
        solver_type=tp.SemiImplicitFourierSpectral,
        end_time=0.03, step_dt=0.01, numeric_dt=0.001,
        state_to_observation_func=lambda y: np.clip(
            y.numpy() * 255, 0, 255).astype(np.uint8)[None],
        reward_function=lambda y: float(-torch.var(y, correction=0)),
        reset_func=lambda domain, seed=0: torch.clamp(
            0.5 + 0.01 * torch.randn(domain.points, generator=torch.Generator().manual_seed(seed)),
            0.0, 1.0),
        reset_control_value=0.002,
        update_control_value=lambda off, old: float(
            np.clip(old + 0.0005 * np.asarray(off)[0], 1e-4, 0.01)),
        update_control_parameter=lambda old, new: new,
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={"mu": lambda c: c**3 - c, "D": torch.ones_like,
                                    "derivs": "fd", "device": "cpu"},
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        device="cpu",
    )
    obs, info = env.reset(seed=0)
    assert obs.shape == (1, N, N) and obs.dtype == np.uint8
    assert env.observation_space.contains(obs)
    done = False
    steps = 0
    while not done:
        obs, reward, done, truncated, info = env.step(env.action_space.sample())
        steps += 1
        assert isinstance(reward, float)
    assert steps == 3  # end_time / step_dt


def test_gym_registration_and_advection_diffusion_env():
    """tests/test_env.py::test_gym_registration_and_advection_diffusion_env
    through ``gym.make`` of the port's id."""
    L = 0.02 * N
    domain = tp.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    env = gym.make(
        "pde_opt_tpu_torch/AdvectionDiffusion-v0",
        reset_func=lambda domain, seed=0: 0.5 * torch.ones(domain.points)
        + 0.01 * torch.randn(domain.points, generator=torch.Generator().manual_seed(seed)),
        diffusion_coefficient=0.1,
        max_control_step=0.1,
        end_time=0.1,
        step_dt=0.05,
        numeric_dt=0.01,
        domain=domain,
        field_dim=1,
        reward_function=lambda x: float(torch.var(x)),
        discrete_action_space=True,
        device="cpu",
    )
    obs, info = env.reset(seed=0)
    assert obs.shape == (1, N, N)
    obs, reward, terminated, truncated, info = env.step(1)
    assert obs.shape == (1, N, N)
    assert np.isfinite(reward)
    obs, reward, terminated, truncated, info = env.step(3)
    assert terminated


def test_each_id_makes_its_own_package_class():
    """With both packages imported, each id resolves to its own package's
    class (the port's ids carry the ``pde_opt_tpu_torch/`` namespace)."""
    assert gym.spec("PDEEnv-v0").entry_point == "pde_opt_tpu.envs.gym_adapter:PDEEnv"
    assert gym.spec("pde_opt_tpu_torch/PDEEnv-v0").entry_point == (
        "pde_opt_tpu_torch.envs.gym_adapter:PDEEnv")
    kw = dict(reset_func=lambda domain, seed=0: np.full(domain.points, 0.5),
              diffusion_coefficient=0.1, max_control_step=0.1, end_time=0.1, step_dt=0.05,
              numeric_dt=0.01)
    jenv = gym.make("AdvectionDiffusion-v0", domain=jp.Domain((N, N), ((0, 1), (0, 1))), **kw)
    tenv = gym.make("pde_opt_tpu_torch/AdvectionDiffusion-v0",
                    domain=tp.Domain((N, N), ((0, 1), (0, 1))), device="cpu", **kw)
    assert type(jenv.unwrapped) is jgym.AdvectionDiffusionEnv
    assert type(tenv.unwrapped) is tgym.AdvectionDiffusionEnv
    assert tp.PDEEnv is tp.envs.PDEEnv is tgym.PDEEnv
    assert tp.AdvectionDiffusionEnv is tgym.AdvectionDiffusionEnv


def test_pde_env_trajectory_matches_jax():
    """One field, one action list: the port's PDEEnv steps as JAX's (f64,
    fft stepper, 1e-12), observations and rewards included."""
    rng = np.random.default_rng(0)
    field = (0.5 + 0.05 * rng.standard_normal((N, N))).astype(np.float64)
    jenv, tenv = _pde_envs(field)
    jo, _ = jenv.reset(seed=0)
    to, _ = tenv.reset(seed=0)
    np.testing.assert_array_equal(to, jo)
    for a in rng.uniform(-1, 1, (3, 1)):
        jo, jr, jdone, *_ = jenv.step(a)
        to, tr, tdone, *_ = tenv.step(a)
        np.testing.assert_allclose(tenv._state.numpy(), np.asarray(jenv._state), rtol=0,
                                   atol=1e-12)
        assert np.abs(to.astype(int) - jo.astype(int)).max() <= 1
        np.testing.assert_allclose(tr, jr, rtol=1e-9)
        assert tdone == jdone and tenv._control_value == jenv._control_value
    assert tdone


def test_advection_diffusion_trajectory_matches_jax():
    """``AdvectionDiffusionEnv`` (RK4, the 2-vector velocity) with discrete
    and continuous actions against JAX's, f64 fields, 1e-12."""
    rng = np.random.default_rng(1)
    xs = (np.arange(N) + 0.5) / N
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    field = 0.5 + 0.3 * np.sin(2 * np.pi * X) * np.cos(4 * np.pi * Y)
    for discrete, actions in ((True, [1, 3, 2]), (False, list(rng.uniform(-1, 1, (3, 2))))):
        kw = dict(reset_func=lambda domain, seed=0: field, diffusion_coefficient=0.05,
                  max_control_step=0.5, end_time=0.15, step_dt=0.05, numeric_dt=0.01,
                  reward_function=lambda x: float(np.var(np.asarray(x))),
                  discrete_action_space=discrete)
        jenv = jgym.AdvectionDiffusionEnv(
            domain=jp.Domain((N, N), ((0, 1), (0, 1)), dtype=jnp.float64), **kw)
        tenv = tgym.AdvectionDiffusionEnv(
            domain=tp.Domain((N, N), ((0, 1), (0, 1)), dtype=torch.float64), device="cpu",
            **{**kw, "reward_function": lambda x: float(torch.var(x, correction=0))})
        jenv.reset(seed=0)
        tenv.reset(seed=0)
        for a in actions:
            jo, jr, jdone, *_ = jenv.step(a)
            to, tr, tdone, *_ = tenv.step(a)
            np.testing.assert_allclose(tenv._state.numpy(), np.asarray(jenv._state), rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(tr, jr, rtol=1e-9)
            np.testing.assert_array_equal(np.asarray(tenv._control_value),
                                          np.asarray(jenv._control_value))
            assert tdone == jdone
        assert tdone
        assert float(np.abs(tenv._state.numpy() - field).max()) > 1e-3


def test_import_without_gymnasium_and_sympy():
    """In a process where gymnasium and sympy cannot be imported: the port
    imports, the CH preset builds and steps on the CPU, and the gym names
    raise an ImportError that names gymnasium."""
    code = textwrap.dedent("""
        import sys
        sys.modules["gymnasium"] = None
        sys.modules["sympy"] = None
        import torch
        import pde_opt_tpu_torch as tp
        assert "gymnasium" not in [m for m in sys.modules if sys.modules[m] is not None]
        env = tp.make_cahn_hilliard_control_env(num_envs=2, grid_size=16, substeps=2,
                                                device="cpu")
        gen = torch.Generator().manual_seed(0)
        state, _ = env.reset(gen)
        state, obs, reward, *_ = env.step(state, env.sample_actions(gen))
        assert bool(torch.isfinite(reward).all())
        for where in (tp, tp.envs):
            try:
                where.PDEEnv
            except ImportError as e:
                assert "gymnasium" in str(e), e
            else:
                raise AssertionError("PDEEnv without gymnasium")
        try:
            import pde_opt_tpu_torch.models.symbolic
        except ImportError:
            pass
        else:
            raise AssertionError("models.symbolic without sympy")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
