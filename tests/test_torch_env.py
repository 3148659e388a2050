"""The port's flagship CH control fleet held against the JAX package.

The same numpy state and actions go into the JAX env and the port's env;
the random streams of the two packages differ, so nothing random is
compared.  Tolerances (fused path, bf16 matrices): field atol 1e-3, obs
<= 1 LSB, reward rtol 1e-3, terminated/diverged exact.

With bf16 matrices each RL step starts both envs from the same field: the
macro rounds the field itself to bf16 before the spectrum it carries, and
the deadbeat high-k response passes a one-ulp rounding flip at one pixel
(2^-9 ~ 2e-3 at u ~ 0.5) straight into the next field, so two f32-different
fields drift apart by whole bf16 ulps at isolated pixels.  Free-running
trajectories are held with f32 matrices (tight) and, on the FFT path, in
float64 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_opt_tpu import grid as jgrid
from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env as jpreset
from pde_opt_tpu.envs.vector_env import EnvState as JState
from pde_opt_tpu.envs.vector_env import VectorPDEEnv as JEnv
from pde_opt_tpu.models.cahn_hilliard import CahnHilliard2DPeriodic as JCH
from pde_opt_tpu.ops.steppers import FusedSemiImplicitSpectral as JFused
from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.presets import CH_MU
from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env as tpreset
from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv as TEnv
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy, env_state_to_numpy
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic as TCH
from pde_opt_tpu_torch.ops.steppers import FusedSemiImplicitSpectral as TFused

torch.set_num_threads(1)

B, H = 16, 64


def _np_state(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {
        # Around the 0.5 operating point, where the env's centered-moment
        # reward is cancellation-free.
        "y": (0.5 + 0.05 * rng.standard_normal((B, H, H))).astype(dtype),
        "t": np.zeros(B, np.float32),
        "control_value": rng.uniform(2e-3, 1e-2, B).astype(np.float32),
        "step_count": np.zeros(B, np.int32),
        "done": np.zeros(B, bool),
    }


def _jax_state(arrs):
    return JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                  control_value=jnp.asarray(arrs["control_value"]),
                  key=jax.random.split(jax.random.PRNGKey(0), B),
                  step_count=jnp.asarray(arrs["step_count"]),
                  done=jnp.asarray(arrs["done"]))


def _assert_obs(to, jo):
    d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert d.max() <= 1


@pytest.mark.parametrize("solve,mats,dtype,resync,atol", [
    ("fused", "bf16", "f32", True, 1e-3),
    ("fused", "f32", "f32", False, 1e-5),
    ("fft", None, "f64", False, 1e-12),
])
def test_env_step_matches_jax(solve, mats, dtype, resync, atol):
    jdt, tdt, ndt = {"f32": (jnp.float32, torch.float32, np.float32),
                     "f64": (jnp.float64, torch.float64, np.float64)}[dtype]
    kw = dict(num_envs=B, grid_size=H, substeps=10, spectral_solve=solve)
    jenv, tenv = jpreset(**kw, dtype=jdt), tpreset(device="cpu", **kw, dtype=tdt)
    assert (jenv.fused_epilogue is None) == (tenv.fused_epilogue is None)
    if mats == "f32":
        jenv.solver_parameters = {"A": 1.0, "mats_dtype": jnp.float32}
        tenv.solver_parameters = {"A": 1.0, "mats_dtype": torch.float32}
    arrs = _np_state(0, ndt)
    js = _jax_state(arrs)
    ts = env_state_from_numpy(arrs, "cpu")
    tenv.reset(torch.Generator().manual_seed(0))      # seeds auto-reset draws
    rng = np.random.default_rng(1)
    for _ in range(5):
        a = rng.uniform(-1, 1, (B, 1))
        js, jo, jr, jt, jtr, ji = jenv.step(js, jnp.asarray(a))
        ts, to, tr, tt, ttr, ti = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=atol)
        _assert_obs(to, jo)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti["diverged"].numpy(), np.asarray(ji["diverged"]))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        for f in ("t", "control_value", "step_count"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
        assert ts.y.dtype == tdt and ts.control_value.dtype == torch.float32
        if resync:
            ts.y.copy_(torch.from_numpy(np.array(js.y)))


def test_env_step_at_128_matches_jax():
    """One step of bench.py's run_ch128 fleet (128², derivs="pallas", the
    fused stepper with its epilogue, bf16 matrices) from the same state, on
    the CPU against the JAX env; the card runs the tiled K1 here."""
    n, N = 4, 128
    kw = dict(num_envs=n, grid_size=N, substeps=10, spectral_solve="fused", derivs="pallas")
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    rng = np.random.default_rng(7)
    arrs = {"y": (0.5 + 0.05 * rng.standard_normal((n, N, N))).astype(np.float32),
            "t": np.zeros(n, np.float32),
            "control_value": rng.uniform(2e-3, 1e-2, n).astype(np.float32),
            "step_count": np.zeros(n, np.int32), "done": np.zeros(n, bool)}
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), n),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    ts = env_state_from_numpy(arrs, "cpu")
    tenv.reset(torch.Generator().manual_seed(0))
    a = rng.uniform(-1, 1, (n, 1))
    js, jo, jr, jt, jtr, ji = jenv.step(js, jnp.asarray(a))
    ts, to, tr, tt, ttr, ti = tenv.step(ts, torch.from_numpy(a))
    assert ts.y.shape == (n, N, N) and to.shape == (n, 1, N, N)
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=1e-3)
    _assert_obs(to, jo)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ti["diverged"].numpy(), np.asarray(ji["diverged"]))
    np.testing.assert_array_equal(ts.control_value.numpy(), np.asarray(js.control_value))


def _direct_envs(reset_field, end_time):
    """The fused-epilogue CH fleet built as ``VectorPDEEnv`` in both
    packages, with the same key-ignoring reset field and f32 matrices (a
    free-running trajectory, see the module docstring)."""
    L = 0.01 * H
    box = ((-L / 2, L / 2), (-L / 2, L / 2))
    ep = {"obs_scale": 255.0, "obs_offset": 0.0, "obs_downsample": 1,
          "stats_center": 0.5,
          "reward_from_stats": lambda s1, s2, cnt, n: -(s2 / n - (s1 / n) ** 2)}
    common = dict(end_time=end_time, step_dt=0.01, numeric_dt=0.001,
                  reset_control_value=0.004,
                  action_space_config={"type": "continuous", "shape": (1,)},
                  control_equation_parameter_name="kappa",
                  num_envs=B, auto_reset=True,
                  vectorized_control=True, fused_epilogue=ep)
    jenv = JEnv(
        equation_type=JCH, domain=jgrid.Domain((H, H), box), solver_type=JFused,
        state_to_observation_func=lambda y: jnp.clip(y * 255.0, 0, 255).astype(
            jnp.uint8)[..., None, :, :],
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: jnp.asarray(reset_field),
        update_control_value=lambda off, old: jnp.clip(old + 0.0005 * off[..., 0], 0.002, 0.01),
        update_control_parameter=lambda old, new: new[..., None, None],
        solver_parameters={"A": 1.0, "mats_dtype": jnp.float32},
        static_equation_parameters={"mu": lambda c: c**3 - c,
                                    "D": lambda c: jnp.ones_like(c), "derivs": "fd"},
        **common)
    tenv = TEnv(
        equation_type=TCH, domain=tgrid.Domain((H, H), box), solver_type=TFused,
        state_to_observation_func=lambda y: torch.clamp(y * 255.0, 0, 255).to(
            torch.uint8)[..., None, :, :],
        reward_function=lambda y: -y.var(dim=(-2, -1), correction=0),
        reset_func=lambda domain, gen, n: torch.from_numpy(reset_field).expand(n, H, H).clone(),
        update_control_value=lambda off, old: torch.clamp(old + 0.0005 * off[..., 0], 0.002, 0.01),
        update_control_parameter=lambda old, new: new[..., None, None],
        solver_parameters={"A": 1.0, "mats_dtype": torch.float32},
        static_equation_parameters={"mu": CH_MU, "D": torch.ones_like, "derivs": "fd"},
        device="cpu", **common)
    return jenv, tenv


def test_rollout_across_auto_reset_matches_jax():
    rng = np.random.default_rng(2)
    field = (0.5 + 0.05 * rng.standard_normal((H, H))).astype(np.float32)
    actions = rng.uniform(-1, 1, (B, 1))
    jenv, tenv = _direct_envs(field, end_time=0.05)
    js, jo = jenv.reset(jax.random.PRNGKey(0))
    ts, to = tenv.reset(torch.Generator().manual_seed(0))
    _assert_obs(to, jo)
    # 8 steps cross the end_time = 0.05 / step_dt = 0.01 episode end.
    js, jrew, jterm = jenv.rollout(js, lambda obs, key: jnp.asarray(actions), 8,
                                   key=jax.random.PRNGKey(3))
    ts, trew, tterm = tenv.rollout(ts, lambda obs, gen: torch.from_numpy(actions), 8)
    assert bool(np.asarray(jterm).any(axis=0).all())          # every env reset
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-3)
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts.step_count.numpy(), np.asarray(js.step_count))
    np.testing.assert_array_equal(ts.control_value.numpy(), np.asarray(js.control_value))


def test_random_reset_statistics():
    env = tpreset(device="cpu", num_envs=64, grid_size=H, spectral_solve="fused")
    state, obs = env.reset(torch.Generator().manual_seed(4))
    y = state.y
    assert y.shape == (64, H, H) and y.dtype == torch.float32
    assert obs.shape == (64, 1, H, H) and obs.dtype == torch.uint8
    assert abs(float(y.mean()) - 0.5) < 1e-3
    assert abs(float(y.std()) - 0.01) < 2e-4
    torch.testing.assert_close(state.control_value, torch.full((64,), 0.004))
    assert not bool(state.done.any()) and int(state.step_count.sum()) == 0


def test_env_state_carried_across():
    jenv = jpreset(num_envs=B, grid_size=16, spectral_solve="fused")
    js, _ = jenv.reset(jax.random.PRNGKey(5))
    ts = env_state_from_numpy(js, "cpu")
    back = env_state_to_numpy(ts)
    for f in ("y", "t", "control_value", "step_count", "done"):
        a = np.asarray(getattr(js, f))
        assert back[f].dtype == a.dtype
        np.testing.assert_array_equal(back[f], a)
    assert ts.step_count.dtype == torch.int32 and ts.done.dtype == torch.bool


def test_poisoned_env_is_flagged_and_reset():
    env = tpreset(device="cpu", num_envs=8, grid_size=16, substeps=5, spectral_solve="fused")
    gen = torch.Generator().manual_seed(6)
    state, _ = env.reset(gen)
    state.y[3] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    assert bool(info["diverged"][3]) and bool(terminated[3])
    assert int(info["diverged"].sum()) == 1
    assert float(reward[3]) == 0.0
    assert bool(torch.isfinite(state.y).all())
    assert int(state.step_count[3]) == 0 and float(state.t[3]) == 0.0


def test_poisoned_env_without_auto_reset_is_scrubbed():
    env = tpreset(device="cpu", num_envs=8, grid_size=16, substeps=5, spectral_solve="fused",
                  auto_reset=False)
    gen = torch.Generator().manual_seed(7)
    state, _ = env.reset(gen)
    state.y[2] = float("inf")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    assert bool(info["diverged"][2]) and bool(terminated[2]) and bool(state.done[2])
    assert bool(torch.isfinite(state.y).all()) and float(state.y[2].abs().max()) == 0.0


def _env_kwargs(env):
    """The constructor arguments a built env keeps as attributes."""
    names = ("equation_type", "domain", "solver_type", "end_time", "step_dt",
             "numeric_dt", "state_to_observation_func", "reward_function",
             "reset_func", "reset_control_value", "update_control_value",
             "update_control_parameter", "action_space_config",
             "static_equation_parameters", "control_equation_parameter_name",
             "solver_parameters", "num_envs", "auto_reset", "vectorized_control",
             "fused_epilogue", "device")
    return {n: getattr(env, n) for n in names}


def test_pooled_obs_and_unported_options():
    env = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=5, spectral_solve="fused",
                  obs_downsample=4)
    gen = torch.Generator().manual_seed(8)
    state, obs0 = env.reset(gen)
    _, obs, *_ = env.step(state, env.sample_actions(gen))
    assert obs0.shape == obs.shape == (4, 1, 4, 4)
    # spectral_solve="dense" is ported: its fleet builds and steps.
    denv = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=5, spectral_solve="dense")
    dstate, _ = denv.reset(gen)
    dstate, _, dr, *_ = denv.step(dstate, denv.sample_actions(gen))
    assert bool(torch.isfinite(dstate.y).all()) and bool(torch.isfinite(dr).all())
    # Per-env stepping (vectorized_control=False) is ported: its fleet
    # builds and steps, and the fused epilogue still needs the batched mode.
    penv = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=5,
                   vectorized_control=False, spectral_solve="fused")
    assert penv.fused_epilogue is None
    pstate, _ = penv.reset(gen)
    pstate, _, pr, *_ = penv.step(pstate, penv.sample_actions(gen))
    assert bool(torch.isfinite(pstate.y).all()) and pr.shape == (4,)
    with pytest.raises(ValueError, match="vectorized_control"):
        tpreset(device="cpu", num_envs=4, grid_size=16, vectorized_control=False,
                spectral_solve="fused", fused_epilogue=True)
    # A discrete space with no mapping: five actions, all a zero offset.
    denv = TEnv(**{**_env_kwargs(env), "action_space_config": {"type": "discrete"}})
    dstate, _ = denv.reset(gen)
    cv0 = dstate.control_value.clone()
    acts = denv.sample_actions(gen)
    assert denv.num_actions == 5 and acts.shape == (4,) and int(acts.max()) < 5
    dstate, *_ = denv.step(dstate, acts)
    assert torch.equal(dstate.control_value, cv0)
    with pytest.raises(ValueError, match="must divide"):
        tpreset(device="cpu", num_envs=4, grid_size=16, obs_downsample=3)


def test_env_step_gradient_reaches_the_action():
    """A pathwise gradient through a fused-epilogue env step with respect to
    the action: a step that autograd records returns a new state and leaves
    the one it read (which the macro saved for its backward) as it was."""
    env = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=2, spectral_solve="fused")
    state, _ = env.reset(torch.Generator().manual_seed(9))
    y0 = state.y.clone()
    scale = torch.tensor(0.5, requires_grad=True)
    state1, _, reward, *_ = env.step(state, scale * torch.ones(4, 1))
    assert state1.y is not state.y and torch.equal(state.y, y0)
    assert state1.y.dtype == y0.dtype and state1.step_count.dtype == torch.int32
    reward.sum().backward()
    assert bool(torch.isfinite(scale.grad)) and float(scale.grad.abs()) > 0.0
    # Without a gradient the step writes in place, as before.
    state2, *_ = env.step(state, torch.zeros(4, 1))
    assert state2.y is state.y


def test_default_device_is_cuda():
    """The entry points build on the card unless the caller asks for the
    CPU; without CUDA, a call that names no device raises rather than
    building on the CPU."""
    from pde_opt_tpu_torch.utils import initialization as tinit

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpreset(num_envs=4, grid_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        env_state_from_numpy({f: np.zeros(2, np.float32) for f in
                              ("y", "t", "control_value", "step_count", "done")})
    with pytest.raises(RuntimeError, match="CUDA"):
        tinit.initialize_Psi(8, 2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinit.step_interface((4, 4))
    env = tpreset(num_envs=4, grid_size=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEnv(**{**_env_kwargs(env), "device": "cuda"})
    # The equation constructors: a float κ (or a numpy ψ) names no device,
    # so they build on the card; a tensor κ or ψ keeps its own device.
    from pde_opt_tpu_torch.envs.presets import AC_MU, AC_R
    from pde_opt_tpu_torch.models import (
        AllenCahn2DPeriodic,
        AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent as SBM,
        GPE2DTSControl,
    )

    td = tgrid.Domain((16, 16), ((0.0, 1.0), (0.0, 1.0)))
    builds = {
        "ch": lambda **d: TCH(td, 0.004, CH_MU, torch.ones_like, **d),
        "ac": lambda **d: AllenCahn2DPeriodic(td, 4e-4, AC_MU, AC_R, **d),
        "gpe": lambda **d: GPE2DTSControl(td, k=1.0, e=0.0,
                                          lights=lambda t, x, y: 0.0 * x, **d),
        "sbm": lambda **d: SBM(td, 5e-4, None, CH_MU, torch.ones_like, 0.5, 1.0,
                               psi=np.ones((16, 16), np.float32), **d),
    }
    for build in builds.values():
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        assert build(device="cpu").device.type == "cpu"
    assert TCH(td, torch.tensor(0.004), CH_MU, torch.ones_like).device.type == "cpu"
