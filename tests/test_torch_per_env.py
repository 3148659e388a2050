"""Per-env stepping (``vectorized_control=False``, the JAX env's default)
held against the JAX package's per-env ``VectorPDEEnv`` on the same numpy
state and actions, at 16², 3 steps that end no episode (the two packages'
random streams differ).

Tolerances are test_torch_env.py's for the same stepper: the fused macros
(cas and dft) with f32 matrices and the dense solve with f32 products,
field atol 1e-5; the fft stepper in f64 on both sides, with and without
``derivs="pallas"`` (the fused rhs's plain version and JAX's kernel in
interpret mode), 1e-12; rewards rtol 1e-3, obs within 1 LSB, terminations
exact.  Also: one plain-version call a
macro-step under ``vmap`` (the CPU twin of the card's one launch), no
batching-rule fallback, a gradient through a per-env step equal to the
batched step's, per-env time, the JAX-style per-env reward, and the three
faults repaired with per-env stepping.
"""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_opt_tpu as p
from pde_opt_tpu.envs.presets import make_allen_cahn_control_env as jac
from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env as jch
from pde_opt_tpu.envs.vector_env import EnvState as JState
from pde_opt_tpu.envs.vector_env import VectorPDEEnv as JEnv
from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.presets import make_allen_cahn_control_env as tac
from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env as tch
from pde_opt_tpu_torch.envs.vector_env import EnvState
from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv as TEnv
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy
from pde_opt_tpu_torch.models.advection_diffusion import AdvectionDiffusion2D as TAD
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic as TCH
from pde_opt_tpu_torch.ops import cas_spectral, dft, fused, fused_spectral
from pde_opt_tpu_torch.ops.steppers import RK4 as TRK4
from pde_opt_tpu_torch.ops.steppers import SemiImplicitFourierSpectral as TSIF
from pde_opt_tpu_torch.utils import ptree

torch.set_num_threads(1)

B, N, STEPS = 4, 16, 3
# The CH presets' fields relax to uniform within a step at 16² (every mode
# of that grid is damped by κ(2πk)⁴ ≥ 1e4 at the presets' spacing), and the
# reward -var with them: the CH cases step at 64², the rest at 16².
N_CH = 64

_F32 = (jnp.float32, torch.float32, np.float32)
_F64 = (jnp.float64, torch.float64, np.float64)

# name -> (JAX preset, port preset, preset kwargs, solver parameters on both
# sides (JAX value, port value), dtypes, field atol)
CASES = {
    "ch_fused_cas": (jch, tch, dict(spectral_solve="fused"),
                     {"A": (1.0, 1.0), "mats_dtype": (jnp.float32, torch.float32)}, _F32, 1e-5),
    "ch_fused_dft": (jch, tch, dict(spectral_solve="fused"),
                     {"A": (1.0, 1.0), "mats_dtype": (jnp.float32, torch.float32),
                      "algo": ("dft", "dft")}, _F32, 1e-5),
    "ch_fft": (jch, tch, dict(spectral_solve="fft"), None, _F64, 1e-12),
    "ch_fft_pallas": (jch, tch, dict(spectral_solve="fft", derivs="pallas"), None, _F64, 1e-12),
    "ch_dense": (jch, tch, dict(spectral_solve="dense"), {"dtype": ("f32", "f32")}, _F32, 1e-5),
    "ac_fused_cas": (jac, tac, dict(spectral_solve="fused"),
                     {"A": (1.0, 1.0), "mats_dtype": (jnp.float32, torch.float32)}, _F32, 1e-5),
    "ac_fused_dft": (jac, tac, dict(spectral_solve="fused"),
                     {"A": (1.0, 1.0), "mats_dtype": (jnp.float32, torch.float32),
                      "algo": ("dft", "dft")}, _F32, 1e-5),
}


def _np_state(seed, ndt, ac=False, t=None, n=N):
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, n, n)) if ac
         else 0.5 + 0.05 * rng.standard_normal((B, n, n)))
    # κ in the low part of each preset's control range: the fields keep a
    # variance that f32 resolves, so the reward -var holds to rtol 1e-3.
    cv = rng.uniform(2e-4, 8e-4, B) if ac else rng.uniform(2e-3, 4e-3, B)
    return {"y": y.astype(ndt),
            "t": np.zeros(B, np.float32) if t is None else t.astype(np.float32),
            "control_value": cv.astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}


def _jax_state(arrs):
    n = arrs["y"].shape[0]
    return JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                  control_value=jnp.asarray(arrs["control_value"]),
                  key=jax.random.split(jax.random.PRNGKey(0), n),
                  step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))


def _assert_obs(to, jo):
    d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert d.max() <= 1


def _grid(name):
    return N_CH if name.startswith("ch") else N


def _pair(name, num_envs=B):
    jmake, tmake, kw, solver, (jdt, tdt, _), _ = CASES[name]
    kw = dict(num_envs=num_envs, grid_size=_grid(name), vectorized_control=False, **kw)
    jenv, tenv = jmake(**kw, dtype=jdt), tmake(device="cpu", **kw, dtype=tdt)
    assert jenv.fused_epilogue is None and tenv.fused_epilogue is None
    if solver:
        jenv.solver_parameters = {**jenv.solver_parameters, **{k: v[0] for k, v in solver.items()}}
        tenv.solver_parameters = {**tenv.solver_parameters, **{k: v[1] for k, v in solver.items()}}
    return jenv, tenv


def _compare(jenv, tenv, arrs, actions, atol):
    js, ts = _jax_state(arrs), env_state_from_numpy(arrs, "cpu")
    tenv.reset(torch.Generator().manual_seed(0))          # seeds the auto-reset draws
    moved = 0.0
    for a in actions:
        y0 = np.array(js.y)
        js, jo, jr, jt, jtr, ji = jenv.step(js, jnp.asarray(a))
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            ts, to, tr, tt, ttr, ti = tenv.step(ts, torch.from_numpy(a))
        moved = max(moved, float(np.abs(np.asarray(js.y) - y0).max()))
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=atol)
        _assert_obs(to, jo)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti["diverged"].numpy(), np.asarray(ji["diverged"]))
        for f in ("t", "control_value", "step_count"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    assert not bool(np.asarray(jt).any())
    assert moved > 100 * atol                  # the steps moved the field


@pytest.mark.parametrize("name", sorted(CASES))
def test_per_env_preset_matches_jax(name):
    jenv, tenv = _pair(name)
    arrs = _np_state(1, CASES[name][4][2], ac=name.startswith("ac"), n=_grid(name))
    rng = np.random.default_rng(2)
    actions = [rng.uniform(-1, 1, (B, 1)) for _ in range(STEPS)]
    _compare(jenv, tenv, arrs, actions, CASES[name][5])


def _tenv_like_jax_ch_env(dtype):
    """The port's twin of tests/test_env.py's ``_ch_env`` (per-env: a
    scalar κ an env, a scalar reward an env)."""
    L = 0.01 * N
    return TEnv(
        equation_type=TCH,
        domain=tgrid.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)), dtype=dtype),
        solver_type=TSIF, end_time=0.05, step_dt=0.01, numeric_dt=0.001,
        state_to_observation_func=lambda y: torch.clamp(y * 255, 0, 255).to(
            torch.uint8)[..., None, :, :],
        reward_function=lambda y: -torch.var(y, correction=0),
        reset_func=lambda domain, g, n: torch.clamp(
            0.5 + 0.01 * torch.randn((n, *domain.points), generator=g, dtype=dtype), 0.0, 1.0),
        reset_control_value=0.002,
        update_control_value=lambda off, old: torch.clamp(old + 0.0005 * off[..., 0], 1e-4, 0.01),
        update_control_parameter=lambda old, new: new,
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={"mu": lambda c: c**3 - c, "D": torch.ones_like,
                                    "derivs": "fd", "device": "cpu"},
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        num_envs=B, device="cpu")


def test_jax_ch_env_default_mode_matches():
    """tests/test_env.py's ``_ch_env`` in its default mode (per env) against
    the port's twin, in its default mode: an f64 field (the JAX env's
    auto-reset branch needs the field's dtype to be its reset's under x64)
    on an f32 Domain, as JAX's.  The two packages round the Domain's f32
    wavenumbers from different f64 values, so the fields agree to f32
    symbol rounding, 1e-6."""
    from test_env import _ch_env

    jenv, tenv = _ch_env(num_envs=B), _tenv_like_jax_ch_env(torch.float32)
    assert jenv.vectorized_control is False and tenv.vectorized_control is False
    arrs = _np_state(3, np.float64)
    rng = np.random.default_rng(4)
    _compare(jenv, tenv, arrs, [rng.uniform(-1, 1, (B, 1)) for _ in range(STEPS)], 1e-6)


def _ad_envs(jdt, tdt):
    """A fleet of AdvectionDiffusion-v0's dynamics (RK4, a 2-vector velocity
    control) whose velocity also depends on each env's own time."""
    L = 1.0
    box = ((-L / 2, L / 2), (-L / 2, L / 2))
    common = dict(end_time=1.0, step_dt=0.01, numeric_dt=0.0025,
                  reset_control_value=np.zeros(2, np.float32),
                  action_space_config={"type": "continuous", "shape": (2,)},
                  control_equation_parameter_name="velocity", solver_parameters={},
                  num_envs=B)
    jenv = JEnv(
        equation_type=p.AdvectionDiffusion2D, domain=p.Domain((N, N), box, dtype=jdt),
        solver_type=p.RK4,
        state_to_observation_func=lambda y: jnp.clip(y * 255, 0, 255).astype(
            jnp.uint8)[..., None, :, :],
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: jnp.zeros(domain.points, jdt),
        update_control_value=lambda off, old: old + 0.1 * off,
        update_control_parameter=lambda old, new: (
            lambda t, X, Y: (new[0] * jnp.cos(6.0 * t), new[1] + t)),
        static_equation_parameters={"diffusion_coeff": 0.01}, **common)
    tenv = TEnv(
        equation_type=TAD, domain=tgrid.Domain((N, N), box, dtype=tdt), solver_type=TRK4,
        state_to_observation_func=lambda y: torch.clamp(y * 255, 0, 255).to(
            torch.uint8)[..., None, :, :],
        reward_function=lambda y: -torch.var(y, correction=0),
        reset_func=lambda domain, g, n: torch.zeros((n, *domain.points), dtype=tdt),
        update_control_value=lambda off, old: old + 0.1 * off,
        update_control_parameter=lambda old, new: (
            lambda t, X, Y: (new[0] * torch.cos(6.0 * t), new[1] + t)),
        static_equation_parameters={"diffusion_coeff": 0.01, "device": "cpu"},
        device="cpu", **common)
    return jenv, tenv


def test_per_env_time_matches_jax():
    """Each env steps from its own ``state.t``: staggered start times
    against JAX's per-env fleet (f64 fields), and against the same envs
    started at t = 0, which end elsewhere.  Under x64 JAX forms a substep's
    time ``t0 + i dt`` in f64 (the integer i promotes), the port in the
    state's f32, as JAX does without x64: the velocities differ at f32
    rounding of t, the fields by at most 3e-11, so 1e-9."""
    rng = np.random.default_rng(5)
    xs = (np.arange(N) + 0.5) / N - 0.5
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    y = 0.5 + 0.3 * np.sin(2 * np.pi * X + rng.uniform(0, 6, (B, 1, 1))) * np.cos(2 * np.pi * Y)
    arrs = {"y": y, "t": np.array([0.0, 0.13, 0.27, 0.41], np.float32),
            "control_value": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}
    actions = [rng.uniform(-1, 1, (B, 2)) for _ in range(STEPS)]
    jenv, tenv = _ad_envs(jnp.float64, torch.float64)
    _compare(jenv, tenv, arrs, actions, 1e-9)
    ts = env_state_from_numpy(arrs, "cpu")
    t0 = env_state_from_numpy({**arrs, "t": np.zeros(B, np.float32)}, "cpu")
    for a in actions:
        ts, *_ = tenv.step(ts, torch.from_numpy(a))
        t0, *_ = tenv.step(t0, torch.from_numpy(a))
    gap = (ts.y - t0.y).abs().amax(dim=(-2, -1))
    assert float(gap[0]) == 0.0 and bool((gap[1:] > 1e-3).all())


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("name,plain,per_step", [
    ("ch_fused_cas", (cas_spectral, "ch_cas_macro_plain"), 1),
    ("ch_fused_dft", (fused_spectral, "ch_sif_macro_plain"), 1),
    ("ch_fft_pallas", (fused, "ch_rhs_fd_plain"), 10),
    ("ch_dense", (dft, "_bf16"), 20),
    ("ac_fused_cas", (cas_spectral, "ac_cas_macro_plain"), 1),
    ("ac_fused_dft", (fused_spectral, "ac_sif_macro_plain"), 1),
])
def test_one_plain_call_a_macro_step(monkeypatch, name, plain, per_step):
    """Under vmap the macro (the fused rhs, the dense product) folds the
    vmapped axis into its env axis: one plain-version call a step for the
    whole fleet (10 a step for the fused rhs, two products a substep for
    the bf16 dense solve), as the card launches its kernel once, and no
    batching-rule fallback."""
    _, tenv = _pair(name, num_envs=6)
    if name == "ch_dense":
        tenv.solver_parameters = {**tenv.solver_parameters, "dtype": "bf16_sqrt"}
    calls = {}
    _counting(monkeypatch, *plain, calls)
    gen = torch.Generator().manual_seed(6)
    state, _ = tenv.reset(gen)
    calls.clear()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        for _ in range(2):
            state, *_ = tenv.step(state, tenv.sample_actions(gen))
    assert calls == {plain[1]: 2 * per_step}


@pytest.mark.parametrize("name", ["ch_fused_cas", "ch_fused_dft", "ac_fused_cas", "ch_dense"])
def test_gradient_through_a_per_env_step(name):
    """d(sum of rewards)/d(action scale) through one per-env step equals the
    batched step's: the vmap rule keeps each Function's backward (K3's plain
    twin for the cas CH macro, the oracle VJP for AC and dft, the product's
    transpose for the dense solve)."""
    grads = []
    for vc in (False, True):
        _, tenv = _pair(name)
        tenv.vectorized_control = vc
        if name == "ch_dense":
            tenv.solver_parameters = {**tenv.solver_parameters, "dtype": "bf16_sqrt"}
        arrs = _np_state(7, np.float32, ac=name.startswith("ac"), n=_grid(name))
        state = env_state_from_numpy(arrs, "cpu")
        tenv.reset(torch.Generator().manual_seed(0))
        scale = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        _, _, reward, *_ = tenv.step(state, scale * torch.linspace(-1, 1, B)[:, None])
        (reward.sum() * 1e6).backward()
        grads.append(float(scale.grad))
    assert grads[0] != 0.0
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5)


def test_jax_style_reward_is_per_env():
    """A JAX-style reward (``-torch.var(y)``, one env's field to a scalar)
    gives each env its own reward per env; in the batched mode it would
    reduce the whole fleet, and the step refuses it."""
    per_env = _tenv_like_jax_ch_env(torch.float64)
    arrs = _np_state(8, np.float64)
    state = env_state_from_numpy(arrs, "cpu")
    per_env.reset(torch.Generator().manual_seed(0))
    state, _, reward, *_ = per_env.step(state, torch.zeros(B, 1))
    want = -state.y.var(dim=(-2, -1), correction=0)
    assert reward.shape == (B,) and len(set(reward.tolist())) == B
    torch.testing.assert_close(reward, want, rtol=1e-12, atol=0)


def test_fault_batched_reward_must_be_per_env():
    """Repaired fault: with vectorized_control=True a reward function that
    returns one scalar for the fleet raised nothing and was broadcast to
    every env; the step now raises ValueError."""
    env = _tenv_like_jax_ch_env(torch.float64)
    env.vectorized_control = True
    env.update_control_parameter = lambda old, new: new[..., None, None]
    state = env_state_from_numpy(_np_state(9, np.float64), "cpu")
    env.reset(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="reward_function"):
        env.step(state, torch.zeros(B, 1))


def test_fault_default_mode_is_per_env_as_in_jax():
    """Repaired fault: the port's VectorPDEEnv defaulted to batched
    stepping, JAX's to per-env; the same constructor call now picks the same
    mode, and a fused epilogue still needs the batched one."""
    tdef = inspect.signature(TEnv).parameters["vectorized_control"].default
    jdef = inspect.signature(JEnv).parameters["vectorized_control"].default
    assert tdef is jdef is False
    assert _tenv_like_jax_ch_env(torch.float32).vectorized_control is False
    with pytest.raises(ValueError, match="vectorized_control"):
        TEnv(**{**{k: getattr(_tenv_like_jax_ch_env(torch.float32), k) for k in (
            "equation_type", "domain", "solver_type", "end_time", "step_dt", "numeric_dt",
            "state_to_observation_func", "reward_function", "reset_func",
            "reset_control_value", "update_control_value", "update_control_parameter",
            "action_space_config", "static_equation_parameters",
            "control_equation_parameter_name", "solver_parameters", "device")},
            "fused_epilogue": {"reward_from_stats": lambda *a: 0.0}})


def test_fault_from_numpy_defaults_to_the_card():
    """Repaired fault: ``ptree.from_numpy`` with no device left numpy leaves
    on the CPU; it now puts them on the card, as every entry point does (and
    raises without CUDA)."""
    tree = {"w": np.ones(3, np.float32), "layers": [np.zeros(2)], "lr": 0.1}
    if torch.cuda.is_available():
        out = ptree.from_numpy(tree)
        assert out["w"].is_cuda and out["layers"][0].is_cuda and out["lr"] == 0.1
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ptree.from_numpy(tree)
    out = ptree.from_numpy(tree, device="cpu")
    assert out["w"].device.type == "cpu" and out["w"].dtype == torch.float32


def test_discrete_per_env_offsets_are_looked_up_for_the_fleet():
    """A discrete action's offset comes from the device table for the whole
    fleet before the vmap; per env, the control moves by its own offset."""
    env = _tenv_like_jax_ch_env(torch.float64)
    env.action_type, env.num_actions = "discrete", 3
    env._action_table = torch.tensor([[0.0], [1.0], [-1.0]])
    state = env_state_from_numpy(_np_state(10, np.float64), "cpu")
    cv0 = state.control_value.clone()
    env.reset(torch.Generator().manual_seed(0))
    state, *_ = env.step(state, torch.tensor([0, 1, 2, 1]))
    want = torch.clamp(cv0 + 0.0005 * torch.tensor([0.0, 1.0, -1.0, 1.0]), 1e-4, 0.01)
    torch.testing.assert_close(state.control_value, want.to(torch.float32))


def test_per_env_steps_across_auto_reset():
    """An episode end under per-env stepping: the ended envs restart from
    the generator's fleet draw, at t = 0, as in the batched mode."""
    env = _tenv_like_jax_ch_env(torch.float64)
    env.end_time = 0.02
    gen = torch.Generator().manual_seed(11)
    state, _ = env.reset(gen)
    saved = EnvState(*(t.clone() for t in state))
    for _ in range(2):
        state, obs, reward, term, _, info = env.step(state, torch.zeros(B, 1))
    assert bool(term.all()) and bool((state.t == 0).all()) and int(state.step_count.sum()) == 0
    assert "final_observation" in info and obs.shape == (B, 1, N, N)
    assert not torch.equal(state.y, saved.y)
