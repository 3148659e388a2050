"""The port's Allen-Cahn fleet (kernel K4's macro, its stepper and preset)
held against the JAX package.

On the CPU the port runs its plain-torch macro; the JAX macro runs its
Pallas kernel in interpret mode.  Same numpy inputs on both sides.
Tolerances, from the measured gaps plus headroom:

    output              f32 matrices     bf16 matrices
    macro u1 vs JAX     atol 1e-5        atol 1e-3
    macro vs oracle     atol 5e-5        (not held: bf16 rounding)
    stats n_finite      exact            exact
    stats s2            rtol 1e-3        rtol 1e-3
    stats s1            1e-3 sqrt(n s2)  1e-3 sqrt(n s2)   (s1 sits near 0)
    obs                 <= 1 LSB         <= 1 LSB
    gradients vs JAX    rtol 1e-3 (the JAX test's bound for fused vs oracle)
    kernel vs plain, 1 substep, bf16: RMS <= 2e-6 (R == 1), 6e-6 (general R)

Tests marked ``cuda`` hold kernel K4 against the plain version on the card
and skip without one; JAX is imported inside the tests that use it, so they
also run where JAX is not installed (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.presets import AC_MU, AC_R
from pde_opt_tpu_torch.envs.presets import make_allen_cahn_control_env as tpreset
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy, env_state_to_numpy
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.cas_spectral import (
    Epilogue,
    PolynomialMu,
    ac_cas_macro_cuda,
    ac_cas_macro_plain,
    cas_constants,
    make_ac_cas_fused_macro as tmake,
    r_is_identity,
)
from pde_opt_tpu_torch.ops.fused_spectral import ac_sif_macro_reference as tref

torch.set_num_threads(1)

MU_T = PolynomialMu((0.0, -1.0, 0.0, 1.0))
R_T = PolynomialMu((1.0, 0.0, 0.5))          # 1 + 0.5 c**2


def MU_J(c):
    return c**3 - c


def R_J(c):
    return 1.0 + 0.5 * c**2


HX, HY = 0.01, 0.02
A, DT = 1.0, 1e-4
TOL_U = {"f32": 1e-5, "bf16": 1e-3}
MATS = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def _jax():
    import jax.numpy as jnp

    from pde_opt_tpu.ops.cas_spectral import make_ac_cas_fused_macro
    from pde_opt_tpu.ops.fused_spectral import ac_sif_macro_reference

    return jnp, make_ac_cas_fused_macro, ac_sif_macro_reference


def _inputs(B, H, seed=0, W=None):
    """AC fields around 0 with kappa across the env's control range."""
    rng = np.random.default_rng(seed)
    u = (0.1 * rng.standard_normal((B, H, H if W is None else W))).astype(np.float32)
    kap = np.linspace(1e-4, 1e-3, B).astype(np.float32)
    return u, kap


def _assert_epilogue(st, so, jt, jo):
    """n_finite exact; s2 to rtol 1e-3; s1 (a sum of signed values around 0,
    so no relative bound holds) to 1e-3 of its natural scale
    ``sqrt(n_px * s2)`` (Cauchy-Schwarz); obs within 1 LSB."""
    jt = np.asarray(jt)
    n_px = so.shape[-1] * so.shape[-2]
    np.testing.assert_array_equal(st[:, 2], jt[:, 2])
    np.testing.assert_allclose(st[:, 1], jt[:, 1], rtol=1e-3)
    assert np.all(np.abs(st[:, 0] - jt[:, 0]) <= 1e-3 * np.sqrt(n_px * jt[:, 1]))
    d = np.abs(so.astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert d.max() <= 1


def test_oracle_matches_jax():
    jnp, _, jref = _jax()
    u, kap = _inputs(6, 16, seed=1)
    j = jref(MU_J, R_J, HX, HY, A, DT, 3)(jnp.asarray(u), jnp.asarray(kap))
    t = tref(MU_T, R_T, HX, HY, A, DT, 3)(torch.from_numpy(u), torch.from_numpy(kap))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("general", [True, False])
def test_macro_matches_fft_reference(general):
    """The cas macro (f32) against the FFT oracle: the spectral Laplacian
    equals the roll-stencil one for periodic fields."""
    B, H = 6, 16
    u, kap = _inputs(B, H, seed=7)
    R = R_T if general else None
    out = tmake(MU_T, R, H, H, HX, HY, A, DT, 3, mats_dtype=torch.float32)(
        torch.from_numpy(u), torch.from_numpy(kap))
    ref = tref(MU_T, R_T if general else torch.ones_like, HX, HY, A, DT, 3)(
        torch.from_numpy(u), torch.from_numpy(kap))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=5e-5)
    assert float((out - torch.from_numpy(u)).abs().max()) > 1e-7


@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("general", [True, False])
@pytest.mark.parametrize("ep", [False, True])
def test_macro_matches_jax(mats, general, ep):
    B, H, n = 6, 16, 5
    u, kap = _inputs(B, H, seed=3 + 2 * general + ep)
    jnp, jmake, _ = _jax()
    jm, tm = getattr(jnp, MATS[mats][0]), MATS[mats][1]
    cfg = {"obs_scale": 127.5, "obs_offset": 127.5} if ep else None
    jout = jmake(MU_J, R_J if general else None, H, H, HX, HY, A, DT, n,
                 mats_dtype=jm, epilogue=cfg)(jnp.asarray(u), jnp.asarray(kap))
    tout = tmake(MU_T, R_T if general else None, H, H, HX, HY, A, DT, n,
                 mats_dtype=tm, epilogue=cfg)(torch.from_numpy(u), torch.from_numpy(kap))
    if not ep:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == (B, H, H) and tout[0].dtype == torch.float32
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0,
                               atol=TOL_U[mats])
    if ep:
        assert tout[2].dtype == torch.uint8 and tout[2].shape == (B, H, H)
        _assert_epilogue(tout[1].numpy(), tout[2].numpy(), jout[1], jout[2])


# Grids above 64², where the card runs the tiled K4: 128² (the AC fleet at
# bench.py's run_ch128 shape) and a non-square grid that is no multiple of
# 64.  f32 matrices throughout (tight: the JAX macro at HIGHEST precision,
# interpret mode), one case in bf16 (the JAX kernel's bf16 gap).
BIG_CASES = [(H, W, "f32", general, ep) for H, W in [(128, 128), (96, 136)]
             for general in (False, True) for ep in (False, True)]
BIG_CASES.append((128, 128, "bf16", False, True))


@pytest.mark.parametrize("H,W,mats,general,ep", BIG_CASES)
def test_macro_above_64_matches_jax(H, W, mats, general, ep):
    """The plain K4 (R == 1 and the polynomial R, epilogue off and on)
    against the JAX macro in interpret mode, 2 envs x 2 substeps."""
    B, n = 2, 2
    u, kap = _inputs(B, H, seed=H + W + 2 * general + ep, W=W)
    jnp, jmake, _ = _jax()
    cfg = {"obs_scale": 127.5, "obs_offset": 127.5} if ep else None
    jout = jmake(MU_J, R_J if general else None, H, W, HX, HY, A, DT, n,
                 mats_dtype=getattr(jnp, MATS[mats][0]), epilogue=cfg, interpret=True)(
        jnp.asarray(u), jnp.asarray(kap))
    tout = tmake(MU_T, R_T if general else None, H, W, HX, HY, A, DT, n,
                 mats_dtype=MATS[mats][1], epilogue=cfg)(torch.from_numpy(u),
                                                         torch.from_numpy(kap))
    if not ep:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == (B, H, W) and tout[0].dtype == torch.float32
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0,
                               atol=TOL_U[mats])
    if ep:
        assert tout[2].dtype == torch.uint8 and tout[2].shape == (B, H, W)
        _assert_epilogue(tout[1].numpy(), tout[2].numpy(), jout[1], jout[2])


def test_macro_pooled_epilogue_matches_jax():
    B, H = 4, 16
    u, kap = _inputs(B, H, seed=12)
    jnp, jmake, _ = _jax()
    cfg = {"obs_scale": 127.5, "obs_offset": 127.5, "obs_downsample": 4}
    _, jst, jobs = jmake(MU_J, None, H, H, HX, HY, A, DT, 3, mats_dtype=jnp.float32,
                         epilogue=cfg)(jnp.asarray(u), jnp.asarray(kap))
    _, tst, tobs = tmake(MU_T, None, H, H, HX, HY, A, DT, 3, mats_dtype=torch.float32,
                         epilogue=cfg)(torch.from_numpy(u), torch.from_numpy(kap))
    assert tobs.shape == (B, 4, 4)
    _assert_epilogue(tst.numpy(), tobs.numpy(), jst, jobs)


@pytest.mark.parametrize("general", [True, False])
def test_macro_grads_match_jax(general):
    """Gradients through the macro (the checkpointed oracle's VJP) against
    ``jax.grad`` of the JAX macro, on a ragged batch."""
    import jax

    B, H = 5, 16
    u, _ = _inputs(B, H, seed=8)
    kap = np.full((B,), 5e-4, np.float32)
    w = np.random.default_rng(9).standard_normal((B, H, H)).astype(np.float32)
    jnp, jmake, _ = _jax()
    jm = jmake(MU_J, R_J if general else (lambda c: jnp.ones_like(c)), H, H, 0.01, 0.01,
               A, DT, 2, mats_dtype=jnp.float32)
    gu_j, gk_j = jax.grad(lambda uu, kk: jnp.sum(jnp.asarray(w) * jm(uu, kk) ** 2),
                          argnums=(0, 1))(jnp.asarray(u), jnp.asarray(kap))
    tm = tmake(MU_T, R_T if general else AC_R, H, H, 0.01, 0.01, A, DT, 2,
               mats_dtype=torch.float32)
    ut, kt = torch.from_numpy(u).requires_grad_(), torch.from_numpy(kap).requires_grad_()
    (torch.from_numpy(w) * tm(ut, kt) ** 2).sum().backward()
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_j), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu_j), rtol=1e-3,
                               atol=1e-3 * float(np.abs(np.asarray(gu_j)).max()))


def test_r_none_identity_path():
    """``R_fn=None``, ``ones_like`` and the preset's ``PolynomialMu((1,))``
    all take the identity path, bit for bit, and match the oracle."""
    B, H = 4, 16
    u, _ = _inputs(B, H, seed=9)
    kap = torch.linspace(2e-4, 8e-4, B)
    args = (H, H, 0.01, 0.01, A, DT, 3)
    outs = [tmake(MU_T, R, *args, mats_dtype=torch.float32)(torch.from_numpy(u), kap)
            for R in (None, torch.ones_like, AC_R)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    ref = tref(MU_T, torch.ones_like, 0.01, 0.01, A, DT, 3)(torch.from_numpy(u), kap)
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), rtol=0, atol=5e-5)


def _jax_verdict(monkeypatch, R_fn):
    """The JAX macro's identity verdict for ``R_fn``: the result of its one
    ``np.array_equal`` probe (None: identity; no call: the probe raised)."""
    jnp, jmake, _ = _jax()
    if R_fn is None:
        return True
    seen = []
    real = np.array_equal

    def record(a, b):
        seen.append(real(a, b))
        return seen[-1]

    monkeypatch.setattr(np, "array_equal", record)
    jmake(MU_J, R_fn, 16, 16, 0.01, 0.01, A, DT, 1)
    monkeypatch.setattr(np, "array_equal", real)
    return seen[-1] if seen else False


def test_identity_probe_verdicts_match_jax(monkeypatch):
    import jax.numpy as jnp

    def boom(c):
        raise RuntimeError("not evaluable")

    cases = [   # (torch R, JAX R)
        (None, None),
        (torch.ones_like, jnp.ones_like),
        (AC_R, lambda c: 1.0 + 0.0 * c),
        (R_T, R_J),
        # 1 on the whole probe range [-64, 64]: treated as identity by both.
        (lambda c: torch.where(c.abs() <= 64, 1.0, 2.0),
         lambda c: jnp.where(jnp.abs(c) <= 64, 1.0, 2.0)),
        # 1 only on the physical band: caught by the geometric probe points.
        (lambda c: torch.where(c.abs() <= 3, 1.0, 2.0),
         lambda c: jnp.where(jnp.abs(c) <= 3, 1.0, 2.0)),
        (lambda c: 1.0, lambda c: 1.0),              # a scalar is not a field
        (boom, boom),
    ]
    verdicts = [(r_is_identity(rt), _jax_verdict(monkeypatch, rj)) for rt, rj in cases]
    assert verdicts == [(v, v) for v in (True, True, True, False, True, False, False, False)]


def test_stepper_through_evolve_matches_jax():
    import jax.numpy as jnp

    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.allen_cahn import AllenCahn2DPeriodic as JAC
    from pde_opt_tpu.ops.integrate import evolve as jevolve
    from pde_opt_tpu.ops.steppers import FusedAllenCahnSpectral as JFused
    from pde_opt_tpu.utils.compat import prepare_solver_params as jprep
    from pde_opt_tpu_torch.models.allen_cahn import AllenCahn2DPeriodic
    from pde_opt_tpu_torch.ops.integrate import evolve
    from pde_opt_tpu_torch.ops.steppers import FusedAllenCahnSpectral
    from pde_opt_tpu_torch.utils.compat import (
        check_equation_solver_compatibility,
        prepare_solver_params,
    )

    box = ((0.0, 0.16), (0.0, 0.16))
    check_equation_solver_compatibility(FusedAllenCahnSpectral, AllenCahn2DPeriodic)
    u0, _ = _inputs(4, 16, seed=4)
    eq = AllenCahn2DPeriodic(tgrid.Domain((16, 16), box), kappa=torch.full((4, 1, 1), 1e-4),
                             mu=AC_MU, R=AC_R)
    st = FusedAllenCahnSpectral(**prepare_solver_params(
        FusedAllenCahnSpectral, {"A": 1.0, "mats_dtype": torch.float32}, eq))
    u1 = evolve(st, eq.rhs, torch.from_numpy(u0), 0.0, 1e-4, 3)
    jeq = JAC(JDomain((16, 16), box), kappa=jnp.full((4, 1, 1), 1e-4), mu=MU_J,
              R=lambda c: jnp.ones_like(c))
    jst = JFused(**jprep(JFused, {"A": 1.0, "mats_dtype": jnp.float32}, jeq))
    ju1 = jevolve(jst, jeq.rhs, jnp.asarray(u0), 0.0, 1e-4, 3)
    assert u1.shape == (4, 16, 16) and bool(torch.isfinite(u1).all())
    assert float((u1 - torch.from_numpy(u0)).abs().max()) > 1e-8
    np.testing.assert_allclose(u1.numpy(), np.asarray(ju1), rtol=0, atol=1e-5)
    # algo="dft": the packed-DFT macro (kernel K9b's plain version) against
    # JAX's, from the same equations.
    st = FusedAllenCahnSpectral(**prepare_solver_params(
        FusedAllenCahnSpectral, {"A": 1.0, "mats_dtype": torch.float32, "algo": "dft"}, eq))
    jst = JFused(**jprep(JFused, {"A": 1.0, "mats_dtype": jnp.float32, "algo": "dft"}, jeq))
    u1 = evolve(st, eq.rhs, torch.from_numpy(u0), 0.0, 1e-4, 3)
    ju1 = jevolve(jst, jeq.rhs, jnp.asarray(u0), 0.0, 1e-4, 3)
    assert float((u1 - torch.from_numpy(u0)).abs().max()) > 1e-8
    np.testing.assert_allclose(u1.numpy(), np.asarray(ju1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("derivs", ["fd", "fourier"])
def test_model_rhs_matches_jax(derivs):
    import jax.numpy as jnp

    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.allen_cahn import AllenCahn2DPeriodic as JAC
    from pde_opt_tpu_torch.models.allen_cahn import AllenCahn2DPeriodic

    box = ((-0.08, 0.08), (-0.08, 0.08))
    u, kap = _inputs(3, 16, seed=13)
    jeq = JAC(JDomain((16, 16), box, dtype=jnp.float64), kappa=jnp.asarray(kap[:, None, None], jnp.float64),
              mu=MU_J, R=R_J, derivs=derivs)
    teq = AllenCahn2DPeriodic(tgrid.Domain((16, 16), box, dtype=torch.float64),
                              kappa=torch.from_numpy(kap[:, None, None]).double(),
                              mu=MU_T, R=R_T, derivs=derivs)
    ud = u.astype(np.float64)
    np.testing.assert_allclose(teq.rhs(torch.from_numpy(ud), 0.0).numpy(),
                               np.asarray(jeq.rhs(jnp.asarray(ud), 0.0)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(teq.fourier_symbol.numpy(), np.asarray(jeq.fourier_symbol),
                               rtol=1e-12)


def _np_state(B, H, seed):
    rng = np.random.default_rng(seed)
    return {"y": (0.1 * rng.standard_normal((B, H, H))).astype(np.float32),
            "t": np.zeros(B, np.float32),
            "control_value": rng.uniform(1e-4, 1e-3, B).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}


@pytest.mark.parametrize("solve,atol", [("fused", 1e-3), ("fft", 1e-5)])
def test_env_step_matches_jax(solve, atol):
    """Same numpy state and actions through both packages' AC fleets; the
    bf16 fused path restarts both from the JAX field every step (see
    ``test_torch_env.py``)."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs.presets import make_allen_cahn_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState

    B, H = 8, 16
    kw = dict(num_envs=B, grid_size=H, substeps=5, spectral_solve=solve)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    assert (jenv.fused_epilogue is None) == (tenv.fused_epilogue is None)
    arrs = _np_state(B, H, 0)
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), B),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    ts = env_state_from_numpy(arrs, "cpu")
    tenv.reset(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for _ in range(3):
        a = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
        js, jo, jr, jt, _, ji = jenv.step(js, jnp.asarray(a))
        ts, to, tr, tt, _, ti = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=atol)
        d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
        assert to.shape == (B, 1, H, H) and d.max() <= 1
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti["diverged"].numpy(), np.asarray(ji["diverged"]))
        np.testing.assert_array_equal(ts.control_value.numpy(), np.asarray(js.control_value))
        ts.y.copy_(torch.from_numpy(np.array(js.y)))


def test_env_step_at_128_matches_jax():
    """One step of the preset at grid_size=128 (the fused bf16 macro, as
    users call it; the tiled K4's grid on the card), 2 envs x 10 substeps,
    from the same numpy state and actions as the JAX preset: field within
    the bf16 bound 1e-3, obs within 1 LSB, reward to rtol 1e-3."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs.presets import make_allen_cahn_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState

    B, H = 2, 128
    kw = dict(num_envs=B, grid_size=H)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    arrs = _np_state(B, H, 8)
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), B),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    ts = env_state_from_numpy(arrs, "cpu")
    tenv.reset(torch.Generator().manual_seed(0))
    a = np.random.default_rng(9).uniform(-1, 1, (B, 1)).astype(np.float32)
    js, jo, jr, jt, _, _ = jenv.step(js, jnp.asarray(a))
    ts, to, tr, tt, _, _ = tenv.step(ts, torch.from_numpy(a))
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=TOL_U["bf16"])
    d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert to.shape == (B, 1, H, H) and d.max() <= 1
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_env_state_round_trip():
    """The JAX AC state, (B, H, W) field and (B,) kappa, through
    ``env_state_from_numpy`` and back."""
    import jax

    from pde_opt_tpu.envs.presets import make_allen_cahn_control_env as jpreset

    js, _ = jpreset(num_envs=6, grid_size=16, substeps=2).reset(jax.random.PRNGKey(5))
    ts = env_state_from_numpy(js, "cpu")
    assert ts.y.shape == (6, 16, 16) and ts.control_value.shape == (6,)
    back = env_state_to_numpy(ts)
    for f in ("y", "t", "control_value", "step_count", "done"):
        a = np.asarray(getattr(js, f))
        assert back[f].dtype == a.dtype
        np.testing.assert_array_equal(back[f], a)


def test_env_step_finite_and_moves():
    env = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=2)
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (4, 1, 16, 16) and obs.dtype == torch.uint8
    y0 = state.y.clone()
    assert abs(float(y0.std()) - 0.1) < 0.02
    torch.testing.assert_close(state.control_value, torch.full((4,), 4e-4))
    state2, obs2, reward, term, trunc, info = env.step(state, torch.zeros(4, 1))
    assert bool(torch.isfinite(state2.y).all())
    assert reward.shape == (4,)
    assert float((state2.y - y0).abs().max()) > 0.0
    assert not bool(info["diverged"].any())


def test_env_fft_solver_variant():
    env = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=2, spectral_solve="fft")
    assert env.fused_epilogue is None
    state, _ = env.reset(torch.Generator().manual_seed(1))
    state2, *_ = env.step(state, torch.zeros(4, 1))
    assert bool(torch.isfinite(state2.y).all())
    with pytest.raises(ValueError, match="unknown spectral_solve"):
        tpreset(device="cpu", num_envs=4, grid_size=16, spectral_solve="dense")


def test_env_step_parity_epilogue_vs_plain():
    """The fused-epilogue fleet against the same fleet without it: fields
    bitwise, obs within 1 LSB (``u*127.5 + 127.5`` and ``(u+1)*127.5``
    round differently), terminated exact, reward to f32 rounding."""
    kw = dict(num_envs=16, grid_size=16, substeps=5, spectral_solve="fused")
    env_e = tpreset(device="cpu", **kw, fused_epilogue=True)
    env_0 = tpreset(device="cpu", **kw, fused_epilogue=False)
    se, oe = env_e.reset(torch.Generator().manual_seed(11))
    s0, o0 = env_0.reset(torch.Generator().manual_seed(11))
    assert torch.equal(oe, o0)
    gen = torch.Generator().manual_seed(300)
    for _ in range(4):
        a = env_e.sample_actions(gen)
        se, oe, re, te, _, _ = env_e.step(se, a)
        s0, o0, r0, t0, _, _ = env_0.step(s0, a)
        assert torch.equal(se.y, s0.y)
        assert int((oe.int() - o0.int()).abs().max()) <= 1
        assert torch.equal(te, t0)
        assert float(((re - r0).abs() / (r0.abs() + 1e-12)).max()) < 1e-5


def test_epilogue_gradients_match_plain():
    B, H = 8, 16
    u, kap = _inputs(B, H, seed=12)
    u, kap = torch.from_numpy(u), torch.from_numpy(kap)
    args = (MU_T, None, H, H, 0.01, 0.01, 1.0, 1e-4, 4)
    m0 = tmake(*args, mats_dtype=torch.float32)
    mep = tmake(*args, mats_dtype=torch.float32,
                epilogue={"obs_scale": 127.5, "obs_offset": 127.5})
    u1 = m0(u, kap)
    u1e, stats, obs = mep(u, kap)
    assert torch.equal(u1, u1e)
    assert torch.equal(obs, torch.clamp((u1 + 1.0) * 127.5, 0, 255).to(torch.uint8))

    def grad(loss):
        k = kap.clone().requires_grad_()
        loss(k).backward()
        return k.grad

    g1 = grad(lambda k: (lambda y, s, _: (y**2).sum() + 1.5 * s[:, 0].sum()
                         + 0.5 * s[:, 1].sum())(*mep(u, k)))
    g2 = grad(lambda k: (lambda y: (y**2).sum() + 1.5 * y.sum() + 0.5 * (y**2).sum())(m0(u, k)))
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-12)


def test_env_step_gradient_reaches_the_action():
    env = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=2)
    state, _ = env.reset(torch.Generator().manual_seed(9))
    scale = torch.tensor(0.5, requires_grad=True)
    _, _, reward, *_ = env.step(state, scale * torch.ones(4, 1))
    reward.sum().backward()
    assert bool(torch.isfinite(scale.grad)) and float(scale.grad.abs()) > 0.0


def test_poisoned_env_is_flagged_and_reset():
    env = tpreset(device="cpu", num_envs=8, grid_size=16, substeps=5)
    gen = torch.Generator().manual_seed(6)
    state, _ = env.reset(gen)
    state.y[3] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    assert bool(info["diverged"][3]) and int(info["diverged"].sum()) == 1
    assert bool(terminated[3]) and float(reward[3]) == 0.0
    assert bool(torch.isfinite(state.y).all()) and int(state.step_count[3]) == 0


def _cpu_args(R=None):
    u, kap = _inputs(2, 16, seed=1)
    consts = cas_constants(16, 16, HX, HY, torch.float32, torch.device("cpu"))
    kw = dict(mu_fn=MU_T, R_fn=R, r_identity=r_is_identity(R), dt=DT, A=A, n_steps=2,
              round_bf16=False)
    return torch.from_numpy(u), torch.from_numpy(kap), consts, kw


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    u, kap, consts, kw = _cpu_args()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ac_cas_macro_cuda(u, kap, consts, **kw)
    with pytest.raises(ValueError, match="PolynomialMu"):
        ac_cas_macro_cuda(u, kap, consts, **{**kw, "mu_fn": MU_J})
    with pytest.raises(ValueError, match="non-identity R"):
        ac_cas_macro_cuda(u, kap, consts, **{**kw, "R_fn": R_J, "r_identity": False})
    # The plain path and its gradient launch nothing.
    ac_cas_macro_plain(u, kap, consts, **kw)
    ut, kt = u.clone().requires_grad_(), kap.clone().requires_grad_()
    tmake(MU_T, R_T, 16, 16, HX, HY, A, DT, 2)(ut, kt).sum().backward()
    assert ut.grad is not None and kt.grad is not None
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="multiples of 8"):
        tmake(MU_T, None, 12, 16, HX, HY, A, DT, 2)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(16, 16), (64, 64), (24, 40), (8, 8), (128, 128),
                                 (96, 136)])
@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("ds", [0, 1, 4])
def test_kernel_matches_plain_on_card(cuda_device, H, W, mats, general, ds):
    B = 300
    u, _ = _inputs(B, H, seed=H, W=W)
    u = torch.from_numpy(u).to(cuda_device)
    kap = torch.linspace(1e-4, 1e-3, B, device=cuda_device)
    tm = MATS[mats][1]
    consts = cas_constants(H, W, 0.01, 0.01, tm, cuda_device)
    R = R_T if general else AC_R
    ep = Epilogue(127.5, 127.5, 0.0, ds) if ds else None
    kw = dict(mu_fn=MU_T, R_fn=R, r_identity=r_is_identity(R), dt=1e-3, A=A,
              n_steps=10, round_bf16=tm == torch.bfloat16, epilogue=ep)
    name = "ac_cas_macro_ep" if ep else "ac_cas_macro"
    before = kernels.launch_counts()[name]
    got = ac_cas_macro_cuda(u, kap, consts, **kw)
    want = ac_cas_macro_plain(u, kap, consts, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_U[mats])
    if ep is not None:
        _assert_epilogue(got[1].cpu().numpy(), got[2].cpu().numpy(),
                         want[1].cpu().numpy(), want[2].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_nan_env_leaves_later_envs_alone_on_card(cuda_device, mats):
    """NaN in two envs of a batch larger than the resident blocks: each block
    walks on to later envs (grid stride), which must all equal plain; the
    poisoned envs are NaN where plain's are and their epilogue flags them."""
    B, H, W = 1000, 24, 40
    u, _ = _inputs(B, H, seed=11, W=W)
    u = torch.from_numpy(u).to(cuda_device)
    u[0, 5, 9] = float("nan")
    u[7] = float("nan")
    kap = torch.linspace(1e-4, 1e-3, B, device=cuda_device)
    consts = cas_constants(H, W, 0.01, 0.01, MATS[mats][1], cuda_device)
    kw = dict(mu_fn=MU_T, R_fn=R_T, r_identity=False, dt=1e-3, A=A, n_steps=10,
              round_bf16=mats == "bf16", epilogue=Epilogue(127.5, 127.5, 0.0, 1))
    got = ac_cas_macro_cuda(u, kap, consts, **kw)
    want = ac_cas_macro_plain(u, kap, consts, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    keep = torch.ones(B, dtype=torch.bool, device=cuda_device)
    keep[[0, 7]] = False
    assert not bool(torch.isnan(got[0][keep]).any())
    torch.testing.assert_close(got[0][keep], want[0][keep], rtol=0, atol=TOL_U[mats])
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][7, 2]) == 0.0


def _rms(d):
    return float(d.double().pow(2).mean().sqrt())


# After 10 substeps a K4 that rounds in the wrong places, or not at all,
# sits about as far from the plain version as a correct one; after ONE
# substep it does not.  Bounds on the RMS of kernel - plain over the fleet
# (R == 1, general R), below the same RMS of the unrounded plain version.
TOL_SITE = {False: 2e-6, True: 6e-6}


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
def test_kernel_rounds_where_plain_rounds_on_card(cuda_device, general):
    B, H = 300, 64
    u, _ = _inputs(B, H, seed=7)
    u = torch.from_numpy(u).to(cuda_device)
    kap = torch.linspace(1e-4, 1e-3, B, device=cuda_device)
    consts = cas_constants(H, H, 0.01, 0.01, torch.bfloat16, cuda_device)
    R = R_T if general else AC_R
    kw = dict(mu_fn=MU_T, R_fn=R, r_identity=r_is_identity(R), dt=1e-3, A=A, n_steps=1)
    want = ac_cas_macro_plain(u, kap, consts, round_bf16=True, **kw)
    got = _rms(ac_cas_macro_cuda(u, kap, consts, round_bf16=True, **kw) - want)
    control = _rms(ac_cas_macro_plain(u, kap, consts, round_bf16=False, **kw) - want)
    assert got <= TOL_SITE[general] < control, (got, control)


@pytest.mark.cuda
def test_fused_env_on_card_matches_cpu(cuda_device):
    """The AC env step on the card (kernel K4) against the same step on the
    CPU (plain version), from the same state, at the bf16 tolerances."""
    B, H = 64, 64
    envs = {d: tpreset(num_envs=B, grid_size=H, device=d) for d in ("cpu", cuda_device)}
    for d, env in envs.items():
        env.reset(torch.Generator(device=d).manual_seed(0))
    arrs = _np_state(B, H, 3)
    rng = np.random.default_rng(4)
    for _ in range(3):
        a = torch.from_numpy(rng.uniform(-1, 1, (B, 1)).astype(np.float32))
        out = {d: env.step(env_state_from_numpy(arrs, d), a.to(d)) for d, env in envs.items()}
        (sc, oc, rc, tc, _, _), (sg, og, rg, tg, _, _) = out["cpu"], out[cuda_device]
        np.testing.assert_allclose(sg.y.cpu().numpy(), sc.y.numpy(), rtol=0, atol=TOL_U["bf16"])
        assert int((og.cpu().int() - oc.int()).abs().max()) <= 1
        np.testing.assert_allclose(rg.cpu().numpy(), rc.numpy(), rtol=1e-3)
        assert torch.equal(tg.cpu(), tc)
        arrs = env_state_to_numpy(sc)
