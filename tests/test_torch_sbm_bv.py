"""The port's smoothed-boundary Butler-Volmer charging fleet (kernel K7's
macro, the SBM equation class, the fused stepper and the preset) held
against the JAX package.

On the CPU the port runs its plain-torch macro; the JAX macro runs its
Pallas kernel in interpret mode.  Same numpy inputs on both sides.
Tolerances, from the measured gaps plus headroom (my CPU runs: plain vs
JAX macro 3.7e-8, vs the roll-stencil oracle 1.5e-8, 5 envs x 16^2):

    equation rhs, voltage vs JAX (f64)        atol 1e-12
    golden sbm_bv_cc_rk4.npz (f64)            atol 1e-12 (the JAX test's)
    batch vs one env at a time (f64)          atol 1e-12 (the JAX test's)
    ψ ≡ 1 vs the periodic class (f64)         rhs 1e-11, voltage 1e-12
    macro u1 vs JAX (f32 throughout)          atol 1e-6 (f32 rounding)
    macro vs sbm_bv_reference                 atol 2e-5 (the JAX test's bound)
    stats                                     n_finite exact, s1/s2 rtol 1e-5
    obs                                       <= 1 LSB
    charging rate vs Crate / area             rtol 2e-2 (the JAX test's)
    gradients vs jax.grad of the oracle       u atol 2e-5, crate rtol 1e-5
                                              (the JAX test's)
    preset ψ vs the JAX preset's              atol 1e-6 (f32 tanh)
    kernel vs plain on the card               atol 1e-5

Tests marked ``cuda`` hold kernel K7 against the plain version on the card
and skip without one; JAX is imported inside the tests that use it.
"""

import os

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU
from pde_opt_tpu_torch.envs.presets import make_sbm_butler_volmer_control_env as tpreset
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy
from pde_opt_tpu_torch.models.allen_cahn import (
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent as TSBM,
)
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.bv_cas import bv_cc_reference
from pde_opt_tpu_torch.ops.integrate import evolve
from pde_opt_tpu_torch.ops.sbm_bv import (
    SbmEpilogue,
    make_sbm_bv_fused_macro as tmake,
    sbm_bv_constants,
    sbm_bv_macro_cuda,
    sbm_bv_macro_plain,
    sbm_bv_reference as tref,
)
from pde_opt_tpu_torch.ops.steppers import RK4, FusedSBMButlerVolmer

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "sbm_bv_cc_rk4.npz")
KAPPA, DT = 5e-4, 5e-4
EP_CFG = {"obs_scale": 255.0, "stats_center": 0.5}


def _jax_coeffs():
    import jax.numpy as jnp

    def clip(c):
        return jnp.clip(c, 1e-4, 1 - 1e-4)

    def mu(c):
        return jnp.log(clip(c) / (1 - clip(c))) + 3.0 * (1.0 - 2.0 * c)

    def j0(c):
        return jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None))

    return jnp, mu, j0


def F(c):
    return 3.0 * c * (1.0 - c)


def _psi(N, width=0.06, W=None):
    """The JAX tests' disk level set (on an N x W grid with ``W``)."""
    x = (np.arange(N) + 0.5) / N - 0.5
    y = x if W is None else (np.arange(W) + 0.5) / W - 0.5
    X, Y = np.meshgrid(x, y, indexing="ij")
    psi = 0.5 * (1.0 + np.tanh((0.35 - np.sqrt(X**2 + Y**2)) / width))
    psi = np.where(psi < 0.001, 0.001, psi)
    return np.where(psi > 0.99, 1.0, psi).astype(np.float32)


def _inputs(B=5, N=16, seed=0, W=None):
    rng = np.random.default_rng(seed)
    shape = (B, N, N if W is None else W)
    u = np.clip(0.1 + 0.01 * rng.standard_normal(shape), 0.01, 0.99).astype(np.float32)
    return u, np.linspace(0.5, 2.0, B).astype(np.float32), _psi(N, W=W)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---- the equation ------------------------------------------------------------

def _golden_equations(g, crate=None):
    import jax.numpy as jnp

    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.allen_cahn import (
        AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent as JSBM,
    )

    _, jmu, jj0 = _jax_coeffs()
    N = int(g["N"])
    box = ((-0.5, 0.5), (-0.5, 0.5))
    C = float(g["Crate"]) if crate is None else crate
    teq = TSBM(tgrid.Domain((N, N), box, dtype=torch.float64), kappa=float(g["kappa"]), f=F,
               mu=BV_MU, j0=BV_J0, alpha=float(g["alpha"]),
               Crate=C if crate is None else torch.from_numpy(C),
               psi=torch.from_numpy(g["psi"]))
    jeq = JSBM(JDomain((N, N), box, dtype=jnp.float64), kappa=float(g["kappa"]), f=F, mu=jmu,
               j0=jj0, alpha=float(g["alpha"]), Crate=C if crate is None else jnp.asarray(C),
               psi=jnp.asarray(g["psi"]))
    return teq, jeq


@pytest.mark.parametrize("crate", ["scalar", "per_env"])
def test_rhs_voltage_and_fields_match_jax(crate):
    import jax.numpy as jnp

    g = np.load(GOLDEN)
    rng = np.random.default_rng(4)
    u = np.clip(0.1 + 0.02 * rng.standard_normal((3, 48, 48)), 0.01, 0.99)
    teq, jeq = _golden_equations(g, None if crate == "scalar"
                                 else np.array([0.5, 1.0, 2.0])[:, None, None])
    np.testing.assert_allclose(teq.rhs(torch.from_numpy(u), 0.0).numpy(),
                               np.asarray(jeq.rhs(jnp.asarray(u), 0.0)), rtol=0, atol=1e-12)
    v = teq.get_voltage(torch.from_numpy(u))
    assert v.shape == (3,)
    np.testing.assert_allclose(v.numpy(), np.asarray(jeq.get_voltage(jnp.asarray(u))),
                               rtol=0, atol=1e-12)
    for name in ("psi_avgx", "psi_avgy", "norm_grad_psi", "left_half"):
        np.testing.assert_allclose(getattr(teq, name).numpy(), np.asarray(getattr(jeq, name)),
                                   rtol=0, atol=1e-12)


def test_golden_field_and_voltage_parity():
    """RK4 through ``evolve`` at f64 against the numpy golden, field and
    ψ-weighted voltage at every save point (tests/test_sbm_bv.py's gate)."""
    g = np.load(GOLDEN)
    eq, _ = _golden_equations(g)
    dt, save = float(g["dt"]), int(g["save_every"])
    u = torch.from_numpy(g["u0"])
    for i in range(1, g["traj"].shape[0]):
        u = evolve(RK4(), eq.rhs, u, (i - 1) * save * dt, dt, save)
        np.testing.assert_allclose(u.numpy(), g["traj"][i], rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(eq.get_voltage(u)), float(g["volts"][i]), rtol=0,
                                   atol=1e-12)


def test_batch_transparency():
    """A stacked batch evolves as each instance alone: the ψ-weighted
    integrals stay per env."""
    g = np.load(GOLDEN)
    eq, _ = _golden_equations(g)
    rng = np.random.default_rng(11)
    u = torch.from_numpy(np.clip(0.1 + 0.02 * rng.standard_normal((3, 48, 48)), 0.01, 0.99))
    dt = float(g["dt"])
    out = evolve(RK4(), eq.rhs, u, 0.0, dt, 5)
    for i in range(3):
        one = evolve(RK4(), eq.rhs, u[i], 0.0, dt, 5)
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), rtol=0, atol=1e-12)
    assert eq.get_voltage(u).shape == (3,)


def test_sbm_bv_psi_one_reduces_to_periodic():
    """ψ ≡ 1 collapses the SBM flux form to the periodic Laplacian and the
    ψ-weighted constraint to the plain one (the analytic-oracle test); the
    fused SBM macro then agrees with the periodic BV oracle."""
    N, kappa, crate = 24, 2e-3, 0.7
    domain = tgrid.Domain((N, N), ((0.0, 1.0), (0.0, 1.0)), dtype=torch.float64)
    periodic = AllenCahn2DPeriodicButlerVolmerConstantCurrent(domain, kappa, BV_MU, BV_J0,
                                                              alpha=0.5, Crate=crate)
    sbm = TSBM(domain, kappa, f=lambda c: 0.0, mu=BV_MU, j0=BV_J0, alpha=0.5, Crate=crate,
               psi=torch.ones((N, N), dtype=torch.float64))
    rng = np.random.default_rng(7)
    u = torch.from_numpy(np.clip(0.3 + 0.05 * rng.standard_normal((N, N)), 0.05, 0.95))
    np.testing.assert_allclose(sbm.rhs_fd(u, 0.0).numpy(), periodic.rhs_fd(u, 0.0).numpy(),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(float(sbm.get_voltage(u)), float(periodic.get_voltage(u)),
                               rtol=0, atol=1e-12)
    u32, cr = _t(*_inputs(3, 16, seed=8)[:2])
    got = tmake(BV_MU, BV_J0, KAPPA, np.ones((16, 16), np.float32), 1 / 16, 1 / 16, DT, 4)(
        u32, cr)
    want = bv_cc_reference(BV_MU, BV_J0, KAPPA, 1 / 16, 1 / 16, DT, 4)(u32, cr)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_psi_is_required():
    domain = tgrid.Domain((16, 16), ((-0.5, 0.5), (-0.5, 0.5)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TSBM(domain, KAPPA, f=F, mu=BV_MU, j0=BV_J0, alpha=0.5, Crate=1.0)
    with pytest.raises(ValueError, match="derivative"):
        TSBM(domain, KAPPA, f=F, mu=BV_MU, j0=BV_J0, alpha=0.5, Crate=1.0,
             psi=np.ones((16, 16)), derivs="fourier")


# ---- the macro ---------------------------------------------------------------

def test_reference_matches_jax():
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.sbm_bv import sbm_bv_reference as jref

    u, cr, psi = _inputs()
    h = 1.0 / 16
    want = jref(jmu, jj0, KAPPA, psi, h, h, DT, 4)(jnp.asarray(u), jnp.asarray(cr))
    got = tref(BV_MU, BV_J0, KAPPA, psi, h, h, DT, 4)(*_t(u, cr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("ep", [False, True])
def test_macro_matches_jax(ep):
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.sbm_bv import make_sbm_bv_fused_macro as jmake

    u, cr, psi = _inputs(3, 32, seed=3 + ep)
    h = 1.0 / 32
    cfg = EP_CFG if ep else None
    jout = jmake(jmu, jj0, KAPPA, psi, h, h, DT, 3, interpret=True, epilogue=cfg)(
        jnp.asarray(u), jnp.asarray(cr))
    tout = tmake(BV_MU, BV_J0, KAPPA, psi, h, h, DT, 3, epilogue=cfg)(*_t(u, cr))
    if not ep:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == (3, 32, 32) and tout[0].dtype == torch.float32
    assert float((tout[0] - torch.from_numpy(u)).abs().max()) > 1e-4
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-6)
    if ep:
        st, jst = tout[1].numpy(), np.asarray(jout[1])
        np.testing.assert_array_equal(st[:, 2], jst[:, 2])
        np.testing.assert_allclose(st[:, :2], jst[:, :2], rtol=1e-5)
        d = np.abs(tout[2].numpy().astype(int) - np.asarray(jout[2]).astype(int))
        assert tout[2].dtype == torch.uint8 and d.max() <= 1


def test_macro_matches_reference():
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.sbm_bv import sbm_bv_reference as jref

    u, cr, psi = _inputs()
    h = 1.0 / 16
    got = tmake(BV_MU, BV_J0, KAPPA, psi, h, h, DT, 4)(*_t(u, cr))
    np.testing.assert_allclose(got.numpy(), tref(BV_MU, BV_J0, KAPPA, psi, h, h, DT, 4)(
        *_t(u, cr)).numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref(jmu, jj0, KAPPA, psi, h, h, DT, 4)(
        jnp.asarray(u), jnp.asarray(cr))), rtol=0, atol=2e-5)


def test_macro_charging_rate_is_galvanostatic():
    """The ψ-weighted mean charges at Crate / ∫ψ per env."""
    u, cr, psi = _inputs(3, 16, seed=1)
    h, n = 1.0 / 16, 10
    u1 = tmake(BV_MU, BV_J0, KAPPA, psi, h, h, DT, n)(*_t(u, cr))
    w = psi / psi.sum()
    rate = ((u1.numpy() * w).sum((-2, -1)) - (u * w).sum((-2, -1))) / (DT * n)
    np.testing.assert_allclose(rate, cr / float(psi.sum() * h * h), rtol=0.02)


@pytest.mark.parametrize("ep", [False, True])
def test_macro_grads_match_jax_oracle(ep):
    """Gradients of ``sum(u1**2)`` (plus the ψ-weighted stats with the
    epilogue) with respect to ``u`` and ``crate`` against ``jax.grad``
    through the JAX oracle (the JAX macro's custom VJP)."""
    import jax

    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.sbm_bv import sbm_bv_reference as jref

    u, cr, psi = _inputs(2, 16, seed=2)
    h = 1.0 / 16
    jm = jref(jmu, jj0, KAPPA, psi, h, h, DT, 2)
    w = jnp.asarray(psi * np.float32(h * h))

    def jloss(a, b):
        u1 = jm(a, b)
        loss = jnp.sum(u1**2)
        if ep:
            uz = u1 - 0.5
            loss = loss + 1.5 * jnp.sum(w * uz) + 0.5 * jnp.sum(w * uz * uz)
        return loss

    gu_j, gc_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(cr))
    tm = tmake(BV_MU, BV_J0, KAPPA, psi, h, h, DT, 2, epilogue=EP_CFG if ep else None)
    ut, ct = (t.requires_grad_() for t in _t(u, cr))
    if ep:
        u1, stats, _ = tm(ut, ct)
        loss = (u1**2).sum() + 1.5 * stats[:, 0].sum() + 0.5 * stats[:, 1].sum()
    else:
        loss = (tm(ut, ct) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc_j), rtol=1e-5, atol=1e-6)


def test_epilogue_matches_its_own_field():
    u, cr, psi = _inputs(4, 16, seed=5)
    args = (BV_MU, BV_J0, KAPPA, psi, 1 / 16, 1 / 16, DT, 3)
    u1 = tmake(*args)(*_t(u, cr))
    u1e, stats, obs = tmake(*args, epilogue=EP_CFG)(*_t(u, cr))
    assert torch.equal(u1, u1e)
    w = torch.from_numpy(psi * np.float32(1 / 256))
    uz = u1 - 0.5
    torch.testing.assert_close(stats, torch.stack(
        [(w * uz).sum((-2, -1)), (w * uz * uz).sum((-2, -1)), torch.full((4,), 256.0)], -1),
        rtol=1e-6, atol=0)
    assert torch.equal(obs, torch.clamp(u1 * torch.from_numpy(psi) * 255.0, 0, 255).to(
        torch.uint8))


def test_constants_built_once_per_psi():
    """The same ψ object gives the same cached constants (an env step
    rebuilds the stepper: rebuilding them would copy ψ from the device);
    they hold the JAX kernel's numpy f32 bits."""
    psi = torch.from_numpy(_psi(16))
    a = sbm_bv_constants(psi, KAPPA, 1 / 16, 1 / 16, "cpu")
    assert sbm_bv_constants(psi, KAPPA, 1 / 16, 1 / 16, "cpu") is a
    assert sbm_bv_constants(psi.clone(), KAPPA, 1 / 16, 1 / 16, "cpu") is not a
    p = psi.numpy()
    np.testing.assert_array_equal(a.psi_ax.numpy(), 0.5 * (p + np.roll(p, -1, 0)))
    np.testing.assert_array_equal(a.psi_ay.numpy(), 0.5 * (p + np.roll(p, -1, 1)))
    np.testing.assert_array_equal(a.kop.numpy(), np.float32(KAPPA) / p)
    np.testing.assert_array_equal(a.psic.numpy(), p * np.float32(1 / 256))
    assert a.inv_hx == float(np.float32(16.0))


# ---- the stepper -------------------------------------------------------------

def test_stepper_through_evolve_matches_jax():
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.allen_cahn import (
        AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent as JSBM,
    )
    from pde_opt_tpu.ops.integrate import evolve as jevolve
    from pde_opt_tpu.ops.steppers import FusedSBMButlerVolmer as JFused
    from pde_opt_tpu.utils.compat import prepare_solver_params as jprep
    from pde_opt_tpu_torch.utils.compat import (
        check_equation_solver_compatibility,
        prepare_solver_params,
    )

    check_equation_solver_compatibility(FusedSBMButlerVolmer, TSBM)
    u, cr, psi = _inputs(3, 32, seed=7)
    box = ((-0.5, 0.5), (-0.5, 0.5))
    teq = TSBM(tgrid.Domain((32, 32), box), KAPPA, F, BV_MU, BV_J0, 0.5,
               torch.from_numpy(cr)[:, None, None], psi=torch.from_numpy(psi))
    st = FusedSBMButlerVolmer(**prepare_solver_params(FusedSBMButlerVolmer, {}, teq))
    jeq = JSBM(JDomain((32, 32), box), KAPPA, F, jmu, jj0, 0.5, jnp.asarray(cr)[:, None, None],
               psi=jnp.asarray(psi))
    jst = JFused(**jprep(JFused, {"interpret": True}, jeq))
    got = evolve(st, teq.rhs, torch.from_numpy(u), 0.0, DT, 3)
    want = jevolve(jst, jeq.rhs, jnp.asarray(u), 0.0, DT, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="alpha"):
        FusedSBMButlerVolmer(KAPPA, BV_MU, BV_J0, 0.25, 1.0, teq.domain, teq.psi)
    with pytest.raises(ValueError, match="does not broadcast"):
        FusedSBMButlerVolmer(KAPPA, BV_MU, BV_J0, 0.5, torch.ones(3, 2), teq.domain,
                             teq.psi).evolve(None, torch.from_numpy(u), 0.0, DT, 1)


def test_cpu_refusals_and_no_launches():
    u, cr, psi = _inputs(2, 16)
    consts = sbm_bv_constants(torch.from_numpy(psi), KAPPA, 1 / 16, 1 / 16, "cpu")
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=DT, n_steps=2)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sbm_bv_macro_cuda(*_t(u, cr), consts, **kw)
    with pytest.raises(ValueError, match="SqrtJ0"):
        sbm_bv_macro_cuda(*_t(u, cr), consts, **{**kw, "j0_fn": torch.sqrt})
    sbm_bv_macro_plain(*_t(u, cr), consts, **kw)
    ut = torch.from_numpy(u).requires_grad_()
    tmake(BV_MU, BV_J0, KAPPA, psi, 1 / 16, 1 / 16, DT, 2)(ut, 1.0).sum().backward()
    assert ut.grad is not None
    assert kernels.launch_counts() == before


# ---- the preset ----------------------------------------------------------------

def _np_state(B, H, seed):
    rng = np.random.default_rng(seed)
    return {"y": np.clip(0.05 + 0.005 * rng.standard_normal((B, H, H)), 0.01, 0.99)
            .astype(np.float32),
            "t": np.zeros(B, np.float32),
            "control_value": rng.uniform(0.5, 2.0, B).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}


@pytest.mark.parametrize("method", ["rk4", "fused"])
def test_env_steps_match_jax(method):
    """Same numpy state and actions through both packages' fleets for three
    steps.  ψ is computed in each framework and held to 1e-6 first; fields
    to 1e-6 (f32 reduction order, and ψ's last bits), obs within 1 LSB,
    rewards to rtol 1e-4, terminations exact, controls to an ulp."""
    import jax

    from pde_opt_tpu.envs.presets import make_sbm_butler_volmer_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState

    jnp = jax.numpy
    B, H = 3, 16
    kw = dict(num_envs=B, grid_size=H, substeps=4, method=method, auto_reset=False)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    np.testing.assert_allclose(tenv.static_equation_parameters["psi"].numpy(),
                               np.asarray(jenv.static_equation_parameters["psi"]),
                               rtol=0, atol=1e-6)
    arrs = _np_state(B, H, 0)
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), B),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    ts = env_state_from_numpy(arrs, "cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):
        a = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
        js, jo, jr, jt, _, _ = jenv.step(js, jnp.asarray(a))
        ts, to, tr, tt, _, _ = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=1e-6)
        d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
        assert to.shape == (B, 1, H, H) and d.max() <= 1
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.control_value.numpy(), np.asarray(js.control_value),
                                   rtol=2e-7)


def test_fused_env_matches_rk4_env():
    kw = dict(num_envs=3, grid_size=16, substeps=4, auto_reset=False, device="cpu")
    env_r, env_f = tpreset(method="rk4", **kw), tpreset(method="fused", **kw)
    sr, _ = env_r.reset(torch.Generator().manual_seed(3))
    sf, _ = env_f.reset(torch.Generator().manual_seed(3))
    acts = torch.tensor([[0.5], [-0.5], [0.0]])
    for _ in range(3):
        sr, _, rr, *_ = env_r.step(sr, acts)
        sf, _, rf, *_ = env_f.step(sf, acts)
    np.testing.assert_allclose(sf.y.numpy(), sr.y.numpy(), rtol=0, atol=5e-5)
    np.testing.assert_allclose(rf.numpy(), rr.numpy(), rtol=1e-3)


def test_reward_from_stats_equals_reward_function():
    env = tpreset(num_envs=4, grid_size=16, substeps=4, auto_reset=False, device="cpu")
    gen = torch.Generator().manual_seed(4)
    state, _ = env.reset(gen)
    state, obs, reward, *_ = env.step(state, env.sample_actions(gen))
    torch.testing.assert_close(reward, env.reward_function(state.y), rtol=1e-5, atol=0)
    assert torch.equal(obs, env.state_to_observation_func(state.y))


def test_preset_charges_particle_and_control_responds():
    env = tpreset(num_envs=4, grid_size=32, substeps=4, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (4, 1, 32, 32) and obs.dtype == torch.uint8
    psi = env.static_equation_parameters["psi"]
    fill0 = float((psi * state.y[0]).sum() / psi.sum())
    state, rewards, _ = env.rollout(state, lambda o, g: torch.zeros(4, 1), 8)
    assert bool(torch.isfinite(rewards).all())
    assert float((psi * state.y[0]).sum() / psi.sum()) > fill0

    env = tpreset(num_envs=2, grid_size=32, substeps=4, auto_reset=False, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(3))
    state.y[1] = state.y[0]
    for _ in range(4):
        state, *_ = env.step(state, torch.tensor([[1.0], [-1.0]]))
    fill = (psi * state.y).sum((-2, -1))
    assert float(fill[0]) > float(fill[1])


def test_preset_galvanostatic_charge_balance():
    """d(Σ ψ c cell)/dt == Crate per env (Crate = 1 at reset)."""
    env = tpreset(num_envs=2, grid_size=32, substeps=4, auto_reset=False, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(2))
    psi = env.static_equation_parameters["psi"]
    cell = float(env.domain.dx[0]) * float(env.domain.dx[1])
    q0 = (psi * state.y).sum((-2, -1)) * cell
    state, *_ = env.step(state, torch.zeros(2, 1))
    q1 = (psi * state.y).sum((-2, -1)) * cell
    np.testing.assert_allclose(((q1 - q0) / env.step_dt).numpy(), 1.0, rtol=0.05)


def test_env_step_gradient_reaches_the_action():
    env = tpreset(num_envs=4, grid_size=16, substeps=2, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(9))
    scale = torch.tensor(0.5, requires_grad=True)
    _, _, reward, *_ = env.step(state, scale * torch.ones(4, 1))
    reward.sum().backward()
    assert bool(torch.isfinite(scale.grad)) and float(scale.grad.abs()) > 0.0


def test_poisoned_env_and_unported_options():
    env = tpreset(num_envs=6, grid_size=16, substeps=2, device="cpu")
    gen = torch.Generator().manual_seed(6)
    state, _ = env.reset(gen)
    state.y[3] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    assert bool(info["diverged"][3]) and int(info["diverged"].sum()) == 1
    assert bool(terminated[3]) and float(reward[3]) == 0.0
    assert bool(torch.isfinite(state.y).all()) and int(state.step_count[3]) == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpreset(num_envs=2, grid_size=16, smooth_geometry=True, device="cpu")


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(16, 16), (64, 64), (24, 40)])
@pytest.mark.parametrize("ep", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, H, W, ep):
    u, cr, psi = _inputs(300, H, seed=H, W=W)
    u, cr = (t.to(cuda_device) for t in _t(u, cr))
    consts = sbm_bv_constants(torch.from_numpy(psi), KAPPA, 1 / H, 1 / W, cuda_device)
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=DT, n_steps=10,
              epilogue=SbmEpilogue(255.0, 0.5) if ep else None)
    name = "sbm_bv_macro_ep" if ep else "sbm_bv_macro"
    before = kernels.launch_counts()[name]
    got = sbm_bv_macro_cuda(u, cr, consts, **kw)
    want = sbm_bv_macro_plain(u, cr, consts, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    if not ep:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    if ep:
        assert torch.equal(got[1][:, 2], want[1][:, 2])
        torch.testing.assert_close(got[1][:, :2], want[1][:, :2], rtol=1e-4, atol=0)
        assert int((got[2].int() - want[2].int()).abs().max()) <= 1


@pytest.mark.cuda
def test_kernel_matches_reference_on_card(cuda_device):
    u, cr, psi = _inputs(64, 64, seed=2)
    u, cr = (t.to(cuda_device) for t in _t(u, cr))
    consts = sbm_bv_constants(torch.from_numpy(psi), KAPPA, 1 / 64, 1 / 64, cuda_device)
    got = sbm_bv_macro_cuda(u, cr, consts, mu_fn=BV_MU, j0_fn=BV_J0, dt=DT, n_steps=10)
    want = tref(BV_MU, BV_J0, KAPPA, consts.psi, 1 / 64, 1 / 64, DT, 10, remat=False)(u, cr)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="LogRatioMu"):
        sbm_bv_macro_cuda(u, cr, consts, mu_fn=lambda c: c, j0_fn=BV_J0, dt=DT, n_steps=1)


@pytest.mark.cuda
def test_fused_env_on_card_matches_cpu(cuda_device):
    B, H = 64, 64
    envs = {d: tpreset(num_envs=B, grid_size=H, device=d) for d in ("cpu", cuda_device)}
    for d, env in envs.items():
        env.reset(torch.Generator(device=d).manual_seed(0))
    arrs = _np_state(B, H, 3)
    a = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (B, 1)).astype(np.float32))
    out = {d: env.step(env_state_from_numpy(arrs, d), a.to(d)) for d, env in envs.items()}
    (sc, oc, rc, tc, _, _), (sg, og, rg, tg, _, _) = out["cpu"], out[cuda_device]
    np.testing.assert_allclose(sg.y.cpu().numpy(), sc.y.numpy(), rtol=0, atol=1e-5)
    assert int((og.cpu().int() - oc.int()).abs().max()) <= 1
    np.testing.assert_allclose(rg.cpu().numpy(), rc.numpy(), rtol=1e-4)
    assert torch.equal(tg.cpu(), tc)
