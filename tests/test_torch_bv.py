"""The port's Butler-Volmer charging fleet (kernel K6's macro, the BV
equation classes, RK4, the fused stepper and the preset) held against the
JAX package.

On the CPU the port runs its plain-torch macro; the JAX macro runs its
Pallas kernel in interpret mode.  Same numpy inputs on both sides.
Tolerances, from the measured gaps plus headroom (my CPU runs: plain vs
JAX macro 7.5e-9 with f32 matrices, 3.0e-8 with bf16, 3 envs x 32^2):

    equation rhs, voltage vs JAX (f64)        atol 1e-12
    golden bv_cc_rk4.npz (f64)                atol 1e-12 (the JAX test's)
    LogRatioMu, SqrtJ0 vs the JAX lambdas     atol 1e-6 f32, 1e-14 f64 (torch's
                                              and XLA's log differ by an ulp)
    macro u1 vs JAX, f32 matrices             atol 1e-6 (f32 rounding)
    macro u1 vs JAX, bf16 matrices            atol 1e-5 (both round the same
                                              sites; 3e-8 measured)
    macro (f32) vs bv_cc_reference            atol 2e-5 (the JAX test's bound)
    stats                                     n_finite exact, s1/s2 rtol 1e-5
    obs                                       <= 1 LSB
    charging rate vs Crate                    rtol 2e-2 (the JAX test's)
    gradients vs jax.grad of the oracle       rtol 1e-4 (the JAX test's)
    kernel vs plain on the card               atol 1e-5 f32, 1e-4 bf16
    kernel vs plain, 1 substep, bf16          RMS <= 2e-7 (below the control)

Tests marked ``cuda`` hold kernel K6 against the plain version on the card
and skip without one; JAX is imported inside the tests that use it, so they
also run where JAX is not installed (``pytest --noconftest -m cuda``).
"""

import os

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU
from pde_opt_tpu_torch.envs.presets import make_butler_volmer_control_env as tpreset
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy
from pde_opt_tpu_torch.models.allen_cahn import (
    AllenCahn2DPeriodicButlerVolmer,
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
)
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.bv_cas import (
    LogRatioMu,
    SqrtJ0,
    bv_cc_macro_cuda,
    bv_cc_macro_plain,
    bv_cc_reference as tref,
    make_bv_cc_fused_macro as tmake,
)
from pde_opt_tpu_torch.ops.cas_spectral import Epilogue, cas_constants
from pde_opt_tpu_torch.ops.integrate import evolve
from pde_opt_tpu_torch.ops.steppers import (
    RK4,
    FusedButlerVolmer,
    _normalize_per_env_control,
)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
KAPPA, DT = 5e-4, 5e-4
EP_CFG = {"obs_scale": 255.0, "obs_offset": 0.0, "stats_center": 0.5}
MATS = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}
TOL_U = {"f32": 1e-6, "bf16": 1e-5}


def _jax_coeffs():
    import jax.numpy as jnp

    def clip(c):
        return jnp.clip(c, 1e-4, 1 - 1e-4)

    def mu(c):
        return jnp.log(clip(c) / (1 - clip(c))) + 3.0 * (1.0 - 2.0 * c)

    def j0(c):
        return jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None))

    return jnp, mu, j0


def _inputs(B=5, N=16, seed=0, W=None):
    """The JAX tests' setup: fields around 0.1 and C-rates across [0.5, 2]."""
    rng = np.random.default_rng(seed)
    shape = (B, N, N if W is None else W)
    u = np.clip(0.1 + 0.01 * rng.standard_normal(shape), 0.01, 0.99).astype(np.float32)
    return u, np.linspace(0.5, 2.0, B).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---- coefficient functions and equations ------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_coefficient_functions_match_jax_lambdas(dtype):
    """Pointwise on [-0.5, 1.5], where both clips and the j0 floor bite."""
    jnp, jmu, jj0 = _jax_coeffs()
    c = np.linspace(-0.5, 1.5, 4001).astype(dtype)
    assert (c < 1e-4).any() and (c > 1 - 1e-4).any() and (c * (1 - c) < 1e-6).any()
    tol = 1e-6 if dtype == "float32" else 1e-14
    for t_fn, j_fn in ((LogRatioMu(), jmu), (SqrtJ0(), jj0)):
        got = t_fn(torch.from_numpy(c)).numpy()
        want = np.asarray(j_fn(jnp.asarray(c)))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert BV_MU == LogRatioMu(3.0, 1e-4) and BV_J0 == SqrtJ0(1e-6)
    assert LogRatioMu().bounds() == (float(np.float32(1e-4)), float(np.float32(1 - 1e-4)))


def _domains(N=16, L=1.0, dtype="float64"):
    import jax.numpy as jnp

    from pde_opt_tpu.grid import Domain as JDomain

    box = ((-L / 2, L / 2), (-L / 2, L / 2))
    return (tgrid.Domain((N, N), box, dtype=getattr(torch, dtype)),
            JDomain((N, N), box, dtype=getattr(jnp, dtype)))


@pytest.mark.parametrize("crate", ["scalar", "per_env"])
def test_constant_current_rhs_and_voltage_match_jax(crate):
    from pde_opt_tpu.models.allen_cahn import (
        AllenCahn2DPeriodicButlerVolmerConstantCurrent as JCC,
    )

    jnp, jmu, jj0 = _jax_coeffs()
    u, cr = _inputs(3, 16, seed=1)
    u = u.astype(np.float64)
    C = 1.3 if crate == "scalar" else cr.astype(np.float64)[:, None, None]
    td, jd = _domains()
    tC = C if crate == "scalar" else torch.from_numpy(C)
    teq = AllenCahn2DPeriodicButlerVolmerConstantCurrent(td, KAPPA, BV_MU, BV_J0, alpha=0.5,
                                                          Crate=tC)
    jeq = JCC(jd, KAPPA, jmu, jj0, alpha=0.5, Crate=C if crate == "scalar" else jnp.asarray(C))
    np.testing.assert_allclose(teq.rhs(torch.from_numpy(u), 0.0).numpy(),
                               np.asarray(jeq.rhs(jnp.asarray(u), 0.0)), rtol=0, atol=1e-12)
    v = teq.get_voltage(torch.from_numpy(u))
    assert v.shape == (3,)
    np.testing.assert_allclose(v.numpy(), np.asarray(jeq.get_voltage(jnp.asarray(u))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("alpha,v", [(0.5, 0.0), (0.3, -0.2)])
def test_fixed_voltage_rhs_matches_jax(alpha, v):
    from pde_opt_tpu.models.allen_cahn import AllenCahn2DPeriodicButlerVolmer as JBV

    jnp, jmu, jj0 = _jax_coeffs()
    u, _ = _inputs(2, 16, seed=2)
    u = u.astype(np.float64)
    td, jd = _domains()
    teq = AllenCahn2DPeriodicButlerVolmer(td, KAPPA, BV_MU, BV_J0, alpha=alpha, v=v)
    jeq = JBV(jd, KAPPA, jmu, jj0, alpha=alpha, v=v)
    np.testing.assert_allclose(teq.rhs(torch.from_numpy(u), 0.0).numpy(),
                               np.asarray(jeq.rhs(jnp.asarray(u), 0.0)), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="derivative"):
        AllenCahn2DPeriodicButlerVolmer(td, KAPPA, BV_MU, BV_J0, alpha=alpha, derivs="fourier")


def test_golden_bv_cc_rk4():
    """RK4 through ``evolve`` at f64 against the numpy golden, field and
    voltage at every save point (tests/test_golden_parity.py's gate)."""
    z = np.load(os.path.join(GOLDENS, "bv_cc_rk4.npz"))
    N, dx, dt = int(z["N"]), float(z["dx"]), float(z["dt"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])
    L = N * dx
    domain = tgrid.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)), dtype=torch.float64)
    eq = AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        domain, float(z["kappa"]), BV_MU, BV_J0, alpha=float(z["alpha"]),
        Crate=float(z["Crate"]))
    u = torch.from_numpy(z["u0"])
    traj, volts = [u], [float(eq.get_voltage(u))]
    for k in range(n_steps // save_every):
        u = evolve(RK4(), eq.rhs, u, k * save_every * dt, dt, save_every)
        traj.append(u)
        volts.append(float(eq.get_voltage(u)))
    np.testing.assert_allclose(torch.stack(traj).numpy(), z["traj"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(volts), z["volts"], rtol=0, atol=1e-12)


# ---- analytic oracles (the BV half of tests/test_analytic_oracles.py) --------

def _unit_domain(N):
    return tgrid.Domain((N, N), ((0.0, 1.0), (0.0, 1.0)), dtype=torch.float64)


def _mu_prime(c):
    return 1.0 / (c * (1.0 - c)) - 6.0


def _lap_symbol(m, N, h):
    return (4.0 / h**2) * np.sin(np.pi * m / N) ** 2


def _sine_mode(domain, m, axis):
    x, y = domain.mesh()
    return torch.from_numpy(np.sin(2.0 * np.pi * m * (x if axis == 0 else y)))


@pytest.mark.parametrize("c0,m,axis", [(0.1, 1, 0), (0.1, 5, 1), (0.3, 3, 0)])
def test_bv_cc_rhs_linear_response_matches_analytic(c0, m, axis):
    """Around the Crate = 0 stationary state a sine mode decays (or, inside
    the spinodal at c0 = 0.3, grows) at ``j0(c0) (mu'(c0) + κ k²_disc)``."""
    N, kappa = 32, 5e-4
    domain = _unit_domain(N)
    eq = AllenCahn2DPeriodicButlerVolmerConstantCurrent(domain, kappa, BV_MU, BV_J0,
                                                        alpha=0.5, Crate=0.0)
    s = _sine_mode(domain, m, axis)
    base = torch.full((N, N), c0, dtype=torch.float64)
    np.testing.assert_allclose(eq.rhs_fd(base, 0.0).numpy(), 0.0, atol=1e-12)
    eps = 1e-5
    measured = (eq.rhs_fd(base + eps * s, 0.0) - eq.rhs_fd(base - eps * s, 0.0)) / (2 * eps)
    lam = float(BV_J0(torch.tensor(c0, dtype=torch.float64))) * (
        _mu_prime(c0) + kappa * _lap_symbol(m, N, 1.0 / N))
    np.testing.assert_allclose(measured.numpy(), -lam * s.numpy(), rtol=0,
                               atol=3e-6 * max(1.0, abs(lam)))


def test_bv_cc_rk4_oracle_amplification_matches_analytic():
    """The RK4 oracle's per-mode gain over n steps equals the RK4 stability
    polynomial of the analytic rate, r(-λ dt)^n."""
    N, m, kappa, dt, n, c0 = 32, 2, 5e-4, 2e-3, 25, 0.1
    domain = _unit_domain(N)
    s = _sine_mode(domain, m, axis=0)
    u0 = torch.full((N, N), c0, dtype=torch.float64) + 1e-5 * s
    u1 = tref(BV_MU, BV_J0, kappa, 1.0 / N, 1.0 / N, dt, n)(u0, 0.0)

    def proj(u):
        return float(((u - u.mean()) * s).sum() * 2.0 / (N * N))

    lam = float(BV_J0(torch.tensor(c0, dtype=torch.float64))) * (
        _mu_prime(c0) + kappa * _lap_symbol(m, N, 1.0 / N))
    z = -lam * dt
    r = 1.0 + z + z**2 / 2 + z**3 / 6 + z**4 / 24
    np.testing.assert_allclose(proj(u1) / proj(u0), r**n, rtol=5e-6)


# ---- the macro ---------------------------------------------------------------

def test_reference_matches_jax():
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.bv_cas import bv_cc_reference as jref

    u, cr = _inputs()
    h = 1.0 / 16
    want = jref(jmu, jj0, KAPPA, h, h, DT, 4)(jnp.asarray(u), jnp.asarray(cr))
    got = tref(BV_MU, BV_J0, KAPPA, h, h, DT, 4)(*_t(u, cr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("ep", [False, True])
def test_macro_matches_jax(mats, ep):
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.bv_cas import make_bv_cc_fused_macro as jmake

    B, N, n = 3, 32, 3
    u, cr = _inputs(B, N, seed=3 + ep)
    h = 1.0 / N
    cfg = EP_CFG if ep else None
    jout = jmake(jmu, jj0, KAPPA, N, N, h, h, DT, n, mats_dtype=getattr(jnp, MATS[mats][0]),
                 interpret=True, epilogue=cfg)(jnp.asarray(u), jnp.asarray(cr))
    tout = tmake(BV_MU, BV_J0, KAPPA, N, N, h, h, DT, n, mats_dtype=MATS[mats][1],
                 epilogue=cfg)(*_t(u, cr))
    if not ep:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == (B, N, N) and tout[0].dtype == torch.float32
    assert float((tout[0] - torch.from_numpy(u)).abs().max()) > 1e-4
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=TOL_U[mats])
    if ep:
        st, jst = tout[1].numpy(), np.asarray(jout[1])
        np.testing.assert_array_equal(st[:, 2], jst[:, 2])
        np.testing.assert_allclose(st[:, :2], jst[:, :2], rtol=1e-5)
        assert tout[2].dtype == torch.uint8 and tout[2].shape == (B, N, N)
        d = np.abs(tout[2].numpy().astype(int) - np.asarray(jout[2]).astype(int))
        assert d.max() <= 1


# Grids above 64², where the card runs the tiled K6: 128² (the 128² BV
# fleet) and a non-square grid that is no multiple of 64.  f32 matrices
# throughout, one case in bf16; 2 envs x 2 substeps.
BIG_CASES = [(H, W, "f32", ep) for H, W in [(128, 128), (96, 136)] for ep in (False, True)]
BIG_CASES.append((128, 128, "bf16", True))


@pytest.mark.parametrize("H,W,mats,ep", BIG_CASES)
def test_macro_above_64_matches_jax(H, W, mats, ep):
    """The plain K6 against the JAX macro in interpret mode above 64²."""
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.bv_cas import make_bv_cc_fused_macro as jmake

    B, n = 2, 2
    u, cr = _inputs(B, H, seed=H + W + ep, W=W)
    hx, hy = 1.0 / H, 1.0 / W
    cfg = EP_CFG if ep else None
    jout = jmake(jmu, jj0, KAPPA, H, W, hx, hy, DT, n, mats_dtype=getattr(jnp, MATS[mats][0]),
                 interpret=True, epilogue=cfg)(jnp.asarray(u), jnp.asarray(cr))
    tout = tmake(BV_MU, BV_J0, KAPPA, H, W, hx, hy, DT, n, mats_dtype=MATS[mats][1],
                 epilogue=cfg)(*_t(u, cr))
    if not ep:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == (B, H, W) and tout[0].dtype == torch.float32
    assert float((tout[0] - torch.from_numpy(u)).abs().max()) > 1e-4
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=TOL_U[mats])
    if ep:
        st, jst = tout[1].numpy(), np.asarray(jout[1])
        np.testing.assert_array_equal(st[:, 2], jst[:, 2])
        np.testing.assert_allclose(st[:, :2], jst[:, :2], rtol=1e-5)
        assert tout[2].dtype == torch.uint8 and tout[2].shape == (B, H, W)
        d = np.abs(tout[2].numpy().astype(int) - np.asarray(jout[2]).astype(int))
        assert d.max() <= 1


def test_macro_matches_reference():
    """The cas Laplacian equals the roll stencil's for periodic fields: the
    f32 macro against the port's and the JAX package's oracles at 2e-5."""
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.bv_cas import bv_cc_reference as jref

    u, cr = _inputs()
    h = 1.0 / 16
    got = tmake(BV_MU, BV_J0, KAPPA, 16, 16, h, h, DT, 4, mats_dtype=torch.float32)(*_t(u, cr))
    ref_t = tref(BV_MU, BV_J0, KAPPA, h, h, DT, 4)(*_t(u, cr))
    ref_j = jref(jmu, jj0, KAPPA, h, h, DT, 4)(jnp.asarray(u), jnp.asarray(cr))
    np.testing.assert_allclose(got.numpy(), ref_t.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_j), rtol=0, atol=2e-5)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_macro_charging_rate_is_galvanostatic(mats):
    """d<c>/dt equals Crate / area per env (area 1)."""
    u, cr = _inputs(3, 16, seed=1)
    n = 10
    u1 = tmake(BV_MU, BV_J0, KAPPA, 16, 16, 1 / 16, 1 / 16, DT, n,
               mats_dtype=MATS[mats][1])(*_t(u, cr))
    rate = (u1.mean((-2, -1)) - torch.from_numpy(u).mean((-2, -1))) / (DT * n)
    np.testing.assert_allclose(rate.numpy(), cr, rtol=0.02)


@pytest.mark.parametrize("ep", [False, True])
def test_macro_grads_match_jax_oracle(ep):
    """Gradients of ``sum(u1**2)`` (plus the stats with the epilogue) with
    respect to ``u`` and ``crate`` against ``jax.grad`` through the JAX
    oracle: the JAX macro's custom VJP, without its slow interpret run."""
    import jax

    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.ops.bv_cas import bv_cc_reference as jref

    u, cr = _inputs(2, 16, seed=2)
    h = 1.0 / 16
    jm = jref(jmu, jj0, KAPPA, h, h, DT, 2)

    def jloss(a, b):
        u1 = jm(a, b)
        loss = jnp.sum(u1**2)
        if ep:
            uz = u1 - 0.5
            loss = loss + 1.5 * jnp.sum(uz) + 0.5 * jnp.sum(uz * uz)
        return loss

    gu_j, gc_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(cr))
    tm = tmake(BV_MU, BV_J0, KAPPA, 16, 16, h, h, DT, 2, mats_dtype=torch.float32,
               epilogue=EP_CFG if ep else None)
    ut, ct = (t.requires_grad_() for t in _t(u, cr))
    if ep:
        u1, stats, _ = tm(ut, ct)
        loss = (u1**2).sum() + 1.5 * stats[:, 0].sum() + 0.5 * stats[:, 1].sum()
    else:
        loss = (tm(ut, ct) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc_j), rtol=1e-4, atol=1e-8)


def test_epilogue_matches_its_own_field():
    u, cr = _inputs(4, 16, seed=5)
    args = (BV_MU, BV_J0, KAPPA, 16, 16, 1 / 16, 1 / 16, DT, 3)
    u1 = tmake(*args)(*_t(u, cr))
    u1e, stats, obs = tmake(*args, epilogue=EP_CFG)(*_t(u, cr))
    assert torch.equal(u1, u1e)
    uz = u1 - 0.5
    torch.testing.assert_close(stats, torch.stack(
        [uz.sum((-2, -1)), (uz * uz).sum((-2, -1)), torch.full((4,), 256.0)], -1),
        rtol=1e-6, atol=0)
    assert torch.equal(obs, torch.clamp(u1 * 255.0, 0, 255).to(torch.uint8))
    with pytest.raises(NotImplementedError, match="obs_downsample"):
        tmake(*args, epilogue={**EP_CFG, "obs_downsample": 2})


# ---- the stepper ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (3,), (3, 1), (3, 1, 1)])
def test_stepper_accepts_per_env_crate_shapes(shape):
    u, cr = _inputs(3, 16, seed=6)
    domain = tgrid.Domain((16, 16), ((-0.5, 0.5), (-0.5, 0.5)))
    C = torch.full(shape, 1.25)
    st = FusedButlerVolmer(KAPPA, BV_MU, BV_J0, 0.5, C, domain, mats_dtype=torch.float32)
    got = evolve(st, None, torch.from_numpy(u), 0.0, DT, 2)
    want = tmake(BV_MU, BV_J0, KAPPA, 16, 16, 1 / 16, 1 / 16, DT, 2,
                 mats_dtype=torch.float32)(torch.from_numpy(u), 1.25)
    assert torch.equal(got, want)
    assert _normalize_per_env_control(C, (3,), "Crate").shape == (3,)


def test_stepper_rejects_bad_crate_and_alpha():
    domain = tgrid.Domain((16, 16), ((-0.5, 0.5), (-0.5, 0.5)))
    st = FusedButlerVolmer(KAPPA, BV_MU, BV_J0, 0.5, torch.ones(3, 2), domain)
    with pytest.raises(ValueError, match="does not broadcast"):
        st.evolve(None, torch.full((3, 16, 16), 0.1), 0.0, DT, 1)
    with pytest.raises(ValueError, match="alpha"):
        FusedButlerVolmer(KAPPA, BV_MU, BV_J0, 0.3, 1.0, domain)
    assert FusedButlerVolmer(KAPPA, BV_MU, BV_J0, 0.5, 1.0, domain).mats_dtype == torch.bfloat16


def test_stepper_through_evolve_matches_jax():
    jnp, jmu, jj0 = _jax_coeffs()
    from pde_opt_tpu.models.allen_cahn import (
        AllenCahn2DPeriodicButlerVolmerConstantCurrent as JCC,
    )
    from pde_opt_tpu.ops.integrate import evolve as jevolve
    from pde_opt_tpu.ops.steppers import FusedButlerVolmer as JFused
    from pde_opt_tpu.utils.compat import prepare_solver_params as jprep
    from pde_opt_tpu_torch.utils.compat import (
        check_equation_solver_compatibility,
        prepare_solver_params,
    )

    check_equation_solver_compatibility(FusedButlerVolmer,
                                        AllenCahn2DPeriodicButlerVolmerConstantCurrent)
    u, cr = _inputs(3, 32, seed=7)
    td, jd = _domains(32, dtype="float32")
    teq = AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        td, KAPPA, BV_MU, BV_J0, 0.5, torch.from_numpy(cr)[:, None, None])
    st = FusedButlerVolmer(**prepare_solver_params(
        FusedButlerVolmer, {"mats_dtype": torch.float32}, teq))
    jeq = JCC(jd, KAPPA, jmu, jj0, 0.5, jnp.asarray(cr)[:, None, None])
    jst = JFused(**jprep(JFused, {"mats_dtype": jnp.float32, "interpret": True}, jeq))
    got = evolve(st, teq.rhs, torch.from_numpy(u), 0.0, DT, 3)
    want = jevolve(jst, jeq.rhs, jnp.asarray(u), 0.0, DT, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL_U["f32"])


def test_cpu_refusals_and_no_launches():
    u, cr = _inputs(2, 16)
    consts = cas_constants(16, 16, 1 / 16, 1 / 16, torch.float32, torch.device("cpu"))
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=KAPPA, cell=1 / 256, dt=DT, n_steps=2,
              round_bf16=False)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bv_cc_macro_cuda(*_t(u, cr), consts, **kw)
    with pytest.raises(ValueError, match="LogRatioMu"):
        bv_cc_macro_cuda(*_t(u, cr), consts, **{**kw, "mu_fn": lambda c: c})
    bv_cc_macro_plain(*_t(u, cr), consts, **kw)
    ut = torch.from_numpy(u).requires_grad_()
    tmake(BV_MU, BV_J0, KAPPA, 16, 16, 1 / 16, 1 / 16, DT, 2)(ut, 1.0).sum().backward()
    assert ut.grad is not None
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="multiples of 8"):
        tmake(BV_MU, BV_J0, KAPPA, 12, 16, 1 / 16, 1 / 16, DT, 2)
    # The grid cap is checked before the device: 256² is the tiled kernel's
    # largest grid, so a 264² state is refused on any device.
    big = torch.full((1, 264, 264), 0.1)
    with pytest.raises(ValueError, match="multiples of 8 up to 256"):
        bv_cc_macro_cuda(big, torch.ones(1), consts, **kw)


# ---- the preset ---------------------------------------------------------------

def _np_state(B, H, seed):
    rng = np.random.default_rng(seed)
    return {"y": np.clip(0.05 + 0.005 * rng.standard_normal((B, H, H)), 0.01, 0.99)
            .astype(np.float32),
            "t": np.zeros(B, np.float32),
            "control_value": rng.uniform(0.5, 2.0, B).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}


@pytest.mark.parametrize("method,atol", [("rk4", 1e-6), ("fused", 1e-5)])
def test_env_steps_match_jax(method, atol):
    """Same numpy state and actions through both packages' fleets for three
    steps: fields (f32 reduction order; the fused path's bf16 rounding
    sites as measured above), obs within 1 LSB, rewards to rtol 1e-4,
    terminations exact, controls to an ulp (XLA fuses the control update's
    multiply-add)."""
    import jax

    from pde_opt_tpu.envs.presets import make_butler_volmer_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState

    jnp = jax.numpy
    B, H = 3, 16
    kw = dict(num_envs=B, grid_size=H, substeps=4, method=method, auto_reset=False)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    assert (jenv.fused_epilogue is None) == (tenv.fused_epilogue is None)
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
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=atol)
        d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
        assert to.shape == (B, 1, H, H) and d.max() <= 1
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.control_value.numpy(), np.asarray(js.control_value),
                                   rtol=2e-7)


def test_env_step_at_128_matches_jax():
    """One fused env step of the preset at grid_size=128 (the 128² fleet's
    grid; box 1, h = 1/128) on three envs, against the JAX preset: fields,
    obs, rewards and terminations as in test_env_steps_match_jax."""
    import jax

    from pde_opt_tpu.envs.presets import make_butler_volmer_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState

    jnp = jax.numpy
    B, H = 3, 128
    kw = dict(num_envs=B, grid_size=H, substeps=4, method="fused", auto_reset=False)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    assert tenv.domain.dx[0] == pytest.approx(1 / H) and tenv.fused_epilogue is not None
    arrs = _np_state(B, H, 5)
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), B),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    a = np.random.default_rng(2).uniform(-1, 1, (B, 1)).astype(np.float32)
    js, jo, jr, jt, _, _ = jenv.step(js, jnp.asarray(a))
    ts, to, tr, tt, _, _ = tenv.step(env_state_from_numpy(arrs, "cpu"), torch.from_numpy(a))
    assert float((ts.y - torch.from_numpy(arrs["y"])).abs().max()) > 1e-4
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=1e-5)
    d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert to.shape == (B, 1, H, H) and d.max() <= 1
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_fused_env_matches_rk4_env():
    """The fused macro through the env against the RK4 path, per env
    (tests/test_presets_gpe_ac.py's bound, 5e-5)."""
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


def test_rollout_charges_and_control_responds():
    """Crate = 1 charges every particle; pushing the C-rate up fills faster
    than pushing it down from the same state."""
    env = tpreset(num_envs=4, grid_size=16, substeps=4, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (4, 1, 16, 16) and obs.dtype == torch.uint8
    fill0 = float(state.y.mean())
    state, rewards, _ = env.rollout(state, lambda o, g: torch.zeros(4, 1), 10)
    assert bool(torch.isfinite(rewards).all()) and float(state.y.mean()) > fill0

    env = tpreset(num_envs=2, grid_size=16, substeps=4, auto_reset=False, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(0))
    state.y[1] = state.y[0]
    for _ in range(4):
        state, *_ = env.step(state, torch.tensor([[1.0], [-1.0]]))
    assert float(state.y[0].mean()) > float(state.y[1].mean())


def test_per_env_closure_is_galvanostatic():
    """Two envs with different states each charge at their own Crate."""
    env = tpreset(num_envs=2, grid_size=16, substeps=4, auto_reset=False, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(2))
    m0 = state.y.mean((-2, -1)).clone()
    state, *_ = env.step(state, torch.zeros(2, 1))
    np.testing.assert_allclose(((state.y.mean((-2, -1)) - m0) / env.step_dt).numpy(), 1.0,
                               rtol=0.05)


def test_env_step_gradient_reaches_the_action():
    env = tpreset(num_envs=4, grid_size=16, substeps=2, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(9))
    scale = torch.tensor(0.5, requires_grad=True)
    _, _, reward, *_ = env.step(state, scale * torch.ones(4, 1))
    reward.sum().backward()
    assert bool(torch.isfinite(scale.grad)) and float(scale.grad.abs()) > 0.0


def test_poisoned_env_is_flagged_and_reset():
    env = tpreset(num_envs=6, grid_size=16, substeps=2, device="cpu")
    gen = torch.Generator().manual_seed(6)
    state, _ = env.reset(gen)
    state.y[3] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    assert bool(info["diverged"][3]) and int(info["diverged"].sum()) == 1
    assert bool(terminated[3]) and float(reward[3]) == 0.0
    assert bool(torch.isfinite(state.y).all()) and int(state.step_count[3]) == 0
    with pytest.raises(ValueError, match="unknown method"):
        tpreset(num_envs=2, grid_size=16, method="euler", device="cpu")


# ---- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_args(dev, B, H, seed, mats="f32", n_steps=10, W=None):
    W = H if W is None else W
    u, cr = _inputs(B, H, seed=seed, W=W)
    tm = MATS[mats][1]
    consts = cas_constants(H, W, 1 / H, 1 / W, tm, dev)
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=KAPPA, cell=1 / (H * W), dt=DT,
              n_steps=n_steps, round_bf16=tm == torch.bfloat16)
    return torch.from_numpy(u).to(dev), torch.from_numpy(cr).to(dev), consts, kw


# Above 64² the tiled K6; at 256² with bf16 matrices two correct macros sit
# 1.6e-4 apart (summation order; chip_smoke.py phase 13 holds that shape
# against its controls), so the card's 1e-4 is checked up to 136.
@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(16, 16), (64, 64), (24, 40), (8, 8), (128, 128), (96, 136)])
@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("ep", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, H, W, mats, ep):
    u, cr, consts, kw = _card_args(cuda_device, 300, H, H, mats, W=W)
    epi = Epilogue(255.0, 0.0, 0.5, 1) if ep else None
    name = "bv_cc_macro_ep" if ep else "bv_cc_macro"
    before = kernels.launch_counts()[name]
    got = bv_cc_macro_cuda(u, cr, consts, epilogue=epi, **kw)
    want = bv_cc_macro_plain(u, cr, consts, epilogue=epi, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    if not ep:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5 if mats == "f32" else 1e-4)
    if ep:
        assert torch.equal(got[1][:, 2], want[1][:, 2])
        torch.testing.assert_close(got[1][:, :2], want[1][:, :2], rtol=1e-4, atol=0)
        assert int((got[2].int() - want[2].int()).abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_nan_env_leaves_later_envs_alone_on_card(cuda_device, mats):
    """NaN in two envs of a batch larger than the resident blocks: each block
    walks on to later envs (grid stride), which must all equal plain; the
    poisoned envs are NaN where plain's are and their epilogue flags them."""
    B, H, W = 1000, 24, 40
    u, cr, consts, kw = _card_args(cuda_device, B, H, 11, mats, W=W)
    u[0, 5, 9] = float("nan")
    u[7] = float("nan")
    epi = Epilogue(255.0, 0.0, 0.5, 1)
    got = bv_cc_macro_cuda(u, cr, consts, epilogue=epi, **kw)
    want = bv_cc_macro_plain(u, cr, consts, epilogue=epi, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    keep = torch.ones(B, dtype=torch.bool, device=cuda_device)
    keep[[0, 7]] = False
    assert not bool(torch.isnan(got[0][keep]).any())
    torch.testing.assert_close(got[0][keep], want[0][keep], rtol=0,
                               atol=1e-5 if mats == "f32" else 1e-4)
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][7, 2]) == 0.0


def _rms(d):
    return float(d.double().pow(2).mean().sqrt())


# One substep, bf16 matrices: the RMS of kernel - plain over the fleet must
# sit below the bound, and the unrounded plain version (the control) above.
TOL_SITE = 2e-7


@pytest.mark.cuda
def test_kernel_rounds_where_plain_rounds_on_card(cuda_device):
    u, cr, consts, kw = _card_args(cuda_device, 300, 64, 7, "bf16", n_steps=1)
    want = bv_cc_macro_plain(u, cr, consts, **kw)
    got = _rms(bv_cc_macro_cuda(u, cr, consts, **kw) - want)
    control = _rms(bv_cc_macro_plain(u, cr, consts, **{**kw, "round_bf16": False}) - want)
    assert got <= TOL_SITE < control, (got, control)


@pytest.mark.cuda
def test_cuda_macro_refuses_other_coefficients_on_card(cuda_device):
    u, cr, consts, kw = _card_args(cuda_device, 4, 16, 1)
    with pytest.raises(ValueError, match="LogRatioMu"):
        bv_cc_macro_cuda(u, cr, consts, **{**kw, "mu_fn": lambda c: torch.log(c)})
    with pytest.raises(ValueError, match="SqrtJ0"):
        tmake(BV_MU, torch.sqrt, KAPPA, 16, 16, 1 / 16, 1 / 16, DT, 2)(u, cr)


@pytest.mark.cuda
def test_fused_env_on_card_matches_cpu(cuda_device):
    """The BV env step on the card (kernel K6) against the same step on the
    CPU (plain version), from the same state."""
    B, H = 64, 64
    envs = {d: tpreset(num_envs=B, grid_size=H, device=d) for d in ("cpu", cuda_device)}
    for d, env in envs.items():
        env.reset(torch.Generator(device=d).manual_seed(0))
    arrs = _np_state(B, H, 3)
    a = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (B, 1)).astype(np.float32))
    out = {d: env.step(env_state_from_numpy(arrs, d), a.to(d)) for d, env in envs.items()}
    (sc, oc, rc, tc, _, _), (sg, og, rg, tg, _, _) = out["cpu"], out[cuda_device]
    np.testing.assert_allclose(sg.y.cpu().numpy(), sc.y.numpy(), rtol=0, atol=1e-4)
    assert int((og.cpu().int() - oc.int()).abs().max()) <= 1
    np.testing.assert_allclose(rg.cpu().numpy(), rc.numpy(), rtol=1e-4)
    assert torch.equal(tg.cpu(), tc)
