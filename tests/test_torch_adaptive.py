"""The port's adaptive integration (``Tsit5``, ``integrate_adaptive``,
``PDEModel.solve`` under a ``PIDController``) held against the JAX package
on the same numpy inputs, and the JAX package's own adaptive tests
mirrored: ``tests/test_adaptive_saves.py`` (every case),
``tests/test_adaptive_model_dtypes.py``, the adaptive cases of
``tests/test_solvers.py`` (``:56``, ``:135``, ``:236``) and the
``ac2d_tsit5_fd.npz`` golden of ``tests/test_golden_parity.py:108``.

Tolerances: the mirrored cases keep the JAX tests' own bounds; f64 parity
with the JAX integrator is 1e-10 on the saves with equal accepted and rejected
step counts (the same arithmetic on the host and in XLA).
"""

import os

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.grid import Domain
from pde_opt_tpu_torch.models.allen_cahn import AllenCahn2DPeriodic
from pde_opt_tpu_torch.models.pde_model import PDEModel
from pde_opt_tpu_torch.ops.integrate import PIDController, evolve, integrate_adaptive
from pde_opt_tpu_torch.ops.steppers import RK4, Heun, Tsit5
from pde_opt_tpu_torch.utils.compat import check_equation_solver_compatibility

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
KAPPA = 0.002


def _jax():
    import jax.numpy as jnp

    import pde_opt_tpu as jp

    return jnp, jp


def _exp_decay_rhs(y, t):
    return -y


def _linear_rhs(y, t):
    return torch.full_like(y, 0.5)


# ---- tests/test_adaptive_saves.py ------------------------------------------

def _check_capture(ts, dt0, rtol=1e-6, atol=1e-9, tol=1e-2):
    """dy/dt = -y from y(ts[0]) = 1: every save slot matches
    exp(-(t - ts[0])) within the integrator's linear interpolation error."""
    y0 = torch.tensor(1.0, dtype=torch.float32)
    ys = integrate_adaptive(Tsit5(), _exp_decay_rhs, y0, ts, dt0, rtol=rtol, atol=atol)
    expect = np.exp(-(np.asarray(ts, np.float64) - float(ts[0])))
    np.testing.assert_allclose(ys.double().numpy(), expect, rtol=tol, atol=tol)


def _check_capture_exact(ts, dt0, atol=1e-5):
    """dy/dt = 1/2: the linear interpolation is exact, so each slot equals
    1 + (t - ts[0])/2 to f32 roundoff (an unwritten, duplicated or
    mis-indexed slot fails)."""
    y0 = torch.tensor(1.0, dtype=torch.float32)
    ys = integrate_adaptive(Tsit5(), _linear_rhs, y0, ts, dt0, rtol=1e-6, atol=1e-9)
    t_np = np.asarray(ts, np.float64)
    np.testing.assert_allclose(ys.double().numpy(), 1.0 + 0.5 * (t_np - t_np[0]),
                               rtol=0, atol=atol)


def test_f32_grid_unit_scale():
    ts = np.linspace(0.0, 1.0, 17, dtype=np.float32)
    _check_capture(ts, dt0=0.05)
    _check_capture_exact(ts, dt0=0.05)


def test_f32_grid_large_time_offset():
    # At t ~ 1e4 one f32 ulp is ~1e-3.
    ts = (np.float32(16384.0) + np.linspace(0.0, 1.0, 9, dtype=np.float32)).astype(np.float32)
    ys = integrate_adaptive(Tsit5(), _exp_decay_rhs, torch.tensor(1.0), ts, 0.1,
                            rtol=1e-6, atol=1e-9)
    expect = np.exp(-(np.asarray(ts, np.float64) - float(ts[0])))
    np.testing.assert_allclose(ys.double().numpy(), expect, rtol=5e-3, atol=5e-3)


def test_f32_grid_tiny_irregular_intervals():
    rng = np.random.default_rng(7)
    deltas = rng.choice([1e-4, 3e-4, 1e-3, 1e-2, 0.05], size=24).astype(np.float32)
    ts = np.concatenate([[np.float32(0.0)], np.cumsum(deltas)]).astype(np.float32)
    _check_capture(ts, dt0=1e-3)


def test_f32_many_saves_per_step():
    # dt grows past the save spacing: one accepted step flushes many saves.
    _check_capture_exact(np.linspace(0.0, 2.0, 101, dtype=np.float32), dt0=0.5)


def test_f32_save_points_on_step_boundaries():
    _check_capture_exact(np.arange(33, dtype=np.float32) * np.float32(0.03125), dt0=0.03125)


@pytest.mark.parametrize("n_save", [2, 3, 64])
def test_final_slot_written_without_backstop(n_save):
    """A stiff oscillator sampled mid-phase: the last slot must hold the
    interpolated save value, not the final carry."""
    w = 40.0

    def rhs(y, t):
        return torch.stack([-w * y[1], w * y[0]])

    ts = np.linspace(np.float32(0.0), np.float32(0.7853982), n_save, dtype=np.float32)
    y0 = torch.tensor([1.0, 0.0], dtype=torch.float32)
    ys = integrate_adaptive(Heun(), rhs, y0, ts, 1e-3, rtol=1e-5, atol=1e-8)
    th = w * np.asarray(ts, np.float64)
    expect = np.stack([np.cos(th), np.sin(th)], axis=-1)
    np.testing.assert_allclose(ys.double().numpy(), expect, rtol=0, atol=5e-3)


def test_stats_and_batched_capture_f32():
    y0 = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float32)
    ts = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    ys, stats = integrate_adaptive(Tsit5(), _exp_decay_rhs, y0, ts, 0.05, rtol=1e-6,
                                   atol=1e-9, return_stats=True, batch_ndim=1)
    expect = y0.numpy()[None] * np.exp(-np.asarray(ts, np.float64))[:, None]
    np.testing.assert_allclose(ys.double().numpy(), expect, rtol=1e-2, atol=1e-2)
    assert int(stats["accepted_steps"]) > 0


# ---- tests/test_adaptive_model_dtypes.py -----------------------------------

N_M, L_M = 16, 0.16


def _ac_model(dtype):
    """The JAX test's 16^2 Allen-Cahn model on ``dtype``.  A bf16 state
    runs on an f32 domain: the port's meshes are f32 or f64, and the FD
    rhs reads none of them."""
    domain = Domain((N_M, N_M), ((-L_M / 2, L_M / 2),) * 2, "dimensionless",
                    dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    model = PDEModel(AllenCahn2DPeriodic, domain, Tsit5)
    params = {"kappa": 1e-3, "mu": lambda c: c**3 - c, "R": torch.ones_like,
              "derivs": "fd", "device": "cpu"}
    return model, params


def _ac_y0(seed=0):
    return 0.1 * np.random.default_rng(seed).standard_normal((N_M, N_M))


def test_pid_path_f32_matches_fixed_step():
    model, params = _ac_model(torch.float32)
    y0 = torch.from_numpy(_ac_y0()).float()
    ts = np.linspace(0.0, 0.02, 5)
    sol_pid = model.solve(params, y0, ts, dt0=1e-4,
                          stepsize_controller=PIDController(rtol=1e-6, atol=1e-9))
    sol_fix = model.solve(params, y0, ts, dt0=1e-4)
    assert sol_pid.shape == (5, N_M, N_M) and sol_pid.dtype == torch.float32
    np.testing.assert_allclose(sol_pid.numpy(), sol_fix.numpy(), rtol=5e-3, atol=1e-3)
    np.testing.assert_array_equal(sol_pid[0].numpy(), y0.numpy())


def test_pid_path_bf16_state_stays_bf16_and_finite():
    model, params = _ac_model(torch.bfloat16)
    ts = np.linspace(0.0, 0.02, 5)
    sol = model.solve(params, torch.from_numpy(_ac_y0()).to(torch.bfloat16), ts, dt0=1e-4,
                      stepsize_controller=PIDController(rtol=1e-3, atol=1e-5))
    assert sol.dtype == torch.bfloat16
    assert bool(torch.isfinite(sol.float()).all())
    model32, params32 = _ac_model(torch.float32)
    ref = model32.solve(params32, torch.from_numpy(_ac_y0()).float(), ts, dt0=1e-4,
                        stepsize_controller=PIDController(rtol=1e-6, atol=1e-9))
    np.testing.assert_allclose(sol.float().numpy(), ref.numpy(), rtol=0, atol=0.03)
    for i in range(1, 5):
        assert float(sol[i].float().abs().max()) > 1e-3


def test_pid_path_adversarial_irregular_save_grid():
    model, params = _ac_model(torch.float32)
    y0 = torch.from_numpy(_ac_y0(seed=1)).float()
    ts = np.asarray([0.0, 1e-4, 1.3e-3, 1.31e-3, 0.01, 0.0123], np.float32)
    sol = model.solve(params, y0, ts, dt0=5e-5,
                      stepsize_controller=PIDController(rtol=1e-6, atol=1e-9))
    assert sol.shape == (6, N_M, N_M)
    ref = model.solve(params, y0, np.linspace(0.0, 0.0123, 2), dt0=5e-5)
    np.testing.assert_allclose(sol[1].numpy(), y0.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(sol[-1].numpy(), ref[-1].numpy(), rtol=2e-3, atol=2e-4)


# ---- tests/test_solvers.py, the adaptive cases -----------------------------

NX = 256


def _interface_domain():
    lx, ly = 0.01 * NX, 0.01
    return Domain((NX, 1), ((-lx / 2, lx / 2), (-ly / 2, ly / 2)), "dimensionless",
                  dtype=torch.float64)


def _step_ic():
    y = np.ones((NX, 1))
    y[: NX // 2] = -1.0
    return y


def _check_interface(final, domain):
    analytic = np.tanh(domain.axes()[0] / np.sqrt(2 * KAPPA))
    np.testing.assert_allclose(final.numpy().squeeze()[NX // 4: 3 * NX // 4],
                               analytic[NX // 4: 3 * NX // 4], rtol=1e-3, atol=1e-3)


def test_1d_allen_cahn_adaptive_tsit5():
    domain = _interface_domain()
    eq = AllenCahn2DPeriodic(domain, KAPPA, lambda c: c**3 - c, torch.ones_like,
                             derivs="fd", device="cpu")
    ys = integrate_adaptive(Tsit5(), eq.rhs, torch.from_numpy(_step_ic()),
                            np.linspace(0.0, 10.0, 200), 0.00005, rtol=1e-4, atol=1e-6)
    _check_interface(ys[-1], domain)


def test_1d_allen_cahn_pde_model_adaptive():
    domain = _interface_domain()
    model = PDEModel(AllenCahn2DPeriodic, domain, Tsit5)
    sol = model.solve(
        {"kappa": KAPPA, "mu": lambda c: c**3 - c, "R": torch.ones_like, "derivs": "fd",
         "device": "cpu"},
        torch.from_numpy(_step_ic()), np.linspace(0.0, 10.0, 200), dt0=0.00005,
        stepsize_controller=PIDController(rtol=1e-4, atol=1e-6),
    )
    assert sol.shape == (200, NX, 1)
    _check_interface(sol[-1], domain)


def test_integrate_adaptive_batched_per_instance_error_control():
    lam = torch.tensor([-1.0, -40.0], dtype=torch.float64)

    def rhs(y, t):
        return lam.reshape(-1, *([1] * (y.ndim - 1))) * y

    y0 = torch.ones((2, 4), dtype=torch.float64)
    ts = np.linspace(0.0, 1.0, 5)
    ys, stats = integrate_adaptive(Heun(), rhs, y0, ts, dt0=0.1, rtol=1e-6, atol=1e-9,
                                   batch_ndim=1, return_stats=True)
    exact = np.exp(lam.numpy()[None, :, None] * ts[:, None, None]) * y0.numpy()[None]
    np.testing.assert_allclose(ys.numpy(), exact, rtol=1e-4, atol=1e-7)
    assert int(stats["accepted_steps"]) > 10


# ---- the golden of tests/test_golden_parity.py:108 ------------------------

def test_ac2d_tsit5_trajectory_matches_golden():
    """Allen-Cahn FD rhs + fixed-dt Tsit5 against the numpy golden."""
    z = np.load(os.path.join(GOLDENS, "ac2d_tsit5_fd.npz"))
    n, dx, dt = int(z["N"]), float(z["dx"]), float(z["dt"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])
    ln = n * dx
    domain = Domain((n, n), ((-ln / 2, ln / 2),) * 2, "dimensionless", dtype=torch.float64)
    eq = AllenCahn2DPeriodic(domain, float(z["kappa"]), lambda c: c**3 - c,
                             R=lambda c: 1.0 + 0.1 * c**2, derivs="fd", device="cpu")
    u = torch.from_numpy(np.array(z["u0"], np.float64))
    got = [u.numpy()]
    for _ in range(n_steps // save_every):
        u = evolve(Tsit5(), eq.rhs, u, 0.0, dt, save_every)
        got.append(u.numpy())
    np.testing.assert_allclose(np.stack(got), z["traj"], rtol=0, atol=1e-12)


# ---- parity with the JAX integrator ---------------------------------------

def _jax_stepper(jp, name):
    return {"tsit5": jp.Tsit5, "heun": jp.Heun}[name]()


@pytest.mark.parametrize("case", ["ac1d_tsit5", "decay_batched_heun", "budget_exhausted"])
def test_integrate_adaptive_matches_jax(case):
    """The same f64 inputs through both drivers: saves within 1e-10 and the
    same accepted and rejected step counts (also when max_steps runs out
    and the backstop fills the last slot)."""
    jnp, jp = _jax()
    from pde_opt_tpu.ops.integrate import integrate_adaptive as jintegrate_adaptive

    if case == "ac1d_tsit5":
        lx, ly = 0.01 * NX, 0.01
        jdom = jp.Domain((NX, 1), ((-lx / 2, lx / 2), (-ly / 2, ly / 2)), "dimensionless",
                         dtype=jnp.float64)
        jrhs = jp.AllenCahn2DPeriodic(jdom, KAPPA, lambda c: c**3 - c, jnp.ones_like,
                                      derivs="fd").rhs
        trhs = AllenCahn2DPeriodic(_interface_domain(), KAPPA, lambda c: c**3 - c,
                                   torch.ones_like, derivs="fd", device="cpu").rhs
        y0, ts, stepper, kw = _step_ic(), np.linspace(0.0, 2.0, 40), "tsit5", {}
        dt0, tol = 5e-5, dict(rtol=1e-4, atol=1e-6)
    else:
        lam = np.array([-1.0, -40.0])

        def jrhs(y, t):
            return jnp.asarray(lam)[:, None] * y

        def trhs(y, t):
            return torch.from_numpy(lam)[:, None] * y

        y0, ts, stepper = np.ones((2, 4)), np.linspace(0.0, 1.0, 5), "heun"
        kw = {"batch_ndim": 1}
        if case == "budget_exhausted":
            kw["max_steps"] = 12
        dt0, tol = 0.1, dict(rtol=1e-6, atol=1e-9)
    jys, jst = jintegrate_adaptive(_jax_stepper(jp, stepper), jrhs, jnp.asarray(y0),
                                   jnp.asarray(ts), dt0, return_stats=True, **tol, **kw)
    tys, tst = integrate_adaptive(Tsit5() if stepper == "tsit5" else Heun(), trhs,
                                  torch.from_numpy(y0), ts, dt0, return_stats=True,
                                  **tol, **kw)
    assert tst == {"accepted_steps": int(jst["accepted_steps"]),
                   "rejected_steps": int(jst["rejected_steps"])}
    assert tst["rejected_steps"] > 0 or case != "ac1d_tsit5"
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=0, atol=1e-10)
    if case == "budget_exhausted":
        assert sum(tst.values()) == 12 and not np.asarray(jys)[2:-1].any()


def test_pid_solve_matches_jax():
    """``PDEModel.solve`` under a ``PIDController`` with ``Tsit5``: the 2D
    Allen-Cahn model of ``tests/test_adaptive_model_dtypes.py`` in f64,
    against the JAX model's solve, saves within 1e-10."""
    jnp, jp = _jax()
    from pde_opt_tpu.ops.integrate import PIDController as JPID

    jdom = jp.Domain((N_M, N_M), ((-L_M / 2, L_M / 2),) * 2, "dimensionless",
                     dtype=jnp.float64)
    jmodel = jp.PDEModel(jp.AllenCahn2DPeriodic, jdom, jp.Tsit5)
    jparams = {"kappa": 1e-3, "mu": lambda c: c**3 - c, "R": jnp.ones_like, "derivs": "fd"}
    model, params = _ac_model(torch.float64)
    y0 = _ac_y0()
    ts = np.linspace(0.0, 0.02, 5)
    want = jmodel.solve(jparams, jnp.asarray(y0), ts, dt0=1e-4,
                        stepsize_controller=JPID(rtol=1e-6, atol=1e-9))
    got = model.solve(params, torch.from_numpy(y0), ts, dt0=1e-4,
                      stepsize_controller=PIDController(rtol=1e-6, atol=1e-9))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


def test_tsit5_step_matches_jax():
    """One Tsit5 step's solution and error estimate against JAX's (f64)."""
    jnp, jp = _jax()
    rng = np.random.default_rng(3)
    y = rng.standard_normal((8, 8))

    def jrhs(u, t):
        return jnp.sin(u) * (1.0 + t) - u**3

    def trhs(u, t):
        return torch.sin(u) * (1.0 + t) - u**3

    jy1, jerr = jp.Tsit5().step(jrhs, jnp.asarray(y), 0.3, 0.05)
    ty1, terr = Tsit5().step(trhs, torch.from_numpy(y), 0.3, 0.05)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), rtol=0, atol=1e-14)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=0, atol=1e-14)
    assert Tsit5.order == 5


def test_tsit5_wiring_and_rejections():
    """``Tsit5`` needs no equation attribute, so it pairs with every
    equation JAX's does; a stepper without an error estimate, or an unknown
    controller, is refused."""
    from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic, CahnHilliard3DPeriodic

    for eq in (AllenCahn2DPeriodic, CahnHilliard2DPeriodic, CahnHilliard3DPeriodic):
        check_equation_solver_compatibility(Tsit5, eq)
    assert Tsit5.required_equation_attrs == ()
    with pytest.raises(ValueError, match="error estimate"):
        integrate_adaptive(RK4(), _exp_decay_rhs, torch.tensor(1.0), [0.0, 1.0], 0.1)
    model, params = _ac_model(torch.float64)
    with pytest.raises(ValueError, match="stepsize_controller"):
        model.solve(params, torch.zeros(N_M, N_M, dtype=torch.float64), [0.0, 1e-3],
                    dt0=1e-4, stepsize_controller="pid")
    ctl = PIDController(1e-5, 1e-7)
    assert (ctl.rtol, ctl.atol) == (1e-5, 1e-7)


# ---- a first step that overflows (the port's one departure from JAX) -------

def _smoothing_flow(stencils, where, N=16):
    """The smoothing flow of ``geometry.Shape`` on a disk mask of N² (ε =
    4/N, the SBM preset's): ``(rhs, y0)`` for one package's stencils."""
    h = 1.0 / N
    eps = 4.0 * h
    x = (np.arange(N) + 0.5) * h - 0.5
    y0 = (np.hypot(*np.meshgrid(x, x, indexing="ij")) < 0.35).astype(np.float64)

    def rhs(u, t):
        gx, gy = stencils.grad_c(u, h, -2), stencils.grad_c(u, h, -1)
        uxx, uyy = stencils.grad2_c(u, h, -2), stencils.grad2_c(u, h, -1)
        uxy = stencils.grad2_cross_c(u, h, h, -2, -1)
        mag2 = where(gx * gx + gy * gy < 1e-7, 1.0, gx * gx + gy * gy)
        along_normal = (uxx * gx * gx + uyy * gy * gy + 2.0 * uxy * gx * gy) / mag2
        return 2.0 * along_normal - 18.0 / eps * u * (1.0 - u) * (1.0 - 2.0 * u) / eps

    return rhs, y0


def test_non_finite_error_is_a_rejection():
    """From dt0 = 0.1 the first Tsit5 step of the smoothing flow overflows
    and its error norm is NaN.  The port rejects it and shrinks dt by
    factor_min until a step is finite, then converges to the run started at
    dt0 = 1e-5 (within the controller's tolerance).  The JAX integrator's
    next dt is NaN there: capped at 100 attempts (max_steps) it accepts
    none and returns the initial mask."""
    jnp, jp = _jax()
    from pde_opt_tpu.ops import stencils as jst
    from pde_opt_tpu.ops.integrate import integrate_adaptive as jintegrate_adaptive
    from pde_opt_tpu_torch.ops import stencils as tst

    trhs, y0 = _smoothing_flow(tst, torch.where)
    jrhs, _ = _smoothing_flow(jst, jnp.where)
    ts, tol = np.array([0.0, 0.05]), dict(rtol=1e-4, atol=1e-6)
    y1, err = Tsit5().step(trhs, torch.from_numpy(y0), torch.tensor(0.0), torch.tensor(0.1))
    assert not bool(torch.isfinite(err).all())
    got, st = integrate_adaptive(Tsit5(), trhs, torch.from_numpy(y0), ts, 0.1,
                                 return_stats=True, **tol)
    ref, st_ref = integrate_adaptive(Tsit5(), trhs, torch.from_numpy(y0), ts, 1e-5,
                                     return_stats=True, **tol)
    assert st["accepted_steps"] > 0 and st["rejected_steps"] >= 5
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[-1].numpy(), ref[-1].numpy(), rtol=0, atol=1e-3)
    # The run from dt0 = 1e-5 meets no non-finite error: JAX's, step for step.
    jys, jst_ref = jintegrate_adaptive(jp.Tsit5(), jrhs, jnp.asarray(y0), jnp.asarray(ts), 1e-5,
                                       return_stats=True, **tol)
    assert st_ref == {k: int(v) for k, v in jst_ref.items()}
    np.testing.assert_allclose(ref.numpy(), np.asarray(jys), rtol=0, atol=1e-10)
    # JAX from dt0 = 0.1, capped: every attempt rejected.
    jys, jst = jintegrate_adaptive(jp.Tsit5(), jrhs, jnp.asarray(y0), jnp.asarray(ts), 0.1,
                                   return_stats=True, max_steps=100, **tol)
    assert int(jst["accepted_steps"]) == 0 and int(jst["rejected_steps"]) == 100
    np.testing.assert_array_equal(np.asarray(jys)[-1], y0)
