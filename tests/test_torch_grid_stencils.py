"""The PyTorch port's grid, stencils, spectral pair, CH rhs and SIF stepper,
held against the JAX package on the same float64 inputs, and against the
numpy goldens the JAX package is held against."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_opt_tpu import grid as jgrid
from pde_opt_tpu.models.cahn_hilliard import CahnHilliard2DPeriodic as JCH
from pde_opt_tpu.ops import spectral as jspec
from pde_opt_tpu.ops import stencils as jst
from pde_opt_tpu.ops.steppers import SemiImplicitFourierSpectral as JSIF
from pde_opt_tpu.utils.compat import prepare_solver_params as jprep
from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic as TCH
from pde_opt_tpu_torch.ops import spectral as tspec
from pde_opt_tpu_torch.ops import stencils as tst
from pde_opt_tpu_torch.ops.integrate import evolve as tevolve
from pde_opt_tpu_torch.ops.steppers import (
    FusedSemiImplicitSpectral as TFused,
    SemiImplicitFourierSpectral as TSIF,
)
from pde_opt_tpu_torch.utils.compat import (
    check_equation_solver_compatibility as tcheck,
    prepare_solver_params as tprep,
)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
RTOL = 1e-10          # f64 on both sides: the same formulas, rounding only


def _field(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _domains(n=16, m=24, dtype64=True):
    box = ((-0.5, 0.5), (-0.3, 0.9))
    return (jgrid.Domain((n, m), box, dtype=jnp.float64 if dtype64 else jnp.float32),
            tgrid.Domain((n, m), box, dtype=torch.float64 if dtype64 else torch.float32))


@pytest.mark.parametrize("dtype64", [True, False])
def test_domain_meshes_match(dtype64):
    jd, td = _domains(dtype64=dtype64)
    assert td.dx == jd.dx and td.L == jd.L and td.ndim == 2
    for name in ("axes", "mesh", "fft_axes", "rfft_axes", "fft_mesh", "rfft_mesh"):
        for a, b in zip(getattr(td, name)(), getattr(jd, name)()):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(td.laplacian_symbol(), jd.laplacian_symbol())
    assert hash(td) == hash(tgrid.Domain(td.points, td.box, dtype=td.dtype))


@pytest.mark.parametrize("name,args", [
    ("lap_2nd_2d", (0.1, 0.07)),
    ("grad_c2f", (0.1, -2)), ("grad_c2f", (0.07, -1)),
    ("avg_c2f", (-2,)), ("avg_c2f", (-1,)),
    ("div_f2c", (0.1, -2)), ("div_f2c", (0.07, -1)),
    ("grad2_c", (0.1, -2)), ("grad2_c", (0.07, -1)),
])
def test_stencils_match_jax(name, args):
    x = _field((3, 16, 24), seed=1)
    _close(getattr(tst, name)(torch.from_numpy(x), *args),
           getattr(jst, name)(jnp.asarray(x), *args))


@pytest.mark.parametrize("real", [False, True])
def test_spectral_pairs_match_jax(real):
    x = _field((2, 16, 24), seed=2)
    if real:
        tf, ti = tspec.make_rfft_pair(2, (16, 24))
        jf, ji = jspec.make_rfft_pair(2, (16, 24))
    else:
        tf, ti = tspec.make_fft_pair(2)
        jf, ji = jspec.make_fft_pair(2)
    X = tf(torch.from_numpy(x))
    _close(X, jf(jnp.asarray(x)), atol=1e-12)
    _close(ti(X), ji(jf(jnp.asarray(x))), atol=1e-12)


def _mu_t(c):
    return c**3 - c


def _mu_j(c):
    return c**3 - c


def _equations(derivs, use_rfft, B=3, n=16):
    L = 0.01 * n
    box = ((-L / 2, L / 2), (-L / 2, L / 2))
    jd = jgrid.Domain((n, n), box, dtype=jnp.float64)
    td = tgrid.Domain((n, n), box, dtype=torch.float64)
    kap = np.linspace(2e-3, 8e-3, B).reshape(B, 1, 1)
    je = JCH(jd, jnp.asarray(kap), _mu_j, lambda c: 1.0 + 0.1 * c**2,
             derivs=derivs, use_rfft=use_rfft)
    te = TCH(td, torch.from_numpy(kap), _mu_t, lambda c: 1.0 + 0.1 * c**2,
             derivs=derivs, use_rfft=use_rfft)
    return je, te


@pytest.mark.parametrize("derivs", ["fd", "fourier"])
@pytest.mark.parametrize("use_rfft", [True, False])
def test_ch_rhs_matches_jax(derivs, use_rfft):
    je, te = _equations(derivs, use_rfft)
    u = 0.5 + 0.05 * _field((3, 16, 16), seed=3)
    ref = je.rhs(jnp.asarray(u), 0.0)
    # The rhs is a difference of O(1e6) flux terms: scale the atol to it.
    _close(te.rhs(torch.from_numpy(u), 0.0), ref, atol=1e-10 * float(jnp.abs(ref).max()))


@pytest.mark.parametrize("derivs", ["fd", "fourier"])
def test_sif_step_matches_jax(derivs):
    je, te = _equations(derivs, use_rfft=True)
    u = 0.5 + 0.05 * _field((3, 16, 16), seed=4)
    js = JSIF(**jprep(JSIF, {"A": 0.5}, je))
    ts = TSIF(**tprep(TSIF, {"A": 0.5}, te))
    y1j, errj = js.step(je.rhs, jnp.asarray(u), 0.0, 1e-4)
    y1t, errt = ts.step(te.rhs, torch.from_numpy(u), 0.0, 1e-4)
    _close(y1t, y1j)
    _close(errt, errj, atol=1e-14)


@pytest.mark.parametrize("fname,derivs", [
    ("ch2d_sif_fourier.npz", "fourier"),
    ("ch2d_sif_fd.npz", "fd"),
])
def test_ch2d_sif_trajectory_matches_golden(fname, derivs):
    z = np.load(os.path.join(GOLDENS, fname))
    N, dx = int(z["N"]), float(z["dx"])
    dt, A = float(z["dt"]), float(z["A"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])
    L = N * dx
    domain = tgrid.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                          dtype=torch.float64)
    eq = TCH(domain, float(z["kappa"]), _mu_t, lambda c: 1.0 + 0.1 * c**2,
             derivs=derivs, use_rfft=False, device="cpu")
    solver = TSIF(**tprep(TSIF, {"A": A}, eq))
    u = torch.from_numpy(np.asarray(z["u0"], np.float64))
    traj = [u.numpy()]
    for _ in range(n_steps // save_every):
        u = tevolve(solver, eq.rhs, u, 0.0, dt, save_every)
        traj.append(u.numpy())
    np.testing.assert_allclose(np.stack(traj), z["traj"], rtol=0, atol=1e-10)


def test_solver_compat_contract():
    tcheck(TSIF, TCH)
    tcheck(TFused, TCH)

    class Bare:
        pass

    with pytest.raises(ValueError, match="fourier_symbol"):
        tcheck(TSIF, Bare)
    _, te = _equations("fd", True)
    params = tprep(TSIF, {"A": 0.5}, te)
    assert params["A"] == 0.5 and params["fourier_symbol"] is te.fourier_symbol


def test_pallas_derivs_not_ported():
    """``derivs="pallas"`` is the fused FD rhs (kernel K8 on the card, its
    plain version here): the equation's rhs equals JAX's ``rhs_pallas``
    (Pallas interpret mode), and the CH fleet built with it steps under both
    ``spectral_solve`` values as the JAX fleet does from the same numpy state
    and actions (the fft stepper calls the rhs every substep; the fused
    stepper never does).  The test keeps its name from when the option
    raised."""
    import jax

    from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState
    from pde_opt_tpu_torch.envs.presets import CH_D, CH_MU
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env as tpreset
    from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy

    box = ((-0.08, 0.08), (-0.12, 0.12))
    jd = jgrid.Domain((16, 24), box, dtype=jnp.float32)
    td = tgrid.Domain((16, 24), box)
    kap = np.linspace(2e-3, 8e-3, 3).reshape(3, 1, 1).astype(np.float32)
    je = JCH(jd, jnp.asarray(kap), _mu_j, lambda c: jnp.ones_like(c), derivs="pallas")
    te = TCH(td, torch.from_numpy(kap), CH_MU, CH_D, derivs="pallas")
    u = (0.5 + 0.05 * _field((3, 16, 24), seed=5)).astype(np.float32)
    ref = np.asarray(je.rhs(jnp.asarray(u), 0.0), np.float64)
    got = te.rhs(torch.from_numpy(u), 0.0).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    with pytest.raises(ValueError, match="Invalid"):
        TCH(td, 0.004, _mu_t, torch.ones_like, derivs="nope", device="cpu")

    B, H = 4, 16
    rng = np.random.default_rng(6)
    arrs = {"y": (0.5 + 0.05 * rng.standard_normal((B, H, H))).astype(np.float32),
            "t": np.zeros(B, np.float32),
            "control_value": rng.uniform(2e-3, 1e-2, B).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}
    actions = rng.uniform(-1, 1, (3, B, 1))
    # fft: f32 SIF on the fused rhs, free-running; fused (bf16 cas macro):
    # both envs restart from the JAX field each step (see test_torch_env.py).
    for solve, atol, resync in (("fft", 1e-5, False), ("fused", 1e-3, True)):
        kw = dict(num_envs=B, grid_size=H, substeps=10, spectral_solve=solve, derivs="pallas")
        jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
        js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                    control_value=jnp.asarray(arrs["control_value"]),
                    key=jax.random.split(jax.random.PRNGKey(0), B),
                    step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
        ts = env_state_from_numpy(arrs, "cpu")
        tenv.reset(torch.Generator().manual_seed(0))
        for a in actions:
            js, _, jr, jt, _, _ = jenv.step(js, jnp.asarray(a))
            ts, _, tr, tt, _, _ = tenv.step(ts, torch.from_numpy(a))
            np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=atol)
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            assert bool(torch.isfinite(tr).all())
            if resync:
                ts.y.copy_(torch.from_numpy(np.array(js.y)))


def test_fused_stepper_requires_unit_mobility():
    td = tgrid.Domain((16, 16), ((0, 1), (0, 1)))
    with pytest.raises(ValueError, match="unit mobility"):
        TFused(0.004, _mu_t, lambda c: 1.0 + c, td)
