"""The port's rotating-frame GPE (``GPE2DTSRot``, ``DirectionalSplitting``,
the matmul ADI macro of ``ops/gpe_rot_fast.py``, ``FusedRotatingSplitting``,
the stirring fleet and the vortex census) held against the JAX package on
the same numpy inputs, and the JAX package's own rotating-GPE tests
mirrored: the non-slow cases of ``tests/test_gpe_rot.py:31-74``,
``tests/test_gpe_rot_fast.py:40-108`` and ``tests/test_gpe_rot_env.py:47-91``.
``tests/test_gpe_rot.py:75`` (no complex constants on the equation or the
stepper) guards a limit of one TPU runtime's eager complex path and has no
counterpart here: the port's equation holds complex symbols on purpose.

Tolerances:

    build_sweep_tensors vs JAX's (same numpy symbols)   atol 1e-7
    GPE2DTSRot terms, DirectionalSplitting (complex128)  atol 1e-12
    ADI macro (f32 matrices) vs JAX macro and oracle     atol 2e-5 (test_gpe_rot_fast.py)
    phase polynomials vs exp/cos/sin                     atol 5e-7 (test_gpe_rot_fast.py)
    vortex_winding, detect_vortices                      exactly equal
    preset obs                                           1 uint8 LSB
    preset rewards (f64, the same fields)                rtol 1e-9
    fused vs fft fleet (density, rewards)                5e-5, 1e-4 (test_gpe_rot_env.py)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_opt_tpu as jp
from pde_opt_tpu.envs import make_gpe_rot_control_env as jpreset
from pde_opt_tpu.ops import gpe_rot_fast as jfast
from pde_opt_tpu.ops.steppers import DirectionalSplitting as JDirectional
from pde_opt_tpu.utils import initialize_Psi as j_initialize_Psi
from pde_opt_tpu.utils import rl as jrl
from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs import make_gpe_rot_control_env as tpreset
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy, env_state_to_numpy
from pde_opt_tpu_torch.models.gross_pitaevskii import GPE2DTSControl, GPE2DTSRot
from pde_opt_tpu_torch.ops import gpe_rot_fast as tfast
from pde_opt_tpu_torch.ops.integrate import evolve
from pde_opt_tpu_torch.ops.steppers import (
    DirectionalSplitting,
    FusedRotatingSplitting,
    StrangSplitting,
)
from pde_opt_tpu_torch.utils import density, initialize_Psi
from pde_opt_tpu_torch.utils import rl as trl

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL_MACRO = 2e-5


def _domains(N, L, jdtype=jnp.float64, tdtype=torch.float64):
    box = ((-L / 2, L / 2), (-L / 2, L / 2))
    return jp.Domain((N, N), box, dtype=jdtype), tgrid.Domain((N, N), box, dtype=tdtype)


def _eqs(N, L, k, e, omega):
    jd, td = _domains(N, L)
    return jd, jp.GPE2DTSRot(jd, k, e, omega), td, GPE2DTSRot(td, k, e, omega, device=CPU)


def _psi0(N, width, vortexnumber, dx, dtype=np.complex64):
    """``initialize_Psi`` normalised to unit L² norm, as numpy."""
    psi = np.asarray(j_initialize_Psi(N, width=width, vortexnumber=vortexnumber)).astype(dtype)
    return psi / np.sqrt((np.abs(psi) ** 2).sum() * dx * dx)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---- the ADI sweep tensors ---------------------------------------------------

@pytest.mark.parametrize("H,W,dtype", [(24, 32, np.complex128), (32, 32, np.complex64)])
def test_build_sweep_tensors_matches_jax(H, W, dtype):
    rng = np.random.default_rng(0)
    Ax = (rng.standard_normal((H, W)) + 1j * rng.standard_normal((H, W))).astype(dtype)
    Ay = (rng.standard_normal((H, W)) + 1j * rng.standard_normal((H, W))).astype(dtype)
    for dt_c in (0.5e-3, -0.5e-3j, 1e-3 * (0.3 - 0.7j)):
        got = tfast.build_sweep_tensors(Ax, Ay, dt_c)
        want = jfast.build_sweep_tensors(Ax, Ay, dt_c)
        for g, w in ((g, w) for gp, wp in zip(got, want) for g, w in zip(gp, wp)):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)


def test_sweep_blocks_are_the_packed_propagators():
    """The x blocks (interleaved (k, re/im) order) and y blocks applied to a
    field in the macro's (H, 2, W, B) layout give the complex sweeps."""
    rng = np.random.default_rng(1)
    H, W, B = 6, 10, 3
    Ax = rng.standard_normal((H, W)) + 1j * rng.standard_normal((H, W))
    Ay = rng.standard_normal((H, W)) + 1j * rng.standard_normal((H, W))
    (mxr, mxi), (myr, myi) = tfast.build_sweep_tensors(Ax, Ay, 1e-2 * (1 - 1j))
    mx, my = mxr + 1j * mxi, myr + 1j * myi
    psi = rng.standard_normal((B, H, W)) + 1j * rng.standard_normal((B, H, W))
    lay = np.stack([psi.real, psi.imag], 1).transpose(2, 1, 3, 0)        # (H, 2, W, B)
    lines = lay.transpose(2, 0, 1, 3).reshape(W, 2 * H, B)               # [y, (x, c), b]
    got = np.einsum("ygh,yhb->ygb", tfast._x_blocks(mxr, mxi), lines)
    got = got.reshape(W, H, 2, B)
    want = np.einsum("ghy,bhy->bgy", mx, psi)
    np.testing.assert_allclose(got[:, :, 0].transpose(2, 1, 0), want.real, atol=1e-5)
    np.testing.assert_allclose(got[:, :, 1].transpose(2, 1, 0), want.imag, atol=1e-5)
    rows = lay.reshape(H, 2 * W, B)                                      # [x, (c, y), b]
    got = np.einsum("xgw,xwb->xgb", tfast._y_blocks(myr, myi), rows).reshape(H, 2, W, B)
    want = np.einsum("gwx,bxw->bxg", my, psi)
    np.testing.assert_allclose(got[:, 0].transpose(2, 0, 1), want.real, atol=1e-5)
    np.testing.assert_allclose(got[:, 1].transpose(2, 0, 1), want.imag, atol=1e-5)


# ---- the equation and the FFT stepper (complex128) ----------------------------

def test_gpe2dtsrot_terms_match_jax():
    jd, jeq, td, teq = _eqs(24, 12.0, 300.0, 0.1, 0.7)
    for a, b in zip(teq.A_terms(None, 0.0), jeq.A_terms(None, 0.0)):
        assert a.dtype == torch.complex128
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)
    rng = np.random.default_rng(2)
    psi = 0.1 * (rng.standard_normal((3, 24, 24)) + 1j * rng.standard_normal((3, 24, 24)))
    np.testing.assert_allclose(_np(teq.B_terms(_t(psi), 0.0)),
                               np.asarray(jeq.B_terms(jnp.asarray(psi), 0.0)), rtol=1e-12, atol=1e-12)
    amp = np.array([0.0, 1.5, 4.0])
    X, Y = jd.mesh()
    spot = np.exp(-((X - 2.0) ** 2 + Y**2))

    jl = jp.GPE2DTSRot(jd, 300.0, 0.1, 0.7,
                       lights=lambda t, x, y: jnp.asarray(amp)[:, None, None] * jnp.asarray(spot))
    tl = GPE2DTSRot(td, 300.0, 0.1, 0.7, device=CPU,
                    lights=lambda t, x, y: _t(amp)[:, None, None] * _t(spot))
    np.testing.assert_allclose(_np(tl.B_terms(_t(psi), 0.0)),
                               np.asarray(jl.B_terms(jnp.asarray(psi), 0.0)), rtol=1e-12, atol=1e-12)
    with pytest.raises(NotImplementedError):
        teq.rhs(_t(psi), 0.0)


def test_gpe2dtsrot_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPE2DTSRot(tgrid.Domain((8, 8), ((-1, 1), (-1, 1))), 1.0, 0.0, 0.5)


@pytest.mark.parametrize("time_scale,n_steps", [(1.0, 5), (-1j, 5), (-1j, 1)])
def test_directional_splitting_matches_jax(time_scale, n_steps):
    N = 32
    jd, jeq, td, teq = _eqs(N, 16.0, 200.0, 0.05, 0.6)
    psi0 = _psi0(N, 10, 1, jd.dx[0], np.complex128)
    batch = np.stack([psi0, 1j * psi0, psi0[::-1]])
    js = JDirectional(jeq.A_terms, jeq.B_terms, jd.dx[0], time_scale=time_scale)
    ts = DirectionalSplitting(teq.A_terms, teq.B_terms, td.dx[0], time_scale=time_scale)
    assert ts.normalize == js.normalize
    want = jp.evolve(js, lambda y, t: y, jnp.asarray(batch), 0.0, 1e-3, n_steps)
    got = evolve(ts, None, _t(batch), 0.0, 1e-3, n_steps)
    assert got.dtype == torch.complex128 and got.shape == (3, N, N)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-12)


# ---- mirrors of tests/test_gpe_rot.py:31-74 ------------------------------------

def _ground_state(td, teq, psi0, n_steps, dt=2e-4):
    stepper = DirectionalSplitting(teq.A_terms, teq.B_terms, td.dx[0], time_scale=-1j)
    return evolve(stepper, None, psi0, 0.0, dt, n_steps)


def _setup_rot(omega, N=64, L=20.0):
    td = tgrid.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)), dtype=torch.float64)
    teq = GPE2DTSRot(td, 500.0, 0.0, omega, device=CPU)
    psi0 = initialize_Psi(N, width=14, vortexnumber=0, device=CPU).to(torch.complex128)
    psi0 = psi0 / torch.sqrt(density(psi0).sum() * td.dx[0] ** 2)
    return td, teq, psi0


def test_nonrotating_ground_state_matches_isotropic_strang():
    """Ω = 0: the x/y-sweep splitting agrees with the isotropic kinetic split."""
    td, teq, psi0 = _setup_rot(0.0)
    psi_dir = _ground_state(td, teq, psi0, 4000)
    ctrl = GPE2DTSControl(td, teq.k, 0.0, lambda t, x, y: 0.0, trap_factor=1.0, kinetic=True,
                          device=CPU)
    strang = StrangSplitting(ctrl.A_term, td.dx[0], ctrl.fft, ctrl.ifft, -1j)
    yT = evolve(strang, ctrl.B_terms, torch.stack([psi0.real, psi0.imag], -1), 0.0, 2e-4, 4000)
    psi_strang = torch.complex(yT[..., 0], yT[..., 1])
    np.testing.assert_allclose(_np(density(psi_dir)), _np(density(psi_strang)),
                               rtol=1e-3, atol=1e-5)


def test_rotating_ground_state_normalized_and_finite():
    td, teq, psi0 = _setup_rot(0.3)
    psi = _ground_state(td, teq, psi0, 2000)
    assert bool(torch.isfinite(psi).all())
    np.testing.assert_allclose(float(density(psi).sum() * td.dx[0] ** 2), 1.0, rtol=1e-3)
    _, teq0, _ = _setup_rot(0.0)
    psi_0 = _ground_state(td, teq0, psi0, 2000)
    assert float((density(psi) - density(psi_0)).abs().max()) > 1e-6


def test_directional_split_batched():
    td, teq, psi0 = _setup_rot(0.2)
    batch = torch.stack([psi0, psi0 * np.exp(0.3j)])
    out = _ground_state(td, teq, batch, 50)
    assert out.shape == (2, 64, 64)
    single = _ground_state(td, teq, psi0, 50)
    np.testing.assert_allclose(_np(density(out[0])), _np(density(single)), rtol=1e-8, atol=1e-12)


# ---- the ADI macro against JAX's and the FFT oracle ------------------------

@pytest.mark.parametrize("N,n_steps,phase_poly,time_scale", [
    (32, 1, True, 1.0), (32, 6, True, 1.0), (32, 6, False, -1j), (32, 1, False, -1j),
    (64, 6, True, -1j), (64, 1, True, 1.0), (64, 6, False, 1.0),
])
def test_macro_matches_jax_and_oracle(N, n_steps, phase_poly, time_scale):
    jd, jeq, td, teq = _eqs(N, 16.0, 200.0, 0.05, 0.6)
    psi0 = _psi0(N, 10 * N / 32, 1, jd.dx[0])
    batch = np.stack([psi0, 1j * psi0, psi0[::-1]])
    jmacro = jfast.make_rot_adi_macro(jeq.A_terms, jeq.B_terms, jd.dx[0], N, N, 1e-3, n_steps,
                                      time_scale=time_scale, mats_dtype=jnp.float32,
                                      phase_poly=phase_poly)
    tmacro = tfast.make_rot_adi_macro(teq.A_terms, teq.B_terms, td.dx[0], N, N, 1e-3, n_steps,
                                      time_scale=time_scale, phase_poly=phase_poly)
    got = tmacro(_t(batch))
    assert got.dtype == torch.complex64 and got.shape == (3, N, N)
    want = np.asarray(jmacro(jnp.asarray(batch)))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL_MACRO)
    oracle = evolve(DirectionalSplitting(teq.A_terms, teq.B_terms, td.dx[0],
                                         time_scale=time_scale),
                    None, _t(batch).to(torch.complex128), 0.0, 1e-3, n_steps)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=0, atol=TOL_MACRO)


def test_macro_with_per_env_control_matches_jax():
    """B may close over a per-env control (the env hook)."""
    N = 32
    jd, jeq, td, teq = _eqs(N, 16.0, 200.0, 0.05, 0.3)
    psi0 = _psi0(N, 10, 1, jd.dx[0])
    batch = np.stack([psi0, psi0])
    X, Y = jd.mesh()
    spot = np.exp(-(X**2 + Y**2))
    amp = np.array([0.0, 5.0])

    def jb(psi, t):
        return jeq.B_terms(psi, t) - 1j * jnp.asarray(amp)[:, None, None] * jnp.asarray(spot)

    def tb(psi, t):
        return teq.B_terms(psi, t) - 1j * _t(amp)[:, None, None] * _t(spot)

    want = jax.jit(jfast.make_rot_adi_macro(jeq.A_terms, jb, jd.dx[0], N, N, 1e-3, 3,
                                            mats_dtype=jnp.float32))(jnp.asarray(batch))
    got = tfast.make_rot_adi_macro(teq.A_terms, tb, td.dx[0], N, N, 1e-3, 3)(_t(batch))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL_MACRO)
    oracle = evolve(DirectionalSplitting(teq.A_terms, tb, td.dx[0]), None,
                    _t(batch).to(torch.complex128), 0.0, 1e-3, 3)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=0, atol=TOL_MACRO)
    assert bool(torch.isfinite(got).all())
    assert float((got[0] - got[1]).abs().max()) > 1e-6


def test_macro_phase_poly_matches_hardware_transcendentals():
    """Degree-7 Taylor B phase vs exp/cos/sin, real and imaginary time."""
    N = 32
    _, _, td, teq = _eqs(N, 16.0, 200.0, 0.05, 0.6)
    psi0 = _t(_psi0(N, 10, 1, td.dx[0]))
    for ts in (1.0, -1j):
        a, b = (tfast.make_rot_adi_macro(teq.A_terms, teq.B_terms, td.dx[0], N, N, 1e-3, 5,
                                         time_scale=ts, phase_poly=p)(psi0) for p in (True, False))
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=5e-7)


def test_fused_stepper_matches_macro_and_caches_its_matrices():
    N = 32
    _, _, td, teq = _eqs(N, 16.0, 200.0, 0.05, 0.6)
    psi0 = _t(np.stack([_psi0(N, 10, 1, td.dx[0])] * 2))
    st = FusedRotatingSplitting(teq.A_terms, teq.B_terms, td.dx[0], time_scale=-1j)
    assert st.normalize
    out = evolve(st, None, psi0, 0.0, 1e-3, 4)
    want = tfast.make_rot_adi_macro(teq.A_terms, teq.B_terms, td.dx[0], N, N, 1e-3, 4,
                                    time_scale=-1j)(psi0)
    assert torch.equal(out, want)
    one, _ = st.step(None, psi0, 0.0, 1e-3)
    assert torch.equal(one, tfast.make_rot_adi_macro(
        teq.A_terms, teq.B_terms, td.dx[0], N, N, 1e-3, 1, time_scale=-1j)(psi0))
    # A rebuilt equation reads the same cached symbols, so the sweep matrices
    # are fetched, not rebuilt.
    teq2 = GPE2DTSRot(td, 200.0, 0.05, 0.6, device=CPU)
    assert teq2.A_terms(None, 0.0)[0] is teq.A_terms(None, 0.0)[0]
    m1 = tfast._sweep_mats(*teq.A_terms(None, 0.0), 1e-3, -1j, torch.float32, CPU)
    m2 = tfast._sweep_mats(*teq2.A_terms(None, 0.0), 1e-3, -1j, torch.float32, CPU)
    assert m1 is m2
    with pytest.raises(ValueError, match="mats_dtype"):
        tfast.make_rot_adi_macro(teq.A_terms, teq.B_terms, td.dx[0], N, N, 1e-3, 1,
                                 mats_dtype=torch.bfloat16)


# ---- the vortex census ----------------------------------------------------

def _census_fields():
    rng = np.random.default_rng(3)
    N = 24
    fields = [rng.standard_normal((2, N, N)) + 1j * rng.standard_normal((2, N, N))]
    vort = np.asarray(j_initialize_Psi(N, width=8, vortexnumber=1)).astype(np.complex128)
    anti = np.asarray(j_initialize_Psi(N, width=8, vortexnumber=-2)).astype(np.complex128)
    fields.append(np.stack([vort, anti, vort * np.roll(anti, 5, 0)]))
    # Real fields of both signs: link products on the branch cut at ±π,
    # with zero imaginary parts of either sign.
    re = rng.choice([-1.0, 1.0, -0.5, 2.0], size=(3, N, N))
    im = rng.choice([0.0, -0.0], size=(3, N, N))
    fields.append(re + 0j * re)
    return fields, re, im


@pytest.mark.parametrize("amp_thresh", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_vortex_winding_equals_jax(amp_thresh, dtype):
    fields, re, im = _census_fields()
    real = np.float32 if dtype == np.complex64 else np.float64
    cases = [(_t(f.astype(dtype)), jnp.asarray(f.astype(dtype))) for f in fields]
    cases.append((torch.complex(_t(re.astype(real)), _t(im.astype(real))),
                  jax.lax.complex(jnp.asarray(re.astype(real)), jnp.asarray(im.astype(real)))))
    for tpsi, jpsi in cases:
        got = _np(trl.vortex_winding(tpsi, amp_thresh=amp_thresh))
        want = np.asarray(jrl.vortex_winding(jpsi, amp_thresh=amp_thresh))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        for axis in (-1, -2):
            # The phases agree to rounding; on the branch cut (the real field)
            # exactly, ±π with the sign of the zero imaginary part.
            tl, jl = _np(trl._link_phase(tpsi, axis)), np.asarray(jrl._link_phase(jpsi, axis))
            on_cut = np.abs(np.abs(jl) - np.pi) < 1e-6
            np.testing.assert_array_equal(tl[on_cut], jl[on_cut])
            np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 if real == np.float32 else 1e-13)
    assert np.abs(_np(trl.vortex_winding(cases[1][0]))).sum() > 0


def test_detect_vortices_equals_jax():
    fields, _, _ = _census_fields()
    for f in fields[1]:
        got = trl.detect_vortices(_t(f), amp_thresh=0.05 * np.abs(f).max() ** 2)
        want = jrl.detect_vortices(jnp.asarray(f), amp_thresh=0.05 * np.abs(f).max() ** 2)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    np.testing.assert_allclose(_np(density(_t(fields[0]))), np.abs(fields[0]) ** 2, rtol=1e-14)


# ---- the stirring fleet ---------------------------------------------------

B, N, T = 16, 32, 8
ENV_KW = dict(num_envs=B, grid_size=N, substeps=4, end_time=0.32, step_dt=0.04, action_gain=2.5)


def _pair(solve, dtype=(jnp.float64, torch.float64), num_envs=4, **kw):
    kw = {**ENV_KW, "num_envs": num_envs, **kw}
    je = jpreset(spectral_solve=solve, dtype=dtype[0], **kw)
    te = tpreset(spectral_solve=solve, dtype=dtype[1], device=CPU, **kw)
    return je, te


@pytest.mark.parametrize("solve", ["fft", "fused"])
def test_preset_step_matches_jax_from_shared_states(solve):
    je, te = _pair(solve)
    js, jobs = je.reset(jax.random.PRNGKey(3))
    te.reset(torch.Generator().manual_seed(0))
    ts = env_state_from_numpy(js, device=CPU)
    assert ts.y.dtype == torch.complex128
    np.testing.assert_array_equal(_np(te.state_to_observation_func(ts.y)), np.asarray(jobs))
    acts = np.random.default_rng(4).uniform(-1, 1, (4, 4, 1))
    for a in acts:
        js, jo, jr, *_ = je.step(js, jnp.asarray(a))
        ts, to, tr, *_ = te.step(ts, _t(a))
        assert to.dtype == torch.uint8 and to.shape == (4, 1, N, N)
        assert np.abs(_np(to).astype(int) - np.asarray(jo).astype(int)).max() <= 1
        np.testing.assert_allclose(_np(ts.control_value), np.asarray(js.control_value),
                                   rtol=1e-12)
        if solve == "fft":
            np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), rtol=0, atol=1e-12)
            r = np.asarray(jr)
            np.testing.assert_allclose(_np(tr), r, rtol=1e-9, atol=1e-9 * np.abs(r).max())
        else:
            # Both fused steppers run f32 matrices.
            np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), rtol=0, atol=TOL_MACRO)
            np.testing.assert_allclose(_np(tr), np.asarray(jr), rtol=0, atol=1e-4)
        ts = env_state_from_numpy(js, device=CPU)


def test_preset_reward_matches_jax_on_the_same_fields():
    """The per-env reward (census at each env's own peak, plus L_z) in f64."""
    je, te = _pair("fused", num_envs=3)
    X, Y = je.domain.mesh()
    dx = je.domain.dx[0]
    psis = [_psi0(N, 10, 1, dx, np.complex128), _psi0(N, 8, -1, dx, np.complex128),
            np.asarray(je.reset_func(je.domain, jax.random.PRNGKey(1)))]
    fleet = np.stack([psis[0], 3.0 * psis[1], psis[2] * np.exp(1j * 0.4 * np.asarray(X))])
    want = np.asarray(jax.vmap(je.reward_function)(jnp.asarray(fleet)))
    got = _np(te.reward_function(_t(fleet)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def test_preset_fused_and_fft_paths_agree():
    """Mirror of test_gpe_rot_env.py::test_fused_and_fft_paths_agree: the same
    fleet and actions through both steppers."""
    outs = {}
    gen_state = None
    for solve in ("fused", "fft"):
        env = tpreset(spectral_solve=solve, device=CPU, **ENV_KW)
        state, _ = env.reset(torch.Generator().manual_seed(3))
        if gen_state is None:
            gen_state = env_state_to_numpy(state)
        state = env_state_from_numpy(gen_state, device=CPU)
        run = env.make_rollout(lambda o, g: torch.ones((B, 1)), 5)
        state, rewards, _ = run(state, torch.Generator().manual_seed(4))
        outs[solve] = (_np(density(state.y)), _np(rewards))
    np.testing.assert_allclose(outs["fused"][0], outs["fft"][0], rtol=0, atol=5e-5)
    np.testing.assert_allclose(outs["fused"][1], outs["fft"][1], rtol=0, atol=1e-4)


def _ep_return(env, policy, seed=5):
    state, _ = env.reset(torch.Generator().manual_seed(seed))
    _, rewards, _ = env.rollout(state, policy, T, generator=torch.Generator().manual_seed(seed + 100))
    return float(rewards.sum(0).mean())


def test_stirring_is_the_good_policy():
    """Mirror of test_gpe_rot_env.py::test_stirring_is_the_good_policy."""
    env = tpreset(device=CPU, **ENV_KW)
    up = _ep_return(env, lambda o, g: torch.ones((B, 1)))
    rnd = _ep_return(env, lambda o, g: 2.0 * torch.rand((B, 1), generator=g) - 1.0)
    assert up > rnd + 0.05, (up, rnd)


def test_vortex_census_rewards_vortices():
    """Mirror of test_gpe_rot_env.py::test_vortex_census_rewards_vortices."""
    env = tpreset(device=CPU, lz_weight=0.0, **{**ENV_KW, "action_gain": 1.0})
    dx = float(env.domain.dx[0])
    psi_v = _t(_psi0(N, 10, 1, dx))
    w = trl.vortex_winding(psi_v * torch.rsqrt(density(psi_v).max()), amp_thresh=0.05)
    assert int(w.abs().sum()) >= 1
    r_vortex = float(env.reward_function(psi_v[None])[0])
    r_flat = float(env.reward_function(env.reset_func(env.domain, torch.Generator().manual_seed(0), 1))[0])
    assert r_vortex > r_flat + 0.5


@pytest.mark.parametrize("solve", ["fused", "fft"])
def test_complex_state_through_auto_reset_and_divergence(solve):
    env = tpreset(spectral_solve=solve, device=CPU, **{**ENV_KW, "num_envs": 4, "end_time": 0.08})
    state, obs = env.reset(torch.Generator().manual_seed(7))
    assert state.y.dtype == torch.complex64 and obs.shape == (4, 1, N, N)
    arrays = env_state_to_numpy(state)
    assert arrays["y"].dtype == np.complex64 and np.abs(arrays["y"].imag).max() == 0.0
    state = env_state_from_numpy(arrays, device=CPU)
    state, *_ = env.step(state, torch.ones((4, 1)))
    assert float(state.y.imag.abs().max()) > 1e-4       # the imaginary part is carried
    state.y[2, 3, 3] = complex(0.0, float("nan"))        # a NaN in the imaginary part only
    before = state.y.clone()
    state, obs, reward, term, _, info = env.step(state, torch.ones((4, 1)))
    assert info["diverged"].tolist() == [False, False, True, False]
    assert term.all()                                     # t = 0.08 ends every episode
    assert reward[2] == 0.0 and bool(torch.isfinite(reward).all())
    assert bool(torch.isfinite(state.y).all())
    assert state.step_count.tolist() == [0] * 4 and float(state.t.abs().max()) == 0.0
    assert float(state.control_value.abs().max()) == 0.0
    norms = (density(state.y).sum((-2, -1)) * float(env.domain.dx[0]) ** 2)
    np.testing.assert_allclose(_np(norms), 1.0, rtol=1e-5)
    assert not torch.equal(state.y, before)
    assert info["final_observation"].shape == obs.shape


def test_preset_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpreset(num_envs=2, grid_size=16)
    with pytest.raises(ValueError, match="spectral_solve"):
        tpreset(num_envs=2, grid_size=16, spectral_solve="dense", device=CPU)
