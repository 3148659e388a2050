"""The port's Gross-Pitaevskii fleet (kernel K5's macro, the Strang
steppers, the model and preset) held against the JAX package.

On the CPU the port runs its plain-torch macro; the JAX macro runs its
Pallas kernel in interpret mode.  Same numpy inputs on both sides.
Tolerances (the JAX package's own where it has one):

    macro vs FFT oracle (f32)         atol 5e-6     (tests/test_gpe_cas.py)
    unit norm of every emitted state  rtol 1e-5
    macro vs JAX macro                f32 atol 5e-6; bf16 atol 5e-3
    kernel vs plain on the card       f32 atol 5e-6; bf16 atol 2e-2 (10 substeps)
    the same, bf16, after 1 substep   RMS <= 5e-5 (below the unrounded control)
    gradients vs JAX                  rtol 1e-4
    phase_poly vs exact cos/sin       atol 2e-6
    Strang golden (float64)           atol 1e-10
    epilogue stats                    rtol 1e-5 (f32), n_finite exact
    obs                               <= 1 LSB

With bf16 matrices two correct macros that accumulate in a different
order drift apart by whole bf16 roundings: the kinetic propagator is
unitary and damps none of that noise (the CH macro's implicit step does),
so the bf16 bound is the bf16 noise level of the macro itself (~4e-3 on a
field of peak ~0.4, the JAX package's measured budget).

Tests marked ``cuda`` hold kernel K5 against the plain version on the card
and skip without one (``pytest --noconftest -m cuda``).
"""

import os

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.presets import make_gpe_control_env as tpreset
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy, env_state_to_numpy
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.gpe_cas import (
    GpeEpilogue,
    gpe_constants,
    gpe_strang_fast_reference as tref,
    gpe_strang_macro_cuda,
    gpe_strang_macro_plain,
    make_gpe_strang_cas_macro as tmake,
)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL_Y = {"f32": 5e-6, "bf16": 5e-3}
# Kernel vs plain on the card at 10 substeps: the bf16 noise grows with the
# number of transforms (a 1e-7 relative input perturbation moves the bf16
# output by 6.7e-3 at 64^2 x 10).
TOL_CARD = {"f32": 5e-6, "bf16": 2e-2}
MATS = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def _jax():
    import jax.numpy as jnp

    from pde_opt_tpu.ops.gpe_cas import gpe_strang_fast_reference, make_gpe_strang_cas_macro

    return jnp, make_gpe_strang_cas_macro, gpe_strang_fast_reference


def _setup(B=4, N=32, L=16.0, seed=0):
    """The JAX test's condensate: a perturbed Gaussian in a harmonic trap
    with a Gaussian control spot."""
    dx = L / N
    x = np.linspace(-L / 2 + dx / 2, L / 2 - dx / 2, N)
    X, Y = np.meshgrid(x, x, indexing="ij")
    V = 0.5 * (X**2 + Y**2)
    rng = np.random.default_rng(seed)
    psi = np.exp(-(X**2 + Y**2) / 4.0)[None] * (1 + 0.05 * rng.standard_normal((B, N, N)))
    psi = psi / np.sqrt((psi**2).sum(axis=(1, 2), keepdims=True) * dx * dx)
    y0 = np.stack([psi, np.zeros_like(psi)], axis=-1).astype(np.float32)
    ctrl = np.ascontiguousarray(
        np.broadcast_to(2.0 * np.exp(-(X**2 + Y**2)), (B, N, N)), np.float32)
    w = np.exp(-(X**2 + Y**2)).astype(np.float32)
    return V, dx, y0, ctrl, w


def _norms(y, dx):
    return (y[..., 0] ** 2 + y[..., 1] ** 2).sum((-2, -1)) * dx * dx


def test_oracle_matches_jax():
    V, dx, y0, ctrl, _ = _setup()
    jnp, _, jref = _jax()
    j = jref(V, 100.0, dx, 1e-3, 5)(jnp.asarray(y0), jnp.asarray(ctrl))
    t = tref(V, 100.0, dx, 1e-3, 5)(torch.from_numpy(y0), torch.from_numpy(ctrl))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,n", [(4, 5), (5, 2)])
def test_macro_matches_oracle(B, n):
    V, dx, y0, ctrl, _ = _setup(B=B, seed=B)
    N = y0.shape[1]
    out = tmake(V, 100.0, N, N, dx, 1e-3, n, mats_dtype=torch.float32)(
        torch.from_numpy(y0), torch.from_numpy(ctrl))
    ref = tref(V, 100.0, dx, 1e-3, n)(torch.from_numpy(y0), torch.from_numpy(ctrl))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=5e-6)
    # every emitted state sits on the unit-norm manifold
    np.testing.assert_allclose(_norms(out, dx).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("ep", [False, True])
def test_macro_matches_jax(mats, poly, ep):
    V, dx, y0, ctrl, w = _setup(seed=10 + 2 * poly + ep)
    N = y0.shape[1]
    jnp, jmake, _ = _jax()
    kw = dict(phase_poly=poly)
    jep = tep = None
    if ep:
        jep = {"obs_scale": 2550.0, "weight": w}
        tep = {"obs_scale": 2550.0, "weight": torch.from_numpy(w)}
    jout = jmake(V, 100.0, N, N, dx, 1e-3, 5, mats_dtype=getattr(jnp, MATS[mats][0]),
                 epilogue=jep, **kw)(jnp.asarray(y0), jnp.asarray(ctrl))
    tout = tmake(V, 100.0, N, N, dx, 1e-3, 5, mats_dtype=MATS[mats][1], epilogue=tep,
                 **kw)(torch.from_numpy(y0), torch.from_numpy(ctrl))
    if not ep:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == y0.shape and tout[0].dtype == torch.float32
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=TOL_Y[mats])
    np.testing.assert_allclose(_norms(tout[0], dx).numpy(), 1.0, rtol=1e-5)
    if ep:
        st, obs = tout[1].numpy(), tout[2].numpy()
        assert obs.dtype == np.uint8 and obs.shape == (4, N, N)
        np.testing.assert_array_equal(st[:, 2], N * N)
        if mats == "f32":
            np.testing.assert_allclose(st, np.asarray(jout[1]), rtol=1e-5)
            assert np.abs(obs.astype(int) - np.asarray(jout[2]).astype(int)).max() <= 1
        # The epilogue against the macro's own final state, either way.
        rho = tout[0][..., 0] ** 2 + tout[0][..., 1] ** 2
        np.testing.assert_allclose(st[:, 1], rho.sum((-2, -1)).numpy(), rtol=1e-5)
        np.testing.assert_allclose(st[:, 0], (rho * torch.from_numpy(w)).sum((-2, -1)).numpy(),
                                   rtol=1e-5)
        want = torch.clamp(rho * 2550.0, 0, 255).to(torch.uint8)
        assert int((tout[2].int() - want.int()).abs().max()) <= 1


# Grids above 64², where the card runs the tiled K5: 128² (BASELINE config
# 5, bench.py's run_gpe128) and a non-square grid that is no multiple of 64.
# f32 matrices (tight), one case in bf16.  Its bound is the bf16 noise of the
# macro at 128² (CPU, 2 envs x 2 substeps): a 1e-7 relative input
# perturbation moves the bf16 output by 2.1e-3, the port's bf16 macro sits
# 3.7e-3 from its f32 one, and the port and the JAX macro differ by 2.0e-3
# to 7.2e-3 with the thread count of the CPU matmul (its summation order).
TOL_Y_BIG_BF16 = 1e-2
BIG_CASES = [(H, W, "f32", poly, ep) for H, W in [(128, 128), (96, 136)]
             for poly in (True, False) for ep in (False, True)]
BIG_CASES.append((128, 128, "bf16", True, True))


def _setup_hw(B, H, W, L=16.0, seed=0):
    """``_setup``'s condensate on an H x W grid of square cells dx = L / H."""
    dx = L / H
    x = (np.arange(H) + 0.5) * dx - H * dx / 2
    yv = (np.arange(W) + 0.5) * dx - W * dx / 2
    X, Y = np.meshgrid(x, yv, indexing="ij")
    rng = np.random.default_rng(seed)
    psi = np.exp(-(X**2 + Y**2) / 4.0)[None] * (1 + 0.05 * rng.standard_normal((B, H, W)))
    psi = psi / np.sqrt((psi**2).sum(axis=(1, 2), keepdims=True) * dx * dx)
    y0 = np.stack([psi, np.zeros_like(psi)], axis=-1).astype(np.float32)
    ctrl = np.ascontiguousarray(
        np.broadcast_to(2.0 * np.exp(-(X**2 + Y**2)), (B, H, W)), np.float32)
    return 0.5 * (X**2 + Y**2), dx, y0, ctrl, np.exp(-(X**2 + Y**2)).astype(np.float32)


@pytest.mark.parametrize("H,W,mats,poly,ep", BIG_CASES)
def test_macro_above_64_matches_jax(H, W, mats, poly, ep):
    """The plain K5 against the JAX macro in interpret mode, 2 envs x 2
    substeps: the state at TOL_Y (bf16: TOL_Y_BIG_BF16), every env at unit
    norm to rtol 1e-5; with f32 matrices the epilogue's stats to rtol 1e-5
    and obs within 1 LSB."""
    B, n = 2, 2
    V, dx, y0, ctrl, w = _setup_hw(B, H, W, seed=H + W + 2 * poly + ep)
    jnp, jmake, _ = _jax()
    jep = {"obs_scale": 2550.0, "weight": w} if ep else None
    tep = {"obs_scale": 2550.0, "weight": torch.from_numpy(w)} if ep else None
    jout = jmake(V, 100.0, H, W, dx, 1e-3, n, mats_dtype=getattr(jnp, MATS[mats][0]),
                 epilogue=jep, phase_poly=poly, interpret=True)(jnp.asarray(y0),
                                                                jnp.asarray(ctrl))
    tout = tmake(V, 100.0, H, W, dx, 1e-3, n, mats_dtype=MATS[mats][1], epilogue=tep,
                 phase_poly=poly)(torch.from_numpy(y0), torch.from_numpy(ctrl))
    if not ep:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == y0.shape and tout[0].dtype == torch.float32
    tol = TOL_Y_BIG_BF16 if mats == "bf16" else TOL_Y["f32"]
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=tol)
    np.testing.assert_allclose(_norms(tout[0], dx).numpy(), 1.0, rtol=1e-5)
    if ep:
        st, obs = tout[1].numpy(), tout[2].numpy()
        assert obs.dtype == np.uint8 and obs.shape == (B, H, W)
        np.testing.assert_array_equal(st[:, 2], H * W)
        if mats == "f32":
            np.testing.assert_allclose(st, np.asarray(jout[1]), rtol=1e-5)
            assert np.abs(obs.astype(int) - np.asarray(jout[2]).astype(int)).max() <= 1


@pytest.mark.parametrize("ep", [False, True])
def test_macro_grads_match_jax(ep):
    """Gradients through the macro (the checkpointed oracle's VJP, with the
    stats cotangent folded in for the epilogue) against ``jax.grad`` of the
    JAX macro.  The loss weighs the state with random signs: ``sum(y1**2)``
    (the JAX test's) is the constant norm, whose gradient is rounding noise."""
    import jax

    V, dx, y0, ctrl, w = _setup(seed=1)
    N = y0.shape[1]
    wt = np.random.default_rng(2).standard_normal(y0.shape).astype(np.float32)
    jnp, jmake, _ = _jax()
    jep = {"obs_scale": 2550.0, "weight": w} if ep else None
    tep = {"obs_scale": 2550.0, "weight": torch.from_numpy(w)} if ep else None
    jm = jmake(V, 100.0, N, N, dx, 1e-3, 3, mats_dtype=jnp.float32, epilogue=jep)
    tm = tmake(V, 100.0, N, N, dx, 1e-3, 3, mats_dtype=torch.float32, epilogue=tep)

    def jloss(yy, cc):
        o = jm(yy, cc)
        if not ep:
            return jnp.sum(jnp.asarray(wt) * o)
        return jnp.sum(jnp.asarray(wt) * o[0]) + 2.0 * jnp.sum(o[1][:, 0]) + jnp.sum(o[1][:, 1])

    gy_j, gc_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(ctrl))
    yt = torch.from_numpy(y0).requires_grad_()
    ct = torch.from_numpy(ctrl.copy()).requires_grad_()
    o = tm(yt, ct)
    wt_t = torch.from_numpy(wt)
    loss = ((wt_t * o).sum() if not ep
            else (wt_t * o[0]).sum() + 2.0 * o[1][:, 0].sum() + o[1][:, 1].sum())
    loss.backward()
    for got, want in ((yt.grad, gy_j), (ct.grad, gc_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_phase_poly_matches_exact_over_domain():
    """The degree-6/7 phase polynomials match cos/sin to f32 over the
    |theta| <= 0.7 domain (theta reaches ~0.5 here at 5x the usual dt)."""
    V, dx, y0, ctrl, _ = _setup(seed=3)
    N = y0.shape[1]
    args = (V, 100.0, N, N, dx, 5e-3, 3)
    poly = tmake(*args, mats_dtype=torch.float32, phase_poly=True)
    exact = tmake(*args, mats_dtype=torch.float32, phase_poly=False)
    y, c = torch.from_numpy(y0), torch.from_numpy(ctrl)
    np.testing.assert_allclose(poly(y, c).numpy(), exact(y, c).numpy(), rtol=0, atol=2e-6)


def test_strang_imaginary_time_trajectory_matches_golden():
    """``StrangSplitting.step`` at imaginary time against the float64 numpy
    golden of the reference's split step (tests/test_golden_parity.py)."""
    from pde_opt_tpu_torch.ops.integrate import evolve
    from pde_opt_tpu_torch.ops.spectral import make_fft_pair
    from pde_opt_tpu_torch.ops.steppers import StrangSplitting

    z = np.load(os.path.join(GOLDENS, "gpe_strang_imag.npz"))
    dx, dt = float(z["dx"]), float(z["dt"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])
    V = torch.from_numpy(z["V"]).double()
    g = float(z["g"])
    fft, ifft = make_fft_pair(2)
    solver = StrangSplitting(A_term=torch.from_numpy(z["A_term"]), dx=dx, fft=fft,
                             ifft=ifft, time_scale=-1j)

    def rhs(y, t):
        b = -(V + g * (y[..., 0] ** 2 + y[..., 1] ** 2))
        return torch.stack([torch.zeros_like(b), b], dim=-1)

    psi0 = z["psi0"]
    y = torch.stack([torch.from_numpy(psi0.real.copy()), torch.from_numpy(psi0.imag.copy())], -1)
    traj = [psi0]
    for _ in range(n_steps // save_every):
        y = evolve(solver, rhs, y, 0.0, dt, save_every)
        traj.append((y[..., 0] + 1j * y[..., 1]).numpy())
    assert y.dtype == torch.float64
    np.testing.assert_allclose(np.stack(traj), z["traj"], rtol=0, atol=1e-10)


def _gpe_eq(N=32, L=16.0, dtype=torch.float32):
    from pde_opt_tpu_torch.models.gross_pitaevskii import GPE2DTSControl

    domain = tgrid.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)), dtype=dtype)
    return GPE2DTSControl(domain, k=50.0, e=0.0, lights=lambda t, x, y: 0.0 * x,
                          kinetic=True, device="cpu")


def test_strang_fast_evolve_matches_per_step_physics():
    """Midpoint (merged-halves) Strang against per-step semantics: the same
    norm manifold and the same trajectory to splitting-error order."""
    from pde_opt_tpu_torch.ops.steppers import StrangSplitting
    from pde_opt_tpu_torch.utils.compat import prepare_solver_params

    eq = _gpe_eq()
    base = prepare_solver_params(StrangSplitting, {"time_scale": 1.0}, eq)
    slow, fast = StrangSplitting(**base), StrangSplitting(**{**base, "fast_evolve": True})
    X, Y = eq.xmesh, eq.ymesh
    dx = float(eq.dx)
    psi = torch.exp(-(X**2 + Y**2) / 4.0)
    psi = psi / torch.sqrt((psi**2).sum() * dx * dx)
    y0 = torch.stack([psi, torch.zeros_like(psi)], -1)
    y_slow = slow.evolve(eq.rhs, y0, 0.0, 5e-4, 20)
    y_fast = fast.evolve(eq.rhs, y0, 0.0, 5e-4, 20)
    for y in (y_slow, y_fast):
        np.testing.assert_allclose(float(_norms(y, dx)), 1.0, rtol=1e-4)
    assert float((y_fast - y_slow).abs().max()) < 0.02 * float(y_slow.abs().max())


@pytest.mark.parametrize("fast", [False, True])
def test_strang_and_model_match_jax(fast):
    """The model's B term and A symbol and both Strang evolves against the
    JAX package on the same state and control."""
    import jax.numpy as jnp

    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.gross_pitaevskii import GPE2DTSControl as JGPE
    from pde_opt_tpu.ops.steppers import StrangSplitting as JStrang
    from pde_opt_tpu.utils.compat import prepare_solver_params as jprep
    from pde_opt_tpu_torch.models.gross_pitaevskii import GPE2DTSControl
    from pde_opt_tpu_torch.ops.steppers import StrangSplitting
    from pde_opt_tpu_torch.utils.compat import prepare_solver_params

    _, _, y0, _, w = _setup(B=3, seed=4)
    inten = np.array([0.0, 2.0, 5.0], np.float32)
    box = ((-8.0, 8.0), (-8.0, 8.0))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jeq = JGPE(JDomain((32, 32), box), k=100.0, e=0.1, kinetic=True,
               lights=lambda t, x, y: jnp.asarray(inten)[:, None, None] * jw)
    teq = GPE2DTSControl(tgrid.Domain((32, 32), box), k=100.0, e=0.1, kinetic=True,
                         lights=lambda t, x, y: torch.from_numpy(inten)[:, None, None] * tw,
                         device="cpu")
    np.testing.assert_allclose(teq.rhs(torch.from_numpy(y0), 0.0).numpy(),
                               np.asarray(jeq.rhs(jnp.asarray(y0), 0.0)), rtol=0, atol=2e-4)
    np.testing.assert_allclose(teq.A_term.numpy(), np.asarray(jeq.A_term), rtol=1e-6)
    params = {"time_scale": 1.0, "fast_evolve": fast}
    jst = JStrang(**jprep(JStrang, params, jeq))
    tst = StrangSplitting(**prepare_solver_params(StrangSplitting, params, teq))
    j1 = jst.evolve(jeq.rhs, jnp.asarray(y0), 0.0, 1e-3, 4)
    t1 = tst.evolve(teq.rhs, torch.from_numpy(y0), 0.0, 1e-3, 4)
    assert t1.dtype == torch.float32 and t1.shape == y0.shape
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=0, atol=1e-5)


def test_env_norm_preserved_and_control_matters():
    env = tpreset(device="cpu", num_envs=4, grid_size=32, substeps=3)
    gen = torch.Generator().manual_seed(2)
    state, obs = env.reset(gen)
    assert state.y.shape == (4, 32, 32, 2) and obs.shape == (4, 1, 32, 32)
    dx = float(env.domain.dx[0])
    np.testing.assert_allclose(_norms(state.y, dx).numpy(), 1.0, rtol=1e-5)
    y0 = state.y.clone()
    s_off, *_ = env.step(state, torch.zeros(4, 1))
    y_off = s_off.y.clone()
    state_b, _ = env.reset(torch.Generator().manual_seed(2))
    torch.testing.assert_close(state_b.y, y0, rtol=0, atol=0)
    s_on, *_ = env.step(state_b, torch.ones(4, 1))
    assert bool(torch.isfinite(y_off).all()) and bool(torch.isfinite(s_on.y).all())
    np.testing.assert_allclose(_norms(y_off, dx).numpy(), 1.0, rtol=1e-4)
    assert float((s_on.y - y_off).abs().max()) > 1e-6


def test_env_rollout_and_reward_signal():
    env = tpreset(device="cpu", num_envs=4, grid_size=32, substeps=2)
    gen = torch.Generator().manual_seed(3)
    state, _ = env.reset(gen)
    state, rewards, terms = env.rollout(state, lambda obs, g: env.sample_actions(g), 10, gen)
    assert rewards.shape == (10, 4)
    assert bool(torch.isfinite(rewards).all())
    # reward = -density inside the spot: negative for a centered condensate.
    assert float(rewards.max()) < 0.0


def test_fused_env_matches_fft_env():
    kw = dict(num_envs=4, grid_size=32, substeps=3)
    env_f = tpreset(device="cpu", spectral_solve="fused", **kw)
    env_x = tpreset(device="cpu", spectral_solve="fft", **kw)
    assert env_x.fused_epilogue is None
    sf, _ = env_f.reset(torch.Generator().manual_seed(9))
    sx, _ = env_x.reset(torch.Generator().manual_seed(9))
    torch.testing.assert_close(sf.y, sx.y, rtol=0, atol=0)
    a = torch.full((4, 1), 0.5)
    sf2, *_ = env_f.step(sf, a)
    sx2, *_ = env_x.step(sx, a)
    # bf16 transform operands: the JAX package's budget for this comparison.
    assert float((sf2.y - sx2.y).abs().max()) < 2e-2 * float(sx2.y.abs().max())
    with pytest.raises(ValueError, match="requires spectral_solve='fused'"):
        tpreset(device="cpu", spectral_solve="fft", fused_epilogue=True, **kw)


def test_env_step_parity_epilogue_vs_plain():
    kw = dict(num_envs=8, grid_size=16, substeps=4, spectral_solve="fused")
    env_e = tpreset(device="cpu", **kw, fused_epilogue=True)
    env_0 = tpreset(device="cpu", **kw, fused_epilogue=False)
    assert env_e.fused_epilogue["n_px"] == 16 * 16
    se, oe = env_e.reset(torch.Generator().manual_seed(21))
    s0, o0 = env_0.reset(torch.Generator().manual_seed(21))
    assert torch.equal(oe, o0)
    gen = torch.Generator().manual_seed(400)
    for _ in range(3):
        a = env_e.sample_actions(gen)
        se, oe, re, te, _, ie = env_e.step(se, a)
        s0, o0, r0, t0, _, i0 = env_0.step(s0, a)
        assert torch.equal(se.y, s0.y)
        assert int((oe.int() - o0.int()).abs().max()) <= 1
        assert torch.equal(te, t0) and torch.equal(ie["diverged"], i0["diverged"])
        assert not bool(ie["diverged"].any())
        assert float(((re - r0).abs() / (r0.abs() + 1e-12)).max()) < 1e-5


def test_epilogue_grad_flows_to_the_action():
    """Pathwise gradient through the epilogue env step with respect to the
    action (the JAX test's contract)."""
    env = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=2, fused_epilogue=True)
    state, _ = env.reset(torch.Generator().manual_seed(22))
    scale = torch.tensor(0.5, requires_grad=True)
    _, _, reward, *_ = env.step(state, scale * torch.ones(4, 1))
    reward.sum().backward()
    assert bool(torch.isfinite(scale.grad)) and float(scale.grad.abs()) > 0.0


def test_epilogue_multidim_batch_grads_match_flat():
    H, L = 16, 8.0
    dx = L / H
    ax = (np.arange(H) - H / 2) * dx
    X, Y = np.meshgrid(ax, ax, indexing="ij")
    V = 0.5 * (X**2 + Y**2)
    w = torch.from_numpy(np.exp(-(X**2 + Y**2)).astype(np.float32))
    mep = tmake(V, 10.0, H, H, dx, 1e-3, 2, mats_dtype=torch.float32,
                epilogue={"obs_scale": 2550.0, "weight": w})
    psi = np.exp(-(X**2 + Y**2) / 4.0)
    psi = psi / np.sqrt((psi**2).sum() * dx * dx)
    y0 = torch.from_numpy((np.stack([psi, 0.01 * psi], axis=-1)[None]
                           * (1.0 + 0.02 * np.random.default_rng(8).standard_normal((6, 1, 1, 1))))
                          .astype(np.float32))

    def grad(yy):
        yy = yy.clone().requires_grad_()
        y1, s, _ = mep(yy, torch.zeros(yy.shape[:-3] + (1, 1)))
        ((y1**2).sum() + 2.0 * s[..., 0].sum() + s[..., 1].sum()).backward()
        return yy.grad

    torch.testing.assert_close(grad(y0.reshape(2, 3, H, H, 2)).reshape(6, H, H, 2), grad(y0),
                               rtol=0, atol=0)


def _np_state(B, H, seed, dx):
    rng = np.random.default_rng(seed)
    x = (np.arange(H) + 0.5) * dx - H * dx / 2
    X, Y = np.meshgrid(x, x, indexing="ij")
    psi = np.exp(-(X**2 + Y**2) / 4.0)[None] * (1 + 0.02 * rng.standard_normal((B, H, H)))
    psi = psi / np.sqrt((psi**2).sum((-2, -1), keepdims=True) * dx * dx)
    return {"y": np.stack([psi, np.zeros_like(psi)], -1).astype(np.float32),
            "t": np.zeros(B, np.float32),
            "control_value": rng.uniform(0.0, 20.0, B).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}


@pytest.mark.parametrize("solve,atol", [("fused", 5e-6), ("fft", 1e-5)])
def test_env_step_matches_jax(solve, atol):
    """Same (B, H, W, 2) state and (B,) intensity through both packages'
    GPE fleets, via ``env_state_from_numpy``; the fused path with f32
    matrices on both sides."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs.presets import make_gpe_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState

    B, H = 4, 32
    kw = dict(num_envs=B, grid_size=H, substeps=3, spectral_solve=solve)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    if solve == "fused":
        jenv.solver_parameters = {"mats_dtype": jnp.float32}
        tenv.solver_parameters = {"mats_dtype": torch.float32}
    arrs = _np_state(B, H, 5, float(tenv.domain.dx[0]))
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), B),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    ts = env_state_from_numpy(arrs, "cpu")
    assert ts.y.shape == (B, H, H, 2) and ts.control_value.shape == (B,)
    tenv.reset(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    for _ in range(2):
        a = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
        js, jo, jr, jt, _, ji = jenv.step(js, jnp.asarray(a))
        ts, to, tr, tt, _, ti = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=atol)
        assert to.shape == (B, 1, H, H)
        assert np.abs(to.numpy().astype(int) - np.asarray(jo).astype(int)).max() <= 1
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti["diverged"].numpy(), np.asarray(ji["diverged"]))
        np.testing.assert_array_equal(ts.control_value.numpy(), np.asarray(js.control_value))


def test_env_step_at_128_matches_jax():
    """One step of the preset at grid_size=128 (BASELINE config 5's grid),
    2 envs x 10 substeps, from the same numpy state and action as the JAX
    preset, the fused macro with f32 matrices on both sides (as
    ``test_env_step_matches_jax``): state to 5e-6, every env at unit norm
    (sum(rho) dx^2 = 1 to rtol 1e-5), obs within 1 LSB, reward to rtol
    1e-5."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs.presets import make_gpe_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState

    B, H = 2, 128
    kw = dict(num_envs=B, grid_size=H)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    jenv.solver_parameters = {"mats_dtype": jnp.float32}
    tenv.solver_parameters = {"mats_dtype": torch.float32}
    dx = float(tenv.domain.dx[0])
    arrs = _np_state(B, H, 7, dx)
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), B),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    ts = env_state_from_numpy(arrs, "cpu")
    tenv.reset(torch.Generator().manual_seed(0))
    a = np.random.default_rng(8).uniform(-1, 1, (B, 1)).astype(np.float32)
    js, jo, jr, jt, _, _ = jenv.step(js, jnp.asarray(a))
    ts, to, tr, tt, _, _ = tenv.step(ts, torch.from_numpy(a))
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=TOL_Y["f32"])
    np.testing.assert_allclose(_norms(ts.y, dx).numpy(), 1.0, rtol=1e-5)
    assert to.shape == (B, 1, H, H)
    assert np.abs(to.numpy().astype(int) - np.asarray(jo).astype(int)).max() <= 1
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_env_state_round_trip():
    import jax

    from pde_opt_tpu.envs.presets import make_gpe_control_env as jpreset

    js, _ = jpreset(num_envs=3, grid_size=16, substeps=2).reset(jax.random.PRNGKey(5))
    ts = env_state_from_numpy(js, "cpu")
    back = env_state_to_numpy(ts)
    for f in ("y", "t", "control_value", "step_count", "done"):
        a = np.asarray(getattr(js, f))
        assert back[f].dtype == a.dtype and back[f].shape == a.shape
        np.testing.assert_array_equal(back[f], a)


def test_poisoned_env_is_flagged_and_reset():
    env = tpreset(device="cpu", num_envs=4, grid_size=16, substeps=2)
    gen = torch.Generator().manual_seed(6)
    state, _ = env.reset(gen)
    state.y[1] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    assert bool(info["diverged"][1]) and int(info["diverged"].sum()) == 1
    assert bool(terminated[1]) and float(reward[1]) == 0.0
    assert bool(torch.isfinite(state.y).all()) and int(state.step_count[1]) == 0
    np.testing.assert_allclose(_norms(state.y, float(env.domain.dx[0])).numpy(), 1.0, rtol=1e-4)


def test_initialization_matches_jax():
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.utils import initialization as jinit
    from pde_opt_tpu_torch.utils import initialization as tinit

    for vn in (0, 2):
        np.testing.assert_allclose(tinit.initialize_Psi(16, 4.0, vn, device="cpu").numpy(),
                                   np.asarray(jinit.initialize_Psi(16, 4.0, vn)), atol=1e-6)
    psi = tinit.initialize_Psi(16, 4.0, device="cpu")
    np.testing.assert_allclose(
        tinit.add_vortex_to_wavefunction(psi, (5, 9), 1, 2.0).numpy(),
        np.asarray(jinit.add_vortex_to_wavefunction(jnp.asarray(psi.numpy()), (5, 9), 1, 2.0)),
        atol=1e-6)
    for axis in (0, 1):
        np.testing.assert_array_equal(tinit.step_interface((6, 8), axis, device="cpu").numpy(),
                                      np.asarray(jinit.step_interface((6, 8), axis)))
    f = tinit.random_uniform_field(torch.Generator().manual_seed(0), (64, 64))
    j = np.asarray(jinit.random_uniform_field(jax.random.PRNGKey(0), (64, 64)))
    assert f.shape == j.shape and float(f.min()) >= 0.0 and float(f.max()) <= 1.0
    assert abs(float(f.mean()) - 0.5) < 1e-3 and abs(float(f.std()) - 0.01) < 1e-3


def _cpu_args():
    V, dx, y0, ctrl, _ = _setup(B=2, N=16, seed=1)
    consts = gpe_constants(16, 16, dx, 1e-3, torch.float32, torch.device("cpu"))
    kw = dict(g=100.0, dt=1e-3, dx=dx, n_steps=2, round_bf16=False, phase_poly=True)
    return (torch.from_numpy(y0), torch.from_numpy(ctrl),
            torch.from_numpy(V.astype(np.float32)), consts, kw)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    y, c, V, consts, kw = _cpu_args()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gpe_strang_macro_cuda(y, c, V, consts, **kw)
    with pytest.raises(ValueError, match=r"\(B, H, W, 2\)"):
        gpe_strang_macro_cuda(y[..., 0], c, V, consts, **kw)
    with pytest.raises(ValueError, match="up to 256;"):
        gpe_strang_macro_cuda(torch.zeros(1, 264, 264, 2), c, V, consts, **kw)
    # The plain path and its gradient launch nothing.
    gpe_strang_macro_plain(y, c, V, consts, **kw)
    yt = y.clone().requires_grad_()
    tmake(V, 100.0, 16, 16, kw["dx"], 1e-3, 2)(yt, c).sum().backward()
    assert yt.grad is not None
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="trailing shape"):
        tmake(V, 100.0, 16, 16, kw["dx"], 1e-3, 2)(torch.zeros(2, 16, 16), c)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 64, 128])
@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("ep", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, N, mats, poly, ep):
    """K5 against the plain version: the field at the f32 / bf16-noise
    bounds, the norm at rtol 1e-5, and the epilogue against the kernel's own
    final state."""
    B, L = 300, 16.0
    V, dx, y0, ctrl, w = _setup(B=B, N=N, L=L, seed=N)
    dev = cuda_device
    y, c = torch.from_numpy(y0).to(dev), torch.from_numpy(ctrl).to(dev)
    Vt, wt = torch.from_numpy(V.astype(np.float32)).to(dev), torch.from_numpy(w).to(dev)
    tm = MATS[mats][1]
    consts = gpe_constants(N, N, dx, 2e-3, tm, dev)
    kw = dict(g=100.0, dt=2e-3, dx=dx, n_steps=10, round_bf16=tm == torch.bfloat16,
              phase_poly=poly, epilogue=GpeEpilogue(2550.0, wt) if ep else None)
    name = "gpe_strang_macro_ep" if ep else "gpe_strang_macro"
    before = kernels.launch_counts()[name]
    got = gpe_strang_macro_cuda(y, c, Vt, consts, **kw)
    want = gpe_strang_macro_plain(y, c, Vt, consts, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    if not ep:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_CARD[mats])
    torch.testing.assert_close(_norms(got[0], dx), torch.ones(B, device=dev), rtol=1e-5, atol=0)
    if ep:
        rho = got[0][..., 0] ** 2 + got[0][..., 1] ** 2
        torch.testing.assert_close(got[1][:, 0], (rho * wt).sum((-2, -1)), rtol=1e-5, atol=0)
        torch.testing.assert_close(got[1][:, 1], rho.sum((-2, -1)), rtol=1e-5, atol=0)
        assert bool((got[1][:, 2] == N * N).all())
        obs = torch.clamp(rho * 2550.0, 0, 255).to(torch.uint8)
        assert int((got[2].int() - obs.int()).abs().max()) <= 1


def _rms(d):
    return float(d.double().pow(2).mean().sqrt())


# The 2e-2 bound above catches a broken K5, not a misplaced rounding: after
# 10 substeps a kernel that rounds in the wrong places, or not at all, sits
# as far from the plain version as a correct one.  After ONE substep it
# does not: a bound on the RMS of kernel - plain over the fleet, below the
# same RMS of the unrounded plain version.
TOL_SITE = 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("poly", [True, False])
def test_kernel_rounds_where_plain_rounds_on_card(cuda_device, poly):
    B, N = 300, 64
    V, dx, y0, ctrl, _ = _setup(B=B, N=N, seed=7)
    dev = cuda_device
    y, c = torch.from_numpy(y0).to(dev), torch.from_numpy(ctrl).to(dev)
    Vt = torch.from_numpy(V.astype(np.float32)).to(dev)
    consts = gpe_constants(N, N, dx, 2e-3, torch.bfloat16, dev)
    kw = dict(g=100.0, dt=2e-3, dx=dx, n_steps=1, phase_poly=poly)
    want = gpe_strang_macro_plain(y, c, Vt, consts, round_bf16=True, **kw)
    got = _rms(gpe_strang_macro_cuda(y, c, Vt, consts, round_bf16=True, **kw) - want)
    control = _rms(gpe_strang_macro_plain(y, c, Vt, consts, round_bf16=False, **kw) - want)
    assert got <= TOL_SITE < control, (got, control)


@pytest.mark.cuda
def test_fused_env_on_card_matches_cpu(cuda_device):
    """The GPE env step on the card (kernel K5, f32 matrices) against the same
    step on the CPU (plain version), from the same state."""
    B, H = 64, 64
    envs = {d: tpreset(num_envs=B, grid_size=H, device=d) for d in ("cpu", cuda_device)}
    for d, env in envs.items():
        env.solver_parameters = {"mats_dtype": torch.float32}
        env.reset(torch.Generator(device=d).manual_seed(0))
    arrs = _np_state(B, H, 3, float(envs["cpu"].domain.dx[0]))
    rng = np.random.default_rng(4)
    for _ in range(3):
        a = torch.from_numpy(rng.uniform(-1, 1, (B, 1)).astype(np.float32))
        out = {d: env.step(env_state_from_numpy(arrs, d), a.to(d)) for d, env in envs.items()}
        (sc, oc, rc, tc, _, _), (sg, og, rg, tg, _, _) = out["cpu"], out[cuda_device]
        np.testing.assert_allclose(sg.y.cpu().numpy(), sc.y.numpy(), rtol=0, atol=TOL_Y["f32"])
        assert int((og.cpu().int() - oc.int()).abs().max()) <= 1
        np.testing.assert_allclose(rg.cpu().numpy(), rc.numpy(), rtol=1e-5)
        assert torch.equal(tg.cpu(), tc)
        arrs = env_state_to_numpy(sc)
