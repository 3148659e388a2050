"""The port's fused cas macro (kernels K1/K2) held against the JAX package.

On the CPU the port runs its plain-torch version; the JAX macro runs its
Pallas kernel in interpret mode.  Same numpy inputs on both sides.
Tolerances, from the measured gaps plus headroom:

    output            f32 matrices     bf16 matrices
    u1                atol 1e-5        atol 1e-3
    stats n_finite    exact            exact
    stats s1, s2      rtol 1e-3        rtol 1e-3
    obs               <= 1 LSB         <= 1 LSB

Tests marked ``cuda`` hold the Hopper kernel against the plain version on
the card and skip without one.  The JAX reference is imported inside the
tests that use it, so the ``cuda`` tests also run where JAX is not
installed (``python -m pytest --noconftest -m cuda tests/test_torch_cas_macro.py``).
"""

import shutil

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.cas_spectral import (
    Epilogue,
    PolynomialMu,
    ac_cas_macro_cuda,
    cas_constants,
    ch_cas_macro_bwd_cuda,
    ch_cas_macro_cuda,
    ch_cas_macro_plain,
    make_ch_cas_fused_macro as tmake,
    make_ch_cas_fused_macro_ep as tmake_ep,
)
from pde_opt_tpu_torch.ops.fused_spectral import ch_sif_macro_reference as tref

torch.set_num_threads(1)

MU_T = PolynomialMu((0.0, -1.0, 0.0, 1.0))


def MU_J(c):
    return c**3 - c


HX = HY = 0.01
A, DT = 1.0, 1e-3
TOL_U = {"f32": 1e-5, "bf16": 1e-3}
# cas macro vs the FFT oracle: bf16 rounding is part of the macro, and the
# JAX kernel's own documented bf16 gap to the oracle is ~4e-3 after 10
# substeps (docs/performance.md, "bf16 matmul accuracy").
TOL_ORACLE = {"f32": 1e-5, "bf16": 5e-3}
MATS = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def _jax():
    """``(jax.numpy, make_ch_cas_fused_macro, ch_sif_macro_reference)`` of
    the JAX package."""
    import jax.numpy as jnp

    from pde_opt_tpu.ops.cas_spectral import make_ch_cas_fused_macro
    from pde_opt_tpu.ops.fused_spectral import ch_sif_macro_reference

    return jnp, make_ch_cas_fused_macro, ch_sif_macro_reference


def _inputs(B, H, seed=0, W=None):
    """Fields around 0.45 (so sum(u - 0.5) is far from 0 and a relative
    tolerance on it is meaningful) and κ across the env's control range;
    (B, H, W), W = H unless given."""
    rng = np.random.default_rng(seed)
    u = (0.45 + 0.05 * rng.standard_normal((B, H, W or H))).astype(np.float32)
    kap = rng.uniform(2e-3, 1e-2, B).astype(np.float32)
    return u, kap


def _assert_epilogue(st, so, jt, jo):
    np.testing.assert_array_equal(st[:, 2], np.asarray(jt)[:, 2])
    np.testing.assert_allclose(st[:, :2], np.asarray(jt)[:, :2], rtol=1e-3)
    d = np.abs(so.astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert d.max() <= 1


@pytest.mark.parametrize("H,n_steps,mats", [
    (16, 5, "f32"), (16, 10, "bf16"), (64, 10, "f32"), (64, 5, "bf16"),
])
def test_macro_matches_jax(H, n_steps, mats):
    B = 8
    u, kap = _inputs(B, H, seed=H + n_steps)
    jnp, jmake, _ = _jax()
    jm, tm = getattr(jnp, MATS[mats][0]), MATS[mats][1]
    ju = jmake(MU_J, H, H, HX, HY, A, DT, n_steps, mats_dtype=jm)(
        jnp.asarray(u), jnp.asarray(kap))
    tu = tmake(MU_T, H, H, HX, HY, A, DT, n_steps, mats_dtype=tm)(
        torch.from_numpy(u), torch.from_numpy(kap))
    assert tu.shape == (B, H, H) and tu.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=TOL_U[mats])


@pytest.mark.parametrize("H,n_steps,ds,mats", [
    (16, 5, 1, "f32"), (16, 10, 4, "bf16"), (64, 10, 1, "bf16"),
    (64, 10, 4, "f32"), (64, 5, 4, "bf16"),
])
def test_macro_epilogue_matches_jax(H, n_steps, ds, mats):
    B = 8
    u, kap = _inputs(B, H, seed=3 * H + n_steps + ds)
    jnp, jmake, _ = _jax()
    jm, tm = getattr(jnp, MATS[mats][0]), MATS[mats][1]
    ep = {"obs_downsample": ds, "stats_center": 0.5}
    ju, jstats, jobs = jmake(MU_J, H, H, HX, HY, A, DT, n_steps, mats_dtype=jm,
                             epilogue=ep)(jnp.asarray(u), jnp.asarray(kap))
    tu, tstats, tobs = tmake_ep(MU_T, H, H, HX, HY, A, DT, n_steps,
                                obs_downsample=ds, stats_center=0.5,
                                mats_dtype=tm)(torch.from_numpy(u), torch.from_numpy(kap))
    assert tstats.shape == (B, 3) and tobs.shape == (B, H // ds, H // ds)
    assert tobs.dtype == torch.uint8
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=TOL_U[mats])
    _assert_epilogue(tstats.numpy(), tobs.numpy(), jstats, jobs)


# Grids above 64², where the card runs the tiled kernels: 128² (the control
# fleet of bench.py's run_ch128 and the NN-control rollout), 256² (run_ch256)
# and a non-square grid that is no multiple of 64.
BIG = [(128, 128), (256, 256), (96, 136)]


@pytest.mark.parametrize("H,W", BIG)
@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("ds", [0, 1, 4])
def test_macro_above_64_matches_jax(H, W, mats, ds):
    """The plain macro (K2 without an epilogue, K1 with it at obs_downsample
    ds) against the JAX macro in interpret mode, 2 envs x 2 substeps."""
    B, n = 2, 2
    u, kap = _inputs(B, H, seed=H + W + ds, W=W)
    jnp, jmake, _ = _jax()
    jm, tm = getattr(jnp, MATS[mats][0]), MATS[mats][1]
    ep = {"obs_downsample": ds, "stats_center": 0.5} if ds else None
    jout = jmake(MU_J, H, W, HX, HY, A, DT, n, mats_dtype=jm, epilogue=ep, interpret=True)(
        jnp.asarray(u), jnp.asarray(kap))
    tout = tmake(MU_T, H, W, HX, HY, A, DT, n, mats_dtype=tm, epilogue=ep)(
        torch.from_numpy(u), torch.from_numpy(kap))
    if ep is None:
        jout, tout = (jout,), (tout,)
    assert tout[0].shape == (B, H, W) and tout[0].dtype == torch.float32
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=TOL_U[mats])
    if ep is not None:
        assert tout[2].shape == (B, H // ds, W // ds) and tout[2].dtype == torch.uint8
        _assert_epilogue(tout[1].numpy(), tout[2].numpy(), jout[1], jout[2])


def test_cas_matrices_are_symmetric():
    """The tiled tensor-core kernels read C^T as C: every cas matrix and
    inverse pair that cas_constants builds is exactly symmetric, in f32 and,
    with bf16 matrices, in its bf16 copy (an exact copy); f32 matrices have
    no bf16 copy."""
    for H, W in [(16, 24), (96, 136), (128, 128), (256, 256)]:
        for mdt in (torch.float32, torch.bfloat16):
            c = cas_constants(H, W, HX, HY, mdt, torch.device("cpu"))
            for name in ("ch", "cw", "ich", "icw"):
                m, m16 = getattr(c, name), getattr(c, name + "16")
                assert torch.equal(m, m.T)
                if mdt == torch.float32:
                    assert m16 is None
                    continue
                assert torch.equal(m16, m16.T)
                assert m16.dtype == torch.bfloat16 and torch.equal(m16.float(), m)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_macro_matches_fft_oracles(mats):
    """The cas macro against the FFT oracle, the port's and the JAX one."""
    B, H, n = 8, 64, 10
    u, kap = _inputs(B, H, seed=11)
    jnp, _, jref = _jax()
    tu = tmake(MU_T, H, H, HX, HY, A, DT, n, mats_dtype=MATS[mats][1])(
        torch.from_numpy(u), torch.from_numpy(kap))
    t_or = tref(MU_T, HX, HY, A, DT, n)(torch.from_numpy(u), torch.from_numpy(kap))
    j_or = jref(MU_J, HX, HY, A, DT, n)(jnp.asarray(u), jnp.asarray(kap))
    np.testing.assert_allclose(t_or.numpy(), np.asarray(j_or), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tu.numpy(), t_or.numpy(), rtol=0, atol=TOL_ORACLE[mats])


def test_macro_kappa_and_batch_shapes():
    u, kap = _inputs(6, 16, seed=5)
    m = tmake(MU_T, 16, 16, HX, HY, A, DT, 3, mats_dtype=torch.float32)
    flat = m(torch.from_numpy(u), torch.from_numpy(kap))
    batched = m(torch.from_numpy(u).reshape(2, 3, 16, 16),
                torch.from_numpy(kap).reshape(2, 3, 1, 1))
    torch.testing.assert_close(batched.reshape(6, 16, 16), flat, rtol=0, atol=0)
    scalar = m(torch.from_numpy(u), 0.004)
    per_env = m(torch.from_numpy(u), torch.full((6,), 0.004))
    torch.testing.assert_close(scalar, per_env, rtol=0, atol=0)
    with pytest.raises(ValueError, match="trailing shape"):
        m(torch.zeros(2, 8, 8), 0.004)
    with pytest.raises(ValueError, match="multiples of 8"):
        tmake(MU_T, 12, 16, HX, HY, A, DT, 3)
    with pytest.raises(ValueError, match="must divide"):
        tmake_ep(MU_T, 16, 16, HX, HY, A, DT, 3, obs_downsample=3)


def test_poisoned_env_is_flagged():
    B, H = 4, 16
    u, kap = _inputs(B, H, seed=7)
    u[2] = np.nan
    tu, stats, obs = tmake_ep(MU_T, H, H, HX, HY, A, DT, 5, stats_center=0.5)(
        torch.from_numpy(u), torch.from_numpy(kap))
    assert stats[2, 2] < H * H
    assert bool(torch.isfinite(stats).all())
    # The per-env macro does not spread NaN to other envs.
    np.testing.assert_array_equal(stats[[0, 1, 3], 2].numpy(), H * H)
    assert int(obs[2].max()) == 0


def test_polynomial_mu():
    c = torch.linspace(-2, 2, 9, dtype=torch.float64)
    torch.testing.assert_close(MU_T(c), c**3 - c)
    assert MU_T == PolynomialMu([0, -1, 0, 1]) and hash(MU_T) == hash(PolynomialMu((0, -1, 0, 1)))
    PolynomialMu(range(8))
    with pytest.raises(ValueError, match="1 to 8"):
        PolynomialMu(range(9))
    with pytest.raises(ValueError, match="1 to 8"):
        PolynomialMu(())


def test_plain_macro_is_differentiable_on_cpu():
    u, kap = _inputs(2, 16, seed=9)
    ut = torch.from_numpy(u).double().requires_grad_()
    m = tmake(MU_T, 16, 16, HX, HY, A, DT, 2, mats_dtype=torch.float32)
    m(ut, torch.from_numpy(kap)).square().sum().backward()
    assert ut.grad is not None and bool(torch.isfinite(ut.grad).all())


def _cpu_args():
    u, kap = _inputs(2, 16, seed=1)
    consts = cas_constants(16, 16, HX, HY, torch.float32, torch.device("cpu"))
    kw = dict(mu_fn=MU_T, dt=DT, A=A, n_steps=2, round_bf16=False)
    return torch.from_numpy(u), torch.from_numpy(kap), consts, kw


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    u, kap, consts, kw = _cpu_args()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ch_cas_macro_cuda(u, kap, consts, **kw)
    with pytest.raises(ValueError, match="PolynomialMu"):
        ch_cas_macro_cuda(u, kap, consts, **{**kw, "mu_fn": MU_J})
    # The CH forward and K3 take grids up to 256² (tiled above 64²).
    with pytest.raises(ValueError, match="up to 256;"):
        ch_cas_macro_cuda(torch.zeros(2, 264, 264), kap, consts, **kw)
    with pytest.raises(ValueError, match="up to 256;"):
        ch_cas_macro_bwd_cuda(torch.zeros(2, 264, 264), kap, torch.zeros(2, 264, 264),
                              consts, **kw)
    # A gradient through the macro on CPU tensors runs the plain backward:
    # it launches no kernel, K3 included.
    ut, kt = u.clone().requires_grad_(), kap.clone().requires_grad_()
    tmake(MU_T, 16, 16, HX, HY, A, DT, 2, mats_dtype=torch.float32)(ut, kt).sum().backward()
    assert ut.grad is not None and kt.grad is not None
    assert kernels.launch_counts() == before


def _other_family_launch(family, N):
    """A launch of another family's CUDA wrapper on an N² state (CPU
    tensors; the grid check comes first)."""
    from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU
    from pde_opt_tpu_torch.ops.bv_cas import bv_cc_macro_cuda
    from pde_opt_tpu_torch.ops.fused_spectral import ac_sif_macro_cuda, ch_sif_macro_cuda
    from pde_opt_tpu_torch.ops.gpe_cas import gpe_strang_macro_cuda
    from pde_opt_tpu_torch.ops.sbm_bv import sbm_bv_macro_cuda

    u, k = torch.zeros(2, N, N), torch.zeros(2)
    if family == "ac":
        return ac_cas_macro_cuda(u, k, None, mu_fn=MU_T, R_fn=None, r_identity=True, dt=DT,
                                 A=A, n_steps=1, round_bf16=True)
    if family == "gpe":
        return gpe_strang_macro_cuda(torch.zeros(2, N, N, 2), u, u[0], None, g=1.0, dt=DT,
                                     dx=0.1, n_steps=1, round_bf16=True, phase_poly=True)
    if family == "bv":
        return bv_cc_macro_cuda(u, k, None, mu_fn=BV_MU, j0_fn=BV_J0, kappa=5e-4, cell=1e-4,
                                dt=DT, n_steps=1, round_bf16=True)
    if family == "sbm":
        return sbm_bv_macro_cuda(u, k, None, mu_fn=BV_MU, j0_fn=BV_J0, dt=DT, n_steps=1)
    if family == "ch_dft":
        return ch_sif_macro_cuda(u, k, None, mu_fn=MU_T, dt=DT, A=A, n_steps=1, round_bf16=True)
    return ac_sif_macro_cuda(u, k, None, mu_fn=MU_T, R_fn=None, r_identity=True, hx=HX, hy=HY,
                             dt=DT, A=A, n_steps=1, round_bf16=True)


@pytest.mark.parametrize("family", ["ac", "gpe", "bv", "sbm", "ch_dft", "ac_dft"])
def test_other_families_refuse_grids_above_64(family):
    """Every family runs tiled kernels above 64², up to 256², as the CH
    macros do: K4 (AC), K5 (GPE), K6 (BV), K7 (SBM) and K9a/K9b
    (algo="dft").  A 264² state raises, before any launch (no fallback to
    the plain version)."""
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="up to 256"):
        _other_family_launch(family, 264)
    assert kernels.launch_counts() == before


def test_plain_path_counts_no_launch():
    u, kap, consts, kw = _cpu_args()
    before = kernels.launch_counts()
    ch_cas_macro_plain(u, kap, consts, **kw)
    tmake_ep(MU_T, 16, 16, HX, HY, A, DT, 2)(u, kap)
    assert kernels.launch_counts() == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed: the build would run")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load_library("ch_cas_macro")
    assert not any(tmp_path.iterdir())


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 64, 128, 256])
@pytest.mark.parametrize("mats", ["f32", "bf16"])
@pytest.mark.parametrize("ds", [0, 1, 4])
def test_kernel_matches_plain_on_card(cuda_device, H, mats, ds):
    B = 300
    u, kap = _inputs(B, H, seed=H)
    u, kap = torch.from_numpy(u).to(cuda_device), torch.from_numpy(kap).to(cuda_device)
    tm = MATS[mats][1]
    consts = cas_constants(H, H, HX, HY, tm, cuda_device)
    ep = Epilogue(255.0, 0.0, 0.5, ds) if ds else None
    kw = dict(mu_fn=MU_T, dt=DT, A=A, n_steps=10, round_bf16=tm == torch.bfloat16,
              epilogue=ep)
    name = "ch_cas_macro_ep" if ep else "ch_cas_macro"
    before = kernels.launch_counts()[name]
    got = ch_cas_macro_cuda(u, kap, consts, **kw)
    want = ch_cas_macro_plain(u, kap, consts, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_U[mats])
    if ep is not None:
        _assert_epilogue(got[1].cpu().numpy(), got[2].cpu().numpy(),
                         want[1].cpu().numpy(), want[2].cpu().numpy())


@pytest.mark.cuda
def test_fused_env_on_card_matches_cpu(cuda_device):
    """The flagship env step on the card (kernel K1) against the same step on
    the CPU (plain version), from the same state, at the bf16 tolerances."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy, env_state_to_numpy

    B, H = 64, 64
    envs = {d: make_cahn_hilliard_control_env(num_envs=B, grid_size=H,
                                              spectral_solve="fused", device=d)
            for d in ("cpu", cuda_device)}
    for d, env in envs.items():
        env.reset(torch.Generator(device=d).manual_seed(0))
    rng = np.random.default_rng(3)
    arrs = {"y": (0.5 + 0.05 * rng.standard_normal((B, H, H))).astype(np.float32),
            "t": np.zeros(B, np.float32),
            "control_value": rng.uniform(2e-3, 1e-2, B).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}
    for _ in range(3):
        a = torch.from_numpy(rng.uniform(-1, 1, (B, 1)).astype(np.float32))
        out = {d: env.step(env_state_from_numpy(arrs, d), a.to(d))
               for d, env in envs.items()}
        (sc, oc, rc, tc, _, _), (sg, og, rg, tg, _, _) = out["cpu"], out[cuda_device]
        np.testing.assert_allclose(sg.y.cpu().numpy(), sc.y.numpy(), rtol=0,
                                   atol=TOL_U["bf16"])
        assert int((og.cpu().int() - oc.int()).abs().max()) <= 1
        np.testing.assert_allclose(rg.cpu().numpy(), rc.numpy(), rtol=1e-3)
        assert torch.equal(tg.cpu(), tc)
        arrs = env_state_to_numpy(sc)


@pytest.mark.cuda
@pytest.mark.parametrize("B,ds", [(4096, 1), (1024, 0)], ids=["K1-4096-ds1", "K2-1024"])
def test_onchip_kernel_matches_plain_on_card(cuda_device, B, ds):
    """The on-chip kernel at the 128² fleet's shape (K1, 4096 x 128² x 10,
    epilogue ds 1) and at run_train_grad_128's forward (K2, 1024 x 128² x
    10) against plain; the launch counts once under its K1/K2 key and once
    under ``ch_cas_macro.onchip``."""
    u, kap = _inputs(B, 128, seed=B + ds)
    u, kap = torch.from_numpy(u).to(cuda_device), torch.from_numpy(kap).to(cuda_device)
    consts = cas_constants(128, 128, HX, HY, torch.bfloat16, cuda_device)
    ep = Epilogue(255.0, 0.0, 0.5, ds) if ds else None
    kw = dict(mu_fn=MU_T, dt=DT, A=A, n_steps=10, round_bf16=True, epilogue=ep)
    name = "ch_cas_macro_ep" if ep else "ch_cas_macro"
    before = kernels.launch_counts()
    got = ch_cas_macro_cuda(u, kap, consts, **kw)
    want = ch_cas_macro_plain(u, kap, consts, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[name] == before[name] + 1
    assert after["ch_cas_macro.onchip"] == before["ch_cas_macro.onchip"] + 1
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_U["bf16"])
    if ep is not None:
        _assert_epilogue(got[1].cpu().numpy(), got[2].cpu().numpy(),
                         want[1].cpu().numpy(), want[2].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B,ds", [(4096, 1), (1024, 0)], ids=["K1-4096-ds1", "K2-1024"])
def test_onchip_table_matches_rebuild_on_card(cuda_device, B, ds):
    """The on-chip kernel with each env's multipliers in the folded table
    (the constants' planes fold) and with the per-substep rebuild (forced by
    ``fold=False``) at the 128² fleet's K1 and at run_train_grad_128's K2:
    the field, stats and obs equal bit for bit; only the table's launch counts
    under ``ch_cas_macro.onchip_fold``."""
    u, kap = _inputs(B, 128, seed=3 * B + ds)
    u, kap = torch.from_numpy(u).to(cuda_device), torch.from_numpy(kap).to(cuda_device)
    consts = cas_constants(128, 128, HX, HY, torch.bfloat16, cuda_device)
    assert consts.fold
    ep = Epilogue(255.0, 0.0, 0.5, ds) if ds else None
    kw = dict(mu_fn=MU_T, dt=DT, A=A, n_steps=10, round_bf16=True, epilogue=ep)
    runs = []
    for c in (consts, consts._replace(fold=False)):
        before = kernels.launch_counts()
        out = ch_cas_macro_cuda(u, kap, c, **kw)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["ch_cas_macro.onchip"] == before["ch_cas_macro.onchip"] + 1
        assert (after["ch_cas_macro.onchip_fold"]
                == before["ch_cas_macro.onchip_fold"] + int(c.fold))
        runs.append((out,) if ep is None else out)
    table, rebuild = runs
    assert all(torch.equal(a, b) for a, b in zip(table, rebuild))


@pytest.mark.cuda
def test_onchip_counter_counts_each_128_step(cuda_device):
    """``ch_cas_macro.onchip`` and ``ch_cas_macro.onchip_fold`` count one
    launch a step of the 128² fleet and none at 64² or 256²
    (``ch_cas_macro_ep`` counts every step), nor a 128² macro with f32
    matrices (the tiled FMA kernel)."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env

    for H, want in ((64, 0), (128, 1), (256, 0)):
        env = make_cahn_hilliard_control_env(num_envs=8, grid_size=H, spectral_solve="fused",
                                             device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(H)
        state, _ = env.reset(gen)
        before = kernels.launch_counts()
        env.step(state, env.sample_actions(gen))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["ch_cas_macro_ep"] == before["ch_cas_macro_ep"] + 1, H
        assert after["ch_cas_macro.onchip"] == before["ch_cas_macro.onchip"] + want, H
        assert (after["ch_cas_macro.onchip_fold"]
                == before["ch_cas_macro.onchip_fold"] + want), H
    u, kap = _inputs(8, 128, seed=1)
    before = kernels.launch_counts()
    ch_cas_macro_cuda(torch.from_numpy(u).to(cuda_device), torch.from_numpy(kap).to(cuda_device),
                      cas_constants(128, 128, HX, HY, torch.float32, cuda_device), mu_fn=MU_T,
                      dt=DT, A=A, n_steps=2, round_bf16=False)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["ch_cas_macro"] == before["ch_cas_macro"] + 1
    assert after["ch_cas_macro.onchip"] == before["ch_cas_macro.onchip"]
    assert after["ch_cas_macro.onchip_fold"] == before["ch_cas_macro.onchip_fold"]


@pytest.mark.cuda
def test_bv_tiled_counter_counts_each_128_step(cuda_device):
    """``bv_cc_macro.tiled`` counts one launch a step of the BV fleet at 128²
    (K6's tiled kernel) and none at 64² (``bv_cc_macro_ep`` counts every
    step)."""
    from pde_opt_tpu_torch.envs.presets import make_butler_volmer_control_env

    for H, want in ((64, 0), (128, 1)):
        env = make_butler_volmer_control_env(num_envs=8, grid_size=H, device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(H)
        state, _ = env.reset(gen)
        for _ in range(2):
            before = kernels.launch_counts()
            env.step(state, env.sample_actions(gen))
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            assert after["bv_cc_macro_ep"] == before["bv_cc_macro_ep"] + 1, H
            assert after["bv_cc_macro.tiled"] == before["bv_cc_macro.tiled"] + want, H
