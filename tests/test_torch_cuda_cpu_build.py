"""Kernels K1-K3 (``csrc/ch_cas_macro.cu``), K4 (``csrc/ac_cas_macro.cu``)
and K6 (``csrc/bv_cc_macro.cu``) compiled for the CPU and held against their
plain versions.

The CUDA sources compile with g++ against the stub headers of
``tests/cuda_stub/``: a block runs as 256 ``std::thread``s with a
``std::barrier`` for ``__syncthreads``, bf16 rounds to nearest even by bit
arithmetic, and the stand-in ``wgmma_ops.cuh`` (first on the include path:
the real one is left out of the build directory) computes each warpgroup
product in C++ from the shared-memory tiles through the descriptors the
kernel builds.  So the indexing, zero padding, pixel ownership, epilogue and
barriers of the tensor-core (bf16) kernels, and the FMA (f32) kernels, run
here on CPU tensors; only the card's reading of the descriptors and the
real ``wgmma`` are left to the ``cuda`` tests.  The test rewrites the two
constructs C++ has no grammar for: the ``<<<...>>>`` launch and ``extern
__shared__``.

Three envs on one block (the stub's device holds one block), so the block
walks the envs by grid stride and K3's three envs share one trajectory slot;
two substeps (K3 also none); (H, W) in {(16, 16), (24, 40), (64, 64)}.
Bounds: the card tests' (``test_torch_cas_macro.py``, ``chip_smoke.py``: CH
field 1e-3 with bf16 matrices, 1e-5 with f32, stats to rtol 1e-3; K3's du
and dkappa relative to their maxima, ``TOL_BWD``, on the cotangent of
``sum(u1**2)``; ``test_torch_ac.py``: field 1e-3 bf16, 1e-5 f32; stats
n_finite exact, s2 to rtol 1e-3, s1 to 1e-3 of sqrt(n_px s2);
``test_torch_bv.py``: field 1e-4 bf16, 1e-5 f32, stats to rtol 1e-4), obs
within 1 LSB.  The bf16 bounds cover two summation orders of the products
rounding a bf16 tie apart.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.envs.presets import AC_R, BV_J0, BV_MU
from pde_opt_tpu_torch.ops.bv_cas import (
    _bind_library as _bind_bv,
    bv_cc_macro_plain,
    check_bv_coefficients,
    rk4_constants,
)
from pde_opt_tpu_torch.ops.cas_spectral import (
    Epilogue,
    PolynomialMu,
    _bind_ac_library,
    _bind_ch_library,
    _c_coeffs,
    ac_cas_macro_plain,
    cas_constants,
    ch_cas_macro_bwd_plain,
    ch_cas_macro_plain,
    r_is_identity,
)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "pde_opt_tpu_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_stub"
SHAPES = [(16, 16), (24, 40), (64, 64)]
B, N_STEPS = 3, 2
MU = PolynomialMu((0.0, -1.0, 0.0, 1.0))          # c**3 - c
R_POLY = PolynomialMu((1.0, 0.0, 0.5))            # 1 + 0.5 c**2
AC_DT, AC_A = 1e-3, 1.0
BV_KAPPA, BV_DT = 5e-4, 5e-4
TOL_AC = {True: 1e-3, False: 1e-5}                # by round_bf16
TOL_BV = {True: 1e-4, False: 1e-5}
CH_DT, CH_A = 1e-3, 1.0
TOL_CH = {True: 1e-3, False: 1e-5}
TOL_BWD = {True: (1e-5, 1e-2), False: (5e-6, 1e-4)}   # du, dkappa over their maxima


def _cpu_source(src: str) -> str:
    """A kernel source as g++ takes it with the stub headers."""
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"stub_launch(\1, \2, ", src, flags=re.S)
    return re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w[\w ]*?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(stub_dynamic_smem());", src)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Build ``ac_cas_macro.cu``, ``bv_cc_macro.cu`` and ``ch_cas_macro.cu``
    for the CPU, in parallel; return their bound libraries (K4, K6, K1-K3)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    build = tmp_path_factory.mktemp("cuda_cpu_build")
    for header in CSRC.glob("*.cuh"):
        if header.name != "wgmma_ops.cuh":
            shutil.copy(header, build)
    procs = {}
    for name in ("ac_cas_macro", "bv_cc_macro", "ch_cas_macro"):
        src = build / f"{name}.cpp"
        src.write_text(_cpu_source((CSRC / f"{name}.cu").read_text()))
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
             f"-I{STUB}", "-o", str(build / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    for name, proc in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, f"g++ failed on {name}:\n{err}"
    return (_bind_ac_library(ctypes.CDLL(str(build / "libac_cas_macro.so"))),
            _bind_bv(ctypes.CDLL(str(build / "libbv_cc_macro.so"))),
            _bind_ch_library(ctypes.CDLL(str(build / "libch_cas_macro.so"))))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _outputs(u, ep):
    Bn, H, W = u.shape
    if ep is None:
        return torch.empty_like(u), None, None
    return (torch.empty_like(u), torch.empty((Bn, 3), dtype=torch.float32),
            torch.empty((Bn, H // ep.ds, W // ep.ds), dtype=torch.uint8))


def _ac_inputs(H, W, seed):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((0.1 * rng.standard_normal((B, H, W))).astype(np.float32))
    return u, torch.from_numpy(np.linspace(1e-4, 1e-3, B).astype(np.float32))


def _ac_kernel(lib, u, kap, consts, R, ep, bf16):
    Bn, H, W = u.shape
    out, stats, obs = _outputs(u, ep)
    mu_c, n_mu = _c_coeffs(MU)
    r_c, n_r = (None, 0) if r_is_identity(R) else _c_coeffs(R)
    rc = lib.ac_cas_macro_launch(
        u.data_ptr(), kap.data_ptr(), consts.ch.data_ptr(), consts.cw.data_ptr(),
        consts.ich.data_ptr(), consts.icw.data_ptr(), consts.lam.data_ptr(), out.data_ptr(),
        _ptr(stats), _ptr(obs), Bn, H, W, N_STEPS, AC_DT, AC_A * AC_DT, mu_c, n_mu, r_c, n_r,
        int(bf16), ep.ds if ep else 1, ep.obs_scale if ep else 0.0,
        ep.obs_offset if ep else 0.0, ep.center if ep else 0.0, None)
    assert rc == 0
    return out if ep is None else (out, stats, obs)


def _ac_plain(u, kap, consts, R, ep, bf16):
    return ac_cas_macro_plain(u, kap, consts, mu_fn=MU, R_fn=R, r_identity=r_is_identity(R),
                              dt=AC_DT, A=AC_A, n_steps=N_STEPS, round_bf16=bf16, epilogue=ep)


def _bv_inputs(H, W, seed):
    rng = np.random.default_rng(seed)
    u = np.clip(0.1 + 0.01 * rng.standard_normal((B, H, W)), 0.01, 0.99).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(np.linspace(0.5, 2.0, B).astype(np.float32))


def _bv_consts(H, W, bf16):
    return cas_constants(H, W, 1 / H, 1 / W, torch.bfloat16 if bf16 else torch.float32,
                         torch.device("cpu"))


def _bv_kernel(lib, u, cr, consts, ep, bf16):
    Bn, H, W = u.shape
    out, stats, obs = _outputs(u, ep)
    rc = lib.bv_cc_macro_launch(
        u.data_ptr(), cr.data_ptr(), consts.ch.data_ptr(), consts.cw.data_ptr(),
        consts.ich.data_ptr(), consts.icw.data_ptr(), consts.lam.data_ptr(), out.data_ptr(),
        _ptr(stats), _ptr(obs), Bn, H, W, N_STEPS, *rk4_constants(BV_DT), BV_KAPPA,
        1 / (H * W), *check_bv_coefficients(BV_MU, BV_J0), int(bf16),
        ep.obs_scale if ep else 0.0, ep.obs_offset if ep else 0.0, ep.center if ep else 0.0,
        None)
    assert rc == 0
    return out if ep is None else (out, stats, obs)


def _bv_plain(u, cr, consts, ep, bf16):
    H, W = u.shape[-2:]
    return bv_cc_macro_plain(u, cr, consts, mu_fn=BV_MU, j0_fn=BV_J0, kappa=BV_KAPPA,
                             cell=1 / (H * W), dt=BV_DT, n_steps=N_STEPS, round_bf16=bf16,
                             epilogue=ep)


def _ch_inputs(H, W, seed):
    """Fields around 0.45 (sum(u - 0.5) far from 0) and kappa across the CH
    fleet's control range."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((0.45 + 0.05 * rng.standard_normal((B, H, W))).astype(np.float32))
    return u, torch.from_numpy(np.linspace(2e-3, 1e-2, B).astype(np.float32))


def _ch_consts(H, W, bf16):
    return cas_constants(H, W, 0.01, 0.01, torch.bfloat16 if bf16 else torch.float32,
                         torch.device("cpu"))


def _ch_kw(n_steps, bf16):
    return dict(mu_fn=MU, dt=CH_DT, A=CH_A, n_steps=n_steps, round_bf16=bf16)


def _mats(consts):
    return (consts.ch.data_ptr(), consts.cw.data_ptr(), consts.ich.data_ptr(),
            consts.icw.data_ptr(), consts.lam.data_ptr(), consts.lam2.data_ptr())


def _ch_kernel(lib, u, kap, consts, ep, bf16):
    Bn, H, W = u.shape
    out, stats, obs = _outputs(u, ep)
    mu_c, n_mu = _c_coeffs(MU)
    rc = lib.ch_cas_macro_launch(
        u.data_ptr(), kap.data_ptr(), *_mats(consts), out.data_ptr(), _ptr(stats), _ptr(obs),
        Bn, H, W, N_STEPS, CH_DT, CH_A * CH_DT, mu_c, n_mu, int(bf16), ep.ds if ep else 1,
        ep.obs_scale if ep else 0.0, ep.obs_offset if ep else 0.0, ep.center if ep else 0.0,
        None)
    assert rc == 0
    return out if ep is None else (out, stats, obs)


def _ch_bwd(lib, u, kap, consts, bf16, n_steps):
    """K3 and the plain backward on the cotangent of ``sum(u1**2)``:
    ``((du, dkappa), (plain du, plain dkappa))``."""
    Bn, H, W = u.shape
    kw = _ch_kw(n_steps, bf16)
    g = 2.0 * ch_cas_macro_plain(u, kap, consts, **kw)
    slots = ctypes.c_int(0)
    assert lib.ch_cas_macro_bwd_slots(int(bf16), ctypes.byref(slots)) == 0
    assert slots.value == 1        # one block: every env reuses its trajectory slot
    du, dk = torch.empty_like(u), torch.empty(Bn)
    scratch = torch.empty((slots.value, max(n_steps, 1), H, W))
    mu_c, n_mu = _c_coeffs(MU)
    dmu_c, n_dmu = _c_coeffs(MU.derivative())
    rc = lib.ch_cas_macro_bwd_launch(
        u.data_ptr(), kap.data_ptr(), g.data_ptr(), *_mats(consts), du.data_ptr(),
        dk.data_ptr(), scratch.data_ptr(), slots.value, Bn, H, W, n_steps, CH_DT,
        CH_A * CH_DT, -(CH_A * CH_DT * CH_DT), mu_c, n_mu, dmu_c, n_dmu, int(bf16), None)
    assert rc == 0
    return (du, dk), ch_cas_macro_bwd_plain(u, kap, g, consts, **kw)


def _assert_bwd(got, want, bf16):
    tol_u, tol_k = TOL_BWD[bf16]
    (du, dk), (pdu, pdk) = got, want
    assert ((du - pdu).abs().max() / pdu.abs().max()).item() <= tol_u
    assert ((dk - pdk).abs().max() / pdk.abs().max().clamp_min(1e-30)).item() <= tol_k


def _assert_ch_epilogue(got, want):
    assert torch.equal(got[1][:, 2], want[1][:, 2])
    torch.testing.assert_close(got[1][:, :2], want[1][:, :2], rtol=1e-3, atol=0)
    assert got[2].shape == want[2].shape
    assert int((got[2].int() - want[2].int()).abs().max()) <= 1


def _assert_ac_epilogue(got, want):
    n_px = got[0].shape[-1] * got[0].shape[-2]
    st, wt = got[1].double(), want[1].double()
    assert torch.equal(st[:, 2], wt[:, 2])
    torch.testing.assert_close(st[:, 1], wt[:, 1], rtol=1e-3, atol=0)
    assert bool(((st[:, 0] - wt[:, 0]).abs() <= 1e-3 * (n_px * wt[:, 1]).sqrt()).all())
    assert got[2].shape == want[2].shape
    assert int((got[2].int() - want[2].int()).abs().max()) <= 1


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("ds", [0, 1, 4])
def test_ac_bf16_kernel_matches_plain(libs, H, W, general, ds):
    u, kap = _ac_inputs(H, W, seed=H + W)
    consts = cas_constants(H, W, 0.01, 0.01, torch.bfloat16, torch.device("cpu"))
    R = R_POLY if general else AC_R
    ep = Epilogue(127.5, 127.5, 0.0, ds) if ds else None
    got = _ac_kernel(libs[0], u, kap, consts, R, ep, True)
    want = _ac_plain(u, kap, consts, R, ep, True)
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_AC[True])
    if ep is not None:
        _assert_ac_epilogue(got, want)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("ep", [False, True])
def test_bv_bf16_kernel_matches_plain(libs, H, W, ep):
    u, cr = _bv_inputs(H, W, seed=H + W)
    consts = _bv_consts(H, W, True)
    epi = Epilogue(255.0, 0.0, 0.5, 1) if ep else None
    got = _bv_kernel(libs[1], u, cr, consts, epi, True)
    want = _bv_plain(u, cr, consts, epi, True)
    if not ep:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_BV[True])
    if ep:
        assert torch.equal(got[1][:, 2], want[1][:, 2])
        torch.testing.assert_close(got[1][:, :2], want[1][:, :2], rtol=1e-4, atol=0)
        assert int((got[2].int() - want[2].int()).abs().max()) <= 1


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("ds", [0, 1, 4])
def test_ch_bf16_kernel_matches_plain(libs, H, W, ds):
    """K2 (ds 0) and K1 (the env epilogue, obs at ds 1 and mean-pooled at
    ds 4) on the tensor-core kernel."""
    u, kap = _ch_inputs(H, W, seed=H + W)
    consts = _ch_consts(H, W, True)
    ep = Epilogue(255.0, 0.0, 0.5, ds) if ds else None
    got = _ch_kernel(libs[2], u, kap, consts, ep, True)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, True))
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_CH[True])
    if ep is not None:
        _assert_ch_epilogue(got, want)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("n_steps", [N_STEPS, 0])
def test_ch_bwd_bf16_kernel_matches_plain(libs, H, W, n_steps):
    """K3 on the tensor cores, three envs through one trajectory slot; with
    no substep it returns du = g and dkappa = 0."""
    u, kap = _ch_inputs(H, W, seed=2 * H + W)
    got, want = _ch_bwd(libs[2], u, kap, _ch_consts(H, W, True), True, n_steps)
    _assert_bwd(got, want, True)
    if n_steps == 0:
        assert torch.equal(got[0], want[0]) and not bool(got[1].any())


@pytest.mark.parametrize("kernel", ["ac", "bv", "ch", "ch_bwd"])
def test_f32_fma_kernel_matches_plain_off_square(libs, kernel):
    """The f32 path (the FMA kernels of cas_common.cuh) at (24, 40)."""
    H, W = 24, 40
    if kernel == "ch_bwd":
        u, kap = _ch_inputs(H, W, seed=3)
        _assert_bwd(*_ch_bwd(libs[2], u, kap, _ch_consts(H, W, False), False, N_STEPS), False)
        return
    if kernel == "ch":
        u, kap = _ch_inputs(H, W, seed=3)
        consts = _ch_consts(H, W, False)
        got = _ch_kernel(libs[2], u, kap, consts, None, False)
        want = ch_cas_macro_plain(u, kap, consts, **_ch_kw(N_STEPS, False))
        tol = TOL_CH[False]
    elif kernel == "ac":
        u, kap = _ac_inputs(H, W, seed=3)
        consts = cas_constants(H, W, 0.01, 0.01, torch.float32, torch.device("cpu"))
        got = _ac_kernel(libs[0], u, kap, consts, R_POLY, None, False)
        want = _ac_plain(u, kap, consts, R_POLY, None, False)
        tol = TOL_AC[False]
    else:
        u, cr = _bv_inputs(H, W, seed=3)
        consts = _bv_consts(H, W, False)
        got = _bv_kernel(libs[1], u, cr, consts, None, False)
        want = _bv_plain(u, cr, consts, None, False)
        tol = TOL_BV[False]
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("kernel", ["ac", "bv", "ch", "ch_bwd"])
def test_nan_env_stays_in_its_env(libs, kernel):
    """One NaN pixel in the first env: the block that takes it goes on to the
    other two envs (grid stride), which must still equal plain; the NaN env
    is NaN wherever plain's is, and its epilogue flags it (K3: its du and
    dkappa are NaN, the other envs' are not)."""
    H, W = 24, 40
    ep = Epilogue(255.0, 0.0, 0.5, 1)
    if kernel == "ch_bwd":
        u, kap = _ch_inputs(H, W, seed=5)
        u[0, 3, 7] = float("nan")
        got, want = _ch_bwd(libs[2], u, kap, _ch_consts(H, W, True), True, N_STEPS)
        assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
        assert bool(torch.isnan(got[0][0]).any()) and not bool(torch.isnan(got[0][1:]).any())
        assert bool(torch.isnan(got[1][0])) and not bool(torch.isnan(got[1][1:]).any())
        _assert_bwd([t[1:] for t in got], [t[1:] for t in want], True)
        return
    if kernel == "ch":
        u, kap = _ch_inputs(H, W, seed=5)
        u[0, 3, 7] = float("nan")
        consts = _ch_consts(H, W, True)
        got = _ch_kernel(libs[2], u, kap, consts, ep, True)
        want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, True))
        tol = TOL_CH[True]
    elif kernel == "ac":
        u, kap = _ac_inputs(H, W, seed=5)
        u[0, 3, 7] = float("nan")
        consts = cas_constants(H, W, 0.01, 0.01, torch.bfloat16, torch.device("cpu"))
        got = _ac_kernel(libs[0], u, kap, consts, R_POLY, ep, True)
        want = _ac_plain(u, kap, consts, R_POLY, ep, True)
        tol = TOL_AC[True]
    else:
        u, cr = _bv_inputs(H, W, seed=5)
        u[0, 3, 7] = float("nan")
        consts = _bv_consts(H, W, True)
        got = _bv_kernel(libs[1], u, cr, consts, ep, True)
        want = _bv_plain(u, cr, consts, ep, True)
        tol = TOL_BV[True]
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    assert bool(torch.isnan(got[0][0]).any()) and not bool(torch.isnan(got[0][1:]).any())
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=tol)
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) < H * W
