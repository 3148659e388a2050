"""Kernels K1-K3 (``csrc/ch_cas_macro.cu``), K4 (``csrc/ac_cas_macro.cu``),
K5 (``csrc/gpe_strang_macro.cu``), K6 (``csrc/bv_cc_macro.cu``), K7
(``csrc/sbm_bv_macro.cu``), K8 2D and 3D (``csrc/ch_rhs_fd.cu``), K9a
(``csrc/ch_sif_macro.cu``) and K9b (``csrc/ac_sif_macro.cu``) compiled for
the CPU and held against their plain versions.

The CUDA sources compile with g++ against the stub headers of
``tests/cuda_stub/``: a block runs as one ``std::thread`` a CUDA thread
with a ``std::barrier`` for ``__syncthreads``, a warp shuffle through a
buffer of the warp, bf16 rounds to nearest even by bit
arithmetic, and the stand-in ``wgmma_ops.cuh`` (first on the include path:
the real one is left out of the build directory) computes each warpgroup
product in C++ from the shared-memory tiles through the descriptors the
kernel builds; the stand-in ``async_copy.cuh`` copies at once where K8's
``cp.async`` queues the copy.  So the indexing, zero padding, pixel
ownership, epilogue and barriers of the tensor-core (bf16) kernels, the FMA
(f32) kernels, K7's tiles and K8's row and plane marches run here on CPU
tensors; only the card's
reading of the descriptors, the real ``wgmma`` and ``cp.async`` are left to
the ``cuda`` tests.  The test rewrites, in the sources and the headers, the
two constructs C++ has no grammar for: the ``<<<...>>>`` launch and
``extern __shared__``.  Each library is bound by its module's own
``_bind_library`` and each kernel runs through its module's own launch
function (``_<entry>``, as the CUDA wrapper calls it), so the argument
order, the pointers and the scratch sizing held here are the card's.

Three envs on one block (the stub's device holds one block), so the block
walks the envs by grid stride and K3's three envs share one trajectory slot;
two substeps (K3 also none); (H, W) in {(16, 16), (24, 40), (64, 64)}.  The
tiled K1/K2 above 64² (a cp.async ring, which the stub's stand-in copies at
once) at 136 x 128 (bf16) or 128² (f32), 96 x 136 and 256², bf16 and f32
matrices, epilogue off and at ds 1 and 4, two envs through one slot; the
tiled K3 at 128² with 2, 1 and 0 substeps and at 256² with one; a NaN env in
each; one bf16 substep at 136 x 128 against the unrounded control.  The
on-chip K1/K2 (bf16 matrices on square grids above 64² up to 128²: 512
threads, m64n64 products over K = 128) at 128², 120², 96² and 72², epilogue
off and at ds 1 and 4, three envs through the one block, the field bit for
bit; a NaN env; one bf16 substep at 128² against the unrounded control; and
its shape rule and scratch query.  The tiled K4 (R == 1 and a polynomial R,
epilogue off and at ds 1) and K5 (phase polynomials on and off, epilogue
off and on, and from a state at 1.5 x unit norm) at 128² and 96 x 136, bf16
and f32 matrices, two envs through one slot, with a NaN env and one bf16
substep at 128² against the unrounded control (K4 at ``test_torch_ac.py``'s
TOL_SITE).
K7 (f32, field 1e-5, stats to rtol 1e-4 as ``test_torch_sbm_bv.py``'s card
test) there too, epilogue on and off, with a NaN env and with no substep.
The tiled K6 (bf16 and f32 matrices, epilogue off and on) at 128², 96 x 136
and 256², two envs through one slot, with a NaN env and one bf16 substep at
128² against the unrounded control; the tiled K7 at the same shapes, with a
NaN env and with no substep.
K8 2D: three envs at 64^2, and at 16 x 24, W = 33, 70 and 256 (one, two,
four and eight columns a lane, a last lane that owns fewer), H = 1 and 2
(a row its own neighbour), with the stub's SM holding 1, 8 or 30 blocks of
four warps (each env one run of rows or up to H runs), and on rows one
float off their 16-byte alignment.  K8 3D: three envs at 32^3, and at N1 in {1, 2, 3, 10} (a plane its own
neighbour, runs of a few planes) and on planes that are not 16-byte aligned
or hold an odd number of floats, with the stub's SM holding 1, 8 or 30
blocks (so each env is one run, or cut into up to N1 runs); K8 is built with
UBSan's alignment check, since the CPU, unlike the card, takes a misaligned
8-byte access.  K9a/K9b: the tensor-core kernels (bf16 tables) at 64^2 with
the half and the full spectrum, 16^2 and 24 x 40, R == 1 and a polynomial
R, with a NaN env, and after one substep against the unrounded control;
the FMA kernels (f32 tables) at 24 x 40 and 16^2 (full spectrum).  The
tiled K9a/K9b (``csrc/sif_tiled.cuh``) at 128² (half and full spectrum), 96
x 136 and 256² (one substep), bf16 and f32 tables, R == 1 and a polynomial
R, two envs through one slot; a NaN env at 96 x 136; one bf16 substep at
128² against the unrounded control (TOL_SIF_TILED_SITE); a 264² launch
refused before it runs.
Bounds: the card tests' (``test_torch_cas_macro.py``, ``chip_smoke.py``: CH
field 1e-3 with bf16 matrices, 1e-5 with f32, stats to rtol 1e-3; K3's du
and dkappa relative to their maxima, ``TOL_BWD``, on the cotangent of
``sum(u1**2)``; ``test_torch_ac.py``: field 1e-3 bf16, 1e-5 f32; stats
n_finite exact, s2 to rtol 1e-3, s1 to 1e-3 of sqrt(n_px s2);
``test_torch_bv.py``: field 1e-4 bf16, 1e-5 f32, stats to rtol 1e-4;
``test_torch_gpe.py``: field 5e-3 bf16, 5e-6 f32, stats to rtol 1e-5 against
the kernel's own final state, and one bf16 substep's RMS against plain below
``chip_smoke.py``'s 5e-5, which the unrounded plain version must exceed;
``chip_smoke.py``'s K8 bound 1e-5 of max|plain|; K9a and K9b at
``chip_smoke.py``'s TOL_U, TOL_AC and TOL_SITE), obs within 1 LSB.  The bf16 bounds cover two summation orders of the products
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
from pde_opt_tpu_torch.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
)
from pde_opt_tpu_torch.ops.bv_cas import (
    _bind_library as _bind_bv,
    _bv_cc_macro_launch,
    bv_cc_macro_plain,
)
from pde_opt_tpu_torch.ops.cas_common import c_coeffs, planes_fold
from pde_opt_tpu_torch.ops.cas_spectral import (
    Epilogue,
    PolynomialMu,
    _ac_cas_macro_launch,
    _bind_library as _bind_cas,
    _ch_cas_macro_bwd_launch,
    _ch_cas_macro_launch,
    ac_cas_macro_plain,
    cas_constants,
    ch_cas_macro_bwd_plain,
    ch_cas_macro_plain,
    r_is_identity,
)
from pde_opt_tpu_torch.ops.fused import (
    FORM_EXP_LEGENDRE_SCALED,
    FORM_LEGENDRE_SCALED,
    FORM_POLY,
    _bind_library as _bind_rhs,
    _ch_rhs_fd_2d_launch,
    _ch_rhs_fd_3d_launch,
    ch3d_rhs_fd_plain,
    ch_rhs_fd_plain,
)
from pde_opt_tpu_torch.ops.fused_spectral import (
    _ac_sif_macro_launch,
    _bind_library as _bind_sif,
    _ch_sif_macro_launch,
    ac_sif_macro_plain,
    ch_sif_macro_plain,
    sif_constants,
)
from pde_opt_tpu_torch.ops.gpe_cas import (
    GpeEpilogue,
    _bind_library as _bind_gpe,
    _gpe_strang_macro_launch,
    gpe_constants,
    gpe_strang_macro_plain,
)
from pde_opt_tpu_torch.ops.kernels import scratch_size
from pde_opt_tpu_torch.ops.sbm_bv import (
    SbmEpilogue,
    _bind_library as _bind_sbm,
    _sbm_bv_macro_launch,
    sbm_bv_constants,
    sbm_bv_macro_plain,
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
TOL_AC_SITE = {False: 2e-6, True: 6e-6}           # one bf16 substep: R == 1, general
TOL_BV = {True: 1e-4, False: 1e-5}
TOL_BV_SITE = 2e-7                                # one bf16 substep (test_torch_bv.py)
CH_DT, CH_A = 1e-3, 1.0
TOL_CH = {True: 1e-3, False: 1e-5}
TOL_BWD = {True: (1e-5, 1e-2), False: (5e-6, 1e-4)}   # du, dkappa over their maxima
# K1-K3 above 64² (the tiled kernels); one bf16 substep's RMS bound.
TILED_SHAPES = [(128, 128), (96, 136), (256, 256)]
TOL_CH_SITE = 2e-5
# The CH forward above 64²: (H, W, bf16) on the tiled kernel, which bf16
# matrices take only off the on-chip kernel's square grids (136 x 128 in
# place of 128²), and (H, W, ds) on the on-chip kernel (bf16, square, up to
# 128²).
CH_TILED_CASES = [(136, 128, True), (96, 136, True), (256, 256, True),
                  (128, 128, False), (96, 136, False), (256, 256, False)]
CH_ONCHIP_CASES = [(128, 128, 0), (128, 128, 1), (128, 128, 4), (96, 96, 1), (72, 72, 0),
                   (120, 120, 4)]
GPE_G, GPE_DT, GPE_BOX = 100.0, 2e-3, 16.0
TOL_GPE = {True: 5e-3, False: 5e-6}
TOL_GPE_SITE = 5e-5
MU_LEG = np.array([0.0, 1.0, 0.5], np.float32)    # the 3D path's Legendre mu
D_LEG = np.array([0.3, 0.2], np.float32)          # and D
TOL_K8 = 1e-5                                     # of max|plain|
# K8 reads (m, d) as 8-byte float2 pairs, which the card faults on at a
# misaligned address; the x86 CPU does not, so UBSan reports it (on stderr).
SANITIZE = {"ch_rhs_fd": ["-fsanitize=alignment"]}
SBM_KAPPA, SBM_DT = 5e-4, 5e-4
TOL_SBM = 1e-5                                    # chip_smoke.py's TOL_BV["f32"]


def _cpu_source(src: str) -> str:
    """A kernel source as g++ takes it with the stub headers."""
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"stub_launch(\1, \2, ", src, flags=re.S)
    return re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w[\w ]*?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(stub_dynamic_smem());", src)


def build_for_cpu(build: Path, names):
    """``csrc/<name>.cu`` for each of ``names`` compiled with g++ against the
    stub headers into ``build``, in parallel: ``{name: library}``, each
    loaded and not yet bound.  Skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    for header in CSRC.glob("*.cuh"):
        if not (STUB / header.name).exists():      # the stub's stand-ins come first
            (build / header.name).write_text(_cpu_source(header.read_text()))
    procs = {}
    for name in names:
        src = build / f"{name}.cpp"
        src.write_text(_cpu_source((CSRC / f"{name}.cu").read_text()))
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
             *SANITIZE.get(name, ()), f"-I{STUB}", "-o", str(build / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    for name, proc in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, f"g++ failed on {name}:\n{err}"
    return {name: ctypes.CDLL(str(build / f"lib{name}.so")) for name in names}


# The libraries the fixture builds, in the order it returns them (K4, K6,
# K1-K3, K5, K8, K9a, K9b, K7), each with its module's binding.
BINDS = {"ac_cas_macro": _bind_cas, "bv_cc_macro": _bind_bv, "ch_cas_macro": _bind_cas,
         "gpe_strang_macro": _bind_gpe, "ch_rhs_fd": _bind_rhs, "ch_sif_macro": _bind_sif,
         "ac_sif_macro": _bind_sif, "sbm_bv_macro": _bind_sbm}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The kernels of :data:`BINDS` built for the CPU, each bound by its
    module's own ``_bind_library``."""
    built = build_for_cpu(tmp_path_factory.mktemp("cuda_cpu_build"), BINDS)
    built["ch_rhs_fd"].stub_set_resident_blocks.argtypes = [ctypes.c_int]
    return tuple(bind(built[name], name) for name, bind in BINDS.items())


def _one_slot(lib, query, *args):
    """The stub's SM holds one block: a kernel that takes a scratch gets
    one slot from the shared query, which every env reuses."""
    slots, floats = scratch_size(lib, query, None, *args)
    assert floats == 0 or slots == 1


def _rms(d):
    return float(d.double().pow(2).mean().sqrt())


def _assert_nan_env_kept(got, want, whole=False):
    """NaN where plain has it: in the first env (all of it with ``whole``)
    and in no env after it."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    first = torch.isnan(got[0])
    assert bool(first.all() if whole else first.any()) and not bool(torch.isnan(got[1:]).any())


def _ac_inputs(H, W, seed, n=B):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((0.1 * rng.standard_normal((n, H, W))).astype(np.float32))
    return u, torch.from_numpy(np.linspace(1e-4, 1e-3, n).astype(np.float32))


def _ac_kw(R, bf16, n_steps):
    return dict(mu_fn=MU, R_fn=R, r_identity=r_is_identity(R), dt=AC_DT, A=AC_A,
                n_steps=n_steps, round_bf16=bf16)


def _ac_kernel(lib, u, kap, consts, R, ep, bf16, n_steps=N_STEPS):
    _one_slot(lib, "ac_cas_macro_scratch", int(bf16), *u.shape[1:])
    return _ac_cas_macro_launch(lib, u, kap, consts, epilogue=ep, stream=None,
                                **_ac_kw(R, bf16, n_steps))


def _ac_plain(u, kap, consts, R, ep, bf16, n_steps=N_STEPS):
    return ac_cas_macro_plain(u, kap, consts, epilogue=ep, **_ac_kw(R, bf16, n_steps))


def _bv_inputs(H, W, seed, n=B):
    rng = np.random.default_rng(seed)
    u = np.clip(0.1 + 0.01 * rng.standard_normal((n, H, W)), 0.01, 0.99).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(np.linspace(0.5, 2.0, n).astype(np.float32))


def _bv_consts(H, W, bf16):
    return cas_constants(H, W, 1 / H, 1 / W, torch.bfloat16 if bf16 else torch.float32,
                         torch.device("cpu"))


def _bv_kw(H, W, bf16, n_steps):
    return dict(mu_fn=BV_MU, j0_fn=BV_J0, kappa=BV_KAPPA, cell=1 / (H * W), dt=BV_DT,
                n_steps=n_steps, round_bf16=bf16)


def _bv_kernel(lib, u, cr, consts, ep, bf16, n_steps=N_STEPS):
    """K6 from the stub build; it says it ran the tiled kernel above 64²."""
    H, W = u.shape[-2:]
    _one_slot(lib, "bv_cc_macro_scratch", int(bf16), H, W)
    got, tiled = _bv_cc_macro_launch(lib, u, cr, consts, epilogue=ep, stream=None,
                                     **_bv_kw(H, W, bf16, n_steps))
    assert tiled == (H > 64 or W > 64)
    return got


def _bv_plain(u, cr, consts, ep, bf16, n_steps=N_STEPS):
    return bv_cc_macro_plain(u, cr, consts, epilogue=ep, **_bv_kw(*u.shape[-2:], bf16, n_steps))


def _ch_inputs(H, W, seed, n=B):
    """``n`` fields around 0.45 (sum(u - 0.5) far from 0) and kappa across
    the CH fleet's control range."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((0.45 + 0.05 * rng.standard_normal((n, H, W))).astype(np.float32))
    return u, torch.from_numpy(np.linspace(2e-3, 1e-2, n).astype(np.float32))


def _ch_consts(H, W, bf16):
    return cas_constants(H, W, 0.01, 0.01, torch.bfloat16 if bf16 else torch.float32,
                         torch.device("cpu"))


def _ch_kw(n_steps, bf16):
    return dict(mu_fn=MU, dt=CH_DT, A=CH_A, n_steps=n_steps, round_bf16=bf16)


def _ch_kernel(lib, u, kap, consts, ep, bf16, n_steps=N_STEPS):
    _one_slot(lib, "ch_cas_macro_scratch", 0, int(bf16), *u.shape[1:], n_steps)
    return _ch_cas_macro_launch(lib, u, kap, consts, epilogue=ep, stream=None,
                                **_ch_kw(n_steps, bf16))


def _ch_bwd(lib, u, kap, consts, bf16, n_steps):
    """K3 and the plain backward on the cotangent of ``sum(u1**2)``:
    ``((du, dkappa), (plain du, plain dkappa))``."""
    kw = _ch_kw(n_steps, bf16)
    g = 2.0 * ch_cas_macro_plain(u, kap, consts, **kw)
    _one_slot(lib, "ch_cas_macro_scratch", 1, int(bf16), *u.shape[1:], n_steps)
    return (_ch_cas_macro_bwd_launch(lib, u, kap, g, consts, stream=None, **kw),
            ch_cas_macro_bwd_plain(u, kap, g, consts, **kw))


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


def _gpe_inputs(H, W, seed, n=B):
    """The GPE fleet's fields on an H x W grid of the 16-wide box: a
    Gaussian with complex noise at unit norm, the harmonic trap, and a spot
    control per env in the control range [0, 50]."""
    rng = np.random.default_rng(seed)
    dx = GPE_BOX / H
    X, Y = np.meshgrid((np.arange(H) - H / 2) * dx, (np.arange(W) - W / 2) * dx, indexing="ij")
    psi = np.exp(-(X**2 + Y**2) / 4)[None] * (
        1 + 0.1 * rng.standard_normal((n, H, W)) + 0.1j * rng.standard_normal((n, H, W)))
    psi /= np.sqrt((np.abs(psi) ** 2).sum((-2, -1), keepdims=True) * dx * dx)
    spot = np.exp(-((X - 1) ** 2 + Y**2)).astype(np.float32)
    ctrl = (rng.uniform(0, 50, (n, 1, 1)) * spot).astype(np.float32)
    return (torch.from_numpy(np.stack([psi.real, psi.imag], -1).astype(np.float32)),
            torch.from_numpy(ctrl), torch.from_numpy((0.5 * (X**2 + Y**2)).astype(np.float32)),
            torch.from_numpy(spot), dx)


def _gpe_case(lib, H, W, bf16, poly, ep, seed, n_steps=N_STEPS, nan=False, n=B, amp=1.0):
    """K5 and its plain version on the same inputs (the state at ``amp``
    times unit norm): ``(got, want, spot)``."""
    y, ctrl, V, spot, dx = _gpe_inputs(H, W, seed, n)
    y *= amp
    if nan:
        y[0, 3, 7, 0] = float("nan")
    consts = gpe_constants(H, W, dx, GPE_DT, torch.bfloat16 if bf16 else torch.float32,
                           torch.device("cpu"))
    kw = dict(g=GPE_G, dt=GPE_DT, dx=dx, n_steps=n_steps, round_bf16=bf16, phase_poly=poly,
              epilogue=GpeEpilogue(2550.0, spot) if ep else None)
    _one_slot(lib, "gpe_strang_macro_scratch", int(bf16), H, W)
    got = _gpe_strang_macro_launch(lib, y, ctrl, V, consts, stream=None, **kw)
    return got, gpe_strang_macro_plain(y, ctrl, V, consts, **kw), spot


def _rhs3d_pair(kind):
    """mu and D as the plain version calls them, and as the kernel reads them
    ((form, coefficients) each)."""
    if kind == "legendre":
        return (ChemicalPotentialLegendrePolynomials(MU_LEG).requires_grad_(False),
                DiffusionLegendrePolynomials(D_LEG).requires_grad_(False),
                (FORM_LEGENDRE_SCALED, torch.from_numpy(MU_LEG)),
                (FORM_EXP_LEGENDRE_SCALED, torch.from_numpy(D_LEG)))
    mu, D = PolynomialMu((0.0, -1.0, 0.0, 1.0)), PolynomialMu((1.0, 0.0, 0.5))
    return mu, D, (FORM_POLY, torch.tensor(mu.coeffs)), (FORM_POLY, torch.tensor(D.coeffs))


def _rhs3d_case(lib, shape, h, kind, resident, seed):
    """K8 3D and its plain version on fields around 0.5, the first env
    stretched beyond [0, 1] (where exp-Legendre D grows); ``(got, want)``."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((0.5 + 0.05 * rng.standard_normal(shape)).astype(np.float32))
    u[0] = u[0] * 3.0 - 1.0
    kap = torch.from_numpy(np.linspace(2e-3, 5e-3, shape[0]).astype(np.float32))
    mu, D, mu_form, D_form = _rhs3d_pair(kind)
    out = torch.full_like(u, float("nan"))
    lib.stub_set_resident_blocks(resident)
    n = ctypes.c_int(0)
    assert lib.ch_rhs_fd_3d_resident(shape[2], shape[3], ctypes.byref(n)) == 0
    assert n.value == resident                    # one stub SM
    spacing = dict(h1=h[0], h2=h[1], h3=h[2])
    _ch_rhs_fd_3d_launch(lib, u, kap, out, mu=mu_form, D=D_form, resident=n.value, stream=None,
                         **spacing)
    return out, ch3d_rhs_fd_plain(u, kap, mu_fn=mu, D_fn=D, **spacing)


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


@pytest.mark.parametrize("H,W,bf16", CH_TILED_CASES)
@pytest.mark.parametrize("ds", [0, 1, 4])
def test_ch_tiled_kernel_matches_plain(libs, H, W, bf16, ds):
    """K2 (ds 0) and K1 above 64² on the tiled kernels (tensor cores with
    bf16 matrices, FMA with f32), two envs through the stub's one slot."""
    assert not libs[2].ch_cas_macro_onchip(H, W, int(bf16))
    u, kap = _ch_inputs(H, W, seed=H + W + ds, n=2)
    consts = _ch_consts(H, W, bf16)
    ep = Epilogue(255.0, 0.0, 0.5, ds) if ds else None
    got = _ch_kernel(libs[2], u, kap, consts, ep, bf16)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, bf16))
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_CH[bf16])
    if ep is not None:
        _assert_ch_epilogue(got, want)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n_steps", [N_STEPS, 1, 0])
def test_ch_tiled_bwd_matches_plain(libs, bf16, n_steps):
    """K3 at 128² on the tiled kernel, three envs through one slot: with one
    substep there is no forward re-run, with none du = g and dkappa = 0."""
    u, kap = _ch_inputs(128, 128, seed=11 + n_steps)
    got, want = _ch_bwd(libs[2], u, kap, _ch_consts(128, 128, bf16), bf16, n_steps)
    _assert_bwd(got, want, bf16)
    if n_steps == 0:
        assert torch.equal(got[0], want[0]) and not bool(got[1].any())


@pytest.mark.parametrize("kernel", ["fwd_bf16", "fwd_f32", "bwd_bf16"])
def test_ch_tiled_nan_env_stays_in_its_env(libs, kernel):
    """One NaN pixel in the first env (96 x 136 forward with the epilogue,
    128² K3): the other envs, which reuse its slot, still equal plain."""
    bf16 = kernel != "fwd_f32"
    H, W = (128, 128) if kernel == "bwd_bf16" else (96, 136)
    u, kap = _ch_inputs(H, W, seed=5)
    u[0, 3, 7] = float("nan")
    consts = _ch_consts(H, W, bf16)
    if kernel == "bwd_bf16":
        got, want = _ch_bwd(libs[2], u, kap, consts, True, N_STEPS)
        _assert_nan_env_kept(got[0], want[0])
        assert bool(torch.isnan(got[1][0])) and not bool(torch.isnan(got[1][1:]).any())
        _assert_bwd([t[1:] for t in got], [t[1:] for t in want], True)
        return
    ep = Epilogue(255.0, 0.0, 0.5, 1)
    got = _ch_kernel(libs[2], u, kap, consts, ep, bf16)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, bf16))
    _assert_nan_env_kept(got[0], want[0])
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=TOL_CH[bf16])
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) < H * W


@pytest.mark.parametrize("kernel", ["tiled", "onchip"])
def test_ch_tiled_bf16_kernel_rounds_where_plain_rounds(libs, kernel):
    """One substep with bf16 matrices, at 136 x 128 on the tiled kernel and
    at 128² on the on-chip one: the RMS of kernel - plain sits below
    chip_smoke.py's TOL_SITE["ch"], which the unrounded plain version (the
    control) exceeds."""
    H, W = (136, 128) if kernel == "tiled" else (128, 128)
    assert libs[2].ch_cas_macro_onchip(H, W, 1) == (kernel == "onchip")
    u, kap = _ch_inputs(H, W, seed=21, n=2)
    consts = _ch_consts(H, W, True)
    got = _ch_kernel(libs[2], u, kap, consts, None, True, n_steps=1)
    want = ch_cas_macro_plain(u, kap, consts, **_ch_kw(1, True))
    ctl = ch_cas_macro_plain(u, kap, consts, **_ch_kw(1, False))

    assert _rms(got - want) <= TOL_CH_SITE < _rms(ctl - want)


@pytest.mark.parametrize("H,W,ds", CH_ONCHIP_CASES)
def test_ch_onchip_kernel_matches_plain(libs, H, W, ds):
    """K2 (ds 0) and K1 (ds 1, 4) on the on-chip kernel (bf16 matrices, one
    env's state in registers and shared memory), three envs through the
    stub's one block, each env's multipliers from the folded table (the
    constants' planes fold): the field bit for bit, as the stub sums each
    product in k order as plain's f32 matmul does here."""
    assert libs[2].ch_cas_macro_onchip(H, W, 1)
    u, kap = _ch_inputs(H, W, seed=3 * H + W + ds)
    consts = _ch_consts(H, W, True)
    assert consts.fold
    ep = Epilogue(255.0, 0.0, 0.5, ds) if ds else None
    got = _ch_kernel(libs[2], u, kap, consts, ep, True)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, True))
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_CH[True])
    assert torch.equal(got[0], want[0])
    if ep is not None:
        _assert_ch_epilogue(got, want)


@pytest.mark.parametrize("H,W,ds", CH_ONCHIP_CASES)
def test_ch_onchip_table_matches_rebuild(libs, H, W, ds):
    """The on-chip kernel with the folded table and with the per-substep
    rebuild (forced by constants whose fold check says no): the same field,
    stats and obs bit for bit, and both the field of plain."""
    u, kap = _ch_inputs(H, W, seed=5 * H + ds)
    consts = _ch_consts(H, W, True)
    ep = Epilogue(255.0, 0.0, 0.5, ds) if ds else None
    table = _ch_kernel(libs[2], u, kap, consts, ep, True)
    rebuild = _ch_kernel(libs[2], u, kap, consts._replace(fold=False), ep, True)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, True))
    if ep is None:
        table, rebuild, want = (table,), (rebuild,), (want,)
    assert all(torch.equal(a, b) for a, b in zip(table, rebuild))
    assert torch.equal(rebuild[0], want[0])


@pytest.mark.parametrize("N", [128, 88])
def test_ch_onchip_table_matches_plain_where_hx_differs_from_hy(libs, N):
    """hx != hy whose planes still fold: the table (not symmetric under i <->
    j) matches plain bit for bit, K1 at ds 1."""
    consts = cas_constants(N, N, 0.01, 0.02, torch.bfloat16, torch.device("cpu"))
    assert consts.fold
    u, kap = _ch_inputs(N, N, seed=7 * N)
    ep = Epilogue(255.0, 0.0, 0.5, 1)
    got = _ch_kernel(libs[2], u, kap, consts, ep, True)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, True))
    assert torch.equal(got[0], want[0])
    _assert_ch_epilogue(got, want)


@pytest.mark.parametrize("N", range(72, 129, 8))
def test_ch_presets_planes_fold(N):
    """The fold check holds at the presets' spacing (h = 0.01) on every grid
    the on-chip kernel takes, although the mirrored f64 symbols differ by an
    ulp at some indices."""
    consts = _ch_consts(N, N, True)
    assert consts.fold and planes_fold(consts.lam.numpy(), consts.lam2.numpy())
    lam_h = consts.lam_h.numpy()
    assert not np.array_equal(lam_h[1:], lam_h[1:][::-1])


@pytest.mark.parametrize("plane", ["lam", "lam2"])
@pytest.mark.parametrize("where", ["mirrored row", "mirrored column", "both"])
def test_planes_fold_refuses_one_changed_entry(plane, where):
    """An entry that is not its own folded entry, moved by one f32 ulp in
    either plane, makes the check say no; restored, the check says yes, and
    the same move at (N / 2, N / 2), which no other pixel folds to, keeps
    it."""
    consts = _ch_consts(128, 128, True)
    planes = {"lam": consts.lam.numpy().copy(), "lam2": consts.lam2.numpy().copy()}
    i, j = {"mirrored row": (100, 5), "mirrored column": (5, 100), "both": (99, 77)}[where]
    p = planes[plane]
    p[i, j] = np.nextafter(p[i, j], np.float32(np.inf))
    assert not planes_fold(planes["lam"], planes["lam2"])
    p[i, j] = consts.lam.numpy()[i, j] if plane == "lam" else consts.lam2.numpy()[i, j]
    assert planes_fold(planes["lam"], planes["lam2"])
    p[64, 64] = np.nextafter(p[64, 64], np.float32(np.inf))
    assert planes_fold(planes["lam"], planes["lam2"])


@pytest.mark.parametrize("N", [72, 96, 120])
def test_ch_onchip_rebuild_where_planes_do_not_fold(libs, N):
    """Spacings hx != hy whose f32 planes do not fold at 72², 96², 120²
    (an entry an ulp off its folded one): the check says no, and the launch
    takes the rebuild and matches plain bit for bit."""
    consts = cas_constants(N, N, 0.01, 0.02, torch.bfloat16, torch.device("cpu"))
    assert not consts.fold
    u, kap = _ch_inputs(N, N, seed=N)
    ep = Epilogue(255.0, 0.0, 0.5, 1)
    got = _ch_kernel(libs[2], u, kap, consts, ep, True)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, True))
    assert torch.equal(got[0], want[0])
    _assert_ch_epilogue(got, want)


@pytest.mark.parametrize("fold", [True, False], ids=["table", "rebuild"])
def test_ch_onchip_nan_env_stays_in_its_env(libs, fold):
    """One NaN pixel in the first of three envs at 128² with the epilogue on
    the on-chip kernel, with the folded table and with the rebuild: the envs
    after it, which reuse its Z^T and T tiles and its table, still equal
    plain."""
    u, kap = _ch_inputs(128, 128, seed=6)
    u[0, 3, 7] = float("nan")
    consts = _ch_consts(128, 128, True)._replace(fold=fold)
    ep = Epilogue(255.0, 0.0, 0.5, 1)
    got = _ch_kernel(libs[2], u, kap, consts, ep, True)
    want = ch_cas_macro_plain(u, kap, consts, epilogue=ep, **_ch_kw(N_STEPS, True))
    _assert_nan_env_kept(got[0], want[0])
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=TOL_CH[True])
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) < 128 * 128
    _assert_ch_epilogue([t[1:] for t in got], [t[1:] for t in want])


@pytest.mark.parametrize("bwd", [0, 1])
def test_ch_onchip_rule_and_scratch(libs, bwd):
    """The shape rule (``ch_cas_macro_onchip``): the forward with bf16
    matrices on square grids above 64² up to 128² runs the on-chip kernel
    and asks for no scratch; 64² and below, grids that are not square or are
    above 128, and f32 matrices keep their kernels (the tiled forward 3
    planes a slot).  The backward (K3)
    keeps its scratch everywhere."""
    lib = libs[2]
    on = [(128, 128), (120, 120), (96, 96), (72, 72)]
    off = [(64, 64), (16, 24), (136, 136), (96, 128), (128, 72), (64, 128), (96, 136),
           (256, 256)]
    for (H, W), bf16 in [(hw, b) for hw in on + off for b in (1, 0)]:
        taken = bf16 == 1 and (H, W) in on
        assert lib.ch_cas_macro_onchip(H, W, bf16) == int(taken), (H, W, bf16)
        _, floats = scratch_size(lib, "ch_cas_macro_scratch", None, bwd, bf16, H, W, N_STEPS)
        tiled = H > 64 or W > 64
        want = ((N_STEPS + 5 if tiled else N_STEPS) if bwd
                else (0 if taken or not tiled else 3)) * H * W
        assert floats == want, (H, W, bf16, bwd)


@pytest.mark.parametrize("bf16", [True, False])
def test_ch_tiled_bwd_256_matches_plain(libs, bf16):
    """K3 at 256² on the tiled kernel, one substep, two envs through one
    slot."""
    u, kap = _ch_inputs(256, 256, seed=31, n=2)
    _assert_bwd(*_ch_bwd(libs[2], u, kap, _ch_consts(256, 256, bf16), bf16, 1), bf16)


def _ac_tiled_case(lib, H, W, bf16, R, ep, seed, n_steps=N_STEPS, nan=False):
    """The tiled K4 and its plain version on two envs through the stub's one
    slot (spacings 0.01): ``(got, want, consts, u, kap)``."""
    u, kap = _ac_inputs(H, W, seed, n=2)
    if nan:
        u[0, 3, 7] = float("nan")
    consts = cas_constants(H, W, 0.01, 0.01, torch.bfloat16 if bf16 else torch.float32,
                           torch.device("cpu"))
    got = _ac_kernel(lib, u, kap, consts, R, ep, bf16, n_steps)
    want = _ac_plain(u, kap, consts, R, ep, bf16, n_steps)
    return got, want, consts, u, kap


@pytest.mark.parametrize("H,W", TILED_SHAPES[:2])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("ds", [0, 1])
def test_ac_tiled_kernel_matches_plain(libs, H, W, bf16, general, ds):
    """K4 above 64² on the tiled kernel (tensor cores with bf16 matrices,
    FMA with f32), the R == 1 path (3 transforms a substep) and the
    polynomial R (4), epilogue off and at ds 1."""
    ep = Epilogue(127.5, 127.5, 0.0, ds) if ds else None
    got, want, *_ = _ac_tiled_case(libs[0], H, W, bf16, R_POLY if general else AC_R, ep,
                                   seed=H + W + 2 * general + ds)
    if ep is None:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_AC[bf16])
    if ep is not None:
        _assert_ac_epilogue(got, want)


@pytest.mark.parametrize("bf16,general", [(True, False), (False, True)])
def test_ac_tiled_nan_env_stays_in_its_env(libs, bf16, general):
    """One NaN pixel in the first env at 96 x 136 with the epilogue: the
    second env, which reuses its slot, still equals plain."""
    ep = Epilogue(127.5, 127.5, 0.0, 1)
    got, want, *_ = _ac_tiled_case(libs[0], 96, 136, bf16, R_POLY if general else AC_R, ep,
                                   seed=9, nan=True)
    _assert_nan_env_kept(got[0], want[0])
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=TOL_AC[bf16])
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) < 96 * 136


@pytest.mark.parametrize("general", [False, True])
def test_ac_tiled_bf16_kernel_rounds_where_plain_rounds(libs, general):
    """One substep at 128² with bf16 matrices: the RMS of kernel - plain
    sits below the card's bound (``test_torch_ac.py``'s TOL_SITE), which
    the unrounded plain version (the control) exceeds."""
    R = R_POLY if general else AC_R
    got, want, consts, u, kap = _ac_tiled_case(libs[0], 128, 128, True, R, None, seed=21,
                                               n_steps=1)
    ctl = _ac_plain(u, kap, consts, R, None, False, 1)

    assert _rms(got - want) <= TOL_AC_SITE[general] < _rms(ctl - want)


@pytest.mark.parametrize("H,W", TILED_SHAPES[:2])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("ep", [False, True])
def test_gpe_tiled_kernel_matches_plain(libs, H, W, bf16, poly, ep):
    """K5 above 64² on the tiled kernel, two envs through one slot: B-phase
    polynomials on and off, with and without the epilogue (held against
    the kernel's own final state), every emitted env at unit norm."""
    got, want, spot = _gpe_case(libs[3], H, W, bf16, poly, ep, seed=H + W + ep, n=2)
    if not ep:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_GPE[bf16])
    rho = got[0][..., 0] ** 2 + got[0][..., 1] ** 2
    torch.testing.assert_close(rho.sum((-2, -1)) * (GPE_BOX / H) ** 2, torch.ones(2),
                               rtol=1e-5, atol=0)
    if ep:
        torch.testing.assert_close(got[1][:, 0], (rho * spot).sum((-2, -1)), rtol=1e-5, atol=0)
        torch.testing.assert_close(got[1][:, 1], rho.sum((-2, -1)), rtol=1e-5, atol=0)
        assert bool((got[1][:, 2] == H * W).all())
        obs = torch.clamp(rho * 2550.0, 0, 255).to(torch.uint8)
        assert int((got[2].int() - obs.int()).abs().max()) <= 1


@pytest.mark.parametrize("bf16", [True, False])
def test_gpe_tiled_renormalises_a_state_off_unit_norm(libs, bf16):
    """A state at 1.5 times unit norm at 128²: the first B phase takes theta
    from the unscaled field, every later one from the field its
    propagation's renormalisation scaled, as plain does; every emitted env
    at unit norm."""
    got, want, _ = _gpe_case(libs[3], 128, 128, bf16, True, False, seed=13, n=2, amp=1.5)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_GPE[bf16])
    rho = got[..., 0] ** 2 + got[..., 1] ** 2
    torch.testing.assert_close(rho.sum((-2, -1)) * (GPE_BOX / 128) ** 2, torch.ones(2),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("bf16,poly", [(True, True), (False, False)])
def test_gpe_tiled_nan_env_stays_in_its_env(libs, bf16, poly):
    """One NaN pixel in the first env at 96 x 136 with the epilogue: its
    renorm makes the whole env NaN, as plain's; the second env, which
    reuses its slot, still equals plain."""
    got, want, _ = _gpe_case(libs[3], 96, 136, bf16, poly, True, seed=5, nan=True, n=2)
    _assert_nan_env_kept(got[0], want[0])
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=TOL_GPE[bf16])
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) < 96 * 136


def test_gpe_tiled_bf16_kernel_rounds_where_plain_rounds(libs):
    """One substep at 128² with bf16 matrices: the RMS of kernel - plain
    below the bound, the unrounded plain version above it."""
    got, want, _ = _gpe_case(libs[3], 128, 128, True, True, False, seed=7, n_steps=1, n=2)
    y, ctrl, V, _, dx = _gpe_inputs(128, 128, 7, n=2)
    control = gpe_strang_macro_plain(
        y, ctrl, V, gpe_constants(128, 128, dx, GPE_DT, torch.bfloat16, torch.device("cpu")),
        g=GPE_G, dt=GPE_DT, dx=dx, n_steps=1, round_bf16=False, phase_poly=True)

    assert _rms(got - want) <= TOL_GPE_SITE < _rms(control - want)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("ep", [False, True])
def test_gpe_kernel_matches_plain(libs, H, W, bf16, poly, ep):
    """K5: the tensor-core kernel (bf16 matrices) and the FMA kernel (f32),
    B-phase polynomials on and off, with and without the env epilogue,
    whose stats and obs are held against the kernel's own final state."""
    got, want, spot = _gpe_case(libs[3], H, W, bf16, poly, ep, seed=H + W)
    if not ep:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_GPE[bf16])
    if ep:
        rho = got[0][..., 0] ** 2 + got[0][..., 1] ** 2
        torch.testing.assert_close(got[1][:, 0], (rho * spot).sum((-2, -1)), rtol=1e-5, atol=0)
        torch.testing.assert_close(got[1][:, 1], rho.sum((-2, -1)), rtol=1e-5, atol=0)
        assert bool((got[1][:, 2] == H * W).all())
        obs = torch.clamp(rho * 2550.0, 0, 255).to(torch.uint8)
        assert int((got[2].int() - obs.int()).abs().max()) <= 1


@pytest.mark.parametrize("H,W", SHAPES)
def test_gpe_bf16_kernel_rounds_where_plain_rounds(libs, H, W):
    """One substep with bf16 matrices: the RMS of kernel - plain below the
    bound, the unrounded plain version (a kernel that skips a rounding site)
    above it."""
    got, want, _ = _gpe_case(libs[3], H, W, True, True, False, seed=7, n_steps=1)
    y, ctrl, V, _, dx = _gpe_inputs(H, W, 7)
    control = gpe_strang_macro_plain(
        y, ctrl, V, gpe_constants(H, W, dx, GPE_DT, torch.bfloat16, torch.device("cpu")),
        g=GPE_G, dt=GPE_DT, dx=dx, n_steps=1, round_bf16=False, phase_poly=True)

    assert _rms(got - want) <= TOL_GPE_SITE < _rms(control - want)


@pytest.mark.parametrize("kind", ["legendre", "poly"])
def test_k8_3d_kernel_matches_plain(libs, kind, capfd):
    """K8 3D at the 3D path's plane size: three envs x 32^3, the Legendre
    pair and c^3 - c with D = 1 + 0.5 c^2."""
    got, want = _rhs3d_case(libs[4], (B, 32, 32, 32), (0.01, 0.01, 0.01), kind, 1, seed=3)
    assert float((got - want).abs().max()) <= TOL_K8 * float(want.abs().max())
    assert "runtime error" not in capfd.readouterr().err


@pytest.mark.parametrize("dims", [(1, 16, 8), (2, 16, 8), (3, 16, 8), (10, 16, 8), (7, 6, 5),
                                  (4, 5, 7), (9, 9, 9)])
@pytest.mark.parametrize("resident", [1, 8, 30])
def test_k8_3d_march_wraps_in_n1(libs, dims, resident, capfd):
    """K8 3D where the march's wrap in N1 matters: N1 = 1, 2, 3 (a plane is
    its own neighbour, or its neighbour's) and 10, N2 != N3, a 6 x 5 plane
    (not 16-byte aligned), 5 x 7 and 9 x 9 planes (an odd number of floats
    before the (m, d) pairs, with no misaligned access); the stub's SM
    holds 1, 8 or 30 blocks, so each env is one run or up to N1 runs of as
    few as one plane."""
    got, want = _rhs3d_case(libs[4], (B, *dims), (0.01, 0.02, 0.03), "legendre", resident,
                            seed=sum(dims))
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL_K8 * float(want.abs().max())
    assert "runtime error" not in capfd.readouterr().err


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


@pytest.mark.parametrize("kernel", ["ac", "bv", "ch", "ch_bwd", "gpe"])
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
        _assert_nan_env_kept(got[0], want[0])
        assert bool(torch.isnan(got[1][0])) and not bool(torch.isnan(got[1][1:]).any())
        _assert_bwd([t[1:] for t in got], [t[1:] for t in want], True)
        return
    if kernel == "gpe":
        got, want, _ = _gpe_case(libs[3], H, W, True, True, True, seed=5, nan=True)
        tol = TOL_GPE[True]
    elif kernel == "ch":
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
    _assert_nan_env_kept(got[0], want[0])
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=tol)
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) < H * W


# ---- K6 above 64², the tiled kernel ---------------------------------------------

def _bv_tiled_case(lib, H, W, bf16, ep, seed, n_steps=N_STEPS, nan=False):
    """The tiled K6 and its plain version on two envs through the stub's one
    slot (box 1, h = 1/H, 1/W): ``(got, want, consts, u, cr)``."""
    u, cr = _bv_inputs(H, W, seed, n=2)
    if nan:
        u[0, 3, 7] = float("nan")
    consts = _bv_consts(H, W, bf16)
    epi = Epilogue(255.0, 0.0, 0.5, 1) if ep else None
    got = _bv_kernel(lib, u, cr, consts, epi, bf16, n_steps)
    want = _bv_plain(u, cr, consts, epi, bf16, n_steps)
    return got, want, consts, u, cr


@pytest.mark.parametrize("H,W", TILED_SHAPES)
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("ep", [False, True])
def test_bv_tiled_kernel_matches_plain(libs, H, W, bf16, ep):
    """K6 above 64² on the tiled kernel (tensor cores with bf16 matrices,
    FMA with f32), epilogue off and on: per RK stage two transforms, the
    closure's integrals in lap's epilogue, one block reduction and a pass
    over the slot's planes."""
    got, want, *_ = _bv_tiled_case(libs[1], H, W, bf16, ep, seed=H + W + ep)
    if not ep:
        got, want = (got,), (want,)
    assert float((got[0] - _bv_inputs(H, W, H + W + ep, n=2)[0]).abs().max()) > 1e-4
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_BV[bf16])
    if ep:
        assert torch.equal(got[1][:, 2], want[1][:, 2])
        torch.testing.assert_close(got[1][:, :2], want[1][:, :2], rtol=1e-4, atol=0)
        assert int((got[2].int() - want[2].int()).abs().max()) <= 1


@pytest.mark.parametrize("bf16", [True, False])
def test_bv_tiled_nan_env_stays_in_its_env(libs, bf16):
    """One NaN pixel in the first env at 96 x 136 with the epilogue: the
    closure spreads it over that env alone; the second env, which reuses
    its slot, still equals plain."""
    got, want, *_ = _bv_tiled_case(libs[1], 96, 136, bf16, True, seed=9, nan=True)
    _assert_nan_env_kept(got[0], want[0], whole=True)
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=TOL_BV[bf16])
    assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) == 0.0


def test_bv_tiled_bf16_kernel_rounds_where_plain_rounds(libs):
    """One substep at 128² with bf16 matrices: the RMS of kernel - plain
    sits below the card's bound (``test_torch_bv.py``'s TOL_SITE), which
    the unrounded plain version (the control) exceeds."""
    got, want, consts, u, cr = _bv_tiled_case(libs[1], 128, 128, True, False, seed=21,
                                              n_steps=1)
    ctl = _bv_plain(u, cr, consts, None, False, 1)

    assert _rms(got - want) <= TOL_BV_SITE < _rms(ctl - want)


# ---- K9a and K9b, the packed-DFT macros ----------------------------------------

def _sif_case(libs, kind, H, W, half, bf16, R=None, n_steps=N_STEPS, seed=0, nan=False, n=B):
    """K9a (``kind`` "ch") or K9b ("ac"; ``R`` None for R == 1) from the stub
    build and its plain version on the same inputs, spacings 0.01 along H
    and 0.02 along W: ``(got, want, control)``, the control the plain
    version with the rounding off.  Above 64² the tiled kernel, its ``n``
    envs through the stub's one scratch slot."""
    u, kap = (_ch_inputs if kind == "ch" else _ac_inputs)(H, W, seed, n=n)
    if nan:
        u[0, 3, 7] = float("nan")
    consts = sif_constants(H, W, SIF_HX, SIF_HY, torch.bfloat16 if bf16 else torch.float32,
                           half, torch.device("cpu"))
    launch, plain, kw = _sif_kind(kind, R, n_steps)
    lib = libs[5] if kind == "ch" else libs[6]
    _one_slot(lib, f"{kind}_sif_macro_scratch", int(bf16), H, W, consts.wr_w.shape[-1])
    return (launch(lib, u, kap, consts, round_bf16=bf16, stream=None, **kw),
            plain(u, kap, consts, round_bf16=bf16, **kw),
            plain(u, kap, consts, round_bf16=False, **kw))


def _sif_kind(kind, R, n_steps):
    """K9a's or K9b's ``(launch, plain version, their keywords)``."""
    if kind == "ch":
        return (_ch_sif_macro_launch, ch_sif_macro_plain,
                dict(mu_fn=MU, dt=CH_DT, A=CH_A, n_steps=n_steps))
    return (_ac_sif_macro_launch, ac_sif_macro_plain,
            dict(mu_fn=MU, dt=AC_DT, A=AC_A, n_steps=n_steps, R_fn=R, r_identity=R is None,
                 hx=SIF_HX, hy=SIF_HY))


SIF_HX, SIF_HY = 0.01, 0.02
SIF_KINDS = [("ch", None), ("ac", None), ("ac", R_POLY)]
SIF_IDS = ["ch", "ac_r1", "ac_poly"]
# chip_smoke.py's bounds: K9a TOL_U, K9b TOL_AC (bf16), both 1e-5 with f32
# tables; one substep's RMS, TOL_SITE["ch_sif"] and ["ac_sif"].
TOL_SIF = {("ch", True): 1e-3, ("ac", True): 5e-4, ("ch", False): 1e-5, ("ac", False): 1e-5}
TOL_SIF_SITE = {"ch": 2e-5, "ac": 1e-6}
# The tiled kernels' one substep at 128²: the unrounded AC control sits at
# 7.0e-7 there, below the 64² bound, so K9b is held at 2e-7.
TOL_SIF_TILED_SITE = {"ch": 2e-5, "ac": 2e-7}


@pytest.mark.parametrize("H,W,half", [(64, 64, True), (64, 64, False), (16, 16, True),
                                      (24, 40, True)], ids=["64-half", "64-full", "16", "24x40"])
@pytest.mark.parametrize("kind,R", SIF_KINDS, ids=SIF_IDS)
def test_sif_bf16_kernel_matches_plain(libs, kind, R, H, W, half):
    """K9a/K9b on the tensor-core kernel (bf16 tables): 64^2 with the half
    spectrum (N = 40) and the full one (N = 64), and the padded shapes
    16^2 (W2 9, N 16) and 24 x 40 (W2 21, N 24; K of the w product 48)."""
    got, want, _ = _sif_case(libs, kind, H, W, half, True, R, seed=H + W)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_SIF[kind, True])


@pytest.mark.parametrize("kind,R", SIF_KINDS, ids=SIF_IDS)
def test_sif_bf16_kernel_rounds_where_plain_rounds(libs, kind, R):
    """One substep with bf16 tables at 64^2: the RMS of kernel - plain below
    chip_smoke.py's bound, the unrounded plain version (a kernel that skips a
    rounding site) above it."""
    got, want, control = _sif_case(libs, kind, 64, 64, True, True, R, n_steps=1, seed=7)

    assert _rms(got - want) <= TOL_SIF_SITE[kind] < _rms(control - want)


@pytest.mark.parametrize("H,W,half", [(24, 40, True), (16, 16, False)], ids=["24x40", "16-full"])
@pytest.mark.parametrize("kind,R", SIF_KINDS, ids=SIF_IDS)
def test_sif_f32_fma_kernel_matches_plain(libs, kind, R, H, W, half):
    """The f32-table path: K9a/K9b's FMA kernels (sif_common.cuh), column
    groups of 3 (W2 21) and 4 (W2 16)."""
    got, want, _ = _sif_case(libs, kind, H, W, half, False, R, seed=3)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_SIF[kind, False])


@pytest.mark.parametrize("kind,R", SIF_KINDS, ids=SIF_IDS)
def test_sif_nan_env_stays_in_its_env(libs, kind, R):
    """One NaN pixel in the first env on the tensor-core kernel at 24 x 40:
    the block goes on to the other two envs, which must still equal plain."""
    got, want, _ = _sif_case(libs, kind, 24, 40, True, True, R, seed=5, nan=True)
    _assert_nan_env_kept(got, want)
    torch.testing.assert_close(got[1:], want[1:], rtol=0, atol=TOL_SIF[kind, True])


@pytest.mark.parametrize("H,W,half", [(128, 128, True), (96, 136, True), (128, 128, False),
                                      (256, 256, True)],
                         ids=["128-half", "96x136", "128-full", "256-half"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,R", SIF_KINDS, ids=SIF_IDS)
def test_sif_tiled_kernel_matches_plain(libs, kind, R, bf16, H, W, half):
    """K9a/K9b above 64² on the tiled kernel (sif_tiled.cuh: tensor cores
    with bf16 tables, FMA with f32), two envs through one scratch slot:
    the half spectrum at 128² (W2 65 in a stacked width of 144), 96 x 136
    (W2 69) and 256² (W2 129), the full one at 128².  One substep at 256²."""
    got, want, _ = _sif_case(libs, kind, H, W, half, bf16, R, n=2,
                             n_steps=1 if H == 256 else N_STEPS, seed=H + W + half)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_SIF[kind, bf16])


@pytest.mark.parametrize("kind,R", SIF_KINDS, ids=SIF_IDS)
def test_sif_tiled_bf16_kernel_rounds_where_plain_rounds(libs, kind, R):
    """One substep with bf16 tables at 128² on the tiled kernel: the RMS of
    kernel - plain below TOL_SIF_TILED_SITE, the unrounded plain version
    above it."""
    got, want, control = _sif_case(libs, kind, 128, 128, True, True, R, n_steps=1, seed=17, n=1)

    assert _rms(got - want) <= TOL_SIF_TILED_SITE[kind] < _rms(control - want)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,R", SIF_KINDS, ids=SIF_IDS)
def test_sif_tiled_nan_env_stays_in_its_env(libs, kind, R, bf16):
    """One NaN pixel in the first env at 96 x 136 on the tiled kernel: the
    other two envs, which reuse its scratch slot, still equal plain."""
    got, want, _ = _sif_case(libs, kind, 96, 136, True, bf16, R, seed=5, nan=True)
    _assert_nan_env_kept(got, want)
    torch.testing.assert_close(got[1:], want[1:], rtol=0, atol=TOL_SIF[kind, bf16])


@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_sif_launch_refuses_264(libs, kind):
    """A 264² state is past the tiled kernels' 256: the launch returns an
    error before it runs anything (the wrapper refuses it before the launch
    and counts none, test_torch_fused_spectral.py)."""
    lib = libs[5] if kind == "ch" else libs[6]
    H = W = 264
    W2 = W // 2 + 1
    _, floats = scratch_size(lib, f"{kind}_sif_macro_scratch", None, 1, H, W, W2)
    u = torch.zeros((1, H, W))
    out = torch.full_like(u, 7.0)
    scratch = torch.zeros(max(floats, 1))
    tables = (ctypes.c_void_p * 6)(*([scratch.data_ptr()] * 6))
    common = (u.data_ptr(), u.data_ptr(), *([u.data_ptr()] * 10), out.data_ptr(), tables,
              scratch.data_ptr(), 1, 1, H, W, W2, 1, 1e-3, 1e-3)
    mu_c, n_mu = c_coeffs(MU)
    if kind == "ch":
        rc = lib.ch_sif_macro_launch(*common, mu_c, n_mu, 1, None)
    else:
        rc = lib.ac_sif_macro_launch(*common, 1.0, 1.0, mu_c, n_mu, None, 0, 1, None)
    assert rc != 0
    assert bool((out == 7.0).all())


@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_launch_error_raises_naming_the_kernel(libs, kind):
    """The program's own K9a/K9b launch on a 264² state (past the tiled
    kernels' 256, which the CUDA wrapper refuses before it gets here): the
    C entry's nonzero return code comes back through the shared envelope as
    a RuntimeError naming the kernel and CUDA's message."""
    H = W = 264
    u, kap = (_ch_inputs if kind == "ch" else _ac_inputs)(H, W, seed=1, n=1)
    consts = sif_constants(H, W, SIF_HX, SIF_HY, torch.bfloat16, True, torch.device("cpu"))
    launch, _, kw = _sif_kind(kind, None, 1)
    with pytest.raises(RuntimeError, match=f"^{kind}_sif_macro launch failed: invalid argument$"):
        launch(libs[5] if kind == "ch" else libs[6], u, kap, consts, round_bf16=True,
               stream=None, **kw)


# ---- K7, the SBM Butler-Volmer macro -------------------------------------------

def _sbm_psi(H, W, width=0.06):
    """The SBM tests' disk level set on an H x W grid of the unit box."""
    x, y = ((np.arange(n) + 0.5) / n - 0.5 for n in (H, W))
    X, Y = np.meshgrid(x, y, indexing="ij")
    psi = 0.5 * (1.0 + np.tanh((0.35 - np.sqrt(X**2 + Y**2)) / width))
    psi = np.where(psi < 0.001, 0.001, psi)
    return np.where(psi > 0.99, 1.0, psi).astype(np.float32)


def _sbm_case(lib, H, W, ep, seed, nan=False, n_steps=N_STEPS, n=B):
    """K7 from the stub build and its plain version on ``n`` charging
    fields: ``(got, want)``, each ``u1`` or ``(u1, stats, obs)``."""
    u, cr = _bv_inputs(H, W, seed, n)
    if nan:
        u[0, 3, 7] = float("nan")
    consts = sbm_bv_constants(_sbm_psi(H, W), SBM_KAPPA, 1 / H, 1 / W, torch.device("cpu"))
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=SBM_DT, n_steps=n_steps,
              epilogue=SbmEpilogue(255.0, 0.5) if ep else None)
    _one_slot(lib, "sbm_bv_macro_scratch", H, W)
    return (_sbm_bv_macro_launch(lib, u, cr, consts, stream=None, **kw),
            sbm_bv_macro_plain(u, cr, consts, **kw))


def _assert_sbm_epilogue(got, want):
    assert torch.equal(got[1][:, 2], want[1][:, 2])
    torch.testing.assert_close(got[1][:, :2], want[1][:, :2], rtol=1e-4, atol=0)
    assert int((got[2].int() - want[2].int()).abs().max()) <= 1


@pytest.mark.parametrize("H,W", SHAPES + TILED_SHAPES)
@pytest.mark.parametrize("ep", [False, True])
def test_sbm_kernel_matches_plain(libs, H, W, ep):
    """K7 at 16^2, 24 x 40 and 64^2, with and without the psi-weighted
    epilogue: three envs through one block (grid stride), each tile's
    fluxes from its neighbours' stage input in shared memory; above 64^2
    the tiled kernel, the three envs through the stub's one scratch slot,
    each group's faces from its neighbours' z in the slot's plane."""
    got, want = _sbm_case(libs[7], H, W, ep, seed=H + W)
    if not ep:
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=TOL_SBM)
    if ep:
        _assert_sbm_epilogue(got, want)


@pytest.mark.parametrize("ep", [False, True])
def test_sbm_nan_env_stays_in_its_env(libs, ep):
    """One NaN pixel in the first env at 24 x 40: its reduction poisons that
    env only; the block goes on to the other two, which must equal plain."""
    got, want = _sbm_case(libs[7], 24, 40, ep, seed=5, nan=True)
    if not ep:
        got, want = (got,), (want,)
    _assert_nan_env_kept(got[0], want[0], whole=True)
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=TOL_SBM)
    if ep:
        assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) == 0.0
        torch.testing.assert_close(got[1][1:, :2], want[1][1:, :2], rtol=1e-4, atol=0)


def test_sbm_no_substep_copies_the_field(libs):
    """n_steps = 0: the field comes back as it went in, and the epilogue
    reads it."""
    got, want = _sbm_case(libs[7], 16, 16, True, seed=1, n_steps=0)
    assert torch.equal(got[0], want[0])
    _assert_sbm_epilogue(got, want)


# ---- K7 above 64², the tiled kernel ---------------------------------------------

@pytest.mark.parametrize("ep", [False, True])
def test_sbm_tiled_nan_env_stays_in_its_env(libs, ep):
    """One NaN pixel in the first env at 96 x 136: its reduction poisons
    that env only; the second env, which reuses the slot, equals plain."""
    got, want = _sbm_case(libs[7], 96, 136, ep, seed=5, nan=True, n=2)
    if not ep:
        got, want = (got,), (want,)
    _assert_nan_env_kept(got[0], want[0], whole=True)
    torch.testing.assert_close(got[0][1:], want[0][1:], rtol=0, atol=TOL_SBM)
    if ep:
        assert torch.equal(got[1][:, 2], want[1][:, 2]) and float(got[1][0, 2]) == 0.0
        torch.testing.assert_close(got[1][1:, :2], want[1][1:, :2], rtol=1e-4, atol=0)


def test_sbm_tiled_no_substep_copies_the_field(libs):
    """n_steps = 0 at 128²: the field comes back as it went in, and the
    epilogue reads it."""
    got, want = _sbm_case(libs[7], 128, 128, True, seed=1, n_steps=0, n=2)
    assert torch.equal(got[0], want[0])
    _assert_sbm_epilogue(got, want)


# ---- K8 2D, the row march ------------------------------------------------------

def _rhs2d_case(lib, shape, h, kind, resident, seed, offset=0):
    """K8 2D from the stub build and its plain version on fields around 0.5,
    the first env stretched beyond [0, 1]; the stub's SM holds ``resident``
    blocks of four warps; ``offset`` floats put u and out off their 16-byte
    alignment.  ``(got, want)``."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    buf = torch.from_numpy((0.5 + 0.05 * rng.standard_normal(n + offset)).astype(np.float32))
    u = buf[offset:].view(shape)
    u[0] = u[0] * 3.0 - 1.0
    kap = torch.from_numpy(np.linspace(2e-3, 5e-3, shape[0]).astype(np.float32))
    mu, D, mu_form, D_form = _rhs3d_pair(kind)
    out = torch.full((n + offset,), float("nan"))[offset:].view(shape)
    lib.stub_set_resident_blocks(resident)
    w = ctypes.c_int(0)
    assert lib.ch_rhs_fd_2d_resident(shape[2], ctypes.byref(w)) == 0
    assert w.value == 4 * resident                   # one stub SM, four warps a block
    _ch_rhs_fd_2d_launch(lib, u, kap, out, mu=mu_form, D=D_form, hx=h[0], hy=h[1],
                         resident=w.value, stream=None)
    return out, ch_rhs_fd_plain(u, kap, mu_fn=mu, D_fn=D, hx=h[0], hy=h[1])


def _assert_k8(got, want, capfd):
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL_K8 * float(want.abs().max())
    assert "runtime error" not in capfd.readouterr().err


@pytest.mark.parametrize("kind", ["legendre", "poly"])
def test_k8_2d_kernel_matches_plain(libs, kind, capfd):
    """K8 2D at the fleet's grid: three envs x 64^2 (two columns a lane), the
    Legendre pair and c^3 - c with D = 1 + 0.5 c^2."""
    got, want = _rhs2d_case(libs[4], (B, 64, 64), (0.01, 0.01), kind, 1, seed=4)
    _assert_k8(got, want, capfd)


@pytest.mark.parametrize("dims", [(16, 24), (64, 64), (9, 70), (5, 33), (3, 256), (1, 8),
                                  (2, 16)])
@pytest.mark.parametrize("resident", [1, 8, 30])
def test_k8_2d_march_wraps(libs, dims, resident, capfd):
    """K8 2D where the row march's wraps matter: 16 x 24 (24 lanes of one
    column), 64^2, W = 70 (four columns a lane, the last lane two) and 33
    (two a lane, the last one, odd rows: single-float access), 256 (eight a
    lane), H = 1 and 2 (a row its own neighbour, or its neighbour's); the
    stub's SM holds 1, 8 or 30 blocks, so each env is one run of rows or up
    to H runs of as few as one row."""
    got, want = _rhs2d_case(libs[4], (B, *dims), (0.01, 0.02), "legendre", resident,
                            seed=sum(dims))
    _assert_k8(got, want, capfd)


@pytest.mark.parametrize("dims", [(16, 64), (8, 128)])
def test_k8_2d_unaligned_rows(libs, dims, capfd):
    """u and out one float off their 16-byte alignment: the march takes
    single-float accesses, not float2 or float4 ones."""
    got, want = _rhs2d_case(libs[4], (B, *dims), (0.01, 0.01), "poly", 8, seed=2, offset=1)
    _assert_k8(got, want, capfd)
