"""Packed-DFT fused semi-implicit CH and AC macro-steps and their FFT oracles
(PyTorch port of :mod:`pde_opt_tpu.ops.fused_spectral`): kernels K9a and K9b.

The JAX package selects these macros with ``algo="dft"`` on the fused CH and
AC steppers.  Each substep is one forward and one inverse separable complex
DFT per env, as real/imaginary pairs of real products, with the FD Laplacian
symbol ``lam`` and each env's own κ in the implicit denominator.  With
``half_spectrum`` (the default for even W) only ``kw`` in ``[0, W/2]`` is
kept, and the inverse along ``kw`` weighs the interior columns twice
(``c_k``).  Per env, the CH macro (K9a) carries the complex spectrum ``û``
across substeps:

    û = F(u)
    n_steps times:
        incr = cm * F(mu(u)) - cu * û      cm = dt lam / (1 + A dt κ lam²)
        û   += incr                        cu = dt κ lam² / (1 + A dt κ lam²)
        u   += Re F⁻¹(incr)

and the AC macro (K9b) takes the periodic 5-point Laplacian by rolls:

    n_steps times:
        lap = roll-stencil Laplacian of u
        g   = -R(u) (mu(u) - κ lap)
        u  += Re F⁻¹(F(g) dt / (1 + A dt κ (-lam)))

With ``mats_dtype=torch.bfloat16`` (the default, as in the JAX package) the
DFT tables are rounded to bf16, and so are the operand of each transform's
first product and the intermediate before its second, where the JAX kernel
rounds them; products accumulate in f32.

Each macro has two implementations of the same function: a plain-torch
version (``*_plain``, what CPU tensors run) and a hand-written Hopper kernel
(``*_cuda``: ``csrc/ch_sif_macro.cu`` and ``csrc/ac_sif_macro.cu``, what
CUDA tensors run; above 64² their tiled kernels on ``csrc/sif_tiled.cuh``,
with the tables of :func:`tiled_tables`), with no fallback from one to the
other.  Gradients with
respect to the field and κ are the VJP of the checkpointed FFT oracle
(:func:`ch_sif_macro_reference`, :func:`ac_sif_macro_reference` with
``remat=True``), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

# cas_spectral imports this module's oracles while it initialises (and the
# package imports cas_spectral first), so it is bound here as a module and
# its names are read at call time.
from . import cas_spectral as _cas
from .kernels import count_launch, load_library

__all__ = [
    "SifConstants",
    "sif_constants",
    "ch_sif_macro_plain",
    "ch_sif_macro_cuda",
    "make_ch_sif_fused_macro",
    "ch_sif_macro_reference",
    "ac_sif_macro_plain",
    "ac_sif_macro_cuda",
    "make_ac_sif_fused_macro",
    "ac_sif_macro_reference",
    "tiled_tables",
]


def _fd_lap_symbols(H: int, W: int, hx: float, hy: float):
    """FD Laplacian eigenvalues per axis (roll-stencil spectrum)."""
    lam_h = (2.0 * np.cos(2.0 * np.pi * np.arange(H) / H) - 2.0) / (hx * hx)
    lam_w = (2.0 * np.cos(2.0 * np.pi * np.arange(W) / W) - 2.0) / (hy * hy)
    return lam_h, lam_w


def _dft_mats(N: int):
    """Forward/inverse DFT matrices as (cos, sin) real pairs.

    Forward: ``X[k] = sum_x u[x] e^{-2 pi i x k / N}`` -> ``(Wr, Wi)`` with
    ``Wr = cos``, ``Wi = -sin``, both (N, N) indexed ``[x, k]``.  Inverse:
    ``u[x] = (1/N) sum_k X[k] e^{+2 pi i k x / N}`` -> ``(Vr, Vi)``,
    ``Vr = cos/N``, ``Vi = sin/N``, indexed ``[k, x]``.
    """
    x = np.arange(N)
    ang = 2.0 * np.pi * np.outer(x, x) / N
    Wr, Wi = np.cos(ang), -np.sin(ang)
    Vr, Vi = np.cos(ang) / N, np.sin(ang) / N
    return (Wr, Wi), (Vr, Vi)


class SifConstants(NamedTuple):
    """The DFT macros' tables, f32 and contiguous on one device, each
    already rounded to ``mats_dtype``.

    ``W2`` is ``W//2 + 1`` with the half spectrum, else ``W``.  Forward:
    ``wr_w``/``wi_w`` (W, W2) ``[w, kw]``, ``wr_h``/``wi_h`` (H, H)
    ``[h, kh]``.  Inverse: ``vr_h``/``vi_h`` (H, H) ``[kh, h]``,
    ``vr_w``/``vi_w`` (W2, W) ``[kw, w]`` with the ``c_k`` weights folded
    in.  ``lam``/``lam2``: the FD Laplacian symbol and its square on the
    (H, W2) spectrum ``[kh, kw]``, f32.
    """

    wr_w: torch.Tensor
    wi_w: torch.Tensor
    wr_h: torch.Tensor
    wi_h: torch.Tensor
    vr_h: torch.Tensor
    vi_h: torch.Tensor
    vr_w: torch.Tensor
    vi_w: torch.Tensor
    lam: torch.Tensor
    lam2: torch.Tensor


@functools.lru_cache(maxsize=32)
def sif_constants(H: int, W: int, hx: float, hy: float, mats_dtype: torch.dtype,
                  half_spectrum: bool, device: torch.device) -> SifConstants:
    """Build (once per configuration and device) the DFT macros' tables.

    The JAX kernel's tables without its TPU packing: with the half
    spectrum, only ``kw`` in ``[0, W/2]`` and the inverse along ``kw``
    weighted by ``c_k`` (1 at ``kw = 0`` and ``W/2``, else 2).
    """

    def mat(m):
        return torch.from_numpy(np.ascontiguousarray(m)).to(mats_dtype).to(
            device, torch.float32).contiguous()

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32).contiguous()

    (Wr_w, Wi_w), (Vr_w, Vi_w) = _dft_mats(W)
    (Wr_h, Wi_h), (Vr_h, Vi_h) = _dft_mats(H)
    lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
    if half_spectrum:
        W2 = W // 2 + 1
        c_k = np.full(W2, 2.0)                        # kw in (0, W/2) pairs with W - kw
        c_k[0] = c_k[-1] = 1.0
    else:
        W2, c_k = W, np.ones(W)
    lam = lam_h[:, None] + lam_w[None, :W2]                            # (H, W2) f64
    return SifConstants(
        wr_w=mat(Wr_w[:, :W2]), wi_w=mat(Wi_w[:, :W2]),
        wr_h=mat(Wr_h), wi_h=mat(Wi_h), vr_h=mat(Vr_h), vi_h=mat(Vi_h),
        vr_w=mat(c_k[:, None] * Vr_w[:W2]), vi_w=mat(c_k[:, None] * Vi_w[:W2]),
        lam=f32(lam), lam2=f32(lam**2),
    )


def _dft_transforms(c: SifConstants, round_bf16: bool):
    """``(fwd, inv)``: ``fwd(x)`` maps a real (B, H, W) field to its
    spectrum ``(re, im)``, each (B, H, W2) ``[kh, kw]``; ``inv(re, im)`` maps
    a spectrum back to the real field.  Each transform contracts ``w`` (or
    ``kh``) first; with bf16 tables it rounds its operand and the
    intermediate between its two products, as the JAX kernel does."""
    if round_bf16:
        def rnd(z):
            return z.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(z):
            return z

    wr_hT, wi_hT, vr_hT, vi_hT = c.wr_h.T, c.wi_h.T, c.vr_h.T, c.vi_h.T

    def fwd(x):
        x = rnd(x)
        ar, ai = rnd(x @ c.wr_w), rnd(x @ c.wi_w)                       # [h, kw]
        return wr_hT @ ar - wi_hT @ ai, wi_hT @ ar + wr_hT @ ai

    def inv(zr, zi):
        zr, zi = rnd(zr), rnd(zi)
        cr, ci = rnd(vr_hT @ zr - vi_hT @ zi), rnd(vi_hT @ zr + vr_hT @ zi)   # [h, kw]
        return cr @ c.vr_w - ci @ c.vi_w

    return fwd, inv


def ch_sif_macro_plain(u: torch.Tensor, kappa: torch.Tensor, consts: SifConstants, *,
                       mu_fn: Callable, dt: float, A: float, n_steps: int,
                       round_bf16: bool) -> torch.Tensor:
    """Plain-torch K9a: ``u`` (B, H, W) f32, ``kappa`` (B,) f32 -> ``u1``.

    The JAX kernel's semantics: the spectrum is taken once from ``u`` and
    carried across the substeps (not recomputed, as the oracle does).
    What CPU tensors run and what the kernel is held against on the card.
    """
    fwd, inv = _dft_transforms(consts, round_bf16)
    _, cm, cu = _cas._coeffs(kappa, consts.lam, consts.lam2, A, dt)
    hr, hi = fwd(u)
    for _ in range(n_steps):
        mr, mi = fwd(mu_fn(u))
        ir, ii = cm * mr - cu * hr, cm * mi - cu * hi
        hr, hi = hr + ir, hi + ii
        u = u + inv(ir, ii)
    return u


def ac_sif_macro_plain(u: torch.Tensor, kappa: torch.Tensor, consts: SifConstants, *,
                       mu_fn: Callable, R_fn: Optional[Callable], r_identity: bool,
                       hx: float, hy: float, dt: float, A: float, n_steps: int,
                       round_bf16: bool) -> torch.Tensor:
    """Plain-torch K9b: ``u`` (B, H, W) f32, ``kappa`` (B,) f32 -> ``u1``.

    Per substep the periodic 5-point Laplacian by rolls (hx along H, hy
    along W), ``g = -R(u) (mu(u) - κ lap)`` (``-(mu(u) - κ lap)`` when
    ``r_identity``) and ``u += inv(dd fwd(g))`` with ``dd = dt/(1 + A dt κ
    (-lam))``.  What CPU tensors run and what the kernel is held against.
    """
    fwd, inv = _dft_transforms(consts, round_bf16)
    k = kappa.reshape(-1, 1, 1)
    denom_dt = float(dt) / (1.0 + float(A) * float(dt) * (k * (-consts.lam)))
    inv_hx2, inv_hy2 = 1.0 / (hx * hx), 1.0 / (hy * hy)
    for _ in range(n_steps):
        lap = ((torch.roll(u, -1, -2) - 2.0 * u + torch.roll(u, 1, -2)) * inv_hx2
               + (torch.roll(u, -1, -1) - 2.0 * u + torch.roll(u, 1, -1)) * inv_hy2)
        g = mu_fn(u) - k * lap
        g = -g if r_identity else -R_fn(u) * g
        gr, gi = fwd(g)
        u = u + inv(denom_dt * gr, denom_dt * gi)
    return u


# ---- the Hopper kernels K9a and K9b ------------------------------------------

def _bind_library(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C interface of ``name`` (``ch_sif_macro`` or
    ``ac_sif_macro``) on ``lib``: ``csrc/<name>.cu`` built for the card, or
    for the CPU by the tests' stub build."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [p, p, *[p] * len(SifConstants._fields), p,   # u, kappa, tables, out
              ctypes.POINTER(p), p, i,                     # tiled tables, scratch, n_slots
              i, i, i, i, i, f, f]                         # B, H, W, W2, n_steps, dt, A*dt
    launch = getattr(lib, f"{name}_launch")
    if name == "ch_sif_macro":
        launch.argtypes = common + [p, i, i, p]            # mu, n_mu, round_bf16, stream
    else:
        launch.argtypes = common + [f, f, p, i, p, i, i, p]  # 1/hx², 1/hy², mu, R, rnd, stream
    launch.restype = ctypes.c_int
    scratch = getattr(lib, f"{name}_scratch")
    scratch.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_longlong)]
    scratch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library(name: str):
    return _bind_library(load_library(name), name)


def _ch_library():
    return _library("ch_sif_macro")


def _ac_library():
    return _library("ac_sif_macro")


@functools.lru_cache(maxsize=32)
def tiled_tables(consts: SifConstants, round_bf16: bool):
    """The tables of the tiled kernels (grids above 64²), built once per
    :func:`sif_constants` result: ``(fw, fh, vh, vw, lam_t, lam2_t)`` in
    ``csrc/sif_tiled.cuh``'s layout, on the tables' device.

    With ``W2p`` the kept width ``W2`` rounded up to a multiple of 8 and
    ``K2 = 2 W2p`` (real part first, then imaginary): ``fw`` (K2, W) =
    ``[Wr_w^T; Wi_w^T]``, ``fh`` (H, 2H) = ``[Wr_h^T | Wi_h^T]``, ``vh``
    (H, 2H) = ``[Vr_h^T | Vi_h^T]``, ``vw`` (W, K2) = ``[Vr_w^T | -Vi_w^T]``,
    zero beyond W2 in each part; bf16 (exact copies) when ``round_bf16``,
    else f32 and each transposed (the FMA path reads [contraction][row]).
    ``lam_t``/``lam2_t`` (W2p, H) f32 are ``lam``/``lam2`` transposed.
    """
    H = consts.wr_h.shape[0]
    W, W2 = consts.wr_w.shape
    W2p = (W2 + 7) // 8 * 8
    dev = consts.wr_w.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    fw = zeros(2 * W2p, W)
    fw[:W2], fw[W2p:W2p + W2] = consts.wr_w.T, consts.wi_w.T
    vw = zeros(W, 2 * W2p)
    vw[:, :W2], vw[:, W2p:W2p + W2] = consts.vr_w.T, -consts.vi_w.T
    fh = torch.cat([consts.wr_h.T, consts.wi_h.T], dim=1)
    vh = torch.cat([consts.vr_h.T, consts.vi_h.T], dim=1)
    lam_t, lam2_t = zeros(W2p, H), zeros(W2p, H)
    lam_t[:W2], lam2_t[:W2] = consts.lam.T, consts.lam2.T
    mats = (fw, fh, vh, vw)
    if round_bf16:
        mats = tuple(m.to(torch.bfloat16).contiguous() for m in mats)
    else:
        mats = tuple(m.T.contiguous() for m in mats)
    return (*mats, lam_t, lam2_t)


def _launch(name: str, u, kappa, consts: SifConstants, mu_fn, dt, A, n_steps, round_bf16,
            before=(), after=()):
    """Check what K9a/K9b take, launch ``name`` on the current stream, raise
    on a nonzero return code, count the launch; returns ``u1``.  Above 64²
    the tiled kernel runs, with :func:`tiled_tables` and a scratch of one
    slot for each resident block, allocated here.  ``before`` and ``after``
    are the kernel's own arguments around mu's coefficients."""
    if not isinstance(mu_fn, _cas.PolynomialMu):
        raise ValueError(
            "the CUDA macro evaluates mu from polynomial coefficients: pass a "
            f"PolynomialMu, got {mu_fn!r}"
        )
    B, H, W = _cas._check_grid(u)
    dev = u.device
    W2 = consts.wr_w.shape[-1]
    _cas._check_cuda("u", u, (B, H, W), torch.float32, dev)
    _cas._check_cuda("kappa", kappa, (B,), torch.float32, dev)
    shapes = {"wr_w": (W, W2), "wi_w": (W, W2), "vr_w": (W2, W), "vi_w": (W2, W),
              "lam": (H, W2), "lam2": (H, W2)}
    for field in SifConstants._fields:
        _cas._check_cuda(field, getattr(consts, field), shapes.get(field, (H, H)),
                         torch.float32, dev)
    out = torch.empty_like(u)
    coeffs, n_coeffs = _cas._c_coeffs(mu_fn)
    library = _ch_library if name == "ch_sif_macro" else _ac_library
    scratch, slots = _cas._alloc_scratch(dev, B, library, f"{name}_scratch", round_bf16, H, W,
                                         W2)
    tables = (None,) * 6 if scratch is None else tiled_tables(consts, bool(round_bf16))
    table_ptrs = (ctypes.c_void_p * 6)(*(None if t is None else t.data_ptr() for t in tables))
    lib = library()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"{name}_launch")(
            u.data_ptr(), kappa.data_ptr(), *(t.data_ptr() for t in consts), out.data_ptr(),
            table_ptrs, None if scratch is None else scratch.data_ptr(), slots,
            B, H, W, W2, int(n_steps), float(dt), float(A) * float(dt), *before,
            coeffs, n_coeffs, *after, int(bool(round_bf16)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {getattr(lib, f'{name}_error_string')(rc).decode()}"
        )
    count_launch(name)
    return out


def ch_sif_macro_cuda(u: torch.Tensor, kappa: torch.Tensor, consts: SifConstants, *,
                      mu_fn: Callable, dt: float, A: float, n_steps: int,
                      round_bf16: bool) -> torch.Tensor:
    """Kernel K9a (``csrc/ch_sif_macro.cu``): same contract as
    :func:`ch_sif_macro_plain`, H and W up to
    :data:`~pde_opt_tpu_torch.ops.cas_spectral.MAX_GRID_TILED` (tiled above
    64²).  ``mu`` must be a
    :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`; raises on
    anything the kernel does not take."""
    return _launch("ch_sif_macro", u, kappa, consts, mu_fn, dt, A, n_steps, round_bf16)


def ac_sif_macro_cuda(u: torch.Tensor, kappa: torch.Tensor, consts: SifConstants, *,
                      mu_fn: Callable, R_fn: Optional[Callable], r_identity: bool,
                      hx: float, hy: float, dt: float, A: float, n_steps: int,
                      round_bf16: bool) -> torch.Tensor:
    """Kernel K9b (``csrc/ac_sif_macro.cu``): same contract as
    :func:`ac_sif_macro_plain`, H and W up to
    :data:`~pde_opt_tpu_torch.ops.cas_spectral.MAX_GRID_TILED` (tiled above
    64²).  ``mu`` must be a
    :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`, and so must
    ``R`` unless ``r_identity``; raises on anything the kernel does not
    take."""
    if not r_identity and not isinstance(R_fn, _cas.PolynomialMu):
        raise ValueError(
            "the CUDA AC macro evaluates a non-identity R from polynomial "
            f"coefficients: pass a PolynomialMu, got {R_fn!r}"
        )
    r_c, n_r = (None, 0) if r_identity else _cas._c_coeffs(R_fn)
    return _launch("ac_sif_macro", u, kappa, consts, mu_fn, dt, A, n_steps, round_bf16,
                   before=(1.0 / (hx * hx), 1.0 / (hy * hy)), after=(r_c, n_r))


def _check_config(H, W, mats_dtype, half_spectrum):
    if H % 8 or W % 8:
        raise ValueError(f"H, W must be multiples of 8, got {(H, W)}")
    if mats_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mats_dtype must be bf16 or f32, got {mats_dtype}")
    return W % 2 == 0 if half_spectrum is None else bool(half_spectrum)


def _oracle_macro(H, W, hx, hy, mats_dtype, half, plain, cuda, oracle, kw):
    """``macro(state, kappa)``: the plain version on CPU tensors, the kernel
    on CUDA tensors, the oracle's VJP as the gradient."""

    def macro(state: torch.Tensor, kappa):
        batch, x, kapf = _cas._flatten_batch(state, kappa, H, W)
        consts = sif_constants(H, W, float(hx), float(hy), mats_dtype, half, state.device)
        impl = plain if state.device.type == "cpu" else cuda

        def run(u, k):
            return impl(u, k, consts, **kw)

        u1 = _cas._OracleMacro.apply(x, kapf, run, oracle, None)
        return u1.to(state.dtype).reshape(*batch, H, W)

    return macro


def make_ch_sif_fused_macro(
    mu_fn: Callable,
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype: torch.dtype = torch.bfloat16,
    half_spectrum: Optional[bool] = None,
):
    """Build ``macro(u, kappa) -> u1`` advancing ``n_steps`` fused CH
    substeps on the packed DFT (the JAX package's ``algo="dft"`` macro).

    ``u`` has shape (..., H, W) (leading axes are the env batch) and
    ``kappa`` broadcasts to the batch.  ``A`` is the implicit splitting
    constant (1 damps high-k bf16 noise deadbeat).  ``half_spectrum``
    (default: W even) keeps only ``kw`` in ``[0, W/2]``.  CPU tensors run
    :func:`ch_sif_macro_plain`, CUDA tensors kernel K9a, where ``mu`` must
    be a :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`.
    Gradients with respect to ``u`` and ``kappa`` are the VJP of
    :func:`ch_sif_macro_reference` with ``remat=True``.  The JAX macro's
    ``block_envs``/``interpret`` (TPU tiling) have no counterpart.
    """
    half = _check_config(H, W, mats_dtype, half_spectrum)
    kw = dict(mu_fn=mu_fn, dt=dt, A=A, n_steps=n_steps,
              round_bf16=mats_dtype == torch.bfloat16)
    oracle = ch_sif_macro_reference(mu_fn, hx, hy, A, dt, n_steps, remat=True)
    return _oracle_macro(H, W, hx, hy, mats_dtype, half, ch_sif_macro_plain,
                         ch_sif_macro_cuda, oracle, kw)


def make_ac_sif_fused_macro(
    mu_fn: Callable,
    R_fn: Optional[Callable],
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype: torch.dtype = torch.bfloat16,
    half_spectrum: Optional[bool] = None,
):
    """Fused Allen-Cahn semi-implicit macro on the packed DFT:
    ``macro(u, kappa) -> u1`` (the JAX package's ``algo="dft"`` macro).

    ``R_fn=None`` stands for ``R ≡ 1``, as does any R the JAX package's
    probe finds equal to 1 (:func:`~pde_opt_tpu_torch.ops.cas_spectral.r_is_identity`).
    CPU tensors run :func:`ac_sif_macro_plain`, CUDA tensors kernel K9b,
    where ``mu`` (and a non-identity ``R``) must be
    :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`.  Gradients
    are the VJP of :func:`ac_sif_macro_reference` with ``remat=True``.
    """
    half = _check_config(H, W, mats_dtype, half_spectrum)
    R = torch.ones_like if R_fn is None else R_fn
    kw = dict(mu_fn=mu_fn, R_fn=R, r_identity=_cas.r_is_identity(R_fn), hx=float(hx),
              hy=float(hy), dt=dt, A=A, n_steps=n_steps,
              round_bf16=mats_dtype == torch.bfloat16)
    oracle = ac_sif_macro_reference(mu_fn, R, hx, hy, A, dt, n_steps, remat=True)
    return _oracle_macro(H, W, hx, hy, mats_dtype, half, ac_sif_macro_plain,
                         ac_sif_macro_cuda, oracle, kw)


# ---- the FFT oracles ----------------------------------------------------------

def _oracle_setup(u: torch.Tensor, kappa, hx: float, hy: float):
    """``(lam (H, W), kap (*batch, 1, 1))`` in the field's dtype and device."""
    H, W = u.shape[-2:]
    lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
    lam = torch.from_numpy(lam_h[:, None] + lam_w[None, :]).to(u.device, u.dtype)
    kap = torch.as_tensor(kappa, device=u.device)
    if kap.ndim <= 1:
        kap = torch.broadcast_to(kap, u.shape[:-2]).reshape(u.shape[:-2] + (1, 1))
    return lam, kap


def ch_sif_macro_reference(mu_fn, hx, hy, A, dt, n_steps, remat=False):
    """FFT reference of the fused kernel's exact semantics (the oracle).

    Per substep, per env with its own κ:
    ``u += dt * ifft(denom * (lam * fft(mu(u)) - κ lam² fft(u)))`` with the
    FD Laplacian symbol ``lam`` and ``denom = 1/(1 + A dt κ lam²)``,
    evaluated with :mod:`torch.fft` in the field's dtype.  With
    ``remat=True`` each substep runs under
    :func:`torch.utils.checkpoint.checkpoint`, so reverse mode keeps only
    the field per substep: the backward of the fused DFT macro.
    """

    def macro(u: torch.Tensor, kappa) -> torch.Tensor:
        lam, kap = _oracle_setup(u, kappa, hx, hy)
        denom = 1.0 / (1.0 + A * dt * kap * lam**2)

        def body(uu):
            m_hat = torch.fft.fftn(mu_fn(uu), dim=(-2, -1))
            u_hat = torch.fft.fftn(uu, dim=(-2, -1))
            incr = denom * (lam * m_hat - kap * lam**2 * u_hat)
            return uu + dt * torch.fft.ifftn(incr, dim=(-2, -1)).real.to(uu.dtype)

        for _ in range(n_steps):
            u = checkpoint(body, u, use_reentrant=False) if remat else body(u)
        return u

    return macro


def ac_sif_macro_reference(mu_fn, R_fn, hx, hy, A, dt, n_steps, remat=False):
    """FFT oracle of the fused AC macro (the JAX package's
    ``ac_sif_macro_reference``).

    Per substep, per env with its own κ and ``denom = 1/(1 + A dt κ (-lam))``:
    ``lap = ifft(lam fft(u))``, ``g = -R(u) (mu(u) - κ lap)``,
    ``u += dt ifft(denom fft(g))``.  With ``remat=True`` each substep runs
    under :func:`torch.utils.checkpoint.checkpoint`, so reverse mode keeps
    only the field per substep: the backward of the fused AC macros.
    """

    def macro(u: torch.Tensor, kappa) -> torch.Tensor:
        lam, kap = _oracle_setup(u, kappa, hx, hy)
        denom = 1.0 / (1.0 + A * dt * kap * (-lam))

        def body(uu):
            lap = torch.fft.ifftn(lam * torch.fft.fftn(uu, dim=(-2, -1)),
                                  dim=(-2, -1)).real.to(uu.dtype)
            g = -R_fn(uu) * (mu_fn(uu) - kap * lap)
            incr = denom * torch.fft.fftn(g, dim=(-2, -1))
            return uu + dt * torch.fft.ifftn(incr, dim=(-2, -1)).real.to(uu.dtype)

        for _ in range(n_steps):
            u = checkpoint(body, u, use_reentrant=False) if remat else body(u)
        return u

    return macro
