"""Hartley-transform fused semi-implicit CH and AC macro-steps (PyTorch port).

Counterpart of :func:`pde_opt_tpu.ops.cas_spectral.make_ch_cas_fused_macro`
and :func:`~pde_opt_tpu.ops.cas_spectral.make_ch_cas_fused_macro_ep`.  Every
multiplier of the semi-implicit CH update is even in each frequency axis,
so the real, symmetric cas transform ``C[x,k] = cos(2πxk/N) + sin(2πxk/N)``
diagonalises it; the spectrum ``u~`` is carried across substeps:

    u~ = fwd(u)                                     fwd(z) = C_H^T z C_W
    n_steps times:
        incr = cm * fwd(mu(u)) - cu * u~            inv(z) = fwd(z) / (H W)
        u~  += incr
        u   += inv(incr)

with ``cm = dt lam / (1 + A dt κ lam²)`` and ``cu = dt κ lam² / (1 + A dt κ
lam²)`` for the FD Laplacian symbol ``lam`` and each env's own κ.  With
``mats_dtype=torch.bfloat16`` (the default, as in the JAX package) the cas
matrices, each transform's operand and its intermediate are rounded to bf16
where the JAX kernel rounds them; products accumulate in f32.

The optional env epilogue emits, from the same pass over the final field,
per-env ``[sum(u-c), sum((u-c)^2), n_finite]`` over finite pixels and the
uint8 observation ``clip(u*scale + offset, 0, 255)`` (mean-pooled by
``obs_downsample``), so the env step never re-reads the field.

Each macro has two implementations of the same function:
:func:`ch_cas_macro_plain` (plain torch; what CPU tensors run) and
:func:`ch_cas_macro_cuda` (the hand-written Hopper kernel
``csrc/ch_cas_macro.cu``; what CUDA tensors run).  So has its backward:
:func:`ch_cas_macro_bwd_plain` and :func:`ch_cas_macro_bwd_cuda` (kernel
K3, in the same source).  Both take grids up to 256²: above 64² they run
the tiled kernels (``csrc/cas_tiled.cuh``), whose per-block scratch the
wrappers allocate, except the forward with bf16 matrices on a square grid
up to 128², which keeps each env on chip (``csrc/cas_onchip.cuh``).  The
macros are ``torch.autograd.Function``s whose backward is the JAX package's
custom VJP: re-run the forward, then sweep back through the same
transforms, rounding where the forward rounds.
There is no fallback from one implementation to the other.

The Allen-Cahn macro (:func:`make_ac_cas_fused_macro`, kernel K4 in
``csrc/ac_cas_macro.cu``, tiled above 64² as well) runs on the same
transforms and epilogue; its backward is the VJP of the checkpointed FFT
oracle, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .fold import fold_vmap
from .fused_spectral import _fd_lap_symbols, ac_sif_macro_reference, ch_sif_macro_reference
from .kernels import count_launch, load_library

__all__ = [
    "PolynomialMu",
    "MAX_MU_DEGREE",
    "CasConstants",
    "Epilogue",
    "cas_constants",
    "ch_cas_macro_plain",
    "ch_cas_macro_cuda",
    "ch_cas_macro_bwd_plain",
    "ch_cas_macro_bwd_cuda",
    "make_ch_cas_fused_macro",
    "make_ch_cas_fused_macro_ep",
    "ch_cas_macro_reference",
    "r_is_identity",
    "ac_cas_macro_plain",
    "ac_cas_macro_cuda",
    "make_ac_cas_fused_macro",
]

# Same semantics as the fused DFT kernel -> same oracle.
ch_cas_macro_reference = ch_sif_macro_reference

MAX_MU_DEGREE = 7
# The largest H, W each CUDA macro takes: every family (K1-K7, K9a/K9b) runs
# tiled kernels above 64^2, up to MAX_GRID_TILED.
MAX_GRID_TILED = 256


class PolynomialMu:
    """``mu(c) = sum_i coeffs[i] * c**i``, evaluated by Horner's rule.

    The CUDA kernel cannot trace a Python callable the way the Pallas kernel
    traces ``mu_fn``; it reads these coefficients instead.  Degree ≤ 7.
    ``PolynomialMu((0.0, -1.0, 0.0, 1.0))`` is the CH preset's ``c**3 - c``.
    """

    def __init__(self, coeffs: Sequence[float]):
        coeffs = tuple(float(c) for c in coeffs)
        if not 1 <= len(coeffs) <= MAX_MU_DEGREE + 1:
            raise ValueError(
                f"PolynomialMu takes 1 to {MAX_MU_DEGREE + 1} coefficients, "
                f"got {len(coeffs)}"
            )
        self.coeffs = coeffs

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        p = torch.full_like(c, self.coeffs[-1])
        for a in reversed(self.coeffs[:-1]):
            p = p * c + a
        return p

    def derivative(self) -> "PolynomialMu":
        """``mu'`` as a polynomial: what the backward kernel evaluates where
        the JAX kernel takes ``jax.jvp`` of ``mu_fn``."""
        d = tuple(i * c for i, c in enumerate(self.coeffs) if i)
        return PolynomialMu(d or (0.0,))

    def __eq__(self, other):
        return isinstance(other, PolynomialMu) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash((PolynomialMu, self.coeffs))

    def __repr__(self):
        return f"PolynomialMu({self.coeffs})"


def _cas_mat(N: int) -> np.ndarray:
    """Symmetric cas (Hartley) matrix: C @ C = N * I."""
    x = np.arange(N)
    ang = 2.0 * np.pi * np.outer(x, x) / N
    return np.cos(ang) + np.sin(ang)


class CasConstants(NamedTuple):
    """The macro's constant operands, contiguous on one device.

    ``ch``/``cw`` are the cas matrices and ``ich``/``icw`` the inverse pair
    ``C/N``, f32, each already rounded to ``mats_dtype``; ``lam``/``lam2``
    are the FD Laplacian symbol and its square on the (H, W) grid (f32).
    With bf16 matrices, ``ch16`` .. ``icw16`` are the same four as bf16
    tensors (exact copies), which the tiled tensor-core CH kernels read;
    ``None`` with f32 matrices, where those kernels refuse the launch.
    ``lam_h`` (H,) and ``lam_w`` (W,) are the f64 axis symbols that ``lam =
    f32(lam_h + lam_w)`` and ``lam2 = f32((lam_h + lam_w)**2)`` are built
    from; the on-chip CH forward rebuilds the two planes from them.
    """

    ch: torch.Tensor
    cw: torch.Tensor
    ich: torch.Tensor
    icw: torch.Tensor
    lam: torch.Tensor
    lam2: torch.Tensor
    ch16: Optional[torch.Tensor] = None
    cw16: Optional[torch.Tensor] = None
    ich16: Optional[torch.Tensor] = None
    icw16: Optional[torch.Tensor] = None
    lam_h: Optional[torch.Tensor] = None
    lam_w: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=32)
def cas_constants(H: int, W: int, hx: float, hy: float,
                  mats_dtype: torch.dtype, device: torch.device) -> CasConstants:
    """Build (once per configuration and device) the macro's constants."""

    def mat(m):
        return torch.from_numpy(m).to(mats_dtype).to(device, torch.float32).contiguous()

    lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
    lam = lam_h[:, None] + lam_w[None, :]                          # (H, W) f64

    def f32(a):
        return torch.from_numpy(a).to(device, torch.float32).contiguous()

    mats = {"ch": mat(_cas_mat(H)), "cw": mat(_cas_mat(W)),
            "ich": mat(_cas_mat(H) / H), "icw": mat(_cas_mat(W) / W)}
    if mats_dtype == torch.bfloat16:
        mats.update({f"{n}16": m.to(torch.bfloat16) for n, m in list(mats.items())})
    return CasConstants(**mats, lam=f32(lam), lam2=f32(lam**2),
                        lam_h=torch.from_numpy(lam_h).to(device),
                        lam_w=torch.from_numpy(lam_w).to(device))


class Epilogue(NamedTuple):
    """Env-epilogue configuration (the kernel's ``_ep_parse``)."""

    obs_scale: float = 255.0
    obs_offset: float = 0.0
    center: float = 0.0
    ds: int = 1

    @classmethod
    def from_dict(cls, cfg: dict, H: int, W: int) -> "Epilogue":
        ep = cls(float(cfg.get("obs_scale", 255.0)),
                 float(cfg.get("obs_offset", 0.0)),
                 float(cfg.get("stats_center", 0.0)),
                 int(cfg.get("obs_downsample", 1)))
        if ep.ds < 1 or H % ep.ds or W % ep.ds:
            raise ValueError(f"obs_downsample={ep.ds} must divide {(H, W)}")
        return ep


def _coeffs(kappa, lam, lam2, A, dt):
    """Per-env ``(denom, cm, cu)``, f32, in the JAX kernel's order."""
    k = kappa.reshape(-1, 1, 1)
    denom = 1.0 / (1.0 + float(A) * float(dt) * (k * lam2))
    cm = (float(dt) * lam) * denom
    cu = (float(dt) * k) * lam2 * denom
    return denom, cm, cu


def _transforms(consts: CasConstants, round_bf16: bool):
    """``(fwd, inv)`` of the JAX kernel's ``make_transforms``: with bf16
    matrices each transform rounds its operand and its intermediate."""
    if round_bf16:
        def rnd(z):
            return z.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(z):
            return z

    def transform(z, mh, mw):
        t = rnd(torch.matmul(rnd(z).transpose(-1, -2), mh))          # [b, w, k]
        return torch.matmul(t.transpose(-1, -2), mw)                  # [b, k, l]

    return (lambda z: transform(z, consts.ch, consts.cw),
            lambda z: transform(z, consts.ich, consts.icw))


def ch_cas_macro_plain(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                       *, mu_fn: Callable, dt: float, A: float, n_steps: int,
                       round_bf16: bool, epilogue: Optional[Epilogue] = None):
    """Plain-torch macro: ``u`` (B, H, W) f32, ``kappa`` (B,) f32.

    Returns ``u1`` or, with ``epilogue``, ``(u1, stats (B, 3), obs uint8)``.
    Runs on any device; it is what the macro runs on CPU tensors and what
    the CUDA kernel is held against on the card.
    """
    fwd, inv = _transforms(consts, round_bf16)
    _, cm, cu = _coeffs(kappa, consts.lam, consts.lam2, A, dt)
    u_t = fwd(u)
    for _ in range(n_steps):
        incr = cm * fwd(mu_fn(u)) - cu * u_t
        u_t = u_t + incr
        u = u + inv(incr)
    if epilogue is None:
        return u
    return (u, *_epilogue_plain(u, epilogue))


def _epilogue_plain(u: torch.Tensor, epilogue: Epilogue):
    """The field epilogue of the CH and AC macros on the final field ``u``
    (B, H, W): ``(stats (B, 3), obs uint8)``."""
    fin = torch.isfinite(u)
    uz = torch.where(fin, u - epilogue.center, torch.zeros_like(u))
    stats = torch.stack(
        [uz.sum((-2, -1)), (uz * uz).sum((-2, -1)),
         fin.sum((-2, -1)).to(torch.float32)], dim=-1,
    )
    ds = epilogue.ds
    if ds > 1:
        B, H, W = u.shape
        inv = 1.0 / ds
        pooled = (uz.reshape(B, H // ds, ds, W // ds, ds) * inv).sum(2)
        pooled = (pooled * inv).sum(-1)                               # (B, Hd, Wd)
        x = (pooled + epilogue.center) * epilogue.obs_scale + epilogue.obs_offset
    else:
        x = torch.where(fin, u, torch.zeros_like(u)) * epilogue.obs_scale + epilogue.obs_offset
    return stats, torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def ch_cas_macro_bwd_plain(u: torch.Tensor, kappa: torch.Tensor, g: torch.Tensor,
                           consts: CasConstants, *, mu_fn: Callable, dt: float,
                           A: float, n_steps: int, round_bf16: bool):
    """Plain-torch VJP of the macro (the JAX kernel's ``bwd_kernel``).

    ``u`` (B, H, W) and ``kappa`` (B,) are the macro's inputs and ``g``
    (B, H, W) the cotangent of ``u1``; returns ``(du (B, H, W), dkappa
    (B,))``.  The forward substeps are re-run into a list, then swept in
    reverse; the cas matrices are symmetric and the multipliers diagonal, so
    each transposed operator is again transform-multiply-transform:

        gbar_k = gbar_{k+1} + mu'(u_k) * inv(cm * ghat) - inv(cu * ghat)
        kacc  += ghat/(H W) * (dcm * fwd(mu(u_k)) - dcu * fwd(u_k))

    with ``ghat = fwd(gbar_{k+1})``, ``dcm = d cm/d kappa = -A dt² lam³
    denom²`` and ``dcu = d cu/d kappa = dt lam² denom²``; ``dkappa`` is the
    per-env sum of ``kacc``.
    """
    fwd, inv = _transforms(consts, round_bf16)
    lam, lam2 = consts.lam, consts.lam2
    denom, cm, cu = _coeffs(kappa, lam, lam2, A, dt)
    dcm = -(float(A) * float(dt) * float(dt)) * (lam * lam2) * denom * denom
    dcu = float(dt) * lam2 * denom * denom

    traj = []
    u_t = fwd(u)
    for _ in range(n_steps):
        traj.append(u)
        incr = cm * fwd(mu_fn(u)) - cu * u_t
        u_t = u_t + incr
        u = u + inv(incr)

    inv_hw = 1.0 / float(u.shape[-2] * u.shape[-1])
    gbar = g
    kacc = torch.zeros_like(g)
    for u_k in reversed(traj):
        ghat = fwd(gbar)
        mu_p = torch.func.jvp(mu_fn, (u_k,), (torch.ones_like(u_k),))[1]
        kacc = kacc + (inv_hw * ghat) * (dcm * fwd(mu_fn(u_k)) - dcu * fwd(u_k))
        gbar = gbar + mu_p * inv(cm * ghat) - inv(cu * ghat)
    return gbar, kacc.sum((-2, -1))


def _bind_ch_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K1-K3's C interface on ``lib`` (``csrc/ch_cas_macro.cu`` built
    for the card, or for the CPU by the tests' stub build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ch_cas_macro_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p,    # u, kappa, ch, cw, ich, icw, ch16 .. icw16
        p, p, p, p,                      # lam, lam2, lam_h, lam_w
        p, p, p, p, i,                   # out, stats, obs, scratch, n_slots
        i, i, i, i, f, f,                # B, H, W, n_steps, dt, A*dt
        p, i, i,                         # mu coeffs, n_coeffs, round_bf16
        i, f, f, f,                      # ds, obs_scale, obs_offset, center
        p,                               # stream
    ]
    lib.ch_cas_macro_launch.restype = ctypes.c_int
    lib.ch_cas_macro_onchip.argtypes = [i, i, i]
    lib.ch_cas_macro_onchip.restype = ctypes.c_int
    lib.ch_cas_macro_scratch.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_longlong)]
    lib.ch_cas_macro_scratch.restype = ctypes.c_int
    lib.ch_cas_macro_bwd_launch.argtypes = [
        p, p, p,                         # u, kappa, g
        p, p, p, p, p, p, p, p, p, p,    # ch, cw, ich, icw, ch16 .. icw16, lam, lam2
        p, p, p, i,                      # du, dkappa, scratch, n_slots
        i, i, i, i, f, f, f,             # B, H, W, n_steps, dt, A*dt, -A*dt*dt
        p, i, p, i, i,                   # mu, n, mu', n, round_bf16
        p,                               # stream
    ]
    lib.ch_cas_macro_bwd_launch.restype = ctypes.c_int
    lib.ch_cas_error_string.argtypes = [ctypes.c_int]
    lib.ch_cas_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return _bind_ch_library(load_library("ch_cas_macro"))


def _raise_if(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: {_library().ch_cas_error_string(rc).decode()}"
        )


def _check_cuda(name, t, shape, dtype, device):
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA macro needs CUDA tensors; {name} is on {t.device}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{name} must be {dtype} of shape {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_grid(u, ndim: int = 3):
    """Raise on a state the CUDA kernels do not take: ``(B, H, W)`` (with
    ``ndim=4`` ``(B, H, W, 2)``), B >= 1, H and W multiples of 8 up to
    :data:`MAX_GRID_TILED`.  Returns ``(B, H, W)``."""
    if u.ndim != ndim or (ndim == 4 and u.shape[-1] != 2):
        want = "(B, H, W)" if ndim == 3 else "(B, H, W, 2)"
        raise ValueError(f"the state must be {want}, got shape {tuple(u.shape)}")
    B, H, W = u.shape[:3]
    cap = MAX_GRID_TILED
    if B < 1 or H % 8 or W % 8 or not (8 <= H <= cap and 8 <= W <= cap):
        raise ValueError(
            f"the CUDA macro takes B >= 1 envs and H, W multiples of 8 up to "
            f"{cap}; got {(B, H, W)}"
        )
    return B, H, W


def _check_macro_args(u, kappa, consts, mu_fn):
    """Raise on what the CUDA kernels do not take; return ``(B, H, W)``."""
    if not isinstance(mu_fn, PolynomialMu):
        raise ValueError(
            "the CUDA macro evaluates mu from polynomial coefficients: pass a "
            f"PolynomialMu, got {mu_fn!r}"
        )
    B, H, W = _check_grid(u)
    dev = u.device
    _check_cuda("u", u, (B, H, W), torch.float32, dev)
    _check_cuda("kappa", kappa, (B,), torch.float32, dev)
    for name in ("lam", "lam2"):
        _check_cuda(name, getattr(consts, name), (H, W), torch.float32, dev)
    _check_mats(consts, H, W, dev)
    return B, H, W


def _check_mats(consts, H: int, W: int, dev):
    """Raise unless ``consts`` holds the cas matrices ``ch, cw, ich, icw``
    (f32) on ``dev`` for an (H, W) grid, and their bf16 copies ``ch16`` ..
    ``icw16`` where it has them."""
    for name, shape in (("ch", (H, H)), ("cw", (W, W)), ("ich", (H, H)), ("icw", (W, W))):
        _check_cuda(name, getattr(consts, name), shape, torch.float32, dev)
        if getattr(consts, name + "16") is not None:
            _check_cuda(name + "16", getattr(consts, name + "16"), shape, torch.bfloat16, dev)


def _mats_ptrs(consts):
    """The pointers of ``ch, cw, ich, icw, ch16 .. icw16`` as the launches
    take them, null where there is no bf16 copy (f32 matrices: a launch
    refuses a grid whose kernel reads one)."""
    return tuple(None if m is None else m.data_ptr()
                 for m in (consts.ch, consts.cw, consts.ich, consts.icw, consts.ch16,
                           consts.cw16, consts.ich16, consts.icw16))


def _mat_ptrs(consts: CasConstants):
    """The pointers of ``ch, cw, ich, icw, ch16 .. icw16, lam, lam2`` as the
    CH launches take them (:func:`_mats_ptrs`, then the symbols)."""
    return (*_mats_ptrs(consts), consts.lam.data_ptr(), consts.lam2.data_ptr())


def _axis_ptrs(consts: CasConstants):
    """The pointers of the f64 axis symbols ``lam_h, lam_w`` as the CH
    forward launch takes them, after :func:`_mat_ptrs`."""
    return consts.lam_h.data_ptr(), consts.lam_w.data_ptr()


@functools.lru_cache(maxsize=None)
def _ch_onchip(H: int, W: int, round_bf16: bool) -> bool:
    """Whether the CH forward of an (H, W) grid runs the on-chip kernel
    (``ch_cas_macro_onchip_kernel``; the rule is the library's
    ``ch_cas_macro_onchip``): bf16 matrices on a square grid above 64² up to
    128²."""
    return bool(_library().ch_cas_macro_onchip(int(H), int(W), int(bool(round_bf16))))


def _c_coeffs(mu: PolynomialMu):
    return (ctypes.c_float * len(mu.coeffs))(*mu.coeffs), len(mu.coeffs)


@functools.lru_cache(maxsize=None)
def _scratch(library: Callable, query: str, device_index: int, *args: int):
    """``(slots, floats)``: the scratch a launch needs on one device, one
    slot of ``floats`` f32 for each block resident at once, as the
    library's ``query`` (``ch_cas_macro_scratch``, ``ac_cas_macro_scratch``,
    ``gpe_strang_macro_scratch``, ``bv_cc_macro_scratch`` or
    ``sbm_bv_macro_scratch``) gives it for ``args``; ``(0, 0)`` where the
    kernel takes none."""
    n, floats = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        rc = getattr(library(), query)(*args, ctypes.byref(n), ctypes.byref(floats))
    if rc != 0:
        raise RuntimeError(f"{query} failed with CUDA error {rc}")
    return n.value, floats.value


def _alloc_scratch(dev, B, library, query, *args):
    """``(scratch, slots)`` for a launch of ``B`` envs: ``min(B, slots)``
    slots as :func:`_scratch` sizes them, allocated with ``torch.empty``
    (``(None, 0)`` where the kernel takes none).  Raises ``RuntimeError``
    naming the size where the card cannot hold it (K3 at 256² keeps n + 5
    planes of 256 KB a slot: 14 MB at 50 substeps)."""
    slots, floats = _scratch(library, query, dev.index, *(int(a) for a in args))
    if floats == 0:
        return None, 0
    slots = min(B, slots)
    try:
        return torch.empty((slots * floats,), dtype=torch.float32, device=dev), slots
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"{query}{tuple(args)}: {slots} scratch slots of {floats * 4 / 2**20:.1f} MiB do "
            f"not fit on {dev}; run fewer substeps a call") from e


def ch_cas_macro_cuda(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                      *, mu_fn: Callable, dt: float, A: float, n_steps: int,
                      round_bf16: bool, epilogue: Optional[Epilogue] = None):
    """The Hopper kernel: same contract as :func:`ch_cas_macro_plain`.

    Launches ``csrc/ch_cas_macro.cu`` on the current stream (K1 with an
    epilogue, K2 without; with ``round_bf16`` on the tensor cores, else f32
    FMA) and counts the launch.  H and W up to :data:`MAX_GRID_TILED`:
    above 64² with bf16 matrices on a square grid up to 128² the on-chip
    kernel runs (also counted as ``ch_cas_macro.onchip``, :func:`_ch_onchip`),
    otherwise above 64² the tiled kernel, with a scratch of three H x W planes
    for each resident block, allocated here.  Raises on anything the kernel
    does not take.
    """
    B, H, W = _check_macro_args(u, kappa, consts, mu_fn)
    dev = u.device
    _check_cuda("lam_h", consts.lam_h, (H,), torch.float64, dev)
    _check_cuda("lam_w", consts.lam_w, (W,), torch.float64, dev)
    out = torch.empty_like(u)
    stats = obs = None
    if epilogue is not None:
        ds = epilogue.ds
        if ds < 1 or H % ds or W % ds:
            raise ValueError(f"obs_downsample={ds} must divide {(H, W)}")
        stats = torch.empty((B, 3), dtype=torch.float32, device=dev)
        obs = torch.empty((B, H // ds, W // ds), dtype=torch.uint8, device=dev)
    coeffs, n_coeffs = _c_coeffs(mu_fn)
    scratch, slots = _alloc_scratch(dev, B, _library, "ch_cas_macro_scratch", 0, round_bf16,
                                    H, W, n_steps)
    with torch.cuda.device(dev):
        rc = _library().ch_cas_macro_launch(
            u.data_ptr(), kappa.data_ptr(), *_mat_ptrs(consts), *_axis_ptrs(consts),
            out.data_ptr(), stats.data_ptr() if stats is not None else None,
            obs.data_ptr() if obs is not None else None,
            scratch.data_ptr() if scratch is not None else None, slots,
            B, H, W, int(n_steps), float(dt), float(A) * float(dt),
            coeffs, n_coeffs, int(bool(round_bf16)),
            epilogue.ds if epilogue else 1,
            epilogue.obs_scale if epilogue else 0.0,
            epilogue.obs_offset if epilogue else 0.0,
            epilogue.center if epilogue else 0.0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_if(rc, "ch_cas_macro launch")
    if _ch_onchip(H, W, round_bf16):
        count_launch("ch_cas_macro.onchip")
    if epilogue is None:
        count_launch("ch_cas_macro")
        return out
    count_launch("ch_cas_macro_ep")
    return out, stats, obs


def ch_cas_macro_bwd_cuda(u: torch.Tensor, kappa: torch.Tensor, g: torch.Tensor,
                          consts: CasConstants, *, mu_fn: Callable, dt: float,
                          A: float, n_steps: int, round_bf16: bool):
    """The Hopper backward kernel K3 (with ``round_bf16`` on the tensor
    cores, else f32 FMA): same contract as :func:`ch_cas_macro_bwd_plain`.

    ``mu'`` reaches the kernel as :meth:`PolynomialMu.derivative`.  Each
    resident block re-runs its envs' forward into its own slot of a
    device-memory scratch, allocated here: ``n_steps`` H x W f32 planes a
    slot at 64² and below (43 MB at 64², 10 substeps on an H100: 264
    slots), ``n_steps + 5`` above (the tiled kernel's planes: 3.8 MB a slot
    at 256², 10 substeps), H and W up to :data:`MAX_GRID_TILED`.  Launches
    on the current stream and counts the launch; raises on anything the
    kernel does not take.
    """
    B, H, W = _check_macro_args(u, kappa, consts, mu_fn)
    dev = u.device
    _check_cuda("g", g, (B, H, W), torch.float32, dev)
    n_steps = int(n_steps)
    du = torch.empty_like(u)
    dkappa = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch, slots = _alloc_scratch(dev, B, _library, "ch_cas_macro_scratch", 1, round_bf16,
                                    H, W, n_steps)
    coeffs, n_coeffs = _c_coeffs(mu_fn)
    dcoeffs, n_dcoeffs = _c_coeffs(mu_fn.derivative())
    with torch.cuda.device(dev):
        rc = _library().ch_cas_macro_bwd_launch(
            u.data_ptr(), kappa.data_ptr(), g.data_ptr(), *_mat_ptrs(consts),
            du.data_ptr(), dkappa.data_ptr(), scratch.data_ptr(), slots,
            B, H, W, n_steps, float(dt), float(A) * float(dt),
            -(float(A) * float(dt) * float(dt)),
            coeffs, n_coeffs, dcoeffs, n_dcoeffs, int(bool(round_bf16)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_if(rc, "ch_cas_macro_bwd launch")
    count_launch("ch_cas_macro_bwd")
    return du, dkappa


def _ep_fold_stats_cotangent(u1, gu, gstats, center):
    """Fold the stats cotangent into the field cotangent at the final field
    (``s1 = sum(uz)``, ``s2 = sum(uz²)`` over the NaN-masked centered field
    ``uz``; the finite count has zero gradient almost everywhere)."""
    fin = torch.isfinite(u1)
    uz = torch.where(fin, u1 - center, torch.zeros_like(u1))
    return gu + torch.where(
        fin, gstats[..., 0, None, None] + 2.0 * uz * gstats[..., 1, None, None],
        torch.zeros_like(u1),
    )


def _run_fwd(x, kapf, consts, kw, epilogue):
    run = ch_cas_macro_plain if x.device.type == "cpu" else ch_cas_macro_cuda
    return run(x, kapf, consts, epilogue=epilogue, **kw)


def _run_bwd(x, kapf, g, consts, kw):
    run = ch_cas_macro_bwd_plain if x.device.type == "cpu" else ch_cas_macro_bwd_cuda
    return run(x, kapf, g.contiguous(), consts, **kw)


def _flatten_batch(state: torch.Tensor, kappa, H: int, W: int):
    """``(batch, x (B, H, W) f32, kapf (B,) f32)`` from a ``(*batch, H, W)``
    state and a scalar, ``(B,)`` or batch-shaped κ.  The broadcast to a flat
    ``(B,)`` vector is plain torch, so every κ shape gets its cotangent from
    autograd."""
    *batch, h, w = state.shape
    if (h, w) != (H, W):
        raise ValueError(f"state trailing shape {(h, w)} != {(H, W)}")
    B = math.prod(batch) if batch else 1
    x = state.reshape(B, H, W).to(torch.float32).contiguous()
    kap = torch.as_tensor(kappa, dtype=torch.float32, device=state.device)
    kapf = (torch.broadcast_to(kap, (B,)) if kap.ndim <= 1
            else kap.reshape(B)).contiguous()
    return batch, x, kapf


class _CasMacro(torch.autograd.Function):
    """The JAX macro's ``_core``: ``x`` (B, H, W), ``kapf`` (B,) f32 ->
    ``u1``, with the backward kernel as its VJP (``_core_bwd``).  Under
    :func:`torch.func.vmap` the vmapped axis folds into the env axis: one
    launch for the whole fleet (:func:`~pde_opt_tpu_torch.ops.fold.fold_vmap`)."""

    @staticmethod
    def forward(x, kapf, consts, kw):
        return _run_fwd(x, kapf, consts, kw, None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, kapf, ctx.consts, ctx.kw = inputs
        ctx.save_for_backward(x, kapf)

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(_CasMacro.apply, info, in_dims, 2, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, kapf = ctx.saved_tensors
        du, dkappa = _run_bwd(x, kapf, g, ctx.consts, ctx.kw)
        return du, dkappa, None, None


class _CasMacroEp(torch.autograd.Function):
    """The JAX macro's ``_core_ep``: ``(u1, stats, obs)``.  ``obs`` is not
    differentiable; the stats cotangent folds into the field cotangent at
    ``u1`` before the backward kernel runs (``_core_ep_bwd``).  Under
    :func:`torch.func.vmap` it folds as :class:`_CasMacro` does."""

    @staticmethod
    def forward(x, kapf, consts, kw, epilogue):
        return _run_fwd(x, kapf, consts, kw, epilogue)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, kapf, ctx.consts, ctx.kw, epilogue = inputs
        ctx.center = epilogue.center
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(x, kapf, output[0])

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(_CasMacroEp.apply, info, in_dims, 2, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, gu, gstats, _gobs):
        x, kapf, u1 = ctx.saved_tensors
        g = _ep_fold_stats_cotangent(u1, gu, gstats, ctx.center)
        du, dkappa = _run_bwd(x, kapf, g, ctx.consts, ctx.kw)
        return du, dkappa, None, None, None


def make_ch_cas_fused_macro(
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
    epilogue: Optional[dict] = None,
):
    """Build ``macro(u, kappa) -> u1`` advancing ``n_steps`` fused substeps.

    ``u`` has shape (..., H, W) (leading axes are the env batch) and
    ``kappa`` broadcasts to the batch (scalar, ``(B,)`` or batch-shaped).
    With ``epilogue`` (keys ``obs_scale``, ``obs_offset``,
    ``obs_downsample``, ``stats_center``) the macro returns
    ``(u1, stats, obs)`` as :func:`make_ch_cas_fused_macro_ep` documents.
    CPU tensors run :func:`ch_cas_macro_plain`; CUDA tensors run the Hopper
    kernel through :func:`ch_cas_macro_cuda`.  Gradients with respect to
    ``u`` and ``kappa`` run the backward of the same kind (plain on CPU,
    kernel K3 on CUDA); ``kappa``'s comes back in the caller's shape.
    ``mats_dtype`` is bf16 (the JAX default) or f32 (no rounding).
    """
    if H % 8 or W % 8:
        raise ValueError(f"H, W must be multiples of 8, got {(H, W)}")
    if mats_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mats_dtype must be bf16 or f32, got {mats_dtype}")
    ep = Epilogue.from_dict(epilogue, H, W) if epilogue is not None else None
    kw = dict(mu_fn=mu_fn, dt=dt, A=A, n_steps=n_steps,
              round_bf16=mats_dtype == torch.bfloat16)

    def macro(state: torch.Tensor, kappa):
        batch, x, kapf = _flatten_batch(state, kappa, H, W)
        consts = cas_constants(H, W, float(hx), float(hy), mats_dtype, state.device)
        if ep is None:
            u1 = _CasMacro.apply(x, kapf, consts, kw)
            return u1.to(state.dtype).reshape(*batch, H, W)
        u1, stats, obs = _CasMacroEp.apply(x, kapf, consts, kw, ep)
        return (u1.to(state.dtype).reshape(*batch, H, W),
                stats.reshape(*batch, 3),
                obs.reshape(*batch, H // ep.ds, W // ep.ds))

    return macro


def make_ch_cas_fused_macro_ep(
    mu_fn: Callable,
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    obs_scale: float = 255.0,
    obs_offset: float = 0.0,
    obs_downsample: int = 1,
    stats_center: float = 0.0,
    mats_dtype: torch.dtype = torch.bfloat16,
):
    """Fused CH macro WITH the env epilogue: ``macro(u, kappa) -> (u1, stats, obs)``.

    * ``stats``: (..., 3) f32 per env — ``[sum(u-c), sum((u-c)**2),
      n_finite]`` over the finite pixels, ``c = stats_center``.
    * ``obs``: (..., H/ds, W/ds) uint8 — ``clip(u*obs_scale + obs_offset,
      0, 255)`` on the NaN-masked field, mean-pooled first when
      ``ds = obs_downsample > 1``.
    """
    return make_ch_cas_fused_macro(
        mu_fn, H, W, hx, hy, A, dt, n_steps, mats_dtype=mats_dtype,
        epilogue={"obs_scale": obs_scale, "obs_offset": obs_offset,
                  "obs_downsample": obs_downsample,
                  "stats_center": stats_center},
    )


# ---- Allen-Cahn: kernel K4 -------------------------------------------------

# The JAX macro's identity-R probe points: dense on the physical [-2, 2]
# band, geometric out to +-64.
_R_PROBE = np.concatenate([
    np.linspace(-2.0, 2.0, 257),
    np.geomspace(2.0, 64.0, 32),
    -np.geomspace(2.0, 64.0, 32),
])


def _probe_r_identity(R_fn) -> bool:
    if R_fn is None:
        return True
    try:
        out = R_fn(torch.as_tensor(_R_PROBE, dtype=torch.float32))
        out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        return bool(np.array_equal(out, np.ones_like(_R_PROBE)))
    except Exception:
        return False


_probe_r_identity_cached = functools.lru_cache(maxsize=64)(_probe_r_identity)


def r_is_identity(R_fn) -> bool:
    """The JAX AC macro's verdict on ``R ≡ 1`` (``R_fn=None`` counts as 1).

    Same probe points and exact equality as the JAX package, evaluated in
    float32 on the CPU (the JAX package's default precision): an R that is
    1 at every probe point is treated as identity, and the macro takes the
    3-transform path.  The verdict is cached per ``R_fn``, so rebuilding the
    macro every env step runs the probe once.
    """
    try:
        return _probe_r_identity_cached(R_fn)
    except TypeError:                      # an unhashable callable
        return _probe_r_identity(R_fn)


def ac_cas_macro_plain(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                       *, mu_fn: Callable, R_fn: Optional[Callable], r_identity: bool,
                       dt: float, A: float, n_steps: int, round_bf16: bool,
                       epilogue: Optional[Epilogue] = None):
    """Plain-torch AC macro: ``u`` (B, H, W) f32, ``kappa`` (B,) f32.

    Returns ``u1`` or, with ``epilogue``, ``(u1, stats (B, 3), obs uint8)``
    (the CH macro's epilogue).  Per substep, with ``dd = dt/(1 + A dt κ
    (-lam))``: ``u += inv(dd (κ lam fwd(u) - fwd(mu(u))))`` when
    ``r_identity``, else ``lap = inv(lam fwd(u))``, ``g = -R(u) (mu(u) - κ
    lap)``, ``u += inv(dd fwd(g))``.  What CPU tensors run and what kernel K4
    is held against on the card.
    """
    fwd, inv = _transforms(consts, round_bf16)
    lam = consts.lam
    k = kappa.reshape(-1, 1, 1)
    denom_dt = float(dt) / (1.0 + float(A) * float(dt) * (k * (-lam)))
    for _ in range(n_steps):
        if r_identity:
            u = u + inv(denom_dt * (k * lam * fwd(u) - fwd(mu_fn(u))))
        else:
            lap = inv(lam * fwd(u))
            g = -R_fn(u) * (mu_fn(u) - k * lap)
            u = u + inv(denom_dt * fwd(g))
    if epilogue is None:
        return u
    return (u, *_epilogue_plain(u, epilogue))


def _bind_ac_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K4's C interface on ``lib`` (``csrc/ac_cas_macro.cu`` built
    for the card, or for the CPU by the tests' stub build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ac_cas_macro_launch.argtypes = [
        p, p, p, p, p, p,                # u, kappa, ch, cw, ich, icw
        p, p, p, p, p,                   # ch16 .. icw16, lam
        p, p, p, p, i,                   # out, stats, obs, scratch, n_slots
        i, i, i, i, f, f,                # B, H, W, n_steps, dt, A*dt
        p, i, p, i,                      # mu coeffs, n, R coeffs, n (0: R == 1)
        i, i, f, f, f,                   # round_bf16, ds, obs_scale, obs_offset, center
        p,                               # stream
    ]
    lib.ac_cas_macro_launch.restype = ctypes.c_int
    lib.ac_cas_macro_scratch.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_longlong)]
    lib.ac_cas_macro_scratch.restype = ctypes.c_int
    lib.ac_cas_error_string.argtypes = [ctypes.c_int]
    lib.ac_cas_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _ac_library():
    return _bind_ac_library(load_library("ac_cas_macro"))


def ac_cas_macro_cuda(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                      *, mu_fn: Callable, R_fn: Optional[Callable], r_identity: bool,
                      dt: float, A: float, n_steps: int, round_bf16: bool,
                      epilogue: Optional[Epilogue] = None):
    """Kernel K4: same contract as :func:`ac_cas_macro_plain`.

    Launches ``csrc/ac_cas_macro.cu`` on the current stream and counts the
    launch (``ac_cas_macro_ep`` with an epilogue, ``ac_cas_macro``
    without).  H and W up to :data:`MAX_GRID_TILED`: above 64² the tiled
    kernel runs, with a scratch of three H x W planes for each resident
    block, allocated here.  ``mu`` must be a :class:`PolynomialMu`, and so
    must ``R`` unless ``r_identity``; raises on anything the kernel does not
    take.
    """
    if not r_identity and not isinstance(R_fn, PolynomialMu):
        raise ValueError(
            "the CUDA AC macro evaluates a non-identity R from polynomial "
            f"coefficients: pass a PolynomialMu, got {R_fn!r}"
        )
    B, H, W = _check_macro_args(u, kappa, consts, mu_fn)
    dev = u.device
    out = torch.empty_like(u)
    stats = obs = None
    if epilogue is not None:
        ds = epilogue.ds
        if ds < 1 or H % ds or W % ds:
            raise ValueError(f"obs_downsample={ds} must divide {(H, W)}")
        stats = torch.empty((B, 3), dtype=torch.float32, device=dev)
        obs = torch.empty((B, H // ds, W // ds), dtype=torch.uint8, device=dev)
    mu_c, n_mu = _c_coeffs(mu_fn)
    r_c, n_r = (None, 0) if r_identity else _c_coeffs(R_fn)
    lib = _ac_library()
    scratch, slots = _alloc_scratch(dev, B, _ac_library, "ac_cas_macro_scratch", round_bf16,
                                    H, W)
    with torch.cuda.device(dev):
        rc = lib.ac_cas_macro_launch(
            u.data_ptr(), kappa.data_ptr(), *_mats_ptrs(consts),
            consts.lam.data_ptr(), out.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            obs.data_ptr() if obs is not None else None,
            scratch.data_ptr() if scratch is not None else None, slots,
            B, H, W, int(n_steps), float(dt), float(A) * float(dt),
            mu_c, n_mu, r_c, n_r, int(bool(round_bf16)),
            epilogue.ds if epilogue else 1,
            epilogue.obs_scale if epilogue else 0.0,
            epilogue.obs_offset if epilogue else 0.0,
            epilogue.center if epilogue else 0.0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ac_cas_macro launch failed: {lib.ac_cas_error_string(rc).decode()}"
        )
    if epilogue is None:
        count_launch("ac_cas_macro")
        return out
    count_launch("ac_cas_macro_ep")
    return out, stats, obs


def _oracle_vjp(oracle: Callable, g, *inputs):
    """Cotangents of ``inputs`` under ``oracle(*inputs)`` for the output
    cotangent ``g``: reverse mode through the (checkpointed) FFT oracle,
    re-run here from the saved inputs."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs]
        out = oracle(*xs)
        return torch.autograd.grad(out, xs, g)


class _OracleMacro(torch.autograd.Function):
    """A macro whose VJP is the checkpointed FFT oracle's (the JAX package's
    ``_attach_oracle_vjp``): the AC and GPE macros, epilogue on or off.

    ``run(x, c)`` is the forward (the kernel or its plain version) and
    returns ``out``, or ``(out, stats, obs)`` when ``fold`` is given;
    ``obs`` is not differentiable, and ``fold(out, g_out, g_stats)`` folds
    the stats cotangent into the output cotangent before the oracle VJP.
    Under :func:`torch.func.vmap` the vmapped axis folds into the env axis:
    ``run`` sees the whole fleet at once."""

    @staticmethod
    def forward(x, c, run, oracle, fold):
        return run(x, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, c, _, ctx.oracle, ctx.fold = inputs
        if ctx.fold is None:
            ctx.save_for_backward(x, c)
            return
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(x, c, output[0])

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(_OracleMacro.apply, info, in_dims, 2, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, *g_ep):
        x, c, *out = ctx.saved_tensors
        if ctx.fold is not None:
            g = ctx.fold(out[0], g, g_ep[0])
        dx, dc = _oracle_vjp(ctx.oracle, g, x, c)
        return dx, dc, None, None, None


def make_ac_cas_fused_macro(
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
    epilogue: Optional[dict] = None,
):
    """Build ``macro(u, kappa) -> u1``: the fused Allen-Cahn semi-implicit
    macro (``∂u/∂t = -R(u) (mu(u) - κ ∇²u)``, FD Laplacian symbol, each env's
    own κ in the implicit denominator ``1/(1 + A dt κ (-lam))``).

    ``R_fn=None``, or an R the JAX package's probe finds equal to 1
    (:func:`r_is_identity`), takes the 3-transform path; any other R the
    4-transform path.  ``u`` is ``(..., H, W)`` and ``kappa`` broadcasts to
    the batch.  With ``epilogue`` (keys ``obs_scale``, ``obs_offset``,
    ``obs_downsample``, ``stats_center``) the macro returns ``(u1, stats,
    obs)`` as :func:`make_ch_cas_fused_macro_ep` documents.  CPU tensors run
    :func:`ac_cas_macro_plain`, CUDA tensors kernel K4; on CUDA ``mu`` (and a
    non-identity ``R``) must be :class:`PolynomialMu`.  Gradients with
    respect to ``u`` and ``kappa`` come from the checkpointed FFT oracle
    (:func:`~pde_opt_tpu_torch.ops.fused_spectral.ac_sif_macro_reference`)
    through the true ``mu_fn`` and ``R_fn``, as in the JAX package.  The JAX
    macro's ``block_envs``/``interpret`` (TPU tiling) have no counterpart.
    """
    if H % 8 or W % 8:
        raise ValueError(f"H, W must be multiples of 8, got {(H, W)}")
    if mats_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mats_dtype must be bf16 or f32, got {mats_dtype}")
    ep = Epilogue.from_dict(epilogue, H, W) if epilogue is not None else None
    kw = dict(mu_fn=mu_fn, R_fn=R_fn, r_identity=r_is_identity(R_fn), dt=dt, A=A,
              n_steps=n_steps, round_bf16=mats_dtype == torch.bfloat16)
    oracle = ac_sif_macro_reference(
        mu_fn, torch.ones_like if R_fn is None else R_fn, hx, hy, A, dt, n_steps,
        remat=True)

    fold = (None if ep is None
            else functools.partial(_ep_fold_stats_cotangent, center=ep.center))

    def macro(state: torch.Tensor, kappa):
        batch, x, kapf = _flatten_batch(state, kappa, H, W)
        consts = cas_constants(H, W, float(hx), float(hy), mats_dtype, state.device)
        impl = ac_cas_macro_plain if state.device.type == "cpu" else ac_cas_macro_cuda

        def run(u, k):
            return impl(u, k, consts, epilogue=ep, **kw)

        if ep is None:
            u1 = _OracleMacro.apply(x, kapf, run, oracle, None)
            return u1.to(state.dtype).reshape(*batch, H, W)
        u1, stats, obs = _OracleMacro.apply(x, kapf, run, oracle, fold)
        return (u1.to(state.dtype).reshape(*batch, H, W),
                stats.reshape(*batch, 3),
                obs.reshape(*batch, H // ep.ds, W // ep.ds))

    return macro
