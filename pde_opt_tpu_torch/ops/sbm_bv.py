"""Fused smoothed-boundary galvanostatic Butler-Volmer macro-step (PyTorch
port of :mod:`pde_opt_tpu.ops.sbm_bv`).

The smoothed-boundary (SBM) chemical potential uses ψ-weighted
variable-coefficient fluxes, ``div(ψ_face grad c)/ψ``, which are not
circular convolutions, so this macro runs stencils instead of cas
transforms.  Per RK4 stage, with each env wrapping periodically on its own:

    Fx = ψ_ax (z[i+1] - z[i]) / hx        Fy = ψ_ay (z[j+1] - z[j]) / hy
    div = (Fx - Fx[i-1]) / hx + (Fy - Fy[j-1]) / hy
    m = mu(z) - (κ/ψ) div

then the closure of :mod:`.bv_cas` with the integrals weighted by ψ·cell.
The ψ constants are built once in numpy float32 exactly as the JAX kernel
builds them, so the plain version, kernel K7 and the JAX kernel read the
same bits.

:func:`sbm_bv_macro_plain` is the plain-torch version (what CPU tensors
run) and :func:`sbm_bv_macro_cuda` kernel K7 (``csrc/sbm_bv_macro.cu``, what
CUDA tensors run; above 64² its tiled kernel, up to 256²); there is no
fallback from one to the other.  The
backward is reverse mode through the checkpointed roll-stencil oracle
:func:`sbm_bv_reference`.  The optional env epilogue is ψ-weighted:
``[sum(w (u-c)), sum(w (u-c)^2), n_finite]`` with ``w = ψ·cell`` over finite
pixels, and the uint8 observation ``clip(u ψ scale, 0, 255)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import stencils as st
from .bv_cas import (
    _rk4_macro,
    bv_closure,
    check_bv_coefficients,
    rk4_constants,
    rk4_fused,
)
from .cas_spectral import (
    _alloc_scratch,
    _check_cuda,
    _check_grid,
    _flatten_batch,
    _OracleMacro,
)
from .kernels import count_launch, load_library

__all__ = [
    "SbmConstants",
    "SbmEpilogue",
    "sbm_bv_constants",
    "sbm_bv_reference",
    "sbm_bv_macro_plain",
    "sbm_bv_macro_cuda",
    "make_sbm_bv_fused_macro",
]


def sbm_bv_reference(mu_fn, j0_fn, kappa, psi, hx, hy, dt, n_steps, remat=True):
    """Roll-stencil RK4 oracle: ``macro(u, crate) -> u1`` (batched), the JAX
    package's ``sbm_bv_reference``: ψ-face-weighted flux divergence,
    ψ-weighted integrals, α = 1/2 closed-form voltage.  ``psi`` is an
    (H, W) tensor or array."""
    cell = hx * hy

    def rhs(u, crate):
        p = torch.as_tensor(psi, device=u.device)
        div = (st.div_f2c(st.avg_c2f(p, -2) * st.grad_c2f(u, hx, -2), hx, -2)
               + st.div_f2c(st.avg_c2f(p, -1) * st.grad_c2f(u, hy, -1), hy, -1))
        m = mu_fn(u) - (kappa / p) * div
        j = j0_fn(u)
        em = torch.exp(0.5 * m)
        ip = (j * em * p).sum((-2, -1), keepdim=True) * cell
        im = (j * p / em).sum((-2, -1), keepdim=True) * cell
        y = (-crate + torch.sqrt(crate**2 + 4.0 * ip * im)) / (2.0 * ip)
        return j * (1.0 / (em * y) - em * y)

    return _rk4_macro(rhs, dt, n_steps, remat)


class SbmConstants(NamedTuple):
    """The macro's (H, W) f32 constants on one device, built in numpy f32
    as the JAX kernel builds them: the face averages ``psi_ax``, ``psi_ay``
    of ψ, ``kop = κ/ψ``, ``psic = ψ·cell`` and ψ itself; and the f32
    inverse spacings."""

    psi_ax: torch.Tensor
    psi_ay: torch.Tensor
    kop: torch.Tensor
    psic: torch.Tensor
    psi: torch.Tensor
    inv_hx: float
    inv_hy: float


def _build_constants(psi, kappa, hx, hy, device) -> SbmConstants:
    if torch.is_tensor(psi):
        psi = psi.detach().cpu().numpy()
    psi_np = np.asarray(psi, np.float32)
    psi_ax = 0.5 * (psi_np + np.roll(psi_np, -1, 0))
    psi_ay = 0.5 * (psi_np + np.roll(psi_np, -1, 1))
    kop = np.float32(kappa) / psi_np
    psic = psi_np * np.float32(hx * hy)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return SbmConstants(dev(psi_ax), dev(psi_ay), dev(kop), dev(psic), dev(psi_np),
                        float(np.float32(1.0 / hx)), float(np.float32(1.0 / hy)))


_CONSTANTS: dict = {}
_MAX_CACHED = 32


def sbm_bv_constants(psi, kappa: float, hx: float, hy: float, device) -> SbmConstants:
    """The macro's constants for this ψ on ``device``, built once per ψ
    object and configuration: an env rebuilds its stepper every step, and
    rebuilding would copy ψ from the device every step.  ψ is a constant:
    a ψ changed in place afterwards is not seen."""
    device = torch.device(device)
    key = (id(psi), float(kappa), float(hx), float(hy), device)
    hit = _CONSTANTS.get(key)
    if hit is not None and hit[0] is psi:
        return hit[1]
    consts = _build_constants(psi, kappa, hx, hy, device)
    if len(_CONSTANTS) >= _MAX_CACHED:
        _CONSTANTS.pop(next(iter(_CONSTANTS)))
    _CONSTANTS[key] = (psi, consts)
    return consts


class SbmEpilogue(NamedTuple):
    """Env-epilogue configuration (the JAX kernel's ``kernel_ep``)."""

    obs_scale: float = 255.0
    center: float = 0.0


def sbm_bv_macro_plain(u: torch.Tensor, crate: torch.Tensor, consts: SbmConstants, *,
                       mu_fn: Callable, j0_fn: Callable, dt: float, n_steps: int,
                       epilogue: Optional[SbmEpilogue] = None):
    """Plain-torch macro: ``u`` (B, H, W) f32, ``crate`` (B,) f32.

    Returns ``u1`` or, with ``epilogue``, ``(u1, stats (B, 3), obs uint8)``.
    Follows the JAX kernel's arithmetic: fluxes times the f32 inverse
    spacings, ``κ/ψ`` and ``ψ·cell`` folded into constants.  What CPU tensors
    run and what kernel K7 is held against on the card.
    """
    c = crate.reshape(-1, 1, 1)
    ihx, ihy = consts.inv_hx, consts.inv_hy

    def integral(a):
        return (a * consts.psic).sum((-2, -1), keepdim=True)

    def rhs(z):
        fx = consts.psi_ax * (torch.roll(z, -1, -2) - z) * ihx
        fy = consts.psi_ay * (torch.roll(z, -1, -1) - z) * ihy
        div = (fx - torch.roll(fx, 1, -2)) * ihx + (fy - torch.roll(fy, 1, -1)) * ihy
        return bv_closure(mu_fn(z) - consts.kop * div, j0_fn(z), c, integral)

    u = rk4_fused(rhs, u, float(dt), n_steps)
    if epilogue is None:
        return u
    fin = torch.isfinite(u)
    uz = torch.where(fin, u - epilogue.center, torch.zeros_like(u))
    wuz = consts.psic * uz
    stats = torch.stack([wuz.sum((-2, -1)), (wuz * uz).sum((-2, -1)),
                         fin.sum((-2, -1)).to(torch.float32)], dim=-1)
    x = torch.where(fin, u, torch.zeros_like(u)) * consts.psi * epilogue.obs_scale
    return u, stats, torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def _bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K7's C interface on ``lib`` (``csrc/sbm_bv_macro.cu`` built
    for the card, or for the CPU by the tests' stub build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sbm_bv_macro_launch.argtypes = [
        p, p, p, p, p, p, p,             # u, crate, psi_ax, psi_ay, kop, psic, psi
        p, p, p, p, i,                   # out, stats, obs, scratch, n_slots
        i, i, i, i,                      # B, H, W, n_steps
        f, f, f, f, f,                   # dt/2, dt, dt/6, 1/hx, 1/hy
        f, f, f, f,                      # mu omega, clip lo, clip hi, j0 floor
        f, f,                            # obs_scale, center
        p,                               # stream
    ]
    lib.sbm_bv_macro_launch.restype = ctypes.c_int
    lib.sbm_bv_macro_scratch.argtypes = [i, i, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_longlong)]
    lib.sbm_bv_macro_scratch.restype = ctypes.c_int
    lib.sbm_bv_error_string.argtypes = [ctypes.c_int]
    lib.sbm_bv_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return _bind_library(load_library("sbm_bv_macro"))


def sbm_bv_macro_cuda(u: torch.Tensor, crate: torch.Tensor, consts: SbmConstants, *,
                      mu_fn: Callable, j0_fn: Callable, dt: float, n_steps: int,
                      epilogue: Optional[SbmEpilogue] = None):
    """Kernel K7: same contract as :func:`sbm_bv_macro_plain`.

    Launches ``csrc/sbm_bv_macro.cu`` on the current stream and counts the
    launch (``sbm_bv_macro_ep`` with an epilogue, ``sbm_bv_macro``
    without).  H and W up to :data:`MAX_GRID_TILED`: above 64² the tiled
    kernel runs, with a scratch of four H x W planes for each resident
    block, allocated here.  Raises on anything the kernel does not take.
    """
    coeffs = check_bv_coefficients(mu_fn, j0_fn)
    B, H, W = _check_grid(u)
    dev = u.device
    _check_cuda("u", u, (B, H, W), torch.float32, dev)
    _check_cuda("crate", crate, (B,), torch.float32, dev)
    for name in ("psi_ax", "psi_ay", "kop", "psic", "psi"):
        _check_cuda(name, getattr(consts, name), (H, W), torch.float32, dev)
    out = torch.empty_like(u)
    stats = obs = None
    if epilogue is not None:
        stats = torch.empty((B, 3), dtype=torch.float32, device=dev)
        obs = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    lib = _library()
    scratch, slots = _alloc_scratch(dev, B, _library, "sbm_bv_macro_scratch", H, W)
    with torch.cuda.device(dev):
        rc = lib.sbm_bv_macro_launch(
            u.data_ptr(), crate.data_ptr(), consts.psi_ax.data_ptr(),
            consts.psi_ay.data_ptr(), consts.kop.data_ptr(), consts.psic.data_ptr(),
            consts.psi.data_ptr(), out.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            obs.data_ptr() if obs is not None else None,
            scratch.data_ptr() if scratch is not None else None, slots,
            B, H, W, int(n_steps), *rk4_constants(dt), consts.inv_hx, consts.inv_hy, *coeffs,
            epilogue.obs_scale if epilogue else 0.0,
            epilogue.center if epilogue else 0.0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"sbm_bv_macro launch failed: {lib.sbm_bv_error_string(rc).decode()}")
    if epilogue is None:
        count_launch("sbm_bv_macro")
        return out
    count_launch("sbm_bv_macro_ep")
    return out, stats, obs


def _fold_psi_stats(u1, gu, gstats, weight, center):
    """The JAX macro's ``_core_ep_bwd`` fold: the cotangent of the
    ψ-weighted stats ``s1 = sum(w (u1-c))``, ``s2 = sum(w (u1-c)^2)`` joins
    the field cotangent as ``w (gs1 + 2 (u1-c) gs2)`` on finite pixels."""
    fin = torch.isfinite(u1)
    uz = torch.where(fin, u1 - center, torch.zeros_like(u1))
    return gu + torch.where(
        fin, weight * (gstats[..., 0, None, None] + 2.0 * uz * gstats[..., 1, None, None]),
        torch.zeros_like(u1))


def make_sbm_bv_fused_macro(
    mu_fn: Callable,
    j0_fn: Callable,
    kappa: float,
    psi,
    hx: float,
    hy: float,
    dt: float,
    n_steps: int,
    *,
    epilogue: Optional[dict] = None,
):
    """Build ``macro(u, crate) -> u1``: the fused SBM-BV charging macro-step.

    ``psi`` is the (H, W) smoothed-boundary level set (tensor or array; a
    constant, see :func:`sbm_bv_constants`); ``u`` is ``(..., H, W)`` and
    ``crate`` the per-env applied C-rate, broadcastable to the batch.  α is
    1/2.  With ``epilogue`` (keys ``obs_scale``, ``stats_center``) the macro
    returns ``(u1, stats, obs)``, ψ-weighted as the module docstring says.
    CPU tensors run :func:`sbm_bv_macro_plain`, CUDA tensors kernel K7 (f32
    throughout), where ``mu_fn`` must be a
    :class:`~pde_opt_tpu_torch.ops.bv_cas.LogRatioMu` and ``j0_fn`` a
    :class:`~pde_opt_tpu_torch.ops.bv_cas.SqrtJ0`.  Gradients with respect
    to ``u`` and ``crate`` come from the checkpointed
    :func:`sbm_bv_reference`.  H and W are multiples of 8; on CUDA tensors
    up to :data:`MAX_GRID_TILED` (above 64² kernel K7 runs its tiled form).
    The JAX macro's ``block_envs``/``interpret`` (TPU tiling) have no
    counterpart.
    """
    H, W = tuple(psi.shape)
    if H % 8 or W % 8:
        raise ValueError(f"H, W must be multiples of 8, got {(H, W)}")
    ep = None
    if epilogue is not None:
        ep = SbmEpilogue(float(epilogue.get("obs_scale", 255.0)),
                         float(epilogue.get("stats_center", 0.0)))
    kw = dict(mu_fn=mu_fn, j0_fn=j0_fn, dt=float(dt), n_steps=int(n_steps))

    def macro(state: torch.Tensor, crate):
        batch, x, cf = _flatten_batch(state, crate, H, W)
        consts = sbm_bv_constants(psi, kappa, hx, hy, state.device)
        impl = sbm_bv_macro_plain if state.device.type == "cpu" else sbm_bv_macro_cuda
        oracle = sbm_bv_reference(mu_fn, j0_fn, float(kappa), consts.psi, float(hx),
                                  float(hy), float(dt), int(n_steps))

        def run(u, c):
            return impl(u, c, consts, epilogue=ep, **kw)

        if ep is None:
            u1 = _OracleMacro.apply(x, cf, run, oracle, None)
            return u1.to(state.dtype).reshape(*batch, H, W)
        fold = functools.partial(_fold_psi_stats, weight=consts.psic, center=ep.center)
        u1, stats, obs = _OracleMacro.apply(x, cf, run, oracle, fold)
        return (u1.to(state.dtype).reshape(*batch, H, W), stats.reshape(*batch, 3),
                obs.reshape(*batch, H, W))

    return macro
