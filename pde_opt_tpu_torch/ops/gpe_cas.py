"""Fused Gross-Pitaevskii Strang macro-step (PyTorch port of
:mod:`pde_opt_tpu.ops.gpe_cas`).

One macro advances ``n_steps`` merged-half-step (midpoint) Strang substeps
of the GPE control fleet, the scheme of
``StrangSplitting(fast_evolve=True)`` at real time with a control that is
constant within the macro-step:

* **kinetic propagator**: the phase rotation ``exp(-i phi(k) tau)``, ``phi =
  (2πk)²/2``, has axis-even cos and sin parts, so the cas transform
  diagonalises it: ``pr' = inv(c fwd(pr) + s fwd(pi))``, ``pi' = inv(c
  fwd(pi) - s fwd(pr))``;
* **B phase**: the pointwise rotation ``exp(-i dt (V + ctrl + g|ψ|²))``,
  by degree-6/7 Taylor polynomials (``phase_poly``) or cos/sin;
* **renormalisation** to unit L² norm per env after each propagation, in
  full f32.

:func:`gpe_strang_macro_plain` is the plain-torch version (what CPU tensors
run) and :func:`gpe_strang_macro_cuda` kernel K5 (``csrc/gpe_strang_macro.cu``,
what CUDA tensors run; grids up to 256², tiled above 64²); there is no
fallback from one to the other.  The
macros are ``torch.autograd.Function``s whose backward is the VJP of the
checkpointed FFT oracle :func:`gpe_strang_fast_reference`, as in the JAX
package.  The optional env epilogue emits per env ``[sum(w rho), sum(rho),
n_finite]`` over finite pixels of ``rho = |ψ|²`` and the uint8 observation
``clip(rho * obs_scale, 0, 255)``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .cas_spectral import (
    _alloc_scratch,
    _cas_mat,
    _check_cuda,
    _check_grid,
    _check_mats,
    _mats_ptrs,
    _OracleMacro,
    _transforms,
)
from .kernels import count_launch, load_library

__all__ = [
    "GpeConstants",
    "GpeEpilogue",
    "gpe_constants",
    "gpe_strang_fast_reference",
    "gpe_strang_macro_plain",
    "gpe_strang_macro_cuda",
    "make_gpe_strang_cas_macro",
]


def _phi_symbol(N: int, h: float) -> np.ndarray:
    """Kinetic symbol phi(k) = (2*pi*k)^2 / 2 (cycles-per-unit freqs)."""
    k = np.fft.fftfreq(N, h)
    return 0.5 * (2.0 * np.pi * k) ** 2


def _phi(H: int, W: int, dx: float) -> np.ndarray:
    return _phi_symbol(H, float(dx))[:, None] + _phi_symbol(W, float(dx))[None, :]


def gpe_strang_fast_reference(V_trap, g, dx, dt, n_steps, remat=True):
    """FFT oracle of the merged-half-step (midpoint) Strang macro.

    ``macro(y, ctrl) -> y1`` with ``y`` the real-stacked (..., H, W, 2)
    wavefunction and ``ctrl`` the per-env control potential (..., H, W);
    ``V_trap`` (H, W) is a tensor or array.  With ``remat`` each merged
    substep runs under :func:`torch.utils.checkpoint.checkpoint` (the
    backward of the fused macro).
    """

    def macro(y: torch.Tensor, ctrl) -> torch.Tensor:
        H, W = y.shape[-3:-1]
        cdtype = torch.promote_types(y.dtype, torch.complex64)
        V = torch.as_tensor(V_trap, device=y.device)
        expA_half = torch.from_numpy(np.exp(-0.5j * dt * _phi(H, W, dx))).to(y.device, cdtype)
        expA_full = expA_half * expA_half
        psi = torch.complex(y[..., 0], y[..., 1])

        def prop(p, e):
            return torch.fft.ifftn(torch.fft.fftn(p, dim=(-2, -1)) * e, dim=(-2, -1)).to(cdtype)

        def b_renorm(p):
            w = V + ctrl + g * (p.real**2 + p.imag**2)
            p = p * torch.exp(-1j * dt * w)
            norm = torch.sqrt((p.real**2 + p.imag**2).sum((-2, -1), keepdim=True) * dx * dx)
            return (p / norm).to(cdtype)

        def body(p):
            return prop(b_renorm(p), expA_full)

        psi = prop(psi, expA_half)
        for _ in range(n_steps - 1):
            psi = checkpoint(body, psi, use_reentrant=False) if remat else body(psi)
        psi = prop(b_renorm(psi), expA_half)
        return torch.stack([psi.real, psi.imag], dim=-1).to(y.dtype)

    return macro


class GpeConstants(NamedTuple):
    """The macro's constant operands, f32 and contiguous on one device:
    the cas matrices (``ch``, ``cw``) and their inverses (``ich``, ``icw``,
    ``C/N``), rounded to ``mats_dtype``, and the kinetic phase tables
    ``cos``/``sin`` of ``phi dt`` (``*_full``) and ``phi dt/2``
    (``*_half``) on the (H, W) grid.  With bf16 matrices, ``ch16`` ..
    ``icw16`` are the four matrices as bf16 tensors (exact copies), which
    the tiled tensor-core kernel reads; ``None`` with f32 matrices."""

    ch: torch.Tensor
    cw: torch.Tensor
    ich: torch.Tensor
    icw: torch.Tensor
    cos_full: torch.Tensor
    sin_full: torch.Tensor
    cos_half: torch.Tensor
    sin_half: torch.Tensor
    ch16: Optional[torch.Tensor] = None
    cw16: Optional[torch.Tensor] = None
    ich16: Optional[torch.Tensor] = None
    icw16: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=32)
def gpe_constants(H: int, W: int, dx: float, dt: float, mats_dtype: torch.dtype,
                  device: torch.device) -> GpeConstants:
    """Build (once per configuration and device) the macro's constants."""

    def mat(m):
        return torch.from_numpy(m).to(mats_dtype).to(device, torch.float32).contiguous()

    def f32(a):
        return torch.from_numpy(a).to(device, torch.float32).contiguous()

    phi = _phi(H, W, dx)
    mats = {"ch": mat(_cas_mat(H)), "cw": mat(_cas_mat(W)),
            "ich": mat(_cas_mat(H) / H), "icw": mat(_cas_mat(W) / W)}
    if mats_dtype == torch.bfloat16:
        mats.update({f"{n}16": m.to(torch.bfloat16) for n, m in list(mats.items())})
    return GpeConstants(
        **mats,
        cos_full=f32(np.cos(phi * dt)), sin_full=f32(np.sin(phi * dt)),
        cos_half=f32(np.cos(phi * 0.5 * dt)), sin_half=f32(np.sin(phi * 0.5 * dt)),
    )


class GpeEpilogue(NamedTuple):
    """Env-epilogue configuration: the obs scale and the (H, W) f32 weight
    ``w`` of the first stat, on the macro's device."""

    obs_scale: float
    weight: torch.Tensor


def gpe_strang_macro_plain(y: torch.Tensor, ctrl: torch.Tensor, V: torch.Tensor,
                           consts: GpeConstants, *, g: float, dt: float, dx: float,
                           n_steps: int, round_bf16: bool, phase_poly: bool,
                           epilogue: Optional[GpeEpilogue] = None):
    """Plain-torch macro: ``y`` (B, H, W, 2) f32, ``ctrl`` (B, H, W) f32,
    ``V`` (H, W) f32.

    Returns ``y1`` (B, H, W, 2) or, with ``epilogue``, ``(y1, stats (B, 3),
    obs (B, H, W) uint8)``.  What CPU tensors run and what kernel K5 is held
    against on the card; it rounds to bf16 where the JAX kernel does.
    """
    fwd, inv = _transforms(consts, round_bf16)
    g, dt, dx2 = float(g), float(dt), float(dx) * float(dx)
    pr, pi = y[..., 0], y[..., 1]
    vc = V + ctrl

    def prop(r, i, c, s):
        rh, ih = fwd(r), fwd(i)
        return inv(c * rh + s * ih), inv(c * ih - s * rh)

    def b_phase(r, i):
        th = dt * (vc + g * (r * r + i * i))
        if phase_poly:
            t2 = th * th
            c = 1.0 + t2 * (-0.5 + t2 * (1.0 / 24.0 + t2 * (-1.0 / 720.0)))
            s = th * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 + t2 * (-1.0 / 5040.0))))
        else:
            c, s = torch.cos(th), torch.sin(th)
        return c * r + s * i, c * i - s * r

    def renorm(r, i):
        scale = torch.rsqrt((r * r + i * i).sum((-2, -1), keepdim=True) * dx2)
        return r * scale, i * scale

    # Renormalise after each propagation: the kinetic rotation preserves the
    # norm, so this equals renormalise-then-propagate (the oracle's order)
    # and puts every emitted state on the unit-norm manifold.
    pr, pi = prop(pr, pi, consts.cos_half, consts.sin_half)
    for _ in range(n_steps - 1):
        pr, pi = b_phase(pr, pi)
        pr, pi = renorm(*prop(pr, pi, consts.cos_full, consts.sin_full))
    pr, pi = b_phase(pr, pi)
    pr, pi = renorm(*prop(pr, pi, consts.cos_half, consts.sin_half))
    out = torch.stack([pr, pi], dim=-1)
    if epilogue is None:
        return out
    rho = pr * pr + pi * pi
    fin = torch.isfinite(rho)
    rz = torch.where(fin, rho, torch.zeros_like(rho))
    stats = torch.stack([(rz * epilogue.weight).sum((-2, -1)), rz.sum((-2, -1)),
                         fin.sum((-2, -1)).to(torch.float32)], dim=-1)
    obs = torch.clamp(rz * epilogue.obs_scale, 0.0, 255.0).to(torch.uint8)
    return out, stats, obs


def _bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K5's C interface on ``lib`` (``csrc/gpe_strang_macro.cu``
    built for the card, or for the CPU by the tests' stub build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gpe_strang_macro_launch.argtypes = [
        p, p, p,                         # y, ctrl, V
        p, p, p, p, p, p, p, p,          # ch, cw, ich, icw, ch16 .. icw16
        p, p, p, p,                      # cos/sin full, cos/sin half
        p, p, p, p, f,                   # out, stats, obs, weight, obs_scale
        p, i,                            # scratch, n_slots
        i, i, i, i, f, f, f,             # B, H, W, n_steps, g, dt, dx^2
        i, i,                            # phase_poly, round_bf16
        p,                               # stream
    ]
    lib.gpe_strang_macro_launch.restype = ctypes.c_int
    lib.gpe_strang_macro_scratch.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_longlong)]
    lib.gpe_strang_macro_scratch.restype = ctypes.c_int
    lib.gpe_strang_error_string.argtypes = [ctypes.c_int]
    lib.gpe_strang_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return _bind_library(load_library("gpe_strang_macro"))


def gpe_strang_macro_cuda(y: torch.Tensor, ctrl: torch.Tensor, V: torch.Tensor,
                          consts: GpeConstants, *, g: float, dt: float, dx: float,
                          n_steps: int, round_bf16: bool, phase_poly: bool,
                          epilogue: Optional[GpeEpilogue] = None):
    """Kernel K5: same contract as :func:`gpe_strang_macro_plain`.

    Launches ``csrc/gpe_strang_macro.cu`` on the current stream and counts
    the launch (``gpe_strang_macro_ep`` with an epilogue,
    ``gpe_strang_macro`` without).  H and W up to :data:`MAX_GRID_TILED`:
    above 64² the tiled kernel runs, with a scratch of five H x W planes for
    each resident block, allocated here.  Raises on anything the kernel
    does not take.
    """
    B, H, W = _check_grid(y, ndim=4)
    dev = y.device
    _check_cuda("y", y, (B, H, W, 2), torch.float32, dev)
    _check_cuda("ctrl", ctrl, (B, H, W), torch.float32, dev)
    _check_cuda("V", V, (H, W), torch.float32, dev)
    _check_mats(consts, H, W, dev)
    for name in ("cos_full", "sin_full", "cos_half", "sin_half"):
        _check_cuda(name, getattr(consts, name), (H, W), torch.float32, dev)
    out = torch.empty_like(y)
    stats = obs = None
    if epilogue is not None:
        _check_cuda("weight", epilogue.weight, (H, W), torch.float32, dev)
        stats = torch.empty((B, 3), dtype=torch.float32, device=dev)
        obs = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    lib = _library()
    scratch, slots = _alloc_scratch(dev, B, _library, "gpe_strang_macro_scratch",
                                    round_bf16, H, W)
    with torch.cuda.device(dev):
        rc = lib.gpe_strang_macro_launch(
            y.data_ptr(), ctrl.data_ptr(), V.data_ptr(), *_mats_ptrs(consts),
            consts.cos_full.data_ptr(), consts.sin_full.data_ptr(),
            consts.cos_half.data_ptr(), consts.sin_half.data_ptr(), out.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            obs.data_ptr() if obs is not None else None,
            epilogue.weight.data_ptr() if epilogue is not None else None,
            float(epilogue.obs_scale) if epilogue is not None else 0.0,
            scratch.data_ptr() if scratch is not None else None, slots,
            B, H, W, int(n_steps), float(g), float(dt), float(dx) * float(dx),
            int(bool(phase_poly)), int(bool(round_bf16)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"gpe_strang_macro launch failed: {lib.gpe_strang_error_string(rc).decode()}"
        )
    if epilogue is None:
        count_launch("gpe_strang_macro")
        return out
    count_launch("gpe_strang_macro_ep")
    return out, stats, obs


def _fold_rho_stats(y1, gy, gstats, weight):
    """The JAX macro's ``_core_ep`` fold: the cotangent of the stats
    ``[sum(w rho), sum(rho)]`` joins the state cotangent at ``y1`` as
    ``2 y1 (w gs0 + gs1)`` on finite pixels."""
    rho = y1[..., 0] ** 2 + y1[..., 1] ** 2
    coef = torch.where(
        torch.isfinite(rho),
        gstats[..., 0, None, None] * weight + gstats[..., 1, None, None],
        torch.zeros_like(rho),
    )
    return gy + 2.0 * y1 * coef[..., None]


def _on_device(a, device: torch.device) -> torch.Tensor:
    """``a`` as a contiguous f32 tensor on ``device``; a tensor already there
    is returned as it is (no copy)."""
    return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()


def make_gpe_strang_cas_macro(
    V_trap,
    g: float,
    H: int,
    W: int,
    dx: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype: torch.dtype = torch.bfloat16,
    phase_poly: bool = True,
    epilogue: Optional[dict] = None,
):
    """Build ``macro(y, ctrl) -> y1``: the fused GPE control macro-step.

    Args:
        V_trap: static (H, W) trap potential, array or tensor.  Pass a tensor
            on the fleet's device to keep the macro free of host copies.
        g: interaction strength.
        H, W: grid (multiples of 8; the CUDA kernel takes up to 256).
        dx: grid spacing (square cells).
        dt: substep size; real-time propagation.
        n_steps: substeps per macro-step (merged-half-step scheme).
        phase_poly: the JAX kernel's degree-6/7 Taylor polynomials for the
            B-phase cos/sin (accurate to f32 for ``|dt (V + ctrl + g|ψ|²)|``
            up to ~0.35, ~1e-6 at 0.7), else exact cos/sin.
        epilogue: ``{"obs_scale": float, "weight": (H, W)}`` adds the env
            epilogue: the macro returns ``(y1, stats, obs)``.

    ``y`` is the real-stacked ``(..., H, W, 2)`` state and ``ctrl`` the
    ``(..., H, W)`` control potential (leading axes broadcast against
    ``y``'s batch).  CPU tensors run :func:`gpe_strang_macro_plain`, CUDA
    tensors kernel K5; gradients with respect to ``y`` and ``ctrl`` come
    from the checkpointed FFT oracle.  The JAX macro's ``block_envs`` and
    ``interpret`` (TPU tiling) have no counterpart.
    """
    if H % 8 or W % 8:
        raise ValueError(f"H, W must be multiples of 8, got {(H, W)}")
    if mats_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mats_dtype must be bf16 or f32, got {mats_dtype}")
    kw = dict(g=float(g), dt=float(dt), dx=float(dx), n_steps=int(n_steps),
              round_bf16=mats_dtype == torch.bfloat16, phase_poly=bool(phase_poly))
    obs_scale = weight = None
    if epilogue is not None:
        obs_scale = float(epilogue.get("obs_scale", 2550.0))
        weight = epilogue.get("weight")
        if weight is None:
            weight = torch.ones((H, W), dtype=torch.float32)
        if tuple(weight.shape) != (H, W):
            raise ValueError(f"epilogue weight shape {tuple(weight.shape)} != {(H, W)}")
    oracle = gpe_strang_fast_reference(V_trap, float(g), float(dx), float(dt), int(n_steps))

    def macro(y: torch.Tensor, ctrl):
        *batch, h, w, two = y.shape
        if (h, w, two) != (H, W, 2):
            raise ValueError(f"state trailing shape {(h, w, two)} != {(H, W, 2)}")
        B = math.prod(batch) if batch else 1
        dev = y.device
        x = y.reshape(B, H, W, 2).to(torch.float32).contiguous()
        c = torch.broadcast_to(torch.as_tensor(ctrl, dtype=torch.float32, device=dev),
                               (*batch, H, W)).reshape(B, H, W).contiguous()
        V = _on_device(V_trap, dev)
        consts = gpe_constants(H, W, float(dx), float(dt), mats_dtype, dev)
        impl = gpe_strang_macro_plain if dev.type == "cpu" else gpe_strang_macro_cuda
        ep = None if epilogue is None else GpeEpilogue(obs_scale, _on_device(weight, dev))

        def run(yy, cc):
            return impl(yy, cc, V, consts, epilogue=ep, **kw)

        if ep is None:
            y1 = _OracleMacro.apply(x, c, run, oracle, None)
            return y1.to(y.dtype).reshape(*batch, H, W, 2)
        fold = functools.partial(_fold_rho_stats, weight=ep.weight)
        y1, stats, obs = _OracleMacro.apply(x, c, run, oracle, fold)
        return (y1.to(y.dtype).reshape(*batch, H, W, 2), stats.reshape(*batch, 3),
                obs.reshape(*batch, H, W))

    return macro
