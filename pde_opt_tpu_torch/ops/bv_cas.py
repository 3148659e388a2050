"""Fused galvanostatic Butler-Volmer macro-step (PyTorch port of
:mod:`pde_opt_tpu.ops.bv_cas`).

One macro advances ``n_steps`` classical RK4 substeps of the
constant-current Butler-Volmer Allen-Cahn with the field held on chip:

* **Laplacian by cas transforms.**  The FD Laplacian is a circular
  convolution with the axis-even symbol ``lam``, so it evaluates as
  ``inv(lam * fwd(u))`` (4 matrix products per RK stage), rounded to bf16
  where the JAX kernel rounds when ``mats_dtype=torch.bfloat16``.
* **Galvanostatic closure.**  Per stage: ``m = mu(u) - kappa lap``,
  ``em = exp(m/2)``, the two per-env integrals ``I+ = sum(j em) cell`` and
  ``I- = sum(j / em) cell``, the closed-form (alpha = 1/2) root
  ``y = (-C + sqrt(C^2 + 4 I+ I-)) / (2 I+)`` and the reaction
  ``j (1/(em y) - em y)``; ``C`` is each env's applied C-rate.

``mu`` and ``j0`` reach the CUDA kernel as the parameters of
:class:`LogRatioMu` and :class:`SqrtJ0` (the presets' coefficient
functions); a kernel cannot call a Python function.

:func:`bv_cc_macro_plain` is the plain-torch version (what CPU tensors run)
and :func:`bv_cc_macro_cuda` kernel K6 (``csrc/bv_cc_macro.cu``, what CUDA
tensors run; above 64² its tiled kernel on ``csrc/cas_tiled.cuh``, up to
256²); there is no fallback from one to the other.  The macro's
backward is reverse mode through the checkpointed roll-stencil oracle
:func:`bv_cc_reference`, the JAX package's custom VJP.  The optional env
epilogue is the CH macro's (``obs_downsample`` 1 only, as in JAX).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import stencils as st
from .cas_spectral import (
    CasConstants,
    Epilogue,
    _alloc_scratch,
    _check_cuda,
    _check_grid,
    _check_mats,
    _ep_fold_stats_cotangent,
    _epilogue_plain,
    _flatten_batch,
    _mats_ptrs,
    _OracleMacro,
    _transforms,
    cas_constants,
)
from .kernels import count_launch, load_library

__all__ = [
    "LogRatioMu",
    "SqrtJ0",
    "bv_cc_reference",
    "bv_cc_macro_plain",
    "bv_cc_macro_cuda",
    "make_bv_cc_fused_macro",
]


class LogRatioMu:
    """``mu(c) = log(x / (1 - x)) + omega (1 - 2c)`` with ``x = clip(c,
    clip, 1 - clip)``: the BV presets' chemical potential.

    The regular-solution term takes the unclipped ``c``, as the presets'
    lambda does.  The CUDA kernels read ``omega`` and the two clip bounds
    (rounded to f32, as the f32 lambda rounds them).
    """

    def __init__(self, omega: float = 3.0, clip: float = 1e-4):
        self.omega = float(omega)
        self.clip = float(clip)

    def bounds(self):
        """The clip bounds as the f32 kernels and lambdas see them."""
        return float(np.float32(self.clip)), float(np.float32(1.0 - self.clip))

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(c, self.clip, 1 - self.clip)
        return torch.log(x / (1 - x)) + self.omega * (1.0 - 2.0 * c)

    def __eq__(self, other):
        return isinstance(other, LogRatioMu) and (self.omega, self.clip) == (
            other.omega, other.clip)

    def __hash__(self):
        return hash((LogRatioMu, self.omega, self.clip))

    def __repr__(self):
        return f"LogRatioMu(omega={self.omega}, clip={self.clip})"


class SqrtJ0:
    """``j0(c) = sqrt(max(c (1 - c), floor))``: the BV presets' exchange
    current density."""

    def __init__(self, floor: float = 1e-6):
        self.floor = float(floor)

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.clamp(c * (1 - c), min=self.floor))

    def __eq__(self, other):
        return isinstance(other, SqrtJ0) and self.floor == other.floor

    def __hash__(self):
        return hash((SqrtJ0, self.floor))

    def __repr__(self):
        return f"SqrtJ0(floor={self.floor})"


def _rk4_macro(rhs, dt, n_steps, remat):
    """``macro(u, crate)``: ``n_steps`` classical RK4 substeps of ``rhs(u,
    crate)``, each under :func:`torch.utils.checkpoint.checkpoint` with
    ``remat`` (reverse mode then keeps only the field per substep).  The
    crate broadcasts against the batch as the JAX oracles broadcast it."""

    def substep(u, crate):
        k1 = rhs(u, crate)
        k2 = rhs(u + 0.5 * dt * k1, crate)
        k3 = rhs(u + 0.5 * dt * k2, crate)
        k4 = rhs(u + dt * k3, crate)
        return (u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)).to(u.dtype)

    def macro(u: torch.Tensor, crate) -> torch.Tensor:
        crate = torch.as_tensor(crate, device=u.device)
        if crate.ndim <= u.ndim - 2:
            crate = crate.reshape(crate.shape + (1, 1))
        for _ in range(n_steps):
            if remat:
                u = checkpoint(substep, u, crate, use_reentrant=False)
            else:
                u = substep(u, crate)
        return u

    return macro


def bv_cc_reference(mu_fn, j0_fn, kappa, hx, hy, dt, n_steps, remat=True):
    """Roll-stencil RK4 oracle: ``macro(u, crate) -> u1`` (batched), the
    JAX package's ``bv_cc_reference``."""
    cell = hx * hy

    def rhs(u, crate):
        lap = st.lap_2nd_2d(u, hx, hy)
        m = mu_fn(u) - kappa * lap
        j = j0_fn(u)
        ip = (j * torch.exp(0.5 * m)).sum((-2, -1), keepdim=True) * cell
        im = (j * torch.exp(-0.5 * m)).sum((-2, -1), keepdim=True) * cell
        y = (-crate + torch.sqrt(crate**2 + 4.0 * ip * im)) / (2.0 * ip)
        em = torch.exp(0.5 * m)
        return j * (1.0 / (em * y) - em * y)

    return _rk4_macro(rhs, dt, n_steps, remat)


def bv_closure(m, j, crate, integral):
    """The galvanostatic closure of the fused kernels: the RK stage
    ``j (1/(em y) - em y)`` with ``em = exp(m/2)`` and ``y`` the α = 1/2
    root for the per-env integrals ``I+ = integral(j em)``, ``I- =
    integral(j / em)``.  ``crate`` is (B, 1, 1); ``integral`` reduces over
    the trailing axes with ``keepdim`` (K6: the sum times the cell area,
    K7: the ψ·cell-weighted sum)."""
    em = torch.exp(0.5 * m)
    inv_em = 1.0 / em
    ip = integral(j * em)
    im = integral(j * inv_em)
    y = (-crate + torch.sqrt(crate * crate + 4.0 * ip * im)) / (2.0 * ip)
    return j * (inv_em / y - em * y)


def rk4_fused(rhs, u, dt, n_steps):
    """The fused kernels' RK4 loop (the JAX kernels' order of operations)."""
    for _ in range(n_steps):
        k1 = rhs(u)
        k2 = rhs(u + (0.5 * dt) * k1)
        k3 = rhs(u + (0.5 * dt) * k2)
        k4 = rhs(u + dt * k3)
        u = u + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return u


def bv_cc_macro_plain(u: torch.Tensor, crate: torch.Tensor, consts: CasConstants, *,
                      mu_fn: Callable, j0_fn: Callable, kappa: float, cell: float,
                      dt: float, n_steps: int, round_bf16: bool,
                      epilogue: Optional[Epilogue] = None):
    """Plain-torch macro: ``u`` (B, H, W) f32, ``crate`` (B,) f32.

    Returns ``u1`` or, with ``epilogue``, ``(u1, stats (B, 3), obs uint8)``.
    Follows the JAX kernel's arithmetic (``_evolve_packed``): ``lap =
    inv(lam fwd(z))``, ``1/em`` once, ``I± = sum(j em^±1) cell``.  What CPU
    tensors run and what kernel K6 is held against on the card.
    """
    fwd, inv = _transforms(consts, round_bf16)
    lam = consts.lam
    c = crate.reshape(-1, 1, 1)

    def integral(a):
        return a.sum((-2, -1), keepdim=True) * cell

    def rhs(z):
        lap = inv(lam * fwd(z))
        return bv_closure(mu_fn(z) - kappa * lap, j0_fn(z), c, integral)

    u = rk4_fused(rhs, u, float(dt), n_steps)
    if epilogue is None:
        return u
    return (u, *_epilogue_plain(u, epilogue))


def check_bv_coefficients(mu_fn, j0_fn):
    """Raise unless ``mu_fn``/``j0_fn`` are what the CUDA kernels evaluate;
    return ``(omega, lo, hi, floor)``."""
    if not isinstance(mu_fn, LogRatioMu) or not isinstance(j0_fn, SqrtJ0):
        raise ValueError(
            "the CUDA BV macros evaluate mu and j0 from their parameters: pass "
            f"a LogRatioMu and a SqrtJ0, got {mu_fn!r} and {j0_fn!r}"
        )
    return (mu_fn.omega, *mu_fn.bounds(), j0_fn.floor)


def rk4_constants(dt: float):
    """The RK4 stage constants ``(dt/2, dt, dt/6)`` as the plain version
    computes them (in double, rounded to f32 where they meet the field)."""
    return 0.5 * float(dt), float(dt), float(dt) / 6.0


def _bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K6's C interface on ``lib`` (``csrc/bv_cc_macro.cu`` built
    for the card, or for the CPU by the tests' stub build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bv_cc_macro_launch.argtypes = [
        p, p, p, p, p, p,                # u, crate, ch, cw, ich, icw
        p, p, p, p, p,                   # ch16 .. icw16, lam
        p, p, p, p, i,                   # out, stats, obs, scratch, n_slots
        i, i, i, i,                      # B, H, W, n_steps
        f, f, f, f, f,                   # dt/2, dt, dt/6, kappa, cell
        f, f, f, f,                      # mu omega, clip lo, clip hi, j0 floor
        i, f, f, f,                      # round_bf16, obs_scale, obs_offset, center
        p,                               # stream
    ]
    lib.bv_cc_macro_launch.restype = ctypes.c_int
    lib.bv_cc_macro_scratch.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.bv_cc_macro_scratch.restype = ctypes.c_int
    lib.bv_cc_error_string.argtypes = [ctypes.c_int]
    lib.bv_cc_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return _bind_library(load_library("bv_cc_macro"))


def bv_cc_macro_cuda(u: torch.Tensor, crate: torch.Tensor, consts: CasConstants, *,
                     mu_fn: Callable, j0_fn: Callable, kappa: float, cell: float,
                     dt: float, n_steps: int, round_bf16: bool,
                     epilogue: Optional[Epilogue] = None):
    """Kernel K6: same contract as :func:`bv_cc_macro_plain`.

    Launches ``csrc/bv_cc_macro.cu`` on the current stream and counts the
    launch (``bv_cc_macro_ep`` with an epilogue, ``bv_cc_macro``
    without).  H and W up to :data:`MAX_GRID_TILED`: above 64² the tiled
    kernel runs, with a scratch of five H x W planes for each resident
    block, allocated here (with bf16 matrices it reads ``consts``' bf16
    copies).  Raises on anything the kernel does not take.
    """
    coeffs = check_bv_coefficients(mu_fn, j0_fn)
    B, H, W = _check_grid(u)
    dev = u.device
    _check_cuda("u", u, (B, H, W), torch.float32, dev)
    _check_cuda("crate", crate, (B,), torch.float32, dev)
    _check_cuda("lam", consts.lam, (H, W), torch.float32, dev)
    _check_mats(consts, H, W, dev)
    out = torch.empty_like(u)
    stats = obs = None
    if epilogue is not None:
        if epilogue.ds != 1:
            raise NotImplementedError("the BV epilogue supports obs_downsample=1 only")
        stats = torch.empty((B, 3), dtype=torch.float32, device=dev)
        obs = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    lib = _library()
    scratch, slots = _alloc_scratch(dev, B, _library, "bv_cc_macro_scratch", round_bf16, H, W)
    with torch.cuda.device(dev):
        rc = lib.bv_cc_macro_launch(
            u.data_ptr(), crate.data_ptr(), *_mats_ptrs(consts), consts.lam.data_ptr(),
            out.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            obs.data_ptr() if obs is not None else None,
            scratch.data_ptr() if scratch is not None else None, slots,
            B, H, W, int(n_steps), *rk4_constants(dt), float(kappa), float(cell), *coeffs,
            int(bool(round_bf16)),
            epilogue.obs_scale if epilogue else 0.0,
            epilogue.obs_offset if epilogue else 0.0,
            epilogue.center if epilogue else 0.0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bv_cc_macro launch failed: {lib.bv_cc_error_string(rc).decode()}")
    if epilogue is None:
        count_launch("bv_cc_macro")
        return out
    count_launch("bv_cc_macro_ep")
    return out, stats, obs


def make_bv_cc_fused_macro(
    mu_fn: Callable,
    j0_fn: Callable,
    kappa: float,
    H: int,
    W: int,
    hx: float,
    hy: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype: torch.dtype = torch.bfloat16,
    epilogue: Optional[dict] = None,
):
    """Build ``macro(u, crate) -> u1``: the fused BV charging macro-step.

    ``u`` is ``(..., H, W)`` (leading axes are the env batch) and ``crate``
    the per-env applied C-rate, broadcastable to the batch.  ``alpha`` is
    1/2 (the closed-form closure).  With ``epilogue`` (keys ``obs_scale``,
    ``obs_offset``, ``stats_center``) the macro returns ``(u1, stats,
    obs)``: ``[sum(u-c), sum((u-c)^2), n_finite]`` per env and the uint8
    ``clip(u*scale + offset)``.  CPU tensors run :func:`bv_cc_macro_plain`,
    CUDA tensors kernel K6, where ``mu_fn`` must be a :class:`LogRatioMu` and
    ``j0_fn`` a :class:`SqrtJ0`.  Gradients with respect to ``u`` and
    ``crate`` come from the checkpointed :func:`bv_cc_reference`.  H and W
    are multiples of 8; on CUDA tensors up to :data:`MAX_GRID_TILED` (above
    64² kernel K6 runs its tiled form).  The JAX macro's
    ``block_envs``/``interpret`` (TPU tiling) have no counterpart.
    """
    if H % 8 or W % 8:
        raise ValueError(f"H, W must be multiples of 8, got {(H, W)}")
    if mats_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mats_dtype must be bf16 or f32, got {mats_dtype}")
    ep = None
    if epilogue is not None:
        ep = Epilogue.from_dict(epilogue, H, W)
        if ep.ds != 1:
            raise NotImplementedError("the BV epilogue supports obs_downsample=1 only")
    kw = dict(mu_fn=mu_fn, j0_fn=j0_fn, kappa=float(kappa), cell=float(hx) * float(hy),
              dt=float(dt), n_steps=int(n_steps), round_bf16=mats_dtype == torch.bfloat16)
    oracle = bv_cc_reference(mu_fn, j0_fn, float(kappa), float(hx), float(hy), float(dt),
                             int(n_steps))
    fold = (None if ep is None
            else functools.partial(_ep_fold_stats_cotangent, center=ep.center))

    def macro(state: torch.Tensor, crate):
        batch, x, cf = _flatten_batch(state, crate, H, W)
        consts = cas_constants(H, W, float(hx), float(hy), mats_dtype, state.device)
        impl = bv_cc_macro_plain if state.device.type == "cpu" else bv_cc_macro_cuda

        def run(u, c):
            return impl(u, c, consts, epilogue=ep, **kw)

        if ep is None:
            u1 = _OracleMacro.apply(x, cf, run, oracle, None)
            return u1.to(state.dtype).reshape(*batch, H, W)
        u1, stats, obs = _OracleMacro.apply(x, cf, run, oracle, fold)
        return (u1.to(state.dtype).reshape(*batch, H, W), stats.reshape(*batch, 3),
                obs.reshape(*batch, H, W))

    return macro
