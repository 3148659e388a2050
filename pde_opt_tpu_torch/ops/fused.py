"""Fused single-pass conservative Cahn-Hilliard FD rhs, 2D and 3D (PyTorch
port of :mod:`pde_opt_tpu.ops.fused`): kernel K8.

    rhs(u) = div( D_face(u) · grad( mu(u) − κ ∇²u ) )

with the face average ``D_face = (D + D[+1]) / 2``, periodic in every
spatial axis, each env with its own κ.  As a chain of roll stencils this is
~20 passes over the field; the kernel (``csrc/ch_rhs_fd.cu``) reads each
env's field once and writes the rhs once.

Each dimension has two implementations of the same function:
:func:`ch_rhs_fd_plain` / :func:`ch3d_rhs_fd_plain` (a ``torch.roll`` chain
in the JAX kernels' order of operations; what CPU tensors run and what the
kernel is held against on the card) and :func:`ch_rhs_fd_cuda` /
:func:`ch3d_rhs_fd_cuda` (the Hopper kernel; what CUDA tensors run).  There
is no fallback from one to the other.

The plain version evaluates ``mu`` and ``D`` as the callables they are.  The
kernel reads them from coefficients in device memory, for a closed set of
forms (:func:`kernel_form`): a :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`,
a :class:`~pde_opt_tpu_torch.models.functions.LegendrePolynomialExpansion`,
a :class:`~pde_opt_tpu_torch.models.functions.ChemicalPotentialLegendrePolynomials`
without a prior, or a :class:`~pde_opt_tpu_torch.models.functions.DiffusionLegendrePolynomials`;
anything else raises on CUDA tensors.  Coefficients that require a gradient
raise while grad mode is on, on either device (the JAX kernel fails on a
traced parameter too): train learnable ``mu``/``D`` through the
``rhs_impl="xla"`` macro of :mod:`pde_opt_tpu_torch.ops.cas_mobility`.  The
rhs itself has no derivative, as the JAX kernel has none: a backward pass
that reaches it raises.  The JAX functions' ``block_envs``/``interpret``
(TPU tiling) have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Tuple

import torch
from torch import nn

from .cas_common import PolynomialMu
from .fold import fold_vmap
from .kernels import (
    bind,
    check,
    check_cuda,
    count_launch,
    device_stream,
    library,
    register_launches,
)

__all__ = [
    "kernel_form",
    "ch_rhs_fd_plain",
    "ch3d_rhs_fd_plain",
    "ch_rhs_fd_cuda",
    "ch3d_rhs_fd_cuda",
    "make_ch_rhs_fd_fused",
    "make_ch3d_rhs_fd_fused",
]

MAX_COEFFS = 16              # csrc/ch_rhs_fd.cu kMaxCoeffs
MAX_WIDTH_2D = 256           # 32 lanes x 8 columns (csrc/ch_rhs_fd.cu cols_per_lane)
_MAX_SMEM = 232448           # shared memory a Hopper block can opt in to
# The coefficient forms of csrc/ch_rhs_fd.cu (enum Form).
FORM_POLY, FORM_LEGENDRE, FORM_LEGENDRE_SCALED, FORM_EXP_LEGENDRE_SCALED = 0, 1, 2, 3


@functools.lru_cache(maxsize=64)
def _poly_coeffs(coeffs: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A polynomial's coefficients as an f32 tensor on ``device``, copied
    from the host once per polynomial and device."""
    return torch.tensor(coeffs, dtype=torch.float32).to(device)


def kernel_form(fn: Callable, device: torch.device) -> Tuple[int, torch.Tensor]:
    """``(form, coefficients)``: how kernel K8 evaluates ``fn`` on
    ``device``.  The coefficients are an f32 tensor on the device (a
    Legendre module's own parameter, detached).  Raises ``ValueError`` for
    a callable the kernel cannot evaluate."""
    from ..models.functions.legendre import (
        ChemicalPotentialLegendrePolynomials,
        DiffusionLegendrePolynomials,
        LegendrePolynomialExpansion,
    )

    if isinstance(fn, PolynomialMu):
        return FORM_POLY, _poly_coeffs(fn.coeffs, device)
    if isinstance(fn, LegendrePolynomialExpansion):
        form, params = FORM_LEGENDRE, fn.params
    elif isinstance(fn, ChemicalPotentialLegendrePolynomials) and fn.prior_fn is None:
        form, params = FORM_LEGENDRE_SCALED, fn.expansion.params
    elif isinstance(fn, DiffusionLegendrePolynomials):
        form, params = FORM_EXP_LEGENDRE_SCALED, fn.expansion.params
    else:
        raise ValueError(
            "the CUDA rhs (K8) evaluates mu and D from coefficients: pass a "
            "PolynomialMu, a LegendrePolynomialExpansion, a "
            "ChemicalPotentialLegendrePolynomials without prior_fn or a "
            f"DiffusionLegendrePolynomials; got {fn!r}"
        )
    params = params.detach()
    if not 1 <= params.numel() <= MAX_COEFFS:
        raise ValueError(f"K8 takes 1 to {MAX_COEFFS} coefficients, got {params.numel()}")
    check_cuda("coefficients", params, (params.numel(),), torch.float32, device)
    return form, params


def refuse_learnable(*fns: Callable) -> None:
    """Raise if grad mode is on and a coefficient module among ``fns`` has a
    parameter that requires a gradient: the fused rhs has no derivative
    with respect to it."""
    if not torch.is_grad_enabled():
        return
    for fn in fns:
        if isinstance(fn, nn.Module) and any(p.requires_grad for p in fn.parameters()):
            raise ValueError(
                f"{fn!r} has parameters that require a gradient, which the fused "
                "rhs (K8) cannot give: train learnable mu/D with rhs_impl='xla', "
                "or call under torch.no_grad() / after requires_grad_(False)"
            )


def ch_rhs_fd_plain(u: torch.Tensor, kappa: torch.Tensor, *, mu_fn: Callable,
                    D_fn: Callable, hx: float, hy: float) -> torch.Tensor:
    """Plain-torch 2D rhs: ``u`` (B, H, W), ``kappa`` (B,), both of one
    float dtype; the JAX 2D kernel's order of operations."""
    ihx, ihy = 1.0 / hx, 1.0 / hy
    ihx2, ihy2 = 1.0 / (hx * hx), 1.0 / (hy * hy)
    kap = kappa.reshape(-1, 1, 1)
    mu_h, Du = mu_fn(u), D_fn(u)

    def rx(a, s):
        return torch.roll(a, s, -2)

    def ry(a, s):
        return torch.roll(a, s, -1)

    lap = (rx(u, -1) - 2.0 * u + rx(u, 1)) * ihx2 + (ry(u, -1) - 2.0 * u + ry(u, 1)) * ihy2
    mu = mu_h - kap * lap
    Fx = 0.5 * (Du + rx(Du, -1)) * ((rx(mu, -1) - mu) * ihx)
    Fy = 0.5 * (Du + ry(Du, -1)) * ((ry(mu, -1) - mu) * ihy)
    return (Fx - rx(Fx, 1)) * ihx + (Fy - ry(Fy, 1)) * ihy


def ch3d_rhs_fd_plain(u: torch.Tensor, kappa: torch.Tensor, *, mu_fn: Callable,
                      D_fn: Callable, h1: float, h2: float, h3: float) -> torch.Tensor:
    """Plain-torch 3D rhs: ``u`` (B, N1, N2, N3), ``kappa`` (B,); the JAX
    3D kernel's order of operations."""
    inv = [1.0 / h1, 1.0 / h2, 1.0 / h3]
    inv2 = [v * v for v in inv]
    axes = (-3, -2, -1)
    kap = kappa.reshape(-1, 1, 1, 1)
    mu_h, Du = mu_fn(u), D_fn(u)
    lap = 0.0
    for ax, iv2 in zip(axes, inv2):
        lap = lap + (torch.roll(u, -1, ax) - 2.0 * u + torch.roll(u, 1, ax)) * iv2
    mu = mu_h - kap * lap
    out = 0.0
    for ax, iv in zip(axes, inv):
        F = 0.5 * (Du + torch.roll(Du, -1, ax)) * (torch.roll(mu, -1, ax) - mu) * iv
        out = out + (F - torch.roll(F, 1, ax)) * iv
    return out


def _bind_library(lib, name: str):
    """Declare K8's C interface on ``lib`` (``csrc/ch_rhs_fd.cu`` built for
    the card, or for the CPU by the tests' stub build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return bind(lib, {
        "ch_rhs_fd_2d_resident": [i, ctypes.POINTER(ctypes.c_int)],      # W
        "ch_rhs_fd_2d_launch": [
            p, p, p, i, i, i,                # u, kappa, out, B, H, W
            p, i, i, p, i, i,                # mu coeffs, n, form; D coeffs, n, form
            f, f, f, f,                      # 1/hx, 1/hy, 1/hx^2, 1/hy^2
            i,                               # resident warps (ch_rhs_fd_2d_resident)
            p,                               # stream
        ],
        "ch_rhs_fd_3d_resident": [i, i, ctypes.POINTER(ctypes.c_int)],   # N2, N3
        "ch_rhs_fd_3d_launch": [
            p, p, p, i, i, i, i,             # u, kappa, out, B, N1, N2, N3
            p, i, i, p, i, i,                # mu coeffs, n, form; D coeffs, n, form
            p, p,                            # host float[3]: 1/h, 1/h^2
            i,                               # resident blocks (ch_rhs_fd_3d_resident)
            p,                               # stream
        ],
    })


register_launches("ch_rhs_fd", "ch3d_rhs_fd")


def _ch_rhs_fd_2d_launch(lib, u, kappa, out, *, mu, D, hx, hy, resident, stream):
    """K8 (2D) of ``lib`` on ``stream``: the rhs of ``u`` into ``out``.
    ``mu`` and ``D`` are ``(form, coefficients)`` as :func:`kernel_form`
    gives them; ``resident`` as ``ch_rhs_fd_2d_resident`` gives it."""
    (mf, mc), (df, dc) = mu, D
    B, H, W = u.shape
    check(lib, lib.ch_rhs_fd_2d_launch(
        u.data_ptr(), kappa.data_ptr(), out.data_ptr(), B, H, W, mc.data_ptr(), mc.numel(), mf,
        dc.data_ptr(), dc.numel(), df, 1.0 / hx, 1.0 / hy, 1.0 / (hx * hx), 1.0 / (hy * hy),
        resident, stream,
    ), "ch_rhs_fd (2D) launch")
    return out


def _ch_rhs_fd_3d_launch(lib, u, kappa, out, *, mu, D, h1, h2, h3, resident, stream):
    """K8 (3D) of ``lib`` on ``stream``: the rhs of ``u`` into ``out``;
    ``mu``, ``D`` and ``resident`` as for :func:`_ch_rhs_fd_2d_launch`."""
    (mf, mc), (df, dc) = mu, D
    inv = [1.0 / h1, 1.0 / h2, 1.0 / h3]
    check(lib, lib.ch_rhs_fd_3d_launch(
        u.data_ptr(), kappa.data_ptr(), out.data_ptr(), *u.shape, mc.data_ptr(), mc.numel(), mf,
        dc.data_ptr(), dc.numel(), df, (ctypes.c_float * 3)(*inv),
        (ctypes.c_float * 3)(*(v * v for v in inv)), resident, stream,
    ), "ch_rhs_fd (3D) launch")
    return out


def _smem_3d(n2: int, n3: int) -> int:
    """Bytes of K8 (3D)'s shared memory (csrc/ch_rhs_fd.cu ``smem3d_bytes``):
    five u planes, rounded up to an even float count, and two planes of
    (m, D) pairs."""
    n23 = n2 * n3
    return 4 * ((5 * n23 + 1) // 2 * 2 + 4 * n23)


@functools.lru_cache(maxsize=None)
def _resident(query: str, device_index: int, *args: int) -> int:
    """K8's ``query`` on one device (``ch_rhs_fd_2d_resident``: warps
    resident at once for rows of width W; ``ch_rhs_fd_3d_resident``: blocks
    with N2 x N3 planes), asked once per device and shape: a launch then
    only divides."""
    lib = library("ch_rhs_fd", _bind_library)
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(lib, getattr(lib, query)(*args, ctypes.byref(n)), query)
    return n.value


def _check_rhs_args(u, kappa, mu_fn, D_fn):
    """Check what K8 takes; return ``mu`` and ``D`` as :func:`kernel_form`
    gives them."""
    dev = u.device
    check_cuda("u", u, u.shape, torch.float32, dev)
    check_cuda("kappa", kappa, u.shape[:1], torch.float32, dev)
    return kernel_form(mu_fn, dev), kernel_form(D_fn, dev)


def ch_rhs_fd_cuda(u: torch.Tensor, kappa: torch.Tensor, *, mu_fn: Callable,
                   D_fn: Callable, hx: float, hy: float) -> torch.Tensor:
    """Kernel K8 (2D): same contract as :func:`ch_rhs_fd_plain`, f32.

    Launches ``csrc/ch_rhs_fd.cu`` on the current stream and counts the
    launch (``ch_rhs_fd``); raises on anything the kernel does not take (a
    row is one warp's, at most 8 columns a lane: W ≤ 256; any H)."""
    if u.ndim != 3:
        raise ValueError(f"the state must be (B, H, W), got shape {tuple(u.shape)}")
    B, H, W = u.shape
    if W > MAX_WIDTH_2D:
        raise ValueError(f"K8 (2D) puts a row on one warp, W <= {MAX_WIDTH_2D}; got {(H, W)}")
    mu, D = _check_rhs_args(u, kappa, mu_fn, D_fn)
    resident = _resident("ch_rhs_fd_2d_resident", u.device.index, W)
    with device_stream(u.device) as stream:
        out = _ch_rhs_fd_2d_launch(library("ch_rhs_fd", _bind_library), u, kappa,
                                   torch.empty_like(u), mu=mu, D=D, hx=hx, hy=hy,
                                   resident=resident, stream=stream)
    count_launch("ch_rhs_fd")
    return out


def ch3d_rhs_fd_cuda(u: torch.Tensor, kappa: torch.Tensor, *, mu_fn: Callable,
                     D_fn: Callable, h1: float, h2: float, h3: float) -> torch.Tensor:
    """Kernel K8 (3D): same contract as :func:`ch3d_rhs_fd_plain`, f32.

    Launches ``csrc/ch_rhs_fd.cu`` on the current stream and counts the
    launch (``ch3d_rhs_fd``); raises on anything the kernel does not take
    (nine N2 x N3 f32 planes, the march's ring of five u planes and two each
    of m and D, must fit one block's shared memory)."""
    if u.ndim != 4:
        raise ValueError(f"the state must be (B, N1, N2, N3), got shape {tuple(u.shape)}")
    B, N1, N2, N3 = u.shape
    if _smem_3d(N2, N3) > _MAX_SMEM:
        raise ValueError(f"K8 (3D) holds 9 N2 x N3 f32 planes in shared memory; "
                         f"{(N2, N3)} is too large")
    mu, D = _check_rhs_args(u, kappa, mu_fn, D_fn)
    resident = _resident("ch_rhs_fd_3d_resident", u.device.index, N2, N3)
    with device_stream(u.device) as stream:
        out = _ch_rhs_fd_3d_launch(library("ch_rhs_fd", _bind_library), u, kappa,
                                   torch.empty_like(u), mu=mu, D=D, h1=h1, h2=h2, h3=h3,
                                   resident=resident, stream=stream)
    count_launch("ch3d_rhs_fd")
    return out


class _NoDerivative(torch.autograd.Function):
    """The fused rhs as a function autograd records but cannot
    differentiate: ``backward`` raises, as differentiating the JAX kernel
    does.  Under :func:`torch.func.vmap` the vmapped axis folds into the
    env axis: one launch for the whole fleet."""

    @staticmethod
    def forward(x, kap, run):
        return run(x, kap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(_NoDerivative.apply, info, in_dims, 2, *args)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the fused FD rhs (K8) has no derivative: differentiate through "
            "rhs_fd, or through the rhs_impl='xla' mobility macro"
        )


def kappa_vector(kappa, B: int, state: torch.Tensor) -> torch.Tensor:
    """κ as a contiguous ``(B,)`` vector in the state's dtype and device: a
    number is filled in on the device (no copy from the host), a tensor
    is broadcast (``ndim <= 1``) or reshaped (batch-shaped, as ``(B, 1,
    1)``)."""
    if not torch.is_tensor(kappa):
        return torch.full((B,), float(kappa), dtype=state.dtype, device=state.device)
    kap = kappa.to(device=state.device, dtype=state.dtype)
    kap = torch.broadcast_to(kap, (B,)) if kap.ndim <= 1 else kap.reshape(B)
    return kap.contiguous()


def _make_rhs(plain, cuda, mu_fn, D_fn, spacing: dict, nd: int):
    def rhs(state: torch.Tensor, kappa) -> torch.Tensor:
        refuse_learnable(mu_fn, D_fn)
        batch = tuple(state.shape[:-nd])
        dims = tuple(state.shape[-nd:])
        B = math.prod(batch) if batch else 1
        x = state.reshape(B, *dims)
        kap = kappa_vector(kappa, B, state)
        impl = plain if state.device.type == "cpu" else cuda

        def run(u, k):
            return impl(u.contiguous(), k, mu_fn=mu_fn, D_fn=D_fn, **spacing)

        return _NoDerivative.apply(x, kap, run).reshape(*batch, *dims)

    return rhs


def make_ch_rhs_fd_fused(mu_fn: Callable, D_fn: Callable, hx: float, hy: float):
    """Build the fused 2D CH FD rhs: ``rhs(state, kappa) -> dstate``.

    ``state`` is ``(..., H, W)`` (leading axes are batch); ``kappa`` a
    number, or a tensor broadcastable to the batch (scalar, ``(B,)``) or
    batch-shaped (``(B, 1, 1)``).  CPU tensors run :func:`ch_rhs_fd_plain`,
    CUDA tensors kernel K8 through :func:`ch_rhs_fd_cuda`."""
    return _make_rhs(ch_rhs_fd_plain, ch_rhs_fd_cuda, mu_fn, D_fn,
                     {"hx": float(hx), "hy": float(hy)}, 2)


def make_ch3d_rhs_fd_fused(mu_fn: Callable, D_fn: Callable, h1: float, h2: float,
                           h3: float):
    """Build the fused 3D CH FD rhs: ``rhs(state, kappa) -> dstate`` over
    ``(..., N1, N2, N3)`` states; κ as in :func:`make_ch_rhs_fd_fused`.  CPU
    tensors run :func:`ch3d_rhs_fd_plain`, CUDA tensors kernel K8 (3D)
    through :func:`ch3d_rhs_fd_cuda`."""
    return _make_rhs(ch3d_rhs_fd_plain, ch3d_rhs_fd_cuda, mu_fn, D_fn,
                     {"h1": float(h1), "h2": float(h2), "h3": float(h3)}, 3)
