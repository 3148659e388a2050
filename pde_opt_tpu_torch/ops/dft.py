"""Matmul-based spectral solves (PyTorch port of :mod:`pde_opt_tpu.ops.dft`).

* ``separable``: 4 complex axis-transforms as real products — O(B·N³)
  operations, with a (possibly per-env) elementwise denominator.
* ``dense``: the *entire* real→real solve ``Re ifft2(denom ⊙ fft2(x))``
  folded into one precomputed (N², N²) real matrix, applied as one
  ``(B, N²) @ (N², N²)`` product.  Only valid for a *fixed* denominator
  (:class:`pde_opt_tpu_torch.ops.steppers.SemiImplicitDenseSolve`).

The dense matrix is built on the host in numpy (f64) and copied to the
device once.  ``dtype``:

* ``"bf16_sqrt"`` (default) factors the operator as P = √P·√P and applies
  two products with bf16 operands and f32 sums, rounding the half-solved
  field to bf16 in between, as the JAX package does;
* ``"bf16"`` is the single flat product;
* ``"f32"`` is exact f32 (the JAX package's ``Precision.HIGHEST``): its
  products, and the separable solve's, run with TF32 off whatever the
  caller's setting.

JAX's bf16 dots return f32 (``preferred_element_type``); a torch bf16
matmul returns bf16, which would round the output once more.  So the bf16
products keep an f32 output: on CUDA tensors ``torch.mm(a, b,
out_dtype=torch.float32)`` (bf16 operands on the tensor cores, f32 out),
on CPU tensors an f32 product of the bf16-rounded operands (the CPU build
does not implement ``aten::mm.dtype``).  Both products are exact and sum in
f32.  These are plain large products that JAX also runs outside any Pallas
kernel; no hand-written kernel stands behind them.

Both builders put their tables on the card unless the caller names another
device, as every entry point of the port does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device, true_f32
from .fold import fold_vmap

__all__ = ["dense_solve_matrix", "make_dense_spectral_solve",
           "make_separable_spectral_solve"]


def dense_solve_matrix(points, denom: np.ndarray) -> np.ndarray:
    """Real (N², N²) matrix S with ``vec(out) = S @ vec(x)`` for the solve
    ``out = Re ifft2(denom ⊙ fft2(x))`` on a real field.

    Built on the host with numpy FFTs (f64), by applying the solve to the
    identity batch: column j is the solve of the unit field e_j.
    """
    H, W = points
    n = H * W
    denom = np.asarray(denom)
    eye = np.eye(n, dtype=np.float64).reshape(n, H, W)
    out = np.fft.ifftn(np.fft.fftn(eye, axes=(1, 2)) * denom[None], axes=(1, 2)).real
    return out.reshape(n, n).T.copy()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _ProductBF16(torch.autograd.Function):
    """``bf16(x) @ m_t`` with f32 sums and an f32 result for ``x`` (rows,
    N²); ``m_t`` holds bf16 values (bf16 on CUDA, bf16-exact f32 on the
    CPU).  Its gradient passes the rounding through, as autograd does for
    a cast.  Under :func:`torch.func.vmap` the vmapped axis folds into the
    rows: one product for the whole fleet (``aten::mm.dtype`` has no
    batching rule, and PyTorch's fallback would run one product a sample)."""

    @staticmethod
    def forward(x, m_t):
        if x.device.type == "cuda":
            return torch.mm(x.to(torch.bfloat16), m_t, out_dtype=torch.float32)
        return _bf16(x) @ m_t

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (m_t,) = ctx.saved_tensors
        return g @ m_t.t().to(g.dtype), None

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(_ProductBF16.apply, info, in_dims, 1, *args)


def _mm_bf16_f32(x: torch.Tensor, m_t: torch.Tensor) -> torch.Tensor:
    return _ProductBF16.apply(x, m_t)


def make_dense_spectral_solve(points, denom: np.ndarray, dtype: str = "bf16_sqrt",
                              device: Optional[torch.device] = None):
    """Return ``solve(x)`` applying the fixed dense solve to (..., H, W) on
    ``device`` (default: the card, ``"cuda"``).

    ``dtype="bf16_sqrt"`` (default) applies √P twice, the second damping
    the first's bf16 rounding noise at high k where a stiff loop would
    amplify it (the nonnegative ``denom`` it needs is checked); ``"bf16"``
    is one flat product (unstable in stiff loops); ``"f32"`` is exact.
    """
    H, W = points
    device = resolve_device("cuda" if device is None else device)
    mat_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    def bf16_matrix(S):
        # S^T, rounded to bf16 entry by entry, for x @ S^T.
        return torch.from_numpy(S.T.copy()).to(torch.bfloat16).to(device, mat_dtype)

    if dtype == "bf16_sqrt":
        denom = np.asarray(denom)
        if np.any(denom < 0):
            raise ValueError("bf16_sqrt requires a nonnegative denominator")
        S_half_t = bf16_matrix(dense_solve_matrix(points, np.sqrt(denom)))

        def solve(x):
            *batch, h, w = x.shape
            half = _mm_bf16_f32(x.reshape(-1, h * w), S_half_t)
            out = _mm_bf16_f32(half, S_half_t)
            return out.reshape(*batch, h, w).to(x.dtype)

        return solve
    S = dense_solve_matrix(points, denom)
    if dtype == "bf16":
        S_t = bf16_matrix(S)

        def solve(x):
            *batch, h, w = x.shape
            out = _mm_bf16_f32(x.reshape(-1, h * w), S_t)
            return out.reshape(*batch, h, w).to(x.dtype)
    elif dtype == "f32":
        S_t = torch.from_numpy(S.T.copy()).to(device, torch.float32)

        def solve(x):
            *batch, h, w = x.shape
            with true_f32(device):
                out = x.reshape(-1, h * w).to(torch.float32) @ S_t
            return out.reshape(*batch, h, w).to(x.dtype)
    else:
        raise ValueError(f"unknown dtype: {dtype!r}")
    return solve


def make_separable_spectral_solve(points, dtype: str = "f32",
                                  device: Optional[torch.device] = None):
    """Return ``solve(x, denom)`` via 4 complex axis-DFT products.

    Supports a (possibly batched, full-spectrum) elementwise ``denom`` —
    usable with per-env control parameters.  ``dtype="bf16"`` rounds the
    tables and the operand to bf16, the later operands staying f32 (the
    JAX package's mixed einsums promote them); every product sums in f32
    with TF32 off.  The JAX builder's ``precision`` argument is not taken:
    its default is exact f32 off the TPU, which is what this solve does.
    Tables go on ``device`` (default: the card, ``"cuda"``).
    """
    H, W = points
    device = resolve_device("cuda" if device is None else device)
    kh, kw = np.arange(H), np.arange(W)
    WH = np.exp(-2j * np.pi * np.outer(kh, kh) / H)
    WW = np.exp(-2j * np.pi * np.outer(kw, kw) / W)
    VH = np.exp(2j * np.pi * np.outer(kh, kh) / H) / H
    VW = np.exp(2j * np.pi * np.outer(kw, kw) / W) / W
    bf16 = dtype == "bf16"

    def cast(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(
            torch.bfloat16 if bf16 else torch.float32)
        return t.to(device, torch.float32)

    WHr, WHi, WWr, WWi = cast(WH.real), cast(WH.imag), cast(WW.real), cast(WW.imag)
    VHr, VHi, VWr, VWi = cast(VH.real), cast(VH.imag), cast(VW.real), cast(VW.imag)

    def separable(x, denom):
        xd = _bf16(x) if bf16 else x.to(torch.float32)
        # fft along W (last axis): x @ WW^T
        xr, xi = xd @ WWr.T, xd @ WWi.T
        # fft along H: WH @ x
        yr = WHr @ xr - WHi @ xi
        yi = WHr @ xi + WHi @ xr
        yr, yi = yr * denom, yi * denom
        # ifft along H
        zr = VHr @ yr - VHi @ yi
        zi = VHr @ yi + VHi @ yr
        # ifft along W, real part
        out = zr @ VWr.T - zi @ VWi.T
        return out.to(x.dtype)

    def solve(x, denom):
        with true_f32(device):
            return separable(x, denom)

    return solve
