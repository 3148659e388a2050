"""3D Hartley-transform semi-implicit Cahn-Hilliard macro (PyTorch port of
:mod:`pde_opt_tpu.ops.cas3d`), and the separable cas transforms it shares
with the general-mobility macros of :mod:`.cas_mobility`.

Every spectral multiplier of the semi-implicit unit-mobility update is even
in each frequency axis, so the separable real cas transform (one matrix
product per axis) diagonalises it, and the spectrum is carried across
substeps:

    u~ = fwd(u);  n_steps times:  incr = cm·fwd(mu(u)) − cu·u~,
                                  u += inv(incr),  u~ += incr

with ``cm = dt·lam/(1 + A dt κ lam²)``, ``cu = dt κ lam²/(1 + A dt κ lam²)``
for the FD Laplacian symbol ``lam`` and each env's own κ.  The JAX package
computes this with plain XLA contractions (no Pallas kernel), so the port
uses ``torch.matmul``: with ``mats_dtype=torch.bfloat16`` each contraction's
operand is rounded to bf16 by a cast and the product accumulates in f32
(TF32 off), as the JAX einsums with ``preferred_element_type=float32`` do;
with f32 matrices nothing is rounded; with f64 matrices the operand is cast
to f64 and the product rounded back to f32.  The field is f32 throughout, as
in the JAX macro.  Differentiable natively (autograd through the loop).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .cas_common import cas_mat
from .fused import kappa_vector

__all__ = [
    "CasNdConstants",
    "cas_nd_constants",
    "cas_nd_transform",
    "fd_lap_symbol",
    "flatten_nd",
    "make_ch3d_cas_macro",
    "ch3d_sif_macro_reference",
]


def fd_lap_symbol(Ns: Sequence[int], dxs: Sequence[float]) -> np.ndarray:
    """The FD Laplacian's eigenvalues on the ``Ns`` grid, float64, summed
    over the axes in order (the JAX macros' ``lam``)."""
    nd = len(Ns)
    lam = 0.0
    for i, (n, h) in enumerate(zip(Ns, dxs)):
        shape = [1] * nd
        shape[i] = n
        lam = lam + ((2.0 * np.cos(2.0 * np.pi * np.arange(n) / n) - 2.0) / (h * h)).reshape(shape)
    return lam


class CasNdConstants(NamedTuple):
    """A separable cas transform's constants on one device: the forward
    matrices ``fwd`` (one per axis) and the inverse ones ``inv = C/N``, each
    rounded to ``mats_dtype`` and stored in the dtype the products run in
    (f32 for bf16 or f32 matrices); ``lam`` (f32) and ``lam2 = lam²`` (f32
    squared in f32, as the JAX macros square it)."""

    fwd: Tuple[torch.Tensor, ...]
    inv: Tuple[torch.Tensor, ...]
    lam: torch.Tensor
    lam2: torch.Tensor


@functools.lru_cache(maxsize=32)
def cas_nd_constants(Ns: Tuple[int, ...], dxs: Tuple[float, ...], mats_dtype: torch.dtype,
                     device: torch.device) -> CasNdConstants:
    """Build (once per configuration and device) the transform's constants."""
    if mats_dtype not in (torch.bfloat16, torch.float32, torch.float64):
        raise ValueError(f"mats_dtype must be bf16, f32 or f64, got {mats_dtype}")
    work = torch.float64 if mats_dtype == torch.float64 else torch.float32

    def mat(m):
        return torch.from_numpy(m).to(mats_dtype).to(device, work).contiguous()

    lam = torch.from_numpy(fd_lap_symbol(Ns, dxs)).to(torch.float32)
    return CasNdConstants(
        fwd=tuple(mat(cas_mat(n)) for n in Ns),
        inv=tuple(mat(cas_mat(n) / n) for n in Ns),
        lam=lam.to(device), lam2=(lam**2).to(device),
    )


def _contract(z: torch.Tensor, M: torch.Tensor, k: int) -> torch.Tensor:
    """``out[..., d, ...] = Σ_a z[..., a, ...] M[a, d]`` over the axis ``-k``
    of ``z``."""
    if k == 1:
        return torch.matmul(z, M)
    shape = z.shape
    n, tail = shape[-k], math.prod(shape[len(shape) - k + 1:])
    return torch.matmul(M.transpose(0, 1), z.reshape(*shape[:-k], n, tail)).reshape(shape)


def cas_nd_transform(z: torch.Tensor, mats: Sequence[torch.Tensor],
                     mats_dtype: torch.dtype) -> torch.Tensor:
    """Apply one cas matrix per trailing axis of ``z`` (f32), the first of
    ``mats`` to the first of those axes, rounding each contraction's operand
    to ``mats_dtype`` (the JAX ``_apply``); returns f32."""
    nd = len(mats)
    for i, M in enumerate(mats):
        z = _contract(z.to(mats_dtype).to(M.dtype), M, nd - i).to(torch.float32)
    return z


def flatten_nd(state: torch.Tensor, kappa, Ns: Tuple[int, ...]):
    """``(batch, x (B, *Ns) f32, kap (B,) f32)`` from a ``(*batch, *Ns)``
    state and a number, a scalar or ``(B,)`` tensor, or a batch-shaped κ."""
    nd = len(Ns)
    batch, dims = tuple(state.shape[:-nd]), tuple(state.shape[-nd:])
    if dims != tuple(Ns):
        raise ValueError(f"state trailing shape {dims} != {tuple(Ns)}")
    B = math.prod(batch) if batch else 1
    x = state.reshape(B, *Ns).to(torch.float32)
    return batch, x, kappa_vector(kappa, B, x)


def make_ch3d_cas_macro(
    mu_fn: Callable,
    N1: int,
    N2: int,
    N3: int,
    h1: float,
    h2: float,
    h3: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype: torch.dtype = torch.bfloat16,
):
    """Build ``macro(u, kappa) -> u1``: ``n_steps`` semi-implicit substeps.

    ``u``: ``(..., N1, N2, N3)`` (leading axes batch); ``kappa`` a number or
    broadcastable to the batch.  ``mats_dtype``: matmul operand dtype (bf16
    default; f32 or f64 for exact arithmetic in tests).
    """
    Ns, dxs = (N1, N2, N3), (float(h1), float(h2), float(h3))
    A_dt, dt_f = float(A) * float(dt), float(dt)

    def macro(state: torch.Tensor, kappa) -> torch.Tensor:
        batch, u, kap = flatten_nd(state, kappa, Ns)
        c = cas_nd_constants(Ns, dxs, mats_dtype, state.device)
        k = kap.reshape(-1, 1, 1, 1)
        denom = 1.0 / (1.0 + A_dt * (k * c.lam2))
        cm = (dt_f * c.lam) * denom
        cu = (dt_f * k) * c.lam2 * denom

        def fwd(z):
            return cas_nd_transform(z, c.fwd, mats_dtype)

        u_t = fwd(u)
        for _ in range(n_steps):
            incr = cm * fwd(mu_fn(u)) - cu * u_t
            u = u + cas_nd_transform(incr, c.inv, mats_dtype)
            u_t = u_t + incr
        return u.to(state.dtype).reshape(*batch, *Ns)

    return macro


def ch3d_sif_macro_reference(mu_fn, h1, h2, h3, A, dt, n_steps):
    """``torch.fft`` oracle with the macro's exact-arithmetic semantics, in
    the field's dtype (tests and on-card checks)."""

    def macro(u: torch.Tensor, kappa) -> torch.Tensor:
        lam = torch.from_numpy(fd_lap_symbol(u.shape[-3:], (h1, h2, h3))).to(u.device, u.dtype)
        kap = torch.as_tensor(kappa, device=u.device)
        if kap.ndim <= 1:
            kap = torch.broadcast_to(kap, u.shape[:-3]).reshape(u.shape[:-3] + (1, 1, 1))
        denom = 1.0 / (1.0 + A * dt * kap * lam**2)
        dims = (-3, -2, -1)
        for _ in range(n_steps):
            m_hat = torch.fft.fftn(mu_fn(u), dim=dims)
            u_hat = torch.fft.fftn(u, dim=dims)
            incr = denom * (lam * m_hat - kap * lam**2 * u_hat)
            u = u + dt * torch.fft.ifftn(incr, dim=dims).real.to(u.dtype)
        return u

    return macro
