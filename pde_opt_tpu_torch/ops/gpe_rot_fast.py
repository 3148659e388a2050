"""Matmul ADI macro for the rotating-frame GPE (PyTorch port of
:mod:`pde_opt_tpu.ops.gpe_rot_fast`).

Each directional sweep of :class:`~pde_opt_tpu_torch.ops.steppers.DirectionalSplitting`
is a fixed linear operator per grid line: the x-sweep applies
``F⁻¹ · diag(exp(dt·A_x(k_x, y))) · F`` to every column ``y``.  The sweeps
are precomputed on the host into per-line dense propagators, packed as real
``(2N, 2N)`` blocks ``[[Mr, −Mi], [Mi, Mr]]`` (one product of double depth
in place of four), and applied to the whole fleet as one batched matrix
product a sweep (``torch.bmm``, true f32: TF32 is switched off around the
products).  The Strang chain merges across substeps,
``(Sx Sy B Sy Sx)ⁿ = Sx Sy [B Sy Sx² Sy]ⁿ⁻¹ B Sy Sx``: 3 sweeps an inner
substep.  The pointwise ``B`` phase may use degree-7 Taylor polynomials
for ``exp``/``cos``/``sin`` (``phase_poly``, one ``addcmul`` a Horner
step), and the L² renormalisation follows ``B``.  The state is carried as
an f32 (re, im) pair.

Layout.  The fleet lives in one f32 buffer ``(H, 2, W, B)``: row ``x``,
re/im, column ``y``, env innermost.  A y-sweep is then a contiguous batched
product over the rows, ``(H, 2W, 2W) @ (H, 2W, B)``.  An x-sweep contracts
over ``(x, re/im)``; in this layout that pair has the single stride ``W·B``
when re/im is the faster index, so the x-sweep's blocks are packed with
that interleaved order and the product reads and writes the same buffer
through a strided view (lines ``y`` at stride ``B``): no permute between
sweeps.  Each call builds nothing on the host once its sweep matrices are
cached (per symbols, ``dt``, ``time_scale``, matrix dtype and device).
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.device import true_f32

__all__ = ["make_rot_adi_macro", "build_sweep_tensors"]


def _dft(N: int) -> np.ndarray:
    """Forward DFT matrix with ``fft`` conventions: X_k = Σ_x e^{-2πikx/N} ψ_x."""
    x = np.arange(N)
    return np.exp(-2j * np.pi * np.outer(x, x) / N)


def build_sweep_tensors(Ax, Ay, dt_c):
    """Per-line ADI propagators for both axes at phase ``exp(dt_c · A)``.

    Args:
        Ax: (H, W) complex symbol of the x-sweep: row index k_x, column
            index the y grid line (mixed basis).
        Ay: (H, W) complex symbol of the y-sweep: column index k_y, row
            index the x grid line.
        dt_c: complex step (δt·time_scale, the half/full factor applied).

    Returns ``(Mx, My)``: ``Mx[g, h, y] = [F⁻¹ diag(e^{dt_c·Ax[:,y]}) F]_{gh}``
    (shape (H, H, W)) and ``My[g, w, x] = [F⁻¹ diag(e^{dt_c·Ay[x,:]}) F]_{gw}``
    (shape (W, W, H)), as (real, imag) float32 pairs.  Host numpy, in the
    precision of the symbols.
    """
    Ax = np.asarray(Ax)
    Ay = np.asarray(Ay)
    H, W = Ax.shape
    Fh, Fw = _dft(H), _dft(W)
    iFh, iFw = np.conj(Fh) / H, np.conj(Fw) / W
    Ex = np.exp(dt_c * Ax)                       # (H_k, W_y)
    Ey = np.exp(dt_c * Ay)                       # (H_x, W_k)
    Mx = np.einsum("gk,ky,kh->ghy", iFh, Ex, Fh)
    My = np.einsum("gk,xk,kw->gwx", iFw, Ey, Fw)
    return ((np.float32(Mx.real), np.float32(Mx.imag)),
            (np.float32(My.real), np.float32(My.imag)))


def _pack_complex(Mr, Mi):
    """(K, K, L) complex pair -> (2K, 2K, L) real block ``[[Mr, -Mi], [Mi, Mr]]``
    per line (rows and columns ordered (re/im, k))."""
    top = np.concatenate([Mr, -Mi], axis=1)
    bot = np.concatenate([Mi, Mr], axis=1)
    return np.concatenate([top, bot], axis=0)


def _y_blocks(Mr, Mi):
    """The y-sweep's packed blocks as ``(H, 2W, 2W)``, one per row ``x``."""
    return np.ascontiguousarray(_pack_complex(Mr, Mi).transpose(2, 0, 1))


def _x_blocks(Mr, Mi):
    """The x-sweep's packed blocks as ``(W, 2H, 2H)``, one per column ``y``,
    rows and columns ordered (k, re/im): the order in which the pair has a
    single stride in the ``(H, 2, W, B)`` state."""
    H, W = Mr.shape[0], Mr.shape[2]
    P = _pack_complex(Mr, Mi).reshape(2, H, 2, H, W)        # [c', g, c, h, y]
    return np.ascontiguousarray(P.transpose(4, 1, 0, 3, 2).reshape(W, 2 * H, 2 * H))


class _SweepMats(collections.namedtuple("_SweepMats", "Ax Ay Mxh Myh Mxf")):
    """The half-step x and y blocks and the full-step x blocks, with the
    symbols they were built from (held, so the cache's keys stay valid)."""


_SWEEP_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_SWEEP_CACHE_SIZE = 16


def _sweep_mats(Ax: torch.Tensor, Ay: torch.Tensor, dt: float, time_scale, mats_dtype,
                device: torch.device) -> _SweepMats:
    """The packed sweep blocks on ``device``, cached by the symbol tensors'
    identity (the equation caches its symbols per configuration), ``dt``,
    ``time_scale``, the matrix dtype and the device.  A miss builds them on
    the host: the symbols are read back once."""
    key = (id(Ax), id(Ay), float(dt), complex(time_scale), mats_dtype, device)
    hit = _SWEEP_CACHE.get(key)
    if hit is not None and hit.Ax is Ax and hit.Ay is Ay:
        _SWEEP_CACHE.move_to_end(key)
        return hit
    ax, ay = (a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
              for a in (Ax, Ay))
    dt_c = complex(time_scale) * float(dt)
    (mxh_r, mxh_i), (myh_r, myh_i) = build_sweep_tensors(ax, ay, 0.5 * dt_c)
    (mxf_r, mxf_i), _ = build_sweep_tensors(ax, ay, dt_c)

    def dev(a):
        return torch.from_numpy(a).to(device, mats_dtype)

    mats = _SweepMats(Ax, Ay, dev(_x_blocks(mxh_r, mxh_i)), dev(_y_blocks(myh_r, myh_i)),
                      dev(_x_blocks(mxf_r, mxf_i)))
    _SWEEP_CACHE[key] = mats
    while len(_SWEEP_CACHE) > _SWEEP_CACHE_SIZE:
        _SWEEP_CACHE.popitem(last=False)
    return mats


@functools.lru_cache(maxsize=8)
def _coefs(device: torch.device) -> dict:
    """The Taylor coefficients the B phase's Horner steps add, as 0-d f32
    tensors on ``device`` (one ``addcmul`` a step)."""
    vals = (1.0, 0.5, 1.0 / 6.0, 1.0 / 24.0, 1.0 / 120.0, 1.0 / 720.0, -0.5, -1.0 / 6.0)
    return {v: torch.tensor(v, dtype=torch.float32, device=device) for v in vals}


def _exp_poly(zr, zi, k):
    """``exp(z) = e^{zr}(cos zi + i sin zi)`` as degree-7 Taylor polynomials
    by Horner steps (``k``: :func:`_coefs`): returns ``(e^{zr}, cos zi,
    sin zi)``."""
    er = torch.add(k[1.0 / 720.0], zr, alpha=1.0 / 5040.0)
    for c in (1.0 / 120.0, 1.0 / 24.0, 1.0 / 6.0, 0.5, 1.0, 1.0):
        er = torch.addcmul(k[c], er, zr)
    t2 = zi * zi
    c = torch.add(k[1.0 / 24.0], t2, alpha=-1.0 / 720.0)
    for v in (-0.5, 1.0):
        c = torch.addcmul(k[v], c, t2)
    s = torch.add(k[1.0 / 120.0], t2, alpha=-1.0 / 5040.0)
    for v in (-1.0 / 6.0, 1.0):
        s = torch.addcmul(k[v], s, t2)
    return er, c, s * zi


def make_rot_adi_macro(
    A_terms: Callable,
    B_terms: Callable,
    dx: float,
    H: int,
    W: int,
    dt: float,
    n_steps: int,
    *,
    time_scale=1.0,
    normalize: Optional[bool] = None,
    mats_dtype: torch.dtype = torch.float32,
    phase_poly: bool = True,
):
    """Build ``macro(psi, t0=0.0) -> psi1`` advancing ``n_steps`` ADI substeps.

    ``A_terms(None, t)`` gives the two sweep symbols, fixed for the macro;
    ``B_terms(psi, t)`` may close over per-env controls (pointwise, ``psi``
    complex ``(B, H, W)``).  ``psi``: complex ``(..., H, W)``, batch axes
    leading.  ``normalize`` defaults to on for imaginary ``time_scale``, as
    in :class:`~pde_opt_tpu_torch.ops.steppers.DirectionalSplitting`.
    ``phase_poly``: the B phase's ``exp(z)`` by degree-7 Taylor
    polynomials (below f32 resolution for ``|z| <= ~0.35``, ~1e-6 at 0.7;
    no runtime guard).  The sweep matrices live on the symbols' device.
    Only f32 matrices: the JAX macro has no other precision here.
    """
    if mats_dtype != torch.float32:
        raise ValueError(f"mats_dtype must be torch.float32, got {mats_dtype}")
    if normalize is None:
        normalize = complex(time_scale).imag != 0.0
    dt_c = complex(time_scale) * float(dt)
    Ax, Ay = A_terms(None, 0.0)
    device = Ax.device
    mats = _sweep_mats(Ax, Ay, dt, time_scale, mats_dtype, device)
    coefs = _coefs(device)
    dx = float(dx)

    def sweep_y(M, src, dst):
        # Rows x are the batch: (H, 2W, 2W) @ (H, 2W, B), contiguous.
        torch.bmm(M, src.view(H, 2 * W, -1), out=dst.view(H, 2 * W, -1))

    def sweep_x(M, src, dst):
        # Columns y are the batch; the (x, re/im) pair has stride W·B.
        def lines(buf):
            return buf.permute(2, 0, 1, 3).view(W, 2 * H, -1)

        torch.bmm(M, lines(src), out=lines(dst))

    def b_apply(src, dst, t):
        # The (B, H, W) views of (H, 2, W, B) that B_terms sees; the phase's
        # product is written into dst's views.
        pr, pi = src[:, 0].permute(2, 0, 1), src[:, 1].permute(2, 0, 1)
        dr, di = dst[:, 0].permute(2, 0, 1), dst[:, 1].permute(2, 0, 1)
        z = B_terms(torch.complex(pr, pi), t) * dt_c
        zr, zi = z.real, z.imag
        if phase_poly:
            er, c, s = _exp_poly(zr, zi, coefs)
        else:
            er, c, s = torch.exp(zr), torch.cos(zi), torch.sin(zi)
        ec, es = er * c, er * s
        torch.mul(pr, ec, out=dr).addcmul_(pi, es, value=-1.0)
        torch.mul(pr, es, out=di).addcmul_(pi, ec)
        if normalize:
            dst.div_(torch.linalg.vector_norm(dst, dim=(0, 1, 2)) * dx)

    def macro(psi, t0=0.0):
        *batch, a, b = psi.shape
        if (a, b) != (H, W):
            raise ValueError(f"state trailing shape {(a, b)} != {(H, W)}")
        if psi.device != device:
            raise ValueError(f"state on {psi.device}, sweep matrices on {device}")
        B = math.prod(batch) if batch else 1
        flat = psi.reshape(B, H, W)
        p = torch.empty((H, 2, W, B), dtype=torch.float32, device=device)
        q = torch.empty_like(p)
        p[:, 0].copy_(flat.real.permute(1, 2, 0))
        p[:, 1].copy_(flat.imag.permute(1, 2, 0))
        with true_f32(device):
            sweep_x(mats.Mxh, p, q)
            sweep_y(mats.Myh, q, p)
            for i in range(n_steps - 1):
                b_apply(p, q, t0 + i * dt)
                sweep_y(mats.Myh, q, p)
                sweep_x(mats.Mxf, p, q)
                sweep_y(mats.Myh, q, p)
            b_apply(p, q, t0 + (n_steps - 1) * dt)
            sweep_y(mats.Myh, q, p)
            sweep_x(mats.Mxh, p, q)
        out = torch.complex(q[:, 0].permute(2, 0, 1), q[:, 1].permute(2, 0, 1))
        return out.reshape(*batch, H, W).to(psi.dtype).contiguous()

    return macro
