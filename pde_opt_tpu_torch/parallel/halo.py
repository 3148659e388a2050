"""Spatial-domain decomposition: halo exchange and distributed FFT
(PyTorch port of :mod:`pde_opt_tpu.parallel.halo`).

When one grid is too large for a card, its *rows* (first spatial axis) are
split over the ranks of a process group.  Finite-difference stencils then
need one ring exchange of halo rows per evaluation; pseudo-spectral
operators need a distributed FFT: a local FFT, one ``all_to_all`` transpose,
a local FFT.

Every function takes the rank's block with the first spatial axis split,
and ``group``: a process group, a 1-D device mesh, or ``None`` for the
world (where the JAX functions take the ``shard_map`` axis name).  The
collectives run outside any kernel (NCCL on the card, gloo on the CPU); in
a group of one rank they are skipped, and the ring is the local periodic
wrap.  Complex blocks cross as their real views (``torch.view_as_real``):
the transpose moves bytes and needs no complex reduction.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "ring_perm",
    "halo_pad_rows",
    "sharded_lap_2nd_2d",
    "distributed_fft2",
    "distributed_ifft2",
    "make_sharded_sif_ch_macro",
    "sharded_lap_2nd_3d",
    "distributed_fft3",
    "distributed_ifft3",
    "make_sharded_sif_ch3d_macro",
]


def _group(group):
    """A process group from ``group`` (a group, a 1-D mesh or ``None``)."""
    if group is None:
        return dist.group.WORLD
    if hasattr(group, "get_group"):      # a DeviceMesh
        return group.get_group()
    return group


def _size_rank(group):
    g = _group(group)
    return g, dist.get_world_size(g), dist.get_rank(g)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous real buffer for a collective."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def ring_perm(n: int, shift: int = 1):
    """Ring permutation ``[(src, dst)]``: rank ``i`` sends to ``i + shift``."""
    return [(i, (i + shift) % n) for i in range(n)]


def halo_pad_rows(u_local: torch.Tensor, group=None, halo: int = 1) -> torch.Tensor:
    """Pad ``halo`` rows on each side of the split first-spatial axis.

    One ring exchange each way, periodic global topology, in the JAX
    function's order: the top halo is rank ``i - 1``'s last rows, the bottom
    halo rank ``i + 1``'s first rows.  ``u_local``: ``(..., rows_local,
    cols)``.
    """
    g, n, r = _size_rank(group)
    last, first = u_local[..., -halo:, :], u_local[..., :halo, :]
    if n == 1:
        top, bottom = last, first
    else:
        nxt = dist.get_global_rank(g, ring_perm(n, +1)[r][1])
        prv = dist.get_global_rank(g, ring_perm(n, -1)[r][1])
        top = torch.empty(last.shape, dtype=u_local.dtype, device=u_local.device)
        bottom = torch.empty(first.shape, dtype=u_local.dtype, device=u_local.device)
        # The same order on every rank: with two ranks, next and previous
        # are one peer, and point-to-point messages between a pair match in
        # the order they were posted.
        ops = [dist.P2POp(dist.isend, _wire(last), nxt, g),
               dist.P2POp(dist.isend, _wire(first), prv, g),
               dist.P2POp(dist.irecv, _wire(top), prv, g),
               dist.P2POp(dist.irecv, _wire(bottom), nxt, g)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top, u_local, bottom], dim=-2)


def sharded_lap_2nd_2d(u_local: torch.Tensor, hx: float, hy: float, group=None) -> torch.Tensor:
    """2nd-order periodic Laplacian of a row-split 2D field: the single-card
    :func:`~pde_opt_tpu_torch.ops.stencils.lap_2nd_2d` with halos in place of
    the cross-rank rolls."""
    up = halo_pad_rows(u_local, group, halo=1)
    lap_rows = (up[..., :-2, :] - 2 * up[..., 1:-1, :] + up[..., 2:, :]) / hx**2
    lap_cols = (torch.roll(u_local, 1, -1) - 2 * u_local + torch.roll(u_local, -1, -1)) / hy**2
    return lap_rows + lap_cols


def _transpose(a: torch.Tensor, group, split: int, concat: int) -> torch.Tensor:
    """All-to-all of ``a``'s axis ``split`` (of the group's size): block
    ``j`` goes to rank ``j``, and the blocks received stack, by source rank,
    at axis ``concat`` of the result (which has ``a``'s shape)."""
    g, n, _ = _size_rank(group)
    if n == 1:
        return a.movedim(split, concat)
    # all_to_all_single splits dim 0 of a contiguous buffer.
    send = _wire(a.movedim(split, 0))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    if a.is_complex():
        recv = torch.view_as_complex(recv)
    return recv.movedim(0, concat)


def distributed_fft2(u_local: torch.Tensor, group=None) -> torch.Tensor:
    """2D FFT of a row-split field by one all_to_all transpose.

    Input: the rank's ``(N/P, M)`` row block of a global ``(N, M)`` field.
    Output: the rank's ``(N, M/P)`` **column block** of the global 2D FFT.
    Pair with :func:`distributed_ifft2`; spectral multipliers apply
    elementwise in that layout (slice the symbol with ``[..., :, col_block]``).
    """
    _, n_dev, _ = _size_rank(group)
    npp, m = u_local.shape[-2], u_local.shape[-1]
    a = torch.fft.fft(u_local, dim=-1)
    a = a.reshape(*a.shape[:-1], n_dev, m // n_dev)            # (..., npp, P, m/P)
    # Scatter column chunks, gather row chunks (source-rank-major): a
    # global transpose.
    a = _transpose(a, group, split=a.ndim - 2, concat=a.ndim - 3)  # (..., P, npp, m/P)
    a = a.reshape(*a.shape[:-3], n_dev * npp, m // n_dev)
    return torch.fft.fft(a, dim=-2)


def distributed_ifft2(f_local: torch.Tensor, group=None) -> torch.Tensor:
    """Inverse of :func:`distributed_fft2`: ``(N, M/P)`` column block to the
    ``(N/P, M)`` row block."""
    _, n_dev, _ = _size_rank(group)
    n, mpp = f_local.shape[-2], f_local.shape[-1]
    a = torch.fft.ifft(f_local, dim=-2)
    a = a.reshape(*a.shape[:-2], n_dev, n // n_dev, mpp)       # (..., P, n/P, mpp)
    # Scatter row chunks back to their owners; the column chunks received
    # flatten source-rank-major into the full M axis.
    a = _transpose(a, group, split=a.ndim - 3, concat=a.ndim - 2)  # (..., n/P, P, mpp)
    a = a.reshape(*a.shape[:-2], n_dev * mpp)
    return torch.fft.ifft(a, dim=-1)


def _fd_symbol(n: int, h: float) -> np.ndarray:
    """The 2nd-order FD Laplacian's symbol along one axis, in f64."""
    return (2.0 * np.cos(2.0 * np.pi * np.arange(n) / n) - 2.0) / (h * h)


def _sif_macro(mu_fn, lam_block, spatial: int, fft, ifft, A, dt, n_steps, group):
    """The semi-implicit CH macro on a split grid: ``lam_block(rank, P)``
    gives the rank's f64 symbol block in the transposed layout; each device
    and dtype gets its copy once."""
    symbols = {}

    def macro(u_local: torch.Tensor, kappa) -> torch.Tensor:
        _, n_dev, rank = _size_rank(group)
        key = (u_local.device, u_local.dtype)
        if key not in symbols:
            symbols[key] = torch.from_numpy(lam_block(rank, n_dev)).to(
                device=u_local.device, dtype=u_local.dtype)
        lam = symbols[key]
        lam2 = lam * lam
        kap = torch.as_tensor(kappa, dtype=u_local.dtype, device=u_local.device)
        if kap.ndim <= u_local.ndim - spatial:
            kap = kap.reshape(kap.shape + (1,) * spatial)
        denom = 1.0 / (1.0 + A * dt * kap * lam2)
        u = u_local
        for _ in range(n_steps):
            m_hat = fft(mu_fn(u), group)
            u_hat = fft(u, group)
            incr = denom * (lam * m_hat - kap * lam2 * u_hat)
            u = u + dt * ifft(incr, group).real.to(u.dtype)
        return u

    return macro


def make_sharded_sif_ch_macro(mu_fn: Callable, N: int, M: int, hx: float, hy: float,
                              A: float, dt: float, n_steps: int, group=None):
    """Semi-implicit spectral Cahn-Hilliard macro-step on a row-split grid.

    The spatial-decomposition counterpart of the single-card fused macro for
    grids too large for one card: the same substep (FD Laplacian symbols,
    per-instance κ in the implicit denominator) on the all_to_all
    distributed FFT; the symbols apply in the transposed (column-block)
    layout, the rank's block of the f64 symbol cast to the field's dtype.

    Returns ``macro(u_local, kappa) -> u_local`` with ``u_local`` the rank's
    ``(..., N/P, M)`` rows.
    """
    lam_n, lam_m = _fd_symbol(N, hx), _fd_symbol(M, hy)

    def lam_block(rank, n_dev):
        cols = slice(rank * (M // n_dev), (rank + 1) * (M // n_dev))
        return lam_n[:, None] + lam_m[None, cols]                 # (N, M/P)

    return _sif_macro(mu_fn, lam_block, 2, distributed_fft2, distributed_ifft2,
                      A, dt, n_steps, group)


# ---------------------------------------------------------------------------
# 3D: the leading spatial axis of a (..., N, M, K) field is split
# ---------------------------------------------------------------------------

def sharded_lap_2nd_3d(u_local: torch.Tensor, hx: float, hy: float, hz: float,
                       group=None) -> torch.Tensor:
    """2nd-order periodic 3D Laplacian of a first-axis-split field: the
    single-card :func:`~pde_opt_tpu_torch.ops.stencils.lap_2nd_3d`; one ring
    exchange on the split axis, rolls on the two local ones.  ``u_local``:
    ``(..., N/P, M, K)``."""
    up = halo_pad_rows(u_local.reshape(*u_local.shape[:-2], -1), group, halo=1)
    up = up.reshape(*u_local.shape[:-3], u_local.shape[-3] + 2, *u_local.shape[-2:])
    lap_x = (up[..., :-2, :, :] - 2 * up[..., 1:-1, :, :] + up[..., 2:, :, :]) / hx**2
    lap_y = (torch.roll(u_local, 1, -2) - 2 * u_local + torch.roll(u_local, -1, -2)) / hy**2
    lap_z = (torch.roll(u_local, 1, -1) - 2 * u_local + torch.roll(u_local, -1, -1)) / hz**2
    return lap_x + lap_y + lap_z


def distributed_fft3(u_local: torch.Tensor, group=None) -> torch.Tensor:
    """3D FFT of a first-axis-split field by one all_to_all transpose.

    Input: the rank's ``(N/P, M, K)`` block.  The two local axes transform
    on the card; the split axis after an all_to_all that trades M-chunks
    for the full N extent.  Output: the rank's ``(N, M/P, K)`` block (split
    on the SECOND axis) of the global 3D FFT; pair with
    :func:`distributed_ifft3`.
    """
    _, n_dev, _ = _size_rank(group)
    npp, m, k = u_local.shape[-3], u_local.shape[-2], u_local.shape[-1]
    a = torch.fft.fftn(u_local, dim=(-2, -1))
    a = a.reshape(*a.shape[:-3], npp, n_dev, m // n_dev, k)     # (..., npp, P, m/P, k)
    a = _transpose(a, group, split=a.ndim - 3, concat=a.ndim - 4)  # (..., P, npp, m/P, k)
    a = a.reshape(*a.shape[:-4], n_dev * npp, m // n_dev, k)
    return torch.fft.fft(a, dim=-3)


def distributed_ifft3(f_local: torch.Tensor, group=None) -> torch.Tensor:
    """Inverse of :func:`distributed_fft3`: ``(N, M/P, K)`` to ``(N/P, M, K)``."""
    _, n_dev, _ = _size_rank(group)
    n, mpp, k = f_local.shape[-3], f_local.shape[-2], f_local.shape[-1]
    a = torch.fft.ifft(f_local, dim=-3)
    a = a.reshape(*a.shape[:-3], n_dev, n // n_dev, mpp, k)     # (..., P, n/P, mpp, k)
    # The column chunks received flatten source-rank-major into M, as in
    # distributed_ifft2.
    a = _transpose(a, group, split=a.ndim - 4, concat=a.ndim - 3)  # (..., n/P, P, mpp, k)
    a = a.reshape(*a.shape[:-3], n_dev * mpp, k)
    return torch.fft.ifftn(a, dim=(-2, -1))


def make_sharded_sif_ch3d_macro(mu_fn: Callable, N: int, M: int, K: int,
                                hx: float, hy: float, hz: float,
                                A: float, dt: float, n_steps: int, group=None):
    """Semi-implicit spectral 3D Cahn-Hilliard macro on a split grid.

    The 3D counterpart of :func:`make_sharded_sif_ch_macro` for volumes
    beyond one card (256³ at f32 is 64 MiB a field, and a substep holds
    several fields and spectra): the first spatial axis is split, each
    substep the same FD-symbol update on :func:`distributed_fft3`.
    ``u_local``: the rank's ``(..., N/P, M, K)`` block.
    """
    lam_n, lam_m, lam_k = _fd_symbol(N, hx), _fd_symbol(M, hy), _fd_symbol(K, hz)

    def lam_block(rank, n_dev):
        cols = slice(rank * (M // n_dev), (rank + 1) * (M // n_dev))
        return lam_n[:, None, None] + lam_m[None, cols, None] + lam_k[None, None, :]

    return _sif_macro(mu_fn, lam_block, 3, distributed_fft3, distributed_ifft3,
                      A, dt, n_steps, group)
