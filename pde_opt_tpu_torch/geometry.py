"""Smoothed-boundary geometry (PyTorch port of :mod:`pde_opt_tpu.geometry`).

A binary mask becomes a smooth level set ψ by integrating a
curvature-regularised Allen-Cahn flow with the port's adaptive Tsit5
(:func:`pde_opt_tpu_torch.ops.integrate.integrate_adaptive`, one host sync
a step), clamped away from zero.  The mask's 4-neighbour graph Laplacian
and its lowest eigenmodes give a shape basis: host-side numpy and scipy
preprocessing, as in the JAX package, shipped to the shape's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .grid import _numpy_dtype
from .ops import stencils as st
from .ops.integrate import integrate_adaptive
from .ops.steppers import Tsit5
from .utils.device import resolve_device

__all__ = ["Shape"]


@dataclasses.dataclass
class Shape:
    """Geometry for the smoothed-boundary method.

    Args:
        binary: 0/1 mask of the domain interior (tensor or array).
        dx: grid spacings.
        smooth_epsilon: interface width of the smoothing flow.
        smooth_curvature: blend between the full Laplacian (1.0) and
            curvature-free normal diffusion (0.0).
        smooth_dt: initial step of the adaptive smoothing integration.
        smooth_tf: final time of the smoothing flow.
        device: where ψ and the shape basis live (default: ``binary``'s
            device if it is a tensor, else CUDA).

    After construction ``smooth`` holds ψ (in ``torch.get_default_dtype()``,
    clamped to [0.001, 1]) and ``smooth_stats`` the smoothing run's
    accepted and rejected step counts.
    """

    binary: Any
    dx: Optional[Tuple[float, float]] = (1.0, 1.0)
    smooth_epsilon: float = 1.0
    smooth_curvature: float = 0.0
    smooth_dt: float = 0.1
    smooth_tf: float = 1.0
    device: Any = None

    def __post_init__(self):
        if self.device is None:
            self.device = self.binary.device if torch.is_tensor(self.binary) else "cuda"
        self.device = resolve_device(self.device)
        self.binary = torch.as_tensor(self.binary, device=self.device)
        smooth = self.smooth_shape()
        smooth = torch.where(smooth < 0.001, 0.001, smooth)
        self.smooth = torch.where(smooth > 0.99, 1.0, smooth)

    def flow_rhs(self, u: torch.Tensor, t) -> torch.Tensor:
        """The smoothing flow's rhs: ``2·(curv·∇²u + (1−curv)·nᵀHn)``, the
        second derivative along the interface normal (grad-norm floor
        1e-7), minus the double-well potential 18/ε·u(1−u)(1−2u) over ε."""
        eps, curv = self.smooth_epsilon, self.smooth_curvature
        hx, hy = self.dx
        gx = st.grad_c(u, hx, -2)
        gy = st.grad_c(u, hy, -1)
        uxx = st.grad2_c(u, hx, -2)
        uyy = st.grad2_c(u, hy, -1)
        uxy = st.grad2_cross_c(u, hx, hy, -2, -1)
        mag2 = gx * gx + gy * gy
        mag2 = torch.where(mag2 < 1e-7, 1.0, mag2)
        along_normal = (uxx * gx * gx + uyy * gy * gy + 2.0 * uxy * gx * gy) / mag2
        blend = curv * (uxx + uyy) + (1.0 - curv) * along_normal
        return 2.0 * blend - 18.0 / eps * u * (1.0 - u) * (1.0 - 2.0 * u) / eps

    def smooth_shape(self) -> torch.Tensor:
        """Run the smoothing flow (:meth:`flow_rhs`) by adaptive Tsit5 at
        rtol 1e-4, atol 1e-6, in the default dtype; returns ψ at
        ``smooth_tf`` (unclamped) and records the step counts in
        ``smooth_stats``."""
        dtype = torch.get_default_dtype()
        ts = np.array([0.0, self.smooth_tf], dtype=_numpy_dtype(dtype))
        ys, self.smooth_stats = integrate_adaptive(
            Tsit5(), self.flow_rhs, self.binary.to(dtype), ts=ts, dt0=self.smooth_dt,
            rtol=1e-4, atol=1e-6, return_stats=True)
        return ys[-1]

    # ---- graph-Laplacian shape modes (host-side preprocessing) ---------

    def laplacian_from_mask(self, periodic: bool = False):
        """4-neighbour unnormalised graph Laplacian of the 0/1 mask.

        Host-side, one-time.  Returns ``(L, ids)``: ``L`` CSR of shape
        (n_nodes, n_nodes) and ``ids`` mapping pixels to node index (−1
        outside the mask).  Nodes are numbered in raster order; each axis
        links ``ids → roll(ids, −1)`` wherever both ends lie in the mask
        (the roll's wrap-around seam cut unless ``periodic``), and ``L =
        diag(degree) − (A + Aᵀ)``.
        """
        from scipy import sparse

        mask = self.binary.detach().cpu().numpy() > 0
        H, W = mask.shape
        n = int(mask.sum())
        ids = np.where(mask, np.cumsum(mask.ravel()).reshape(H, W) - 1, -1).astype(np.int64)
        if n == 0:
            return sparse.csr_matrix((0, 0)), ids

        rows, cols = [], []
        for axis in (0, 1):
            ahead = np.roll(ids, -1, axis=axis)
            link = (ids >= 0) & (ahead >= 0)
            if not periodic:
                seam = [slice(None)] * 2
                seam[axis] = -1
                link[tuple(seam)] = False
            rows.append(ids[link])
            cols.append(ahead[link])
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        adj = sparse.coo_matrix((np.ones(r.size), (r, c)), shape=(n, n))
        adj = (adj + adj.T).tocsr()
        degree = np.asarray(adj.sum(axis=1)).ravel()
        lap = (sparse.diags(degree) - adj).tocsr()
        return lap, ids

    # Above this node count, the dense symmetric eigensolver gives way to
    # block-iterative LOBPCG (dense eigh is O(n³) time, O(n²) memory).
    _DENSE_EIG_LIMIT = 8192

    def get_shape_modes(self, N: Optional[int] = None):
        """First ``N`` graph-Laplacian eigenmodes of the mask (all if None).

        Smallest-eigenvalue modes of :meth:`laplacian_from_mask`'s operator:
        a dense symmetric solve (``scipy.linalg.eigh``) up to
        ``_DENSE_EIG_LIMIT`` nodes, LOBPCG beyond, with a residual check and
        one harder retry.  Stores ``self.shape_basis`` ((H, W, N) tensor on
        the shape's device in the default dtype, zero off the mask) and
        ``self.shape_basis_evals`` (numpy).
        """
        lap, node_ids = self.laplacian_from_mask()
        n = lap.shape[0]
        k = n if N is None else int(min(N, n))
        if k <= 0 or n == 0:
            raise ValueError("mask has no nodes or N <= 0")

        if n <= self._DENSE_EIG_LIMIT:
            import scipy.linalg

            evals, vecs = scipy.linalg.eigh(lap.toarray(), subset_by_index=(0, k - 1))
        else:
            import scipy.sparse.linalg

            rng = np.random.default_rng(0)
            block = rng.standard_normal((n, k))
            block[:, 0] = 1.0  # seed the known constant kernel mode
            evals, vecs = scipy.sparse.linalg.lobpcg(lap, block, largest=False, tol=1e-7,
                                                     maxiter=500)

            # LOBPCG returns what it has at maxiter with only a warning: demand
            # finite pairs with small residuals, retry harder once, then raise.
            def _accepted(evals_, vecs_):
                if not (np.isfinite(evals_).all() and np.isfinite(vecs_).all()):
                    return False, np.inf, np.nan
                res_ = np.linalg.norm(lap @ vecs_ - vecs_ * evals_[None, :], axis=0)
                tol_ = 1e-5 * max(1.0, float(np.abs(evals_).max()))
                return bool((res_ <= tol_).all()), float(res_.max()), tol_

            ok, res_max, tol = _accepted(evals, vecs)
            if not ok:
                rng2 = np.random.default_rng(1)
                block2 = rng2.standard_normal((n, k))
                block2[:, 0] = 1.0
                start = vecs if np.isfinite(vecs).all() else block2
                evals, vecs = scipy.sparse.linalg.lobpcg(lap, start, largest=False, tol=1e-9,
                                                         maxiter=2000)
                ok, res_max, tol = _accepted(evals, vecs)
                if not ok:
                    detail = ("returned non-finite eigenpairs" if not np.isfinite(tol)
                              else f"max residual {res_max:.3e} > {tol:.3e}")
                    raise RuntimeError(
                        f"LOBPCG failed to converge the shape-mode basis: {detail} after "
                        "retry (reduce N or coarsen the mask)")
            order = np.argsort(evals)
            evals, vecs = evals[order], vecs[:, order]

        # Node numbering is raster order: the in-mask flat positions line up
        # with vecs' rows.
        H, W = node_ids.shape
        grid = np.zeros((H * W, k))
        grid[np.flatnonzero(node_ids.ravel() >= 0)] = vecs
        self.shape_basis = torch.from_numpy(grid.reshape(H, W, k)).to(
            self.device, torch.get_default_dtype())
        self.shape_basis_evals = evals
        return self.shape_basis, self.shape_basis_evals
