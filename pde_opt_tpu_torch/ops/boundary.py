"""Configurable boundary conditions: periodic / Dirichlet / Neumann per axis
(PyTorch port of :mod:`pde_opt_tpu.ops.boundary`).

Ghost-cell padding on the trailing spatial axes, batch-transparent and
differentiable (plain torch ops, so autograd and :mod:`torch.func` go
through).

Conventions (cell-centered grid):

* ``('periodic', None)`` — wrap-around.
* ``('dirichlet', g)`` — boundary value ``g`` held at the domain *face*;
  ghost cell ``= 2g − u_edge`` (2nd-order).  ``g`` may be a scalar or a
  tensor broadcastable to the boundary slice.
* ``('neumann', g)`` — outward normal derivative ``g`` at the face; ghost
  ``= u_edge ∓ g·h`` (zero-flux for ``g = 0``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["pad_ghost", "laplacian", "get_neighbor_indices"]

BCSpec = Tuple[str, Union[None, float, torch.Tensor]]


def pad_ghost(u: torch.Tensor, axis: int, h: float, bc: BCSpec) -> torch.Tensor:
    """Pad one ghost cell on each side of ``axis`` according to ``bc``."""
    kind, value = bc
    n = u.shape[axis]
    edge_lo, edge_hi = u.narrow(axis, 0, 1), u.narrow(axis, n - 1, 1)
    if kind == "periodic":
        return torch.cat([edge_hi, u, edge_lo], dim=axis)
    g = 0.0 if value is None else value
    if kind == "dirichlet":
        ghost_lo, ghost_hi = 2.0 * g - edge_lo, 2.0 * g - edge_hi
    elif kind == "neumann":
        # outward normal: -x side derivative -g, +x side +g
        ghost_lo, ghost_hi = edge_lo - g * h, edge_hi + g * h
    else:
        raise ValueError(f"unknown boundary condition kind: {kind!r}")
    ghost_lo = torch.broadcast_to(ghost_lo, edge_lo.shape)
    ghost_hi = torch.broadcast_to(ghost_hi, edge_hi.shape)
    return torch.cat([ghost_lo, u, ghost_hi], dim=axis)


def laplacian(dx, boundary_conditions: Dict[int, BCSpec]):
    """Build a Laplacian operator with per-axis boundary conditions.

    Args:
        dx: scalar (1D) or per-axis spacings.
        boundary_conditions: ``{axis_index: (kind, value)}`` with axis
            indices counted over the *spatial* dimensions (0 = first spatial
            axis).  Every spatial axis must be present.

    Returns:
        ``lap(u[, t])`` operating on the trailing ``ndim`` axes of ``u``
        (leading axes are batch).
    """
    if np.isscalar(dx):
        dx = (float(dx),)
    dx = tuple(float(h) for h in dx)
    ndim = len(dx)
    if set(boundary_conditions.keys()) != set(range(ndim)):
        raise ValueError(
            f"boundary_conditions must specify every axis 0..{ndim-1}, "
            f"got {sorted(boundary_conditions)}"
        )

    def lap(u: torch.Tensor, t: Optional[float] = None) -> torch.Tensor:
        del t
        out = 0.0
        for d in range(ndim):
            axis = d - ndim
            h = dx[d]
            up = pad_ghost(u, axis, h, boundary_conditions[d])
            n = u.shape[axis]
            center = up.narrow(axis, 1, n)
            left = up.narrow(axis, 0, n)
            right = up.narrow(axis, 2, n)
            out = out + (left - 2.0 * center + right) / h**2
        return out

    return lap


def get_neighbor_indices(shape, index, boundary_conditions=None):
    """Neighbor indices of a grid point under the given BCs.

    For each spatial axis, returns the (−, +) neighbor multi-indices;
    ``None`` marks a neighbor outside a non-periodic boundary.  Axes absent
    from ``boundary_conditions`` are periodic.
    """
    boundary_conditions = boundary_conditions or {}
    index = tuple(int(i) for i in index)
    neighbors = []
    for d, n in enumerate(shape):
        kind = boundary_conditions.get(d, ("periodic", None))[0]
        for delta in (-1, +1):
            j = index[d] + delta
            if 0 <= j < n:
                neighbors.append(index[:d] + (j,) + index[d + 1:])
            elif kind == "periodic":
                neighbors.append(index[:d] + (j % n,) + index[d + 1:])
            else:
                neighbors.append(None)
    return neighbors
