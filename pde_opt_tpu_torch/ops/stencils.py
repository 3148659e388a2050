"""Periodic finite-difference stencils on trailing axes (PyTorch port).

Counterpart of :mod:`pde_opt_tpu.ops.stencils`: spatial axes are the
trailing axes (x = axis ``-ndim``), any leading axes are batch, and every
stencil is a :func:`torch.roll` expression.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = [
    "shift",
    "grad_c2f", "avg_c2f", "div_f2c", "grad_c", "grad2_c", "grad2_cross_c",
    "laplacian",
    "lap_2nd_2d", "lap_2nd_3d",
    "gradx_c2f", "grady_c2f", "gradz_c2f",
    "avgx_c2f", "avgy_c2f", "avgz_c2f",
    "divx_f2c", "divy_f2c", "divz_f2c",
    "gradx_c", "grady_c", "gradz_c",
    "grad2x_c", "grad2y_c", "grad2z_c", "grad2xy_c",
]


def shift(u: torch.Tensor, amount: int, axis: int) -> torch.Tensor:
    """Periodic shift: ``shift(u, +1, ax)[i] = u[i+1]`` along ``axis``."""
    return torch.roll(u, -amount, axis)


def grad_c2f(a: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    """Center→face forward difference: value at face ``i+1/2``."""
    return (torch.roll(a, -1, axis) - a) / h


def avg_c2f(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation of cell centers to faces ``i+1/2``."""
    return 0.5 * (a + torch.roll(a, -1, axis))


def div_f2c(F: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    """Face→center backward difference (adjoint of :func:`grad_c2f`)."""
    return (F - torch.roll(F, 1, axis)) / h


def grad_c(a: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    """Centered first derivative at cell centers."""
    return 0.5 * (torch.roll(a, -1, axis) - torch.roll(a, 1, axis)) / h


def grad2_c(a: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    """Centered second derivative at cell centers."""
    return (torch.roll(a, -1, axis) - 2 * a + torch.roll(a, 1, axis)) / (h * h)


def grad2_cross_c(a: torch.Tensor, hx: float, hy: float, axis_x: int, axis_y: int) -> torch.Tensor:
    """Centered mixed second derivative ∂²/∂x∂y at cell centers."""
    return (
        torch.roll(torch.roll(a, -1, axis_x), -1, axis_y)
        + torch.roll(torch.roll(a, 1, axis_x), 1, axis_y)
        - torch.roll(torch.roll(a, -1, axis_x), 1, axis_y)
        - torch.roll(torch.roll(a, 1, axis_x), -1, axis_y)
    ) / (4.0 * hx * hy)


def laplacian(u: torch.Tensor, dx: Sequence[float], ndim: Optional[int] = None) -> torch.Tensor:
    """2nd-order periodic Laplacian over the trailing ``ndim`` axes
    (default ``len(dx)``), ``dx`` the spacings in axis order."""
    if ndim is None:
        ndim = len(dx)
    out = 0.0
    for d in range(ndim):
        out = out + grad2_c(u, dx[d], d - ndim)
    return out


def lap_2nd_2d(u: torch.Tensor, hx: float, hy: float) -> torch.Tensor:
    """2nd-order periodic Laplacian over the trailing two axes."""
    return grad2_c(u, hx, -2) + grad2_c(u, hy, -1)


def lap_2nd_3d(u: torch.Tensor, hx: float, hy: float, hz: float) -> torch.Tensor:
    """2nd-order periodic Laplacian over the trailing three axes."""
    return grad2_c(u, hx, -3) + grad2_c(u, hy, -2) + grad2_c(u, hz, -1)



# ---- the JAX package's per-axis names (x = axis -ndim, y the next, z the last)

def gradx_c2f(a, hx, ndim: int = 2):
    return grad_c2f(a, hx, -ndim)


def grady_c2f(a, hy, ndim: int = 2):
    return grad_c2f(a, hy, -ndim + 1)


def gradz_c2f(a, hz):
    return grad_c2f(a, hz, -1)


def avgx_c2f(a, ndim: int = 2):
    return avg_c2f(a, -ndim)


def avgy_c2f(a, ndim: int = 2):
    return avg_c2f(a, -ndim + 1)


def avgz_c2f(a):
    return avg_c2f(a, -1)


def divx_f2c(F, hx, ndim: int = 2):
    return div_f2c(F, hx, -ndim)


def divy_f2c(F, hy, ndim: int = 2):
    return div_f2c(F, hy, -ndim + 1)


def divz_f2c(F, hz):
    return div_f2c(F, hz, -1)


def gradx_c(a, hx, ndim: int = 2):
    return grad_c(a, hx, -ndim)


def grady_c(a, hy, ndim: int = 2):
    return grad_c(a, hy, -ndim + 1)


def gradz_c(a, hz):
    return grad_c(a, hz, -1)


def grad2x_c(a, hx, ndim: int = 2):
    return grad2_c(a, hx, -ndim)


def grad2y_c(a, hy, ndim: int = 2):
    return grad2_c(a, hy, -ndim + 1)


def grad2z_c(a, hz):
    return grad2_c(a, hz, -1)


def grad2xy_c(a, hx, hy, ndim: int = 2):
    return grad2_cross_c(a, hx, hy, -ndim, -ndim + 1)
