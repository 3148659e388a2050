"""Periodic finite-difference stencils on trailing axes (PyTorch port).

Counterpart of the Cahn-Hilliard, Allen-Cahn and smoothed-boundary subset
of :mod:`pde_opt_tpu.ops.stencils`: spatial axes are the trailing axes, any
leading axes are batch, and every stencil is a :func:`torch.roll`
expression.
"""

from __future__ import annotations

import torch

__all__ = ["grad_c2f", "avg_c2f", "div_f2c", "grad_c", "grad2_c", "grad2_cross_c", "lap_2nd_2d",
           "lap_2nd_3d"]


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


def lap_2nd_2d(u: torch.Tensor, hx: float, hy: float) -> torch.Tensor:
    """2nd-order periodic Laplacian over the trailing two axes."""
    return grad2_c(u, hx, -2) + grad2_c(u, hy, -1)


def lap_2nd_3d(u: torch.Tensor, hx: float, hy: float, hz: float) -> torch.Tensor:
    """2nd-order periodic Laplacian over the trailing three axes."""
    return grad2_c(u, hx, -3) + grad2_c(u, hy, -2) + grad2_c(u, hz, -1)

