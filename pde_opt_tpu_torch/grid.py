"""Uniform cell-centered grids and their Fourier duals (PyTorch port).

Counterpart of :mod:`pde_opt_tpu.grid`.  A :class:`Domain` is static,
hashable configuration; its meshes and wavenumbers are host numpy arrays,
exactly as in the JAX package.  Equations move what they need to a device
once, with an explicit ``device=``.  Spatial axes are the *trailing* axes
of a state tensor; leading axes are env batch axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Domain", "Grid"]


_NUMPY_DTYPES = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a real torch dtype (by table: a tensor made to ask
    would have no storage under a :mod:`torch.func` transform, where an
    equation may be built first)."""
    return np.dtype(_NUMPY_DTYPES[dtype])


@dataclasses.dataclass
class Domain:
    """A uniform, cell-centered rectangular grid.

    Attributes:
        points: number of collocation points per dimension.
        box: ``((lo, hi), ...)`` physical bounds per dimension.
        units: human-readable length unit label.
        geometry: optional smoothed-boundary
            :class:`~pde_opt_tpu_torch.geometry.Shape`; the smoothed-boundary
            equations read their level set ψ from ``geometry.smooth``.
        dtype: real torch dtype of the derived meshes (default float32).
    """

    points: Tuple[int, ...]
    box: Tuple[Tuple[float, float], ...]
    units: str = "dimensionless"
    geometry: Optional[object] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.points = tuple(int(p) for p in self.points)
        self.box = tuple((float(lo), float(hi)) for lo, hi in self.box)
        self.dx = tuple(
            (hi - lo) / n for (lo, hi), n in zip(self.box, self.points)
        )
        self.L = tuple(hi - lo for (lo, hi) in self.box)

    @property
    def ndim(self) -> int:
        return len(self.points)

    # ---- spatial axes / meshes (cell-centered, host numpy) ---------------
    def axes(self) -> Tuple[np.ndarray, ...]:
        dt = _numpy_dtype(self.dtype)
        return tuple(
            np.linspace(lo + h / 2, hi - h / 2, num=n).astype(dt)
            for (lo, hi), n, h in zip(self.box, self.points, self.dx)
        )

    def mesh(self) -> Tuple[np.ndarray, ...]:
        return tuple(np.meshgrid(*self.axes(), indexing="ij"))

    # ---- Fourier axes / meshes -------------------------------------------
    def fft_axes(self) -> Tuple[np.ndarray, ...]:
        dt = _numpy_dtype(self.dtype)
        return tuple(
            np.fft.fftfreq(n, h).astype(dt)
            for n, h in zip(self.points, self.dx)
        )

    def rfft_axes(self) -> Tuple[np.ndarray, ...]:
        dt = _numpy_dtype(self.dtype)
        return tuple(
            np.fft.rfftfreq(n, h).astype(dt)
            for n, h in zip(self.points, self.dx)
        )

    def fft_mesh(self) -> Tuple[np.ndarray, ...]:
        return tuple(np.meshgrid(*self.fft_axes(), indexing="ij"))

    def rfft_mesh(self) -> Tuple[np.ndarray, ...]:
        """Real-FFT mesh: full frequencies on leading axes, half on the last."""
        axes = list(self.fft_axes())
        axes[-1] = self.rfft_axes()[-1]
        return tuple(np.meshgrid(*axes, indexing="ij"))

    # ---- spectral symbols --------------------------------------------------
    def two_pi_i_k(self) -> Tuple[np.ndarray, ...]:
        """``2πik`` per dimension — the spectral first-derivative symbols."""
        return tuple(2j * np.pi * k for k in self.fft_mesh())

    def laplacian_symbol(self) -> np.ndarray:
        """``(2πik)² summed`` — the spectral Laplacian symbol (real, ≤ 0)."""
        return sum((2 * np.pi * k) ** 2 for k in self.fft_mesh()) * (-1.0)

    def __str__(self):
        return (
            f"Domain with bounds {self.box} with units of {self.units} "
            f"and {self.points} collocation points."
        )

    def __hash__(self):
        return hash((self.points, self.box, self.units, str(self.dtype)))

    def __eq__(self, other):
        if not isinstance(other, Domain):
            return NotImplemented
        return (
            self.points == other.points
            and self.box == other.box
            and self.units == other.units
            and self.geometry is other.geometry
            and self.dtype == other.dtype
        )


Grid = Domain
