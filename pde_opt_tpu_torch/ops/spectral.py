"""Batched spectral transforms over trailing axes (PyTorch port).

Counterpart of :mod:`pde_opt_tpu.ops.spectral`: every transform is pinned
to the trailing ``ndim`` spatial axes, so one call serves a whole env fleet.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["spatial_axes", "make_fft_pair", "make_rfft_pair"]


def spatial_axes(ndim: int) -> Tuple[int, ...]:
    """The trailing ``ndim`` axes: ``(-ndim, ..., -1)``."""
    return tuple(range(-ndim, 0))


def make_fft_pair(ndim: int):
    """Return ``(fft, ifft)`` closures over the trailing ``ndim`` axes."""
    dims = spatial_axes(ndim)

    def _fft(x):
        return torch.fft.fftn(x, dim=dims)

    def _ifft(x):
        return torch.fft.ifftn(x, dim=dims)

    return _fft, _ifft


def make_rfft_pair(ndim: int, shape):
    """Real-input ``(rfft, irfft)`` closures over the trailing ``ndim`` axes.

    ``irfft`` pins the output length to ``shape`` and returns a real tensor,
    so ``.real`` on it is a no-op and the pair meets the same stepper
    contract as the complex pair.
    """
    dims = spatial_axes(ndim)
    shape = tuple(shape)

    def _rfft(x):
        return torch.fft.rfftn(x, dim=dims)

    def _irfft(x):
        return torch.fft.irfftn(x, s=shape, dim=dims)

    return _rfft, _irfft
