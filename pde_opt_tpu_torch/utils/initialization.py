"""Initial-condition builders (PyTorch port of
:mod:`pde_opt_tpu.utils.initialization`).

Randomness comes from a ``torch.Generator``: the same seed gives other
numbers than the JAX package's keys.
"""

from __future__ import annotations

import math

import torch

from .device import resolve_device

__all__ = [
    "initialize_Psi",
    "add_vortex_to_wavefunction",
    "random_uniform_field",
    "step_interface",
]


def initialize_Psi(N: int, width: float = 100, vortexnumber: int = 0, device="cuda"):
    """Gaussian blob wavefunction (complex64), optionally with a central
    phase winding."""
    idx = torch.arange(N, device=resolve_device(device))
    i, j = torch.meshgrid(idx, idx, indexing="ij")
    di = (i - N // 2).to(torch.float32)
    dj = (j - N // 2).to(torch.float32)
    psi = torch.exp(-((di / width) ** 2) - (dj / width) ** 2).to(torch.complex64)
    if vortexnumber:
        phi = vortexnumber * torch.atan2(di, dj)
        psi = psi * torch.exp(1j * torch.remainder(phi, 2 * math.pi))
    return psi


def add_vortex_to_wavefunction(psi, vortex_pos, vortex_strength: int = 1,
                               vortex_width: float = 1):
    """Imprint a vortex (phase winding + smooth core) at ``vortex_pos``."""
    N = psi.shape[0]
    idx = torch.arange(N, device=psi.device)
    x, y = torch.meshgrid(idx, idx, indexing="ij")
    dx, dy = x - vortex_pos[0], y - vortex_pos[1]
    r = torch.sqrt((dx**2 + dy**2).to(torch.float32))
    phi = vortex_strength * torch.atan2(dy.to(torch.float32), dx.to(torch.float32))
    core = torch.tanh(r / vortex_width)
    return psi * (1 - core) + psi * torch.exp(1j * phi) * core


def random_uniform_field(generator: torch.Generator, shape, mean=0.5,
                         amplitude=0.01, clip=(0.0, 1.0)):
    """Small random perturbation around a mean, drawn on ``generator``'s
    device: the standard CH/AC start."""
    field = mean + amplitude * torch.randn(tuple(shape), generator=generator,
                                           device=generator.device)
    if clip is not None:
        field = torch.clamp(field, clip[0], clip[1])
    return field


def step_interface(shape, axis: int = 0, low=-1.0, high=1.0, device="cuda"):
    """Half-domain step initial condition (the 1D interface test fixture)."""
    device = resolve_device(device)
    n = shape[axis]
    mask = torch.arange(n, device=device) < n // 2
    bshape = [1] * len(shape)
    bshape[axis] = n
    mask = mask.reshape(bshape)
    return torch.where(mask, low, high) * torch.ones(tuple(shape), device=device)
