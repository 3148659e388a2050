"""Gross-Pitaevskii equation (PyTorch port of ``GPE2DTSControl`` and the
constants of :mod:`pde_opt_tpu.models.gross_pitaevskii`).

State is a real ``(..., H, W, 2)`` stack of (Re ψ, Im ψ), as in the JAX
package; complex arithmetic appears only inside the Strang stepper.  The
rotating-frame ``GPE2DTSRot`` is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..grid import Domain
from ..ops.spectral import make_fft_pair
from ..utils.device import resolve_device
from .base import TimeSplittingEquation

__all__ = ["GPE2DTSControl", "hbar", "mass_Na23", "a0"]

# Physical constants (the JAX package's, reference gross_pitaevskii.py:14-16)
hbar = 1.05e-34  # J*s
mass_Na23 = 3.8175406e-26  # kg (sodium-23)
a0 = 5.29177210903e-11  # Bohr radius


@functools.lru_cache(maxsize=32)
def _gpe_tensors(domain: Domain, kinetic: bool, trap_factor, e, device: torch.device):
    """``(xmesh, ymesh, V_trap, A_term)`` on ``device``: the meshes and the
    trap ``½ trap_factor ((1+e) x² + (1-e) y²)`` in the domain's dtype, and
    the split-step symbol ``½ i (2πik)²`` (zero unless ``kinetic``) in its
    complex dtype.  Cached, so that building the equation every env step
    moves nothing from the host."""
    x, y = (torch.from_numpy(m).to(device) for m in domain.mesh())
    v_trap = 0.5 * trap_factor * ((1 + e) * x**2 + (1 - e) * y**2)
    kx, ky = domain.fft_mesh()
    k2 = (2j * np.pi * kx.astype(np.float64)) ** 2 + (2j * np.pi * ky.astype(np.float64)) ** 2
    a_term = 0.5j * k2 * (1.0 if kinetic else 0.0)
    return (x, y, v_trap, torch.from_numpy(a_term).to(
        device, torch.promote_types(domain.dtype, torch.complex64)))


class GPE2DTSControl(TimeSplittingEquation):
    """2D GPE with harmonic trap, optical control field and interaction.

        i ∂ψ/∂t = [−½∇² + V(r,t) + k|ψ|²] ψ
        V(r,t) = ½·trap_factor·[(1+e)x² + (1−e)y²] + V_control(r,t)

    ``lights(t, x, y)`` is the control field; the meshes it receives are
    tensors on ``device`` (default CUDA).  As in the JAX package the kinetic
    term is off unless ``kinetic=True`` (the reference's Thomas-Fermi
    default).
    """

    fft = None
    ifft = None
    A_term = None
    dx = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused Strang stepper pulls off instances.
    k = None
    e = None
    lights = None
    trap_factor = None
    kinetic = None
    domain = None
    xmesh = None
    ymesh = None
    V_trap = None

    def __init__(self, domain: Domain, k, e, lights: Callable,
                 trap_factor: float = 1.0, kinetic: bool = False,
                 device: Optional[torch.device] = None):
        self.domain = domain
        self.k = k
        self.e = e
        self.lights = lights
        self.trap_factor = trap_factor
        self.kinetic = kinetic
        self.device = resolve_device("cuda" if device is None else device)

        self.dx = domain.dx[0]
        self.fft, self.ifft = make_fft_pair(2)
        self.xmesh, self.ymesh, self.V_trap, self.A_term = _gpe_tensors(
            domain, bool(kinetic), trap_factor, e, self.device)

    def control(self, t):
        return self.lights(t, self.xmesh, self.ymesh)

    def A_terms(self, state, t):
        return self.A_term if self.kinetic else self.A_term * 0.0

    def B_terms(self, state, t):
        # -i (V_trap + V_control + k|ψ|²): purely imaginary, stacked (Re, Im).
        rho = state[..., 0] ** 2 + state[..., 1] ** 2
        imag = -self.V_trap - self.control(t) - self.k * rho
        imag = torch.broadcast_to(imag, state[..., 0].shape)
        return torch.stack([torch.zeros_like(imag), imag], dim=-1)

    def rhs(self, state, t):
        # For the Strang stepper the vector field is the B (pointwise) part;
        # the A part is applied exactly in Fourier space by the stepper.
        return self.B_terms(state, t)
