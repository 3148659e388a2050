"""Allen-Cahn equation (PyTorch port of the periodic class of
:mod:`pde_opt_tpu.models.allen_cahn`).

    ∂u/∂t = −R(u)·μ,   μ = μ_h(u) − κ∇²u

Batch-transparent: stencils and FFTs act on the trailing two axes, and κ
may be a per-env tensor of shape ``(B, 1, 1)``.  The Butler-Volmer and
smoothed-boundary classes of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..grid import Domain
from ..ops import stencils as st
from ..ops.spectral import make_fft_pair, make_rfft_pair
from .base import BaseEquation
from .cahn_hilliard import _wavenumbers

__all__ = ["AllenCahn2DPeriodic"]


class _Spectral2D:
    """Shared 2D spectral set-up: wavenumbers on the equation's device
    (cached per domain and device) and the FFT pair."""

    def _init_spectral(self, domain: Domain, use_rfft: bool, device: torch.device):
        self.use_rfft = use_rfft
        self.two_pi_i_kx, self.two_pi_i_ky, self.two_pi_i_k_2, _ = _wavenumbers(
            domain, use_rfft, device)
        if use_rfft:
            self.fft, self.ifft = make_rfft_pair(2, domain.points)
        else:
            self.fft, self.ifft = make_fft_pair(2)


class AllenCahn2DPeriodic(BaseEquation, _Spectral2D):
    """2D periodic Allen-Cahn: ∂u/∂t = −R(u)·μ, μ = μ_h(u) − κ∇²u.

    Exposes ``fourier_symbol = −κ(2πik)²`` (the stiff operator) for the
    semi-implicit spectral stepper.  ``device`` places the spectral symbols
    (default: κ's device, else CPU).
    """

    fft = None
    ifft = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused stepper pulls off instances.
    kappa = None
    mu = None
    R = None
    domain = None

    def __init__(self, domain: Domain, kappa, mu: Callable, R: Callable,
                 derivs: str = "fd", use_rfft: bool = True,
                 device: Optional[torch.device] = None):
        if device is None:
            device = kappa.device if torch.is_tensor(kappa) else "cpu"
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.R = R
        self.derivs = derivs
        self.device = torch.device(device)
        self._init_spectral(domain, use_rfft, self.device)
        self._fourier_symbol = None

        if derivs == "fourier":
            self.rhs = self.rhs_fourier
        elif derivs == "fd":
            self.rhs = self.rhs_fd
        else:
            raise ValueError(f"Invalid derivative type: {derivs}")

    @property
    def fourier_symbol(self):
        """``−κ(2πik)²``, built on first use (the fused stepper never reads
        it)."""
        if self._fourier_symbol is None:
            self._fourier_symbol = -self.kappa * self.two_pi_i_k_2
        return self._fourier_symbol

    def rhs_fourier(self, state, t):
        state_hat = self.fft(state)
        mu = self.ifft(
            self.fft(self.mu(state)) - self.kappa * self.two_pi_i_k_2 * state_hat
        ).real
        return -self.R(state) * mu

    def rhs_fd(self, state, t):
        hx, hy = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_2d(state, hx, hy)
        return -self.R(state) * mu
