"""Cahn-Hilliard equation (PyTorch port of :mod:`pde_opt_tpu.models.cahn_hilliard`).

    ∂u/∂t = ∇·(D(u) ∇μ),   μ = μ_h(u) − κ∇²u

Batch-transparent: stencils and FFTs act on the trailing two axes, so one
``rhs`` evaluation serves a whole env fleet, and κ may be a per-env tensor
of shape ``(B, 1, 1)``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..grid import Domain
from ..ops import stencils as st
from ..ops.spectral import make_fft_pair, make_rfft_pair
from ..utils.device import resolve_device
from .base import BaseEquation

__all__ = ["CahnHilliard2DPeriodic"]

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


@functools.lru_cache(maxsize=32)
def _wavenumbers(domain: Domain, use_rfft: bool, device: torch.device):
    """``(2πik_x, 2πik_y, (2πik)², (2πik)⁴)`` as complex tensors on ``device``.

    Cached so that building an equation every env step moves nothing from
    the host once the first step has run.
    """
    kx, ky = domain.rfft_mesh() if use_rfft else domain.fft_mesh()
    tx = 2j * np.pi * kx.astype(np.float64)
    ty = 2j * np.pi * ky.astype(np.float64)
    k2 = tx**2 + ty**2
    cdt = _COMPLEX[domain.dtype]
    return tuple(torch.from_numpy(a).to(device, cdt) for a in (tx, ty, k2, k2**2))


class CahnHilliard2DPeriodic(BaseEquation):
    """2D periodic Cahn-Hilliard with variable mobility.

    ``derivs="fd"`` uses the conservative face-flux form (2nd order);
    ``derivs="fourier"`` the pseudo-spectral form.  Exposes
    ``fourier_symbol = κ(2πik)⁴`` for the semi-implicit spectral stepper.
    ``device`` places the spectral symbols (default: κ's device, else CUDA).
    """

    fft = None
    ifft = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused stepper pulls off instances.
    kappa = None
    mu = None
    D = None
    domain = None

    def __init__(self, domain: Domain, kappa, mu: Callable, D: Callable,
                 derivs: str = "fd", use_rfft: bool = True,
                 device: Optional[torch.device] = None):
        if device is None:
            device = kappa.device if torch.is_tensor(kappa) else "cuda"
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.D = D
        self.derivs = derivs
        self.use_rfft = use_rfft
        self.device = resolve_device(device)
        self._fourier_symbol = None

        (self.two_pi_i_kx, self.two_pi_i_ky, self.two_pi_i_k_2,
         self.two_pi_i_k_4) = _wavenumbers(domain, use_rfft, self.device)
        if use_rfft:
            self.fft, self.ifft = make_rfft_pair(2, domain.points)
        else:
            self.fft, self.ifft = make_fft_pair(2)

        if derivs == "fourier":
            self.rhs = self.rhs_fourier
        elif derivs == "fd":
            self.rhs = self.rhs_fd
        elif derivs == "pallas":
            raise NotImplementedError(
                "derivs='pallas' needs the fused FD-rhs kernel K8 "
                "(pde_opt_tpu/ops/fused.py), which is not ported yet; see "
                "ROADMAP.md.  The fused stepper ignores rhs, so use "
                "derivs='fd' there."
            )
        else:
            raise ValueError(f"Invalid derivative type: {derivs}")

    @property
    def fourier_symbol(self):
        """``κ(2πik)⁴``, built on first use: the fused stepper never reads
        it, and eager PyTorch would otherwise compute it every env step."""
        if self._fourier_symbol is None:
            self._fourier_symbol = self.kappa * self.two_pi_i_k_4
        return self._fourier_symbol

    def rhs_fourier(self, state, t):
        state_hat = self.fft(state)
        mu_hat = self.fft(self.mu(state)) - self.kappa * self.two_pi_i_k_2 * state_hat
        Du = self.D(state)
        fx = self.fft(Du * self.ifft(self.two_pi_i_kx * mu_hat))
        fy = self.fft(Du * self.ifft(self.two_pi_i_ky * mu_hat))
        return self.ifft(self.two_pi_i_kx * fx + self.two_pi_i_ky * fy).real

    def rhs_fd(self, state, t):
        hx, hy = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_2d(state, hx, hy)
        mux_f = st.grad_c2f(mu, hx, -2)
        muy_f = st.grad_c2f(mu, hy, -1)
        Du = self.D(state)
        Fx = st.avg_c2f(Du, -2) * mux_f
        Fy = st.avg_c2f(Du, -1) * muy_f
        return st.div_f2c(Fx, hx, -2) + st.div_f2c(Fy, hy, -1)
