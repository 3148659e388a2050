"""Cahn-Hilliard equations (PyTorch port of :mod:`pde_opt_tpu.models.cahn_hilliard`).

    ∂u/∂t = ∇·(D(u) ∇μ),   μ = μ_h(u) − κ∇²u

Batch-transparent: stencils and FFTs act on the trailing spatial axes (two
in 2D, three in 3D), so one ``rhs`` evaluation serves a whole env fleet, and
κ may be a per-env tensor of shape ``(B, 1, 1)`` (``(B, 1, 1, 1)`` in 3D).
``CahnHilliard2DSmoothedBoundary`` reads its level set ψ from
``domain.geometry.smooth``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..grid import Domain
from ..ops import stencils as st
from ..ops.fused import make_ch_rhs_fd_fused
from ..ops.spectral import make_fft_pair, make_rfft_pair
from ..utils.device import resolve_device
from .base import BaseEquation

__all__ = ["CahnHilliard2DPeriodic", "CahnHilliard3DPeriodic", "CahnHilliard2DSmoothedBoundary",
           "CahnHilliardSIFFT"]

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


@functools.lru_cache(maxsize=32)
def _wavenumbers(domain: Domain, use_rfft: bool, device: torch.device):
    """``(2πik_1, ..., 2πik_d, (2πik)², (2πik)⁴)`` as complex tensors on
    ``device``, one ``2πik`` per axis of the domain.

    Cached so that building an equation every env step moves nothing from
    the host once the first step has run.
    """
    ks = domain.rfft_mesh() if use_rfft else domain.fft_mesh()
    tk = [2j * np.pi * k.astype(np.float64) for k in ks]
    k2 = sum(t**2 for t in tk)
    cdt = _COMPLEX[domain.dtype]
    return tuple(torch.from_numpy(a).to(device, cdt) for a in (*tk, k2, k2**2))


def _device_of(kappa, device):
    """The equation's device: ``device``, else κ's device, else CUDA."""
    if device is None:
        device = kappa.device if torch.is_tensor(kappa) else "cuda"
    return resolve_device(device)


class CahnHilliard2DPeriodic(BaseEquation):
    """2D periodic Cahn-Hilliard with variable mobility.

    ``derivs="fd"`` uses the conservative face-flux form (2nd order);
    ``derivs="fourier"`` the pseudo-spectral form; ``derivs="pallas"`` the
    same face-flux form in one pass, kernel K8 on CUDA tensors
    (:func:`pde_opt_tpu_torch.ops.fused.make_ch_rhs_fd_fused`; on the card
    ``mu`` and ``D`` must be coefficient forms it reads, and it has no
    derivative).  Exposes ``fourier_symbol = κ(2πik)⁴`` for the
    semi-implicit spectral stepper.  ``device`` places the spectral symbols
    (default: κ's device, else CUDA).
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
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.D = D
        self.derivs = derivs
        self.use_rfft = use_rfft
        self.device = _device_of(kappa, device)
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
            self._fused_rhs = make_ch_rhs_fd_fused(self.mu, self.D, *domain.dx)
            self.rhs = self.rhs_pallas
        else:
            raise ValueError(f"Invalid derivative type: {derivs}")

    @property
    def fourier_symbol(self):
        """``κ(2πik)⁴``, built on first use: the fused stepper never reads
        it, and eager PyTorch would otherwise compute it every env step."""
        if self._fourier_symbol is None:
            self._fourier_symbol = self.kappa * self.two_pi_i_k_4
        return self._fourier_symbol

    def rhs_pallas(self, state, t):
        return self._fused_rhs(state, self.kappa)

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


class CahnHilliard3DPeriodic(BaseEquation):
    """3D periodic Cahn-Hilliard with variable mobility.

    ``derivs="fd"`` (conservative face-flux form) or ``"fourier"``
    (pseudo-spectral); ``fourier_symbol = κ(2πik)⁴``.  ``device`` places the
    spectral symbols (default: κ's device, else CUDA).
    """

    fft = None
    ifft = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused 3D steppers pull off instances.
    kappa = None
    mu = None
    D = None
    domain = None

    def __init__(self, domain: Domain, kappa, mu: Callable, D: Callable,
                 derivs: str = "fd", use_rfft: bool = True,
                 device: Optional[torch.device] = None):
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.D = D
        self.derivs = derivs
        self.use_rfft = use_rfft
        self.device = _device_of(kappa, device)
        self._fourier_symbol = None

        (self.two_pi_i_kx, self.two_pi_i_ky, self.two_pi_i_kz, self.two_pi_i_k_2,
         self.two_pi_i_k_4) = _wavenumbers(domain, use_rfft, self.device)
        if use_rfft:
            self.fft, self.ifft = make_rfft_pair(3, domain.points)
        else:
            self.fft, self.ifft = make_fft_pair(3)

        if derivs == "fourier":
            self.rhs = self.rhs_fourier
        elif derivs == "fd":
            self.rhs = self.rhs_fd
        else:
            raise ValueError(f"Invalid derivative type: {derivs}")

    @property
    def fourier_symbol(self):
        """``κ(2πik)⁴``, built on first use (see the 2D class)."""
        if self._fourier_symbol is None:
            self._fourier_symbol = self.kappa * self.two_pi_i_k_4
        return self._fourier_symbol

    def rhs_fourier(self, state, t):
        state_hat = self.fft(state)
        mu_hat = self.fft(self.mu(state)) - self.kappa * self.two_pi_i_k_2 * state_hat
        Du = self.D(state)
        fx = self.fft(Du * self.ifft(self.two_pi_i_kx * mu_hat))
        fy = self.fft(Du * self.ifft(self.two_pi_i_ky * mu_hat))
        fz = self.fft(Du * self.ifft(self.two_pi_i_kz * mu_hat))
        return self.ifft(
            self.two_pi_i_kx * fx + self.two_pi_i_ky * fy + self.two_pi_i_kz * fz
        ).real

    def rhs_fd(self, state, t):
        hx, hy, hz = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_3d(state, hx, hy, hz)
        Du = self.D(state)
        out = 0.0
        for axis, h in zip((-3, -2, -1), (hx, hy, hz)):
            F = st.avg_c2f(Du, axis) * st.grad_c2f(mu, h, axis)
            out = out + st.div_f2c(F, h, axis)
        return out


def _cos(theta):
    """cos of a contact angle: a tensor's on its device, a number's in f64."""
    return torch.cos(theta) if torch.is_tensor(theta) else math.cos(theta)


class _SmoothedBoundary:
    """Shared smoothed-boundary set-up: ψ from ``domain.geometry.smooth``
    (or given), the flux divergence ``div(ψ_face grad ·)``, ψ's face
    averages and ``|∇ψ|/ψ`` (built on first use)."""

    def _init_sbm(self, domain: Domain, psi=None, device=None):
        if psi is None:
            if domain.geometry is None:
                raise ValueError("no psi given and domain.geometry is None: pass a "
                                 "Domain with geometry=Shape(...) or psi")
            psi = domain.geometry.smooth
        if device is None:
            device = psi.device if torch.is_tensor(psi) else "cuda"
        self.device = resolve_device(device)
        self.psi = torch.as_tensor(psi, device=self.device)
        self.hx, self.hy = domain.dx

    def _sbm_div(self, state):
        """``div(ψ_face · grad state)`` (face fluxes, periodic)."""
        return (st.div_f2c(self.psi_avgx * st.grad_c2f(state, self.hx, -2), self.hx, -2)
                + st.div_f2c(self.psi_avgy * st.grad_c2f(state, self.hy, -1), self.hy, -1))

    @functools.cached_property
    def psi_avgx(self):
        return st.avg_c2f(self.psi, -2)

    @functools.cached_property
    def psi_avgy(self):
        return st.avg_c2f(self.psi, -1)

    @functools.cached_property
    def norm_grad_psi(self):
        return torch.sqrt(st.grad_c(self.psi, self.hx, -2) ** 2
                          + st.grad_c(self.psi, self.hy, -1) ** 2) / self.psi


class CahnHilliard2DSmoothedBoundary(BaseEquation, _SmoothedBoundary):
    """Cahn-Hilliard with the smoothed-boundary method (SBM) on irregular
    domains:

        ∂u/∂t = (1/ψ) ∇·(ψ D(u) ∇μ) + (|∇ψ|/ψ) J_n(t),
        μ = μ_h(u) − (κ/ψ) ∇·(ψ ∇u) − √κ·|∇ψ|/ψ·√(2f(u))·cos θ(t)·(2m − 1),

    with the contact mask ``m`` (by default the first ``contact_rows`` rows,
    the reference's hardcoded 50) and ``flux(t) = J_n``.  ψ is
    ``domain.geometry.smooth``, on its device.
    """

    def __init__(self, domain: Domain, kappa, f: Callable, mu: Callable,
                 D: Callable, theta: Callable, flux: Callable,
                 derivs: str = "fd", contact_rows: int = 50, contact_mask=None):
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.domain = domain
        self.kappa = kappa
        self.f = f
        self.mu = mu
        self.D = D
        self.theta = theta
        self.flux = flux
        self.derivs = derivs
        self._init_sbm(domain)
        self.sqrt_kappa = float(np.sqrt(kappa))
        if contact_mask is None:
            contact_mask = torch.zeros_like(self.psi)
            contact_mask[:contact_rows, :] = 1.0
        self.left_half = torch.as_tensor(contact_mask, device=self.device)
        self.rhs = self.rhs_fd

    def rhs_fd(self, state, t):
        cos_theta = _cos(self.theta(t))
        inner = (
            self.mu(state)
            - (self.kappa / self.psi) * self._sbm_div(state)
            - self.sqrt_kappa * self.norm_grad_psi * torch.sqrt(2.0 * self.f(state))
            * (cos_theta * self.left_half - cos_theta * (1.0 - self.left_half))
        )
        Du = self.D(state)
        Fx = self.psi_avgx * st.avg_c2f(Du, -2) * st.grad_c2f(inner, self.hx, -2)
        Fy = self.psi_avgy * st.avg_c2f(Du, -1) * st.grad_c2f(inner, self.hy, -1)
        return ((st.div_f2c(Fx, self.hx, -2) + st.div_f2c(Fy, self.hy, -1)) / self.psi
                + self.norm_grad_psi * self.flux(t))


# The JAX package's (and its reference's) name for the 2D periodic equation.
CahnHilliardSIFFT = CahnHilliard2DPeriodic
