"""Allen-Cahn equation family, Butler-Volmer electrochemistry included
(PyTorch port of :mod:`pde_opt_tpu.models.allen_cahn`).

    ∂u/∂t = −R(u)·μ,   μ = μ_h(u) − κ∇²u

Batch-transparent: stencils and FFTs act on the trailing two axes, and κ
or the C-rate may be a per-env tensor of shape ``(B, 1, 1)``.  The
constant-current closures reduce over the trailing axes with ``keepdim``,
so a batched state yields one overpotential per env.

The smoothed-boundary classes read their level set ψ from
``domain.geometry.smooth`` (a :class:`~pde_opt_tpu_torch.geometry.Shape`),
on that tensor's device; the Butler-Volmer one also takes ``psi``
explicitly.
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
from .cahn_hilliard import _SmoothedBoundary, _cos, _wavenumbers

__all__ = [
    "AllenCahn2DPeriodic",
    "AllenCahn2DSmoothedBoundary",
    "AllenCahn2DPeriodicButlerVolmer",
    "AllenCahn2DPeriodicButlerVolmerConstantCurrent",
    "AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent",
]


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
    (default: κ's device, else CUDA).
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
            device = kappa.device if torch.is_tensor(kappa) else "cuda"
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.R = R
        self.derivs = derivs
        self.device = resolve_device(device)
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


class AllenCahn2DSmoothedBoundary(BaseEquation, _SmoothedBoundary):
    """Allen-Cahn with the smoothed-boundary contact-angle term:
    ``∂u/∂t = −R(u)·μ``, ``μ = μ_h(u) − (κ/ψ) div(ψ_face grad u) −
    √κ·|∇ψ|/ψ·√(2f(u))·cos θ(t)·m``, with ``m`` the contact mask (by
    default the first ``contact_cols`` columns, the reference's hardcoded
    100).  ψ is ``domain.geometry.smooth``, on its device."""

    def __init__(self, domain: Domain, kappa, f: Callable, mu: Callable,
                 R: Callable, theta: Callable, derivs: str = "fd",
                 contact_cols: int = 100, contact_mask=None):
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.domain = domain
        self.kappa = kappa
        self.f = f
        self.mu = mu
        self.R = R
        self.theta = theta
        self.derivs = derivs
        self._init_sbm(domain)
        self.sqrt_kappa = float(np.sqrt(kappa))
        if contact_mask is None:
            contact_mask = torch.zeros_like(self.psi)
            contact_mask[:, :contact_cols] = 1.0
        self.left_half = torch.as_tensor(contact_mask, device=self.device)
        self.rhs = self.rhs_fd

    def rhs_fd(self, state, t):
        mu = (self.mu(state) - (self.kappa / self.psi) * self._sbm_div(state)
              - self.sqrt_kappa * self.norm_grad_psi * torch.sqrt(2.0 * self.f(state))
              * _cos(self.theta(t)) * self.left_half)
        return -self.R(state) * mu


def _bv_reaction(j0_val, eta, alpha):
    """Butler-Volmer kinetics: j0(u)·(e^{−αη} − e^{(1−α)η})."""
    return j0_val * (torch.exp(-alpha * eta) - torch.exp((1.0 - alpha) * eta))


def _closed_form_voltage(crate, int_plus, int_minus):
    """The α = 1/2 galvanostatic closure: ``v = 2 log y`` with ``y`` the
    positive root of ``I+ y² + C y − I− = 0``."""
    y = (-crate + torch.sqrt(crate**2 + 4.0 * int_plus * int_minus)) / (2.0 * int_plus)
    return 2.0 * torch.log(y)


class AllenCahn2DPeriodicButlerVolmer(BaseEquation):
    """Butler-Volmer reaction-driven Allen-Cahn at a fixed applied voltage
    ``v`` (a constructor parameter, as in the JAX package, so the equation
    keeps the ``rhs(state, t)`` contract)."""

    fft = None
    ifft = None

    def __init__(self, domain: Domain, kappa, mu: Callable, j0: Callable,
                 alpha: float, v=0.0, derivs: str = "fd"):
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.v = v
        self.derivs = derivs
        self.rhs = self.rhs_fd

    def rhs_fd(self, state, t):
        hx, hy = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_2d(state, hx, hy)
        return _bv_reaction(self.j0(state), mu + self.v, self.alpha)


class AllenCahn2DPeriodicButlerVolmerConstantCurrent(BaseEquation):
    """Butler-Volmer Allen-Cahn under a constant-current (galvanostatic)
    constraint.

    Per instance the cell voltage ``v`` is solved in closed form from the
    global current constraint (α = 1/2, ``y = e^{v/2}``):
    ``I = ∫ j0 e^{−μ/2} y − ∫ j0 e^{μ/2} / y``.  ``Crate`` may be a scalar or
    a per-env ``(B, 1, 1)`` tensor.  The JAX class also builds an FFT pair
    that its finite-difference ``rhs`` never uses; the port does not.
    """

    fft = None
    ifft = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused stepper pulls off instances.
    kappa = None
    mu = None
    j0 = None
    alpha = None
    Crate = None
    domain = None

    def __init__(self, domain: Domain, kappa, mu: Callable, j0: Callable,
                 alpha: float, Crate, derivs: str = "fd"):
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.Crate = Crate
        self.derivs = derivs
        self.rhs = self.rhs_fd

    def _mu_and_v(self, state):
        hx, hy = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_2d(state, hx, hy)
        j0v = self.j0(state)
        cell = hx * hy
        int_plus = (j0v * torch.exp(0.5 * mu)).sum((-2, -1), keepdim=True) * cell
        int_minus = (j0v * torch.exp(-0.5 * mu)).sum((-2, -1), keepdim=True) * cell
        return mu, _closed_form_voltage(self.Crate, int_plus, int_minus), j0v

    def rhs_fd(self, state, t):
        mu, v, j0v = self._mu_and_v(state)
        return _bv_reaction(j0v, mu + v, self.alpha)

    def get_voltage(self, state):
        """Cell voltage satisfying the constant-current constraint: a
        scalar for an unbatched state, per-env values otherwise."""
        _, v, _ = self._mu_and_v(state)
        return v.squeeze(-1).squeeze(-1)


class AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(BaseEquation, _SmoothedBoundary):
    """Galvanostatic Butler-Volmer Allen-Cahn on a smoothed-boundary (SBM)
    geometry: ψ-face-weighted flux divergence ``div(ψ_face·grad c)/ψ`` and
    ψ-weighted constraint integrals.  The contact-angle term is off, as in
    the reference.

    ``psi`` is the (H, W) level set, by default ``domain.geometry.smooth``.
    ``device`` places ψ (default: ψ's device if it is a tensor, else CUDA).
    The derived fields ``psi_avgx``, ``psi_avgy``, ``norm_grad_psi`` and
    ``left_half`` are built on first use, so an equation rebuilt every env
    step for the fused stepper (which reads only ``psi``) launches nothing
    for them.
    """

    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused SBM stepper pulls off instances.
    kappa = None
    mu = None
    j0 = None
    alpha = None
    Crate = None
    domain = None
    psi = None

    def __init__(self, domain: Domain, kappa, f: Callable, mu: Callable,
                 j0: Callable, alpha: float, Crate, derivs: str = "fd",
                 contact_cols: int = 100, psi=None,
                 device: Optional[torch.device] = None):
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.domain = domain
        self.kappa = kappa
        self.f = f
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.Crate = Crate
        self.derivs = derivs
        self.contact_cols = contact_cols
        self._init_sbm(domain, psi, device)
        self.sqrt_kappa = float(np.sqrt(kappa))
        self.rhs = self.rhs_fd

    @functools.cached_property
    def left_half(self):
        mask = torch.zeros_like(self.psi)
        mask[:, :self.contact_cols] = 1.0
        return mask

    def _mu_and_v(self, state):
        mu = self.mu(state) - (self.kappa / self.psi) * self._sbm_div(state)
        j0v = self.j0(state)
        cell = self.hx * self.hy
        int_plus = (j0v * torch.exp(0.5 * mu) * self.psi).sum((-2, -1), keepdim=True) * cell
        int_minus = (j0v * torch.exp(-0.5 * mu) * self.psi).sum((-2, -1), keepdim=True) * cell
        return mu, _closed_form_voltage(self.Crate, int_plus, int_minus), j0v

    def rhs_fd(self, state, t):
        mu, v, j0v = self._mu_and_v(state)
        return _bv_reaction(j0v, mu + v, self.alpha)

    def get_voltage(self, state):
        _, v, _ = self._mu_and_v(state)
        return v.squeeze(-1).squeeze(-1)
