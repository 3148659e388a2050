"""Advection-diffusion equation (PyTorch port of
:mod:`pde_opt_tpu.models.advection_diffusion`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..grid import Domain
from ..ops import stencils as st
from ..ops.spectral import make_fft_pair, make_rfft_pair
from ..utils.device import resolve_device
from .base import BaseEquation
from .cahn_hilliard import _SmoothedBoundary, _wavenumbers

__all__ = ["AdvectionDiffusion2D"]


class AdvectionDiffusion2D(BaseEquation, _SmoothedBoundary):
    """2D periodic advection-diffusion: ∂u/∂t = −∇·(u·v) + D∇²u.

    Args:
        domain: spatial grid.
        velocity: ``velocity(t, X, Y) -> (vx, vy)``; ``X``, ``Y`` are the
            meshes on the equation's device.
        diffusion_coeff: scalar diffusivity D.
        smooth: the smoothed-boundary form with ψ = ``domain.geometry.smooth``
            (flux form ∇·(ψ u v)/ψ, ∇·(ψ∇u)/ψ).
        derivs: ``"fd"`` (conservative face fluxes, 2nd order) or
            ``"fourier"``.
        device: where the meshes and symbols live (default: ψ's device with
            ``smooth``, else CUDA).
    """

    fft = None
    ifft = None
    fourier_symbol = None

    def __init__(self, domain: Domain, velocity: Callable, diffusion_coeff,
                 smooth: bool = False, derivs: str = "fd", use_rfft: bool = True,
                 device: Optional[torch.device] = None):
        self.domain = domain
        self.velocity = velocity
        self.diffusion_coeff = diffusion_coeff
        self.smooth = smooth
        self.derivs = derivs
        self.use_rfft = use_rfft
        if smooth:
            self._init_sbm(domain, device=device)
        else:
            self.device = resolve_device("cuda" if device is None else device)
            self.hx, self.hy = domain.dx

        self.two_pi_i_kx, self.two_pi_i_ky, self.two_pi_i_k_2, _ = _wavenumbers(
            domain, use_rfft, self.device)
        if use_rfft:
            self.fft, self.ifft = make_rfft_pair(2, domain.points)
        else:
            self.fft, self.ifft = make_fft_pair(2)
        # Diffusion is the stiff part: symbol −D(2πik)² for semi-implicit use.
        self.fourier_symbol = -diffusion_coeff * self.two_pi_i_k_2
        self.xmesh, self.ymesh = (torch.from_numpy(m).to(self.device) for m in domain.mesh())

        if derivs == "fd":
            self.rhs = self.rhs_fd
        elif derivs == "fourier":
            if smooth:
                raise ValueError("smoothed-boundary requires derivs='fd'")
            self.rhs = self.rhs_fourier
        else:
            raise ValueError(f"Invalid derivative type: {derivs}")

    def _velocity_at(self, t):
        return self.velocity(t, self.xmesh, self.ymesh)

    def rhs_fd(self, state, t):
        vx, vy = self._velocity_at(t)
        vx = torch.broadcast_to(torch.as_tensor(vx, device=self.device), state.shape[-2:])
        vy = torch.broadcast_to(torch.as_tensor(vy, device=self.device), state.shape[-2:])
        # Advective flux at faces, centered (2nd order): avg(u) * avg(v).
        ux_f = st.avg_c2f(state, -2)
        uy_f = st.avg_c2f(state, -1)
        vx_f = st.avg_c2f(vx, -2)
        vy_f = st.avg_c2f(vy, -1)
        if self.smooth:
            Fx = self.psi_avgx * vx_f * ux_f
            Fy = self.psi_avgy * vy_f * uy_f
            adv = -(st.div_f2c(Fx, self.hx, -2) + st.div_f2c(Fy, self.hy, -1)) / self.psi
            return adv + self.diffusion_coeff * self._sbm_div(state) / self.psi
        adv = -(st.div_f2c(vx_f * ux_f, self.hx, -2) + st.div_f2c(vy_f * uy_f, self.hy, -1))
        return adv + self.diffusion_coeff * st.lap_2nd_2d(state, self.hx, self.hy)

    def rhs_fourier(self, state, t):
        vx, vy = self._velocity_at(t)
        out_hat = (
            -(self.two_pi_i_kx * self.fft(state * vx) + self.two_pi_i_ky * self.fft(state * vy))
            + self.diffusion_coeff * self.two_pi_i_k_2 * self.fft(state)
        )
        return self.ifft(out_hat).real
