"""FFT oracles of the fused semi-implicit CH and AC macros (PyTorch port
of the oracle half of :mod:`pde_opt_tpu.ops.fused_spectral`).

The packed complex-DFT Pallas kernels of that module (kernel K9) are not
ported; the cas kernels of :mod:`pde_opt_tpu_torch.ops.cas_spectral`
compute the same macros.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["ch_sif_macro_reference", "ac_sif_macro_reference"]


def _fd_lap_symbols(H: int, W: int, hx: float, hy: float):
    """FD Laplacian eigenvalues per axis (roll-stencil spectrum)."""
    lam_h = (2.0 * np.cos(2.0 * np.pi * np.arange(H) / H) - 2.0) / (hx * hx)
    lam_w = (2.0 * np.cos(2.0 * np.pi * np.arange(W) / W) - 2.0) / (hy * hy)
    return lam_h, lam_w


def ch_sif_macro_reference(mu_fn, hx, hy, A, dt, n_steps):
    """FFT reference of the fused kernel's exact semantics (the oracle).

    Per substep, per env with its own κ:
    ``u += dt * ifft(denom * (lam * fft(mu(u)) - κ lam² fft(u)))`` with the
    FD Laplacian symbol ``lam`` and ``denom = 1/(1 + A dt κ lam²)``,
    evaluated with :mod:`torch.fft` in the field's dtype.
    """

    def macro(u: torch.Tensor, kappa) -> torch.Tensor:
        H, W = u.shape[-2:]
        lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
        lam = torch.from_numpy(lam_h[:, None] + lam_w[None, :]).to(u.device, u.dtype)
        kap = torch.as_tensor(kappa, device=u.device)
        if kap.ndim <= 1:
            kap = torch.broadcast_to(kap, u.shape[:-2]).reshape(u.shape[:-2] + (1, 1))
        denom = 1.0 / (1.0 + A * dt * kap * lam**2)
        for _ in range(n_steps):
            m_hat = torch.fft.fftn(mu_fn(u), dim=(-2, -1))
            u_hat = torch.fft.fftn(u, dim=(-2, -1))
            incr = denom * (lam * m_hat - kap * lam**2 * u_hat)
            u = u + dt * torch.fft.ifftn(incr, dim=(-2, -1)).real.to(u.dtype)
        return u

    return macro


def ac_sif_macro_reference(mu_fn, R_fn, hx, hy, A, dt, n_steps, remat=False):
    """FFT oracle of the fused AC macro (the JAX package's
    ``ac_sif_macro_reference``).

    Per substep, per env with its own κ and ``denom = 1/(1 + A dt κ (-lam))``:
    ``lap = ifft(lam fft(u))``, ``g = -R(u) (mu(u) - κ lap)``,
    ``u += dt ifft(denom fft(g))``.  With ``remat=True`` each substep runs
    under :func:`torch.utils.checkpoint.checkpoint`, so reverse mode keeps
    only the field per substep: the backward of the fused AC macro.
    """

    def macro(u: torch.Tensor, kappa) -> torch.Tensor:
        H, W = u.shape[-2:]
        lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
        lam = torch.from_numpy(lam_h[:, None] + lam_w[None, :]).to(u.device, u.dtype)
        kap = torch.as_tensor(kappa, device=u.device)
        if kap.ndim <= 1:
            kap = torch.broadcast_to(kap, u.shape[:-2]).reshape(u.shape[:-2] + (1, 1))
        denom = 1.0 / (1.0 + A * dt * kap * (-lam))

        def body(uu):
            lap = torch.fft.ifftn(lam * torch.fft.fftn(uu, dim=(-2, -1)),
                                  dim=(-2, -1)).real.to(uu.dtype)
            g = -R_fn(uu) * (mu_fn(uu) - kap * lap)
            incr = denom * torch.fft.fftn(g, dim=(-2, -1))
            return uu + dt * torch.fft.ifftn(incr, dim=(-2, -1)).real.to(uu.dtype)

        for _ in range(n_steps):
            u = checkpoint(body, u, use_reentrant=False) if remat else body(u)
        return u

    return macro
