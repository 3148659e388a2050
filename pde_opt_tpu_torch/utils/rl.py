"""GPE / RL analysis utilities (PyTorch port of :mod:`pde_opt_tpu.utils.rl`).

Phase winding is the discrete curl of the link phase field
``arg(psi_ahead · conj(psi))`` (the principal-valued phase carried by each
lattice link).  :func:`vortex_winding` is the fixed-shape, batch-transparent
core (usable inside a fleet's reward); :func:`detect_vortices` wraps it in
the host-side dict of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["density", "vortex_winding", "detect_vortices"]


def density(psi: torch.Tensor) -> torch.Tensor:
    return psi.abs() ** 2


def _link_phase(psi: torch.Tensor, dim: int) -> torch.Tensor:
    """Principal-valued phase carried by each +1 lattice link along ``dim``:
    ``angle(z_ahead · conj(z))`` is the wrapped phase difference."""
    ahead = torch.roll(psi, -1, dim)
    return torch.angle(ahead * psi.conj())


def vortex_winding(psi: torch.Tensor, amp_thresh: float = 0.0, tol: float = 0.5) -> torch.Tensor:
    """Integer phase winding per plaquette (int32, fixed shapes).

    Batch axes lead; the two trailing axes are the periodic grid.  The
    plaquette circulation is ``d_x(link_y) − d_y(link_x)`` (forward
    differences); divided by 2π it is the winding number, rounded half to
    even as ``jnp.rint`` rounds.

    Args:
        psi: complex field, spatial axes trailing.
        amp_thresh: plaquettes whose mean corner density falls below this
            are zeroed (suppresses spurious windings in the vacuum tail).
        tol: |winding| below this (before rounding) is treated as noise.
    """
    lx = _link_phase(psi, -1)
    ly = _link_phase(psi, -2)
    circulation = (torch.roll(ly, -1, -1) - ly) - (torch.roll(lx, -1, -2) - lx)
    w = circulation / (2.0 * math.pi)
    winding = torch.where(w.abs() >= tol, torch.round(w).to(torch.int32), 0)
    if amp_thresh > 0.0:
        rho = density(psi)
        # Mean density over the plaquette's four corner sites.
        corner_sum = rho
        for dims in ((-1,), (-2,), (-1, -2)):
            corner_sum = corner_sum + torch.roll(rho, (-1,) * len(dims), dims)
        winding = torch.where(0.25 * corner_sum >= amp_thresh, winding, 0)
    return winding


def detect_vortices(psi: torch.Tensor, amp_thresh: float = 0.0, tol: float = 0.5):
    """Host-side vortex census with the JAX package's return dict."""
    winding = vortex_winding(psi, amp_thresh=amp_thresh, tol=tol).cpu().numpy()
    idx = np.argwhere(winding != 0)
    charges = winding[winding != 0]
    return {
        "num_vortices": idx.shape[0],
        "winding": winding,
        "total_topological_charge": int(charges.sum()),
        "positions": idx.astype(np.float32) + 0.5,
        "abs_charge_count": int(np.abs(charges).sum()),
        "charges": charges,
    }
