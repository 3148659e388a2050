"""Time steppers (PyTorch port of the CH subset of :mod:`pde_opt_tpu.ops.steppers`).

Each stepper exposes ``step(rhs, y, t, dt) -> (y1, y_err)``; the fused
stepper also overrides the whole substep loop with ``evolve`` (the hook
:func:`pde_opt_tpu_torch.ops.integrate.evolve` looks for) and
``evolve_with_epilogue`` (the env's fused-epilogue hook).  Steppers declare
``required_equation_attrs``, which
:func:`pde_opt_tpu_torch.utils.compat.prepare_solver_params` fills from an
equation.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .cas_spectral import make_ch_cas_fused_macro

__all__ = [
    "AbstractStepper",
    "SemiImplicitFourierSpectral",
    "FusedSemiImplicitSpectral",
]


def _normalize_per_env_control(ctrl, batch_shape, name: str = "control",
                               device=None) -> torch.Tensor:
    """Canonicalize a per-env scalar control to ``batch_shape``.

    Accepts a scalar, ``batch_shape`` itself, or ``batch_shape`` plus
    trailing singleton axes (``(B, 1)``, ``(B, 1, 1)``); a trailing
    non-singleton axis is an error rather than a silent mis-broadcast.
    """
    ctrl = torch.as_tensor(ctrl, device=device)
    while ctrl.ndim > len(batch_shape):
        if ctrl.shape[-1] != 1:
            raise ValueError(
                f"{name} shape {tuple(ctrl.shape)} does not broadcast to the "
                f"env batch {tuple(batch_shape)}: expected scalar, "
                f"{tuple(batch_shape)}, or {tuple(batch_shape)} plus "
                "trailing singleton axes"
            )
        ctrl = ctrl[..., 0]
    return torch.broadcast_to(ctrl, tuple(batch_shape))


class AbstractStepper:
    """Base class: one explicit/implicit time step with optional error estimate."""

    required_equation_attrs: Tuple[str, ...] = ()
    order: int = 1

    def step(self, rhs: Callable, y, t, dt) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        raise NotImplementedError


class SemiImplicitFourierSpectral(AbstractStepper):
    """Semi-implicit Fourier-spectral step for stiff phase-field equations:

        ``y1 = y0 + dt * Re ifft( fft(rhs(y0,t)) / (1 + A*dt*symbol) )``

    with the error estimate against an explicit Euler step.  ``fft``/``ifft``
    transform the trailing spatial axes, so one call steps a whole fleet.
    """

    required_equation_attrs = ("fourier_symbol", "fft", "ifft")
    order = 1

    def __init__(self, A: float, fourier_symbol, fft, ifft):
        self.A = A
        self.fourier_symbol = fourier_symbol
        self.fft = fft
        self.ifft = ifft

    def step(self, rhs, y, t, dt):
        f0 = rhs(y, t)
        denom = 1.0 + self.A * dt * self.fourier_symbol
        y1 = y + dt * self.ifft(self.fft(f0) / denom).real
        euler_y1 = y + dt * f0
        return y1, y1 - euler_y1


class FusedSemiImplicitSpectral(AbstractStepper):
    """Whole-macro-step fused SIF stepper (the flagship fast path).

    Runs all substeps of an ``evolve`` call in one cas macro
    (:func:`pde_opt_tpu_torch.ops.cas_spectral.make_ch_cas_fused_macro`):
    on CUDA tensors one launch of the Hopper kernel, with each env's own κ
    in the implicit denominator.  The equation must be Cahn-Hilliard-like
    with elementwise ``mu`` and unit mobility (``D == 1``); ``rhs`` is
    ignored.  On CUDA, ``mu`` must be a
    :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`.

    The JAX stepper's ``block_envs``/``interpret`` (TPU tiling) have no
    counterpart, and its ``algo="dft"`` kernel (K9) is not ported.
    """

    required_equation_attrs = ("kappa", "mu", "D", "domain")
    order = 1

    def __init__(self, kappa, mu, D, domain, A: float = 1.0,
                 mats_dtype: Optional[torch.dtype] = None):
        self.kappa = kappa
        self.mu = mu
        self.domain = domain
        self.A = float(A)
        self.mats_dtype = torch.bfloat16 if mats_dtype is None else mats_dtype
        probe = torch.as_tensor(D(torch.linspace(0.1, 0.9, 4, dtype=torch.float64)))
        if not torch.allclose(probe.detach().cpu().double(), torch.ones(4, dtype=torch.float64)):
            raise ValueError(
                "FusedSemiImplicitSpectral requires unit mobility "
                "(D == 1); use SemiImplicitFourierSpectral otherwise."
            )

    def _macro(self, dt, n_steps, epilogue=None):
        H, W = self.domain.points
        hx, hy = self.domain.dx
        return make_ch_cas_fused_macro(
            self.mu, H, W, float(hx), float(hy), self.A, float(dt),
            int(n_steps), mats_dtype=self.mats_dtype, epilogue=epilogue,
        )

    def evolve(self, rhs, y0, t0, dt, n_steps):
        """Advance ``n_steps`` substeps in one macro (ignores ``rhs`` — the
        physics enters through ``mu``/``kappa``)."""
        del rhs, t0
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-2], "kappa",
                                           device=y0.device)
        return self._macro(dt, n_steps)(y0, kappa)

    def evolve_with_epilogue(self, rhs, y0, t0, dt, n_steps, ep_cfg):
        """Advance ``n_steps`` substeps AND emit the env epilogue from the
        same macro: ``(y1, stats, obs)`` per
        :func:`pde_opt_tpu_torch.ops.cas_spectral.make_ch_cas_fused_macro_ep`.
        ``ep_cfg`` keys: ``obs_scale``, ``obs_offset``, ``obs_downsample``,
        ``stats_center``."""
        del rhs, t0
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-2], "kappa",
                                           device=y0.device)
        epilogue = {
            "obs_scale": float(ep_cfg.get("obs_scale", 255.0)),
            "obs_offset": float(ep_cfg.get("obs_offset", 0.0)),
            "obs_downsample": int(ep_cfg.get("obs_downsample", 1)),
            "stats_center": float(ep_cfg.get("stats_center", 0.0)),
        }
        return self._macro(dt, n_steps, epilogue)(y0, kappa)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None
