"""Preset environment configurations (PyTorch port of the Cahn-Hilliard
preset of :mod:`pde_opt_tpu.envs.presets`)."""

from __future__ import annotations

import torch

from .. import grid as gridmod
from ..models.cahn_hilliard import CahnHilliard2DPeriodic
from ..ops.cas_spectral import PolynomialMu
from ..ops.steppers import FusedSemiImplicitSpectral, SemiImplicitFourierSpectral
from .vector_env import VectorPDEEnv

__all__ = ["make_cahn_hilliard_control_env", "CH_MU"]

# mu(c) = c**3 - c, in the coefficient form the CUDA macro reads.
CH_MU = PolynomialMu((0.0, -1.0, 0.0, 1.0))


def make_cahn_hilliard_control_env(
    num_envs: int = 4096,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 1.0,
    step_dt: float = 0.01,
    dtype: torch.dtype = torch.float32,
    auto_reset: bool = True,
    derivs: str = "fd",
    vectorized_control: bool = True,
    spectral_solve: str = "fft",
    obs_downsample: int = 1,
    fused_epilogue: bool | None = None,
    device="cpu",
) -> VectorPDEEnv:
    """64×64 Cahn-Hilliard control fleet: the agent drives κ (interface width).

    One RL step is ``substeps`` semi-implicit spectral substeps.  The
    observation is the uint8-scaled concentration field (average-pooled by
    ``obs_downsample``); the reward is the negative variance.
    ``spectral_solve="fused"`` runs the cas macro (on CUDA, the Hopper
    kernel) with the env epilogue fused in by default; ``"fft"`` runs
    :class:`SemiImplicitFourierSpectral`.  ``"dense"`` is not ported yet.
    """
    if grid_size % obs_downsample:
        raise ValueError(
            f"obs_downsample={obs_downsample} must divide grid_size={grid_size}"
        )
    device = torch.device(device)
    L = 0.01 * grid_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    if spectral_solve == "fused":
        # A = 1 gives deadbeat high-k damping of bf16 rounding noise.
        solver_type = FusedSemiImplicitSpectral
        solver_parameters = {"A": 1.0}
    elif spectral_solve == "fft":
        solver_type = SemiImplicitFourierSpectral
        solver_parameters = {"A": 0.5}
    elif spectral_solve in ("dense", "dense_bf16"):
        raise NotImplementedError(
            "spectral_solve='dense' (SemiImplicitDenseSolve) is not ported "
            "yet; see ROADMAP.md"
        )
    else:
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    ds = int(obs_downsample)

    def observe(y):
        if ds > 1:
            *b, h, w = y.shape
            y = y.reshape(*b, h // ds, ds, w // ds, ds).mean(dim=(-3, -1))
        return torch.clamp(y * 255.0, 0, 255).to(torch.uint8)[..., None, :, :]

    # Fused env epilogue (default ON for the fused solver): reward (-var),
    # the divergence flag and the uint8 obs come out of the macro itself.
    # reward_from_stats MUST stay equal to reward_function and the kernel
    # obs to ``observe``: reset() and auto-reset still use those.
    if fused_epilogue is None:
        fused_epilogue = spectral_solve == "fused" and vectorized_control
    ep_cfg = None
    if fused_epilogue:
        ep_cfg = {
            "obs_scale": 255.0,
            "obs_offset": 0.0,
            "obs_downsample": ds,
            # Centered moments around the 0.5 operating point: the same
            # -var formula, but cancellation-free.
            "stats_center": 0.5,
            "reward_from_stats": lambda s1, s2, cnt, n: -(s2 / n - (s1 / n) ** 2),
            "obs_transform": lambda o: o[..., None, :, :],
        }

    def reset_func(domain, generator, n):
        noise = torch.randn((n, *domain.points), generator=generator,
                            dtype=dtype, device=generator.device)
        return torch.clamp(0.5 + 0.01 * noise, 0.0, 1.0)

    return VectorPDEEnv(
        equation_type=CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=observe,
        reward_function=lambda y: -y.var(dim=(-2, -1), correction=0),
        reset_func=reset_func,
        # κ range inside the stable region of the SIF stepper at
        # numeric_dt = step_dt/substeps (κ below ~2e-3 at dt=1e-3 on a
        # dx=0.01 grid blows up).
        reset_control_value=0.004,
        update_control_value=lambda off, old: torch.clamp(
            old + 0.0005 * off[..., 0], 0.002, 0.01
        ),
        # Per-env κ as (B, 1, 1), broadcasting against (B, H, W) fields.
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "mu": CH_MU,
            "D": lambda c: torch.ones_like(c),
            "derivs": derivs,
        },
        control_equation_parameter_name="kappa",
        solver_parameters=solver_parameters,
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=vectorized_control,
        fused_epilogue=ep_cfg,
        device=device,
    )
