"""Preset environment configurations (PyTorch port of the Cahn-Hilliard,
Allen-Cahn, Gross-Pitaevskii (plain and rotating-frame) and Butler-Volmer
presets of :mod:`pde_opt_tpu.envs.presets`).

Every preset builds its fleet on the card unless ``device`` names another
device; without CUDA, ``device="cpu"`` must be passed."""

from __future__ import annotations

import numpy as np
import torch

from .. import grid as gridmod
from ..geometry import Shape
from ..models.allen_cahn import (
    AllenCahn2DPeriodic,
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
)
from ..models.cahn_hilliard import CahnHilliard2DPeriodic
from ..models.gross_pitaevskii import GPE2DTSControl, GPE2DTSRot
from ..ops.bv_cas import LogRatioMu, SqrtJ0
from ..ops.cas_spectral import PolynomialMu
from ..ops.steppers import (
    RK4,
    DirectionalSplitting,
    FusedAllenCahnSpectral,
    FusedButlerVolmer,
    FusedSBMButlerVolmer,
    FusedRotatingSplitting,
    FusedSemiImplicitSpectral,
    FusedStrangControl,
    SemiImplicitDenseSolve,
    SemiImplicitFourierSpectral,
    StrangSplitting,
)
from ..utils.device import resolve_device
from ..utils.rl import vortex_winding
from .vector_env import VectorPDEEnv

__all__ = [
    "make_cahn_hilliard_control_env",
    "make_allen_cahn_control_env",
    "make_gpe_control_env",
    "make_gpe_rot_control_env",
    "make_butler_volmer_control_env",
    "make_sbm_butler_volmer_control_env",
    "CH_MU",
    "CH_D",
    "AC_MU",
    "AC_R",
    "BV_MU",
    "BV_J0",
]

# mu(c) = c**3 - c and unit mobility D(c) = 1, in the coefficient form the
# CUDA kernels read (the fused macro reads mu; the fused FD rhs of
# derivs="pallas" reads both).
CH_MU = PolynomialMu((0.0, -1.0, 0.0, 1.0))
CH_D = PolynomialMu((1.0,))
# The Allen-Cahn preset's mu(c) = c**3 - c and unit mobility R(c) = 1.
AC_MU = PolynomialMu((0.0, -1.0, 0.0, 1.0))
AC_R = PolynomialMu((1.0,))
# The Butler-Volmer presets' mu(c) = log(x/(1-x)) + 3(1-2c), x = clip(c,
# 1e-4, 1-1e-4), and j0(c) = sqrt(max(c(1-c), 1e-6)), in the form the CUDA
# kernels read.
BV_MU = LogRatioMu(omega=3.0, clip=1e-4)
BV_J0 = SqrtJ0(floor=1e-6)


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
    device="cuda",
) -> VectorPDEEnv:
    """64×64 Cahn-Hilliard control fleet: the agent drives κ (interface width).

    One RL step is ``substeps`` semi-implicit spectral substeps.  The
    observation is the uint8-scaled concentration field (average-pooled by
    ``obs_downsample``); the reward is the negative variance.
    ``spectral_solve="fused"`` runs the cas macro (on CUDA, the Hopper
    kernel) with the env epilogue fused in by default; ``"fft"`` runs
    :class:`SemiImplicitFourierSpectral`; ``"dense"`` / ``"dense_bf16"``
    run :class:`SemiImplicitDenseSolve` with the fixed symbol κ_max (2π|k|)⁴,
    κ_max = 0.01 (sqrt-factored and flat bf16 products).
    ``derivs="pallas"`` makes the equation's rhs the fused FD rhs (on CUDA,
    kernel K8): the ``"fft"`` stepper calls it once a substep, the fused
    stepper not at all.
    """
    if grid_size % obs_downsample:
        raise ValueError(
            f"obs_downsample={obs_downsample} must divide grid_size={grid_size}"
        )
    device = resolve_device(device)
    L = 0.01 * grid_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    kappa_max = 0.01
    if spectral_solve == "fused":
        # A = 1 gives deadbeat high-k damping of bf16 rounding noise.
        solver_type = FusedSemiImplicitSpectral
        solver_parameters = {"A": 1.0}
    elif spectral_solve == "fft":
        solver_type = SemiImplicitFourierSpectral
        solver_parameters = {"A": 0.5}
    elif spectral_solve in ("dense", "dense_bf16"):
        # Fixed-symbol semi-implicit step: the implicit damping uses
        # kappa_max (an upper bound of the control range), so the spectral
        # solve is one shared dense product for the whole fleet.
        kx, ky = domain.fft_mesh()
        symbol = kappa_max * ((2 * np.pi * kx) ** 2 + (2 * np.pi * ky) ** 2) ** 2
        solver_type = SemiImplicitDenseSolve
        solver_parameters = {
            "A": 0.5,
            "dense_symbol": symbol,
            "points": domain.points,
            "dtype": "bf16_sqrt" if spectral_solve == "dense" else "bf16",
        }
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
            "D": CH_D,
            "derivs": derivs,
            "device": device,
        },
        control_equation_parameter_name="kappa",
        solver_parameters=solver_parameters,
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=vectorized_control,
        fused_epilogue=ep_cfg,
        device=device,
    )


def make_allen_cahn_control_env(
    num_envs: int = 4096,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 1.0,
    step_dt: float = 0.01,
    dtype: torch.dtype = torch.float32,
    auto_reset: bool = True,
    vectorized_control: bool = True,
    spectral_solve: str = "fused",
    fused_epilogue: bool | None = None,
    device="cuda",
) -> VectorPDEEnv:
    """Allen-Cahn control fleet: the agent drives κ (interface energy).

    The CH flagship's control protocol on the nonconserved dynamics.
    ``spectral_solve="fused"`` runs the AC cas macro (on CUDA, kernel K4)
    with the env epilogue fused in by default; ``"fft"`` runs
    :class:`SemiImplicitFourierSpectral`.  Observation ``(y+1)·127.5`` as
    uint8; reward ``-var``.
    """
    device = resolve_device(device)
    L = 0.01 * grid_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    if spectral_solve == "fused":
        solver_type = FusedAllenCahnSpectral
    elif spectral_solve == "fft":
        solver_type = SemiImplicitFourierSpectral
    else:
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    # Fused env epilogue (as the CH flagship's): obs is the affine
    # (y+1)*127.5 uint8 map and the reward -var, both from the macro's
    # centered-moment stats (AC fields sit around 0).
    if fused_epilogue is None:
        fused_epilogue = spectral_solve == "fused" and vectorized_control
    ep_cfg = None
    if fused_epilogue:
        ep_cfg = {
            "obs_scale": 127.5,
            "obs_offset": 127.5,
            "obs_downsample": 1,
            "stats_center": 0.0,
            "reward_from_stats": lambda s1, s2, cnt, n: -(s2 / n - (s1 / n) ** 2),
            "obs_transform": lambda o: o[..., None, :, :],
        }

    def reset_func(domain, generator, n):
        return 0.1 * torch.randn((n, *domain.points), generator=generator,
                                 dtype=dtype, device=generator.device)

    return VectorPDEEnv(
        equation_type=AllenCahn2DPeriodic,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: torch.clamp(
            (y + 1.0) * 127.5, 0, 255).to(torch.uint8)[..., None, :, :],
        # AC coarsens to ±1 phases; the agent is rewarded for keeping the
        # variance down.
        reward_function=lambda y: -y.var(dim=(-2, -1), correction=0),
        reset_func=reset_func,
        reset_control_value=4e-4,
        update_control_value=lambda off, old: torch.clamp(
            old + 5e-5 * off[..., 0], 1e-4, 1e-3
        ),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={"mu": AC_MU, "R": AC_R, "device": device},
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 1.0},
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=vectorized_control,
        fused_epilogue=ep_cfg,
        device=device,
    )


def make_gpe_control_env(
    num_envs: int = 1024,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 2.0,
    step_dt: float = 0.02,
    dtype: torch.dtype = torch.float32,
    auto_reset: bool = True,
    k_interaction: float = 100.0,
    spot_width: float = 1.0,
    box_size: float = 16.0,
    spectral_solve: str = "fused",
    fused_epilogue: bool | None = None,
    device="cuda",
) -> VectorPDEEnv:
    """Gross-Pitaevskii control fleet: the agent drives an optical spot.

    The control value is each env's intensity of a Gaussian light spot at the
    trap center, entering the Hamiltonian through the ``lights`` potential.
    State is the real-stacked ``(B, H, W, 2)`` wavefunction; one RL step is
    ``substeps`` midpoint Strang substeps with per-substep L²
    renormalisation.  Reward: minus the condensate density inside the spot.
    ``spectral_solve="fused"`` runs the Strang cas macro (on CUDA, kernel
    K5) with the env epilogue fused in by default; ``"fft"`` runs
    ``StrangSplitting(fast_evolve=True)``.
    """
    device = resolve_device(device)
    L = box_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    X, Y = (torch.from_numpy(m).to(device) for m in domain.mesh())
    spot = torch.exp(-(X**2 + Y**2) / (spot_width**2))            # (H, W)
    psi0 = torch.exp(-(X**2 + Y**2) / 4.0)
    dx = float(domain.dx[0])

    def reset_func(domain_, generator, n):
        noise = 0.02 * torch.randn((n, *domain_.points), generator=generator,
                                   dtype=dtype, device=generator.device)
        psi = psi0 * (1.0 + noise)
        psi = psi / torch.sqrt((psi**2).sum((-2, -1), keepdim=True) * dx * dx)
        return torch.stack([psi, torch.zeros_like(psi)], dim=-1)

    def make_lights(intensity):
        # intensity (B,) -> lights(t, x, y) giving (B, 1, 1) * (H, W).
        def lights(t, x, y):
            return intensity[..., None, None] * spot

        return lights

    def density_in_spot(y):
        rho = y[..., 0] ** 2 + y[..., 1] ** 2
        return (rho * spot).sum((-2, -1)) * dx * dx

    if spectral_solve == "fused":
        solver_type = FusedStrangControl
        solver_parameters = {}
    elif spectral_solve == "fft":
        if fused_epilogue:
            raise ValueError("fused_epilogue=True requires spectral_solve='fused'")
        fused_epilogue = False
        # Midpoint Strang: 2 FFT pairs per substep instead of 4.
        solver_type = StrangSplitting
        solver_parameters = {"time_scale": 1.0, "fast_evolve": True}
    else:
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    # Fused env epilogue: density obs and the spot-weighted reward from the
    # macro itself.  n_px is the grid's pixel count: the env's default reads
    # the last two axes, (W, 2) for this state.
    if fused_epilogue is None:
        fused_epilogue = spectral_solve == "fused"
    ep_cfg = None
    if fused_epilogue:
        cell = dx * dx
        ep_cfg = {
            "obs_scale": 2550.0,
            "weight": spot,
            "n_px": grid_size * grid_size,
            # s1 = sum(spot * rho): reward = -density_in_spot
            "reward_from_stats": lambda s1, s2, cnt, n: -(s1 * cell),
            "obs_transform": lambda o: o[..., None, :, :],
        }
    return VectorPDEEnv(
        equation_type=GPE2DTSControl,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: torch.clamp(
            (y[..., 0] ** 2 + y[..., 1] ** 2) * 2550.0, 0, 255
        ).to(torch.uint8)[..., None, :, :],
        reward_function=lambda y: -density_in_spot(y),
        reset_func=reset_func,
        reset_control_value=0.0,
        update_control_value=lambda off, old: torch.clamp(
            old + 2.0 * off[..., 0], 0.0, 50.0
        ),
        update_control_parameter=lambda old, new: make_lights(new),
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "k": k_interaction,
            "e": 0.0,
            "trap_factor": 1.0,
            "kinetic": True,
            "device": device,
        },
        control_equation_parameter_name="lights",
        solver_parameters=solver_parameters,
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
        fused_epilogue=ep_cfg,
        device=device,
    )


def make_gpe_rot_control_env(
    num_envs: int = 512,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 1.0,
    step_dt: float = 0.01,
    dtype: torch.dtype = torch.float32,
    auto_reset: bool = True,
    k_interaction: float = 500.0,
    omega: float = 0.8,
    box_size: float = 20.0,
    stir_radius: float = 2.5,
    stir_width: float = 1.0,
    amp_max: float = 10.0,
    action_gain: float = 1.0,
    vortex_weight: float = 1.0,
    lz_weight: float = 10.0,
    spectral_solve: str = "fused",
    device="cuda",
) -> VectorPDEEnv:
    """Rotating-frame GPE stirring fleet: the agent nucleates vortices.

    The control is each env's intensity of an off-center Gaussian stirring
    beam (a static spot in the rotating frame is a co-rotating stirrer),
    entering the Hamiltonian through the ``lights`` potential.  The state is
    the complex ``(B, H, W)`` wavefunction.  Reward: ``vortex_weight`` times
    the amplitude-gated plaquette vortex census
    (:func:`pde_opt_tpu_torch.utils.rl.vortex_winding`, each env scaled by
    its own peak density) plus ``lz_weight``·⟨L_z⟩.  One RL step is
    ``substeps`` ADI substeps with L² renormalisation.
    ``spectral_solve="fused"`` runs
    :class:`~pde_opt_tpu_torch.ops.steppers.FusedRotatingSplitting` (batched
    matrix products); ``"fft"`` runs
    :class:`~pde_opt_tpu_torch.ops.steppers.DirectionalSplitting`.
    """
    device = resolve_device(device)
    if spectral_solve == "fused":
        solver_type = FusedRotatingSplitting
    elif spectral_solve == "fft":
        solver_type = DirectionalSplitting
    else:
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    L = box_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    X, Y = (torch.from_numpy(m).to(device) for m in domain.mesh())
    spot = torch.exp(-((X - stir_radius) ** 2 + Y**2) / (stir_width**2))   # (H, W)
    psi0 = torch.exp(-(X**2 + Y**2) / 16.0)
    dx = float(domain.dx[0])
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128

    def reset_func(domain_, generator, n):
        noise = 0.05 * torch.randn((n, *domain_.points), generator=generator,
                                   dtype=dtype, device=generator.device)
        psi = (psi0 * (1.0 + noise)).to(cdtype)
        norm = torch.sqrt((psi.real**2 + psi.imag**2).sum((-2, -1), keepdim=True) * dx * dx)
        return psi / norm

    def make_lights(amp):
        # amp (B,) -> lights(t, x, y) giving (B, 1, 1) * (H, W).
        def lights(t, x, y):
            return amp[..., None, None] * spot

        return lights

    def reward_fn(psi):
        # Per env: the gated vortex census at the env's own peak density,
        # plus the angular momentum.
        rho = psi.real**2 + psi.imag**2
        scale = torch.rsqrt(rho.amax((-2, -1), keepdim=True) + 1e-12)
        w = vortex_winding(psi * scale, amp_thresh=0.05)
        n_vortices = w.abs().sum((-2, -1)).to(dtype)
        dpsi_dx = (torch.roll(psi, -1, -2) - torch.roll(psi, 1, -2)) / (2 * dx)
        dpsi_dy = (torch.roll(psi, -1, -1) - torch.roll(psi, 1, -1)) / (2 * dx)
        lz = (psi.conj() * (X * dpsi_dy - Y * dpsi_dx)).imag.sum((-2, -1)) * dx * dx
        return vortex_weight * n_vortices + lz_weight * lz.to(dtype)

    return VectorPDEEnv(
        equation_type=GPE2DTSRot,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: torch.clamp(
            (y.real**2 + y.imag**2) * 2550.0, 0, 255
        ).to(torch.uint8)[..., None, :, :],
        reward_function=reward_fn,
        reset_func=reset_func,
        reset_control_value=0.0,
        update_control_value=lambda off, old: torch.clamp(
            old + action_gain * off[..., 0], 0.0, amp_max
        ),
        update_control_parameter=lambda old, new: make_lights(new),
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "k": k_interaction,
            "e": 0.0,
            "omega": omega,
            "device": device,
        },
        control_equation_parameter_name="lights",
        solver_parameters={"time_scale": 1.0, "normalize": True},
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
        device=device,
    )


def _bv_solver(method: str, fused):
    if method == "fused":
        return fused
    if method == "rk4":
        return RK4
    raise ValueError(f"unknown method: {method!r}")


def _bv_reset_func(dtype):
    """Each env a lightly filled particle: clip(0.05 + 0.005 N(0, 1), 0.01, 0.99)."""

    def reset_func(domain_, generator, n):
        noise = torch.randn((n, *domain_.points), generator=generator, dtype=dtype,
                            device=generator.device)
        return torch.clamp(0.05 + 0.005 * noise, 0.01, 0.99)

    return reset_func


def _bv_control():
    """The BV presets' C-rate control: reset to 1, nudged by 0.2 per unit
    action within [0.2, 3], entering the equation as ``(B, 1, 1)``."""
    return dict(
        reset_control_value=1.0,
        update_control_value=lambda off, old: torch.clamp(old + 0.2 * off[..., 0], 0.2, 3.0),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={"type": "continuous", "shape": (1,)},
        control_equation_parameter_name="Crate",
        solver_parameters={},
    )


def make_butler_volmer_control_env(
    num_envs: int = 1024,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 0.2,
    step_dt: float = 5e-3,
    dtype: torch.dtype = torch.float32,
    auto_reset: bool = True,
    kappa: float = 5e-4,
    method: str = "fused",
    obs_downsample: int = 1,
    fused_epilogue: bool | None = None,
    device="cuda",
) -> VectorPDEEnv:
    """Galvanostatic Butler-Volmer charging fleet: the agent drives the C-rate.

    Each env is a phase-separating electrode particle lithiating under the
    constant-current closure (per-env integrals stay per env); the action
    nudges the applied C-rate.  Reward: filling progress minus ten times the
    variance (charge fast, stay uniform).  One RL step is ``substeps`` RK4
    substeps.  ``method="fused"`` runs the fused macro (on CUDA, kernel K6)
    with the env epilogue fused in by default; ``"rk4"`` steps
    :class:`~pde_opt_tpu_torch.ops.steppers.RK4` through the equation.
    The observation is the full field: ``obs_downsample`` takes 1 only, as
    the fused BV epilogue does.
    """
    if obs_downsample != 1:
        raise ValueError(
            f"obs_downsample={obs_downsample}: the fused BV epilogue emits the full-size "
            "observation only (obs_downsample=1)"
        )
    device = resolve_device(device)
    solver_type = _bv_solver(method, FusedButlerVolmer)
    domain = gridmod.Domain((grid_size, grid_size), ((-0.5, 0.5), (-0.5, 0.5)),
                            "dimensionless", dtype=dtype)
    # Fused env epilogue: obs clip(y*255) and the charging reward
    # mean - 10*var, both from the kernel's centered-moment stats.
    if fused_epilogue is None:
        fused_epilogue = method == "fused"
    ep_cfg = None
    if fused_epilogue:
        ep_cfg = {
            "obs_scale": 255.0,
            "obs_offset": 0.0,
            "stats_center": 0.5,
            "reward_from_stats": lambda s1, s2, cnt, n: (
                (s1 / n + 0.5) - 10.0 * (s2 / n - (s1 / n) ** 2)
            ),
            "obs_transform": lambda o: o[..., None, :, :],
        }
    return VectorPDEEnv(
        equation_type=AllenCahn2DPeriodicButlerVolmerConstantCurrent,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: torch.clamp(
            y * 255.0, 0, 255).to(torch.uint8)[..., None, :, :],
        reward_function=lambda y: (y.mean(dim=(-2, -1))
                                   - 10.0 * y.var(dim=(-2, -1), correction=0)),
        reset_func=_bv_reset_func(dtype),
        static_equation_parameters={"kappa": kappa, "mu": BV_MU, "j0": BV_J0, "alpha": 0.5},
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
        fused_epilogue=ep_cfg,
        device=device,
        **_bv_control(),
    )


def sbm_disk_psi(domain: gridmod.Domain, particle_radius: float = 0.35,
                 interface_width: float = 0.04) -> np.ndarray:
    """The SBM preset's analytic level set of a disk particle, in numpy in
    the domain's dtype: ``0.5 (1 + tanh((R - r)/w))``, raised to 0.001
    outside and set to 1 above 0.99."""
    X, Y = domain.mesh()
    r = np.sqrt(X**2 + Y**2)
    psi = 0.5 * (1.0 + np.tanh((particle_radius - r) / interface_width))
    psi = np.where(psi < 0.001, 0.001, psi)
    return np.where(psi > 0.99, 1.0, psi).astype(X.dtype)


def make_sbm_butler_volmer_control_env(
    num_envs: int = 1024,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 0.2,
    step_dt: float = 5e-3,
    dtype: torch.dtype = torch.float32,
    auto_reset: bool = True,
    kappa: float = 5e-4,
    particle_radius: float = 0.35,
    interface_width: float = 0.04,
    smooth_geometry: bool = False,
    method: str = "fused",
    fused_epilogue: bool | None = None,
    device="cuda",
) -> VectorPDEEnv:
    """Smoothed-boundary galvanostatic charging fleet (a disk particle).

    Each env is a disk-shaped electrode particle embedded in the periodic
    box by the level set ψ: the SBM chemical potential uses ψ-weighted
    fluxes and the closure integrates over ψ, so the charge balance holds
    on the particle.  The agent drives the C-rate; reward: ψ-weighted
    filling progress minus ten times the ψ-weighted variance.  One RL step
    is ``substeps`` RK4 substeps.  ``method="fused"`` runs the fused macro
    (on CUDA, kernel K7) with the ψ-weighted epilogue fused in by default;
    ``"rk4"`` steps :class:`~pde_opt_tpu_torch.ops.steppers.RK4`.
    ψ is the analytic tanh profile (:func:`sbm_disk_psi`), or with
    ``smooth_geometry=True`` the ``Shape`` smoothing flow run on the binary
    disk mask (the reference pipeline: adaptive Tsit5 at construction, one
    host sync a step, in ``torch.get_default_dtype()``); the fleet keeps
    that :class:`~pde_opt_tpu_torch.geometry.Shape` as ``env.shape``.
    """
    device = resolve_device(device)
    solver_type = _bv_solver(method, FusedSBMButlerVolmer)
    domain = gridmod.Domain((grid_size, grid_size), ((-0.5, 0.5), (-0.5, 0.5)),
                            "dimensionless", dtype=dtype)
    shape = None
    if smooth_geometry:
        X, Y = domain.mesh()
        shape = Shape((np.sqrt(X**2 + Y**2) < particle_radius).astype(X.dtype), dx=domain.dx,
                      smooth_epsilon=4.0 * float(domain.dx[0]), device=device)
        psi = shape.smooth.to(dtype)
        psi_sum = float(psi.sum())
    else:
        psi_np = sbm_disk_psi(domain, particle_radius, interface_width)
        psi = torch.from_numpy(psi_np).to(device)
        psi_sum = float(psi_np.sum())

    def psi_mean(y):
        return (psi * y).sum((-2, -1)) / psi_sum

    def psi_var(y):
        m = psi_mean(y)[..., None, None]
        return (psi * (y - m) ** 2).sum((-2, -1)) / psi_sum

    # Fused env epilogue: the kernel's stats are psi*cell-weighted centered
    # moments; dividing by sum(psi*cell) gives the psi-mean/var reward.  The
    # obs is the psi-masked uint8 concentration.
    if fused_epilogue is None:
        fused_epilogue = method == "fused"
    ep_cfg = None
    if fused_epilogue:
        wsum = psi_sum * float(domain.dx[0]) * float(domain.dx[1])

        def _sbm_reward(s1, s2, cnt, n):
            m = s1 / wsum + 0.5
            var = s2 / wsum - (s1 / wsum) ** 2
            return m - 10.0 * var

        ep_cfg = {
            "obs_scale": 255.0,
            "stats_center": 0.5,
            "reward_from_stats": _sbm_reward,
            "obs_transform": lambda o: o[..., None, :, :],
        }
    env = VectorPDEEnv(
        equation_type=AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        # Observe the particle only: psi-masked concentration.
        state_to_observation_func=lambda y: torch.clamp(
            y * psi * 255.0, 0, 255).to(torch.uint8)[..., None, :, :],
        reward_function=lambda y: psi_mean(y) - 10.0 * psi_var(y),
        reset_func=_bv_reset_func(dtype),
        static_equation_parameters={
            "kappa": kappa,
            "f": lambda c: 3.0 * c * (1.0 - c),
            "mu": BV_MU,
            "j0": BV_J0,
            "alpha": 0.5,
            "psi": psi,
        },
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
        fused_epilogue=ep_cfg,
        device=device,
        **_bv_control(),
    )
    env.shape = shape
    return env
