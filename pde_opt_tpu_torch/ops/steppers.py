"""Time steppers (PyTorch port of the explicit (Tsit5 included), CH (2D
and 3D, unit and general mobility), AC, Butler-Volmer, GPE and
rotating-frame GPE subset of :mod:`pde_opt_tpu.ops.steppers`).

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

from .bv_cas import make_bv_cc_fused_macro
from .cas3d import make_ch3d_cas_macro
from .cas_mobility import make_ch3d_mobility_cas_macro, make_ch_mobility_cas_macro
from .cas_spectral import make_ac_cas_fused_macro, make_ch_cas_fused_macro
from .fused_spectral import make_ac_sif_fused_macro, make_ch_sif_fused_macro
from .gpe_cas import make_gpe_strang_cas_macro
from .gpe_rot_fast import make_rot_adi_macro
from .sbm_bv import make_sbm_bv_fused_macro

__all__ = [
    "AbstractStepper",
    "Euler",
    "Heun",
    "RK4",
    "Tsit5",
    "SemiImplicitFourierSpectral",
    "FusedSemiImplicitSpectral",
    "FusedSemiImplicitSpectral3D",
    "FusedMobilitySpectral",
    "FusedAllenCahnSpectral",
    "StrangSplitting",
    "FusedStrangControl",
    "FusedButlerVolmer",
    "FusedSBMButlerVolmer",
    "DirectionalSplitting",
    "FusedRotatingSplitting",
]


def _normalize_per_env_control(ctrl, batch_shape, name: str = "control",
                               device=None) -> torch.Tensor:
    """Canonicalize a per-env scalar control to ``batch_shape``.

    Accepts a scalar, ``batch_shape`` itself, or ``batch_shape`` plus
    trailing singleton axes (``(B, 1)``, ``(B, 1, 1)``); a trailing
    non-singleton axis is an error rather than a silent mis-broadcast.  A
    python float is filled in on ``device`` (no copy from the host).
    """
    if isinstance(ctrl, float):
        return torch.full(tuple(batch_shape), float(ctrl), device=device)
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


class Euler(AbstractStepper):
    """Explicit (forward) Euler, 1st order."""

    order = 1

    def step(self, rhs, y, t, dt):
        return y + dt * rhs(y, t), None


class Heun(AbstractStepper):
    """Heun's method (explicit trapezoidal), 2nd order with embedded Euler error."""

    order = 2

    def step(self, rhs, y, t, dt):
        k1 = rhs(y, t)
        y_euler = y + dt * k1
        k2 = rhs(y_euler, t + dt)
        y1 = y + 0.5 * dt * (k1 + k2)
        return y1, y1 - y_euler


class RK4(AbstractStepper):
    """Classic 4th-order Runge-Kutta (no error estimate)."""

    order = 4

    def step(self, rhs, y, t, dt):
        k1 = rhs(y, t)
        k2 = rhs(y + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = rhs(y + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = rhs(y + dt * k3, t + dt)
        return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None


# Tsitouras 5(4) coefficients (Tsitouras, Comput. Math. Appl. 62 (2011)),
# the tables of the JAX package's Tsit5.
_TSIT5_C = (0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TSIT5_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081, 2.324710524099774),
)
# 5th-order weights are the last A row (FSAL); error weights b - bhat:
_TSIT5_BTILDE = (
    -0.00178001105222577714,
    -0.0008164344596567469,
    0.007880878010261995,
    -0.1447110071732629,
    0.5823571654525552,
    -0.45808210592918697,
    0.015151515151515152,
)


class Tsit5(AbstractStepper):
    """Tsitouras 5(4) explicit Runge-Kutta with embedded 4th-order error."""

    order = 5

    def step(self, rhs, y, t, dt):
        k = [rhs(y, t)]
        for ci, ai in zip(_TSIT5_C, _TSIT5_A):
            yi = y
            for aij, kj in zip(ai, k):
                yi = yi + dt * aij * kj
            k.append(rhs(yi, t + ci * dt))
        y1 = y
        for aij, kj in zip(_TSIT5_A[-1], k):
            y1 = y1 + dt * aij * kj
        y_err = dt * _TSIT5_BTILDE[0] * k[0]
        for bt, kj in zip(_TSIT5_BTILDE[1:], k[1:]):
            y_err = y_err + dt * bt * kj
        return y1, y_err


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


def _check_algo(algo: str) -> str:
    if algo not in ("cas", "dft"):
        raise ValueError(f"algo must be 'cas' or 'dft', got {algo!r}")
    return algo


def _check_epilogue_algo(algo: str) -> None:
    if algo != "cas":
        raise NotImplementedError("fused env epilogue requires algo='cas'")


class FusedSemiImplicitSpectral(AbstractStepper):
    """Whole-macro-step fused SIF stepper (the flagship fast path).

    Runs all substeps of an ``evolve`` call in one macro, on CUDA tensors
    one launch of a Hopper kernel, with each env's own κ in the implicit
    denominator: ``algo="cas"`` (the default) the cas macro
    (:func:`pde_opt_tpu_torch.ops.cas_spectral.make_ch_cas_fused_macro`,
    K2), ``algo="dft"`` the packed-DFT macro
    (:func:`pde_opt_tpu_torch.ops.fused_spectral.make_ch_sif_fused_macro`,
    K9a).  The equation must be Cahn-Hilliard-like with elementwise ``mu``
    and unit mobility (``D == 1``); ``rhs`` is ignored.  On CUDA, ``mu``
    must be a :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`.
    The env epilogue (``evolve_with_epilogue``, K1) needs ``algo="cas"``,
    as in the JAX package.

    The JAX stepper's ``block_envs``/``interpret`` (TPU tiling) have no
    counterpart.
    """

    required_equation_attrs = ("kappa", "mu", "D", "domain")
    order = 1

    def __init__(self, kappa, mu, D, domain, A: float = 1.0,
                 mats_dtype: Optional[torch.dtype] = None, algo: str = "cas"):
        self.algo = _check_algo(algo)
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
        args = (self.mu, H, W, *(float(h) for h in self.domain.dx), self.A, float(dt),
                int(n_steps))
        if self.algo == "dft":
            return make_ch_sif_fused_macro(*args, mats_dtype=self.mats_dtype)
        return make_ch_cas_fused_macro(*args, mats_dtype=self.mats_dtype, epilogue=epilogue)

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
        _check_epilogue_algo(self.algo)
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-2], "kappa",
                                           device=y0.device)
        return self._macro(dt, n_steps, _epilogue_cfg(ep_cfg))(y0, kappa)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


def _epilogue_cfg(ep_cfg) -> dict:
    """The macro's epilogue keys from the env's ``fused_epilogue`` config."""
    return {
        "obs_scale": float(ep_cfg.get("obs_scale", 255.0)),
        "obs_offset": float(ep_cfg.get("obs_offset", 0.0)),
        "obs_downsample": int(ep_cfg.get("obs_downsample", 1)),
        "stats_center": float(ep_cfg.get("stats_center", 0.0)),
    }


class FusedSemiImplicitSpectral3D(AbstractStepper):
    """3D whole-segment semi-implicit CH stepper on cas transforms.

    The 3D counterpart of :class:`FusedSemiImplicitSpectral`: all substeps
    of an ``evolve`` call run in one macro
    (:func:`pde_opt_tpu_torch.ops.cas3d.make_ch3d_cas_macro`, ``torch.matmul``
    transforms, as the JAX package uses XLA einsums), with each env's own
    κ.  Unit mobility (``D == 1``), elementwise ``mu``; natively
    differentiable.  ``rhs`` is ignored.
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
        # The JAX stepper's probe: a D that evaluates off 1 on the host is
        # refused; one that cannot be evaluated there (parameters on the
        # card) is taken on trust.
        try:
            probe = D(torch.linspace(0.1, 0.9, 4, dtype=torch.float64))
        except (RuntimeError, TypeError):
            return
        if not torch.allclose(torch.as_tensor(probe).detach().cpu().double(),
                              torch.ones(4, dtype=torch.float64)):
            raise ValueError(
                "FusedSemiImplicitSpectral3D requires unit mobility "
                "(D == 1); use SemiImplicitFourierSpectral otherwise."
            )

    def evolve(self, rhs, y0, t0, dt, n_steps):
        del rhs, t0
        N1, N2, N3 = self.domain.points
        h1, h2, h3 = (float(h) for h in self.domain.dx)
        macro = make_ch3d_cas_macro(self.mu, N1, N2, N3, h1, h2, h3, self.A, float(dt),
                                    int(n_steps), mats_dtype=self.mats_dtype)
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-3], "kappa",
                                           device=y0.device)
        return macro(y0, kappa)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class FusedMobilitySpectral(AbstractStepper):
    """Whole-segment semi-implicit CH stepper for GENERAL mobility D(c).

    All substeps of an ``evolve`` call run in one macro of
    :mod:`pde_opt_tpu_torch.ops.cas_mobility`: per substep the conservative
    face-flux rhs ``div(D_face·grad(mu − κ∇²u))`` (on CUDA tensors one launch
    of kernel K8, where ``mu`` and ``D`` must be forms it reads) and one
    forward and one inverse cas transform.  Rank is dispatched from the
    domain (2D and 3D).  On CPU tensors the rhs is the roll chain, natively
    differentiable, learnable ``mu``/``D`` parameters included; on CUDA
    tensors gradients with respect to the field and κ come from the roll
    chain's macro, and learnable coefficients raise (see ``rhs_impl`` of
    the macros).

    ``stab_scale``: multiplies the implicit κλ² shift (set ≈ max D(c) when
    the mobility is large).
    """

    required_equation_attrs = ("kappa", "mu", "D", "domain")
    order = 1

    def __init__(self, kappa, mu, D, domain, A: float = 1.0,
                 stab_scale: float = 1.0, mats_dtype: Optional[torch.dtype] = None):
        self.kappa = kappa
        self.mu = mu
        self.D = D
        self.domain = domain
        self.A = float(A)
        self.stab_scale = float(stab_scale)
        self.mats_dtype = torch.bfloat16 if mats_dtype is None else mats_dtype

    def evolve(self, rhs, y0, t0, dt, n_steps):
        del rhs, t0
        pts = tuple(self.domain.points)
        dxs = tuple(float(h) for h in self.domain.dx)
        if len(pts) == 2:
            make = make_ch_mobility_cas_macro
        elif len(pts) == 3:
            make = make_ch3d_mobility_cas_macro
        else:
            raise ValueError(f"FusedMobilitySpectral supports 2D/3D domains, got {pts}")
        macro = make(self.mu, self.D, *pts, *dxs, self.A, float(dt), int(n_steps),
                     stab_scale=self.stab_scale, mats_dtype=self.mats_dtype)
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-len(pts)], "kappa",
                                           device=y0.device)
        return macro(y0, kappa)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class FusedAllenCahnSpectral(AbstractStepper):
    """Whole-macro-step fused semi-implicit stepper for Allen-Cahn.

    The Allen-Cahn counterpart of :class:`FusedSemiImplicitSpectral`: all
    substeps of an ``evolve`` call run in one macro with each env's own κ,
    on CUDA tensors one launch of a Hopper kernel: ``algo="cas"`` (the
    default) the cas macro
    (:func:`pde_opt_tpu_torch.ops.cas_spectral.make_ac_cas_fused_macro`,
    K4), ``algo="dft"`` the packed-DFT macro
    (:func:`pde_opt_tpu_torch.ops.fused_spectral.make_ac_sif_fused_macro`,
    K9b).  ``mu`` and ``R`` must be elementwise; on CUDA ``mu`` must be a
    :class:`~pde_opt_tpu_torch.ops.cas_spectral.PolynomialMu`, and so must
    ``R`` unless the identity probe finds ``R ≡ 1``.  ``rhs`` is ignored.
    Differentiable through the checkpointed FFT oracle.  The env epilogue
    needs ``algo="cas"``, as in the JAX package.

    The JAX stepper's ``block_envs``/``interpret`` (TPU tiling) have no
    counterpart.
    """

    required_equation_attrs = ("kappa", "mu", "R", "domain")
    order = 1

    def __init__(self, kappa, mu, R, domain, A: float = 1.0,
                 mats_dtype: Optional[torch.dtype] = None, algo: str = "cas"):
        self.algo = _check_algo(algo)
        self.kappa = kappa
        self.mu = mu
        self.R = R
        self.domain = domain
        self.A = float(A)
        self.mats_dtype = torch.bfloat16 if mats_dtype is None else mats_dtype

    def _macro(self, dt, n_steps, epilogue=None):
        H, W = self.domain.points
        args = (self.mu, self.R, H, W, *(float(h) for h in self.domain.dx), self.A,
                float(dt), int(n_steps))
        if self.algo == "dft":
            return make_ac_sif_fused_macro(*args, mats_dtype=self.mats_dtype)
        return make_ac_cas_fused_macro(*args, mats_dtype=self.mats_dtype, epilogue=epilogue)

    def evolve(self, rhs, y0, t0, dt, n_steps):
        del rhs, t0
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-2], "kappa",
                                           device=y0.device)
        return self._macro(dt, n_steps)(y0, kappa)

    def evolve_with_epilogue(self, rhs, y0, t0, dt, n_steps, ep_cfg):
        """Advance AND emit ``(y1, stats, obs)`` from the same macro (the
        contract of :meth:`FusedSemiImplicitSpectral.evolve_with_epilogue`)."""
        del rhs, t0
        _check_epilogue_algo(self.algo)
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-2], "kappa",
                                           device=y0.device)
        return self._macro(dt, n_steps, _epilogue_cfg(ep_cfg))(y0, kappa)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class StrangSplitting(AbstractStepper):
    """Strang split-step Fourier method for time-splitting equations (GPE).

    Half-step of the Fourier-diagonal ``A`` operator, full step of the
    pointwise ``B`` operator (``rhs``), per-step L² renormalisation over the
    spatial axes, half-step of ``A`` again.  State is a real ``(..., 2)``
    stack of (Re, Im).  ``time_scale = -1j`` selects imaginary-time
    propagation (ground-state search).

    ``fast_evolve`` merges the trailing and leading ``A`` half-steps of
    consecutive substeps in :meth:`evolve` (the midpoint Strang scheme: 2 FFT
    pairs per substep instead of 4); it is not bit-identical to per-step
    semantics, which :meth:`step` keeps.
    """

    required_equation_attrs = ("A_term", "dx", "fft", "ifft")
    order = 1

    def __init__(self, A_term, dx, fft, ifft, time_scale=1.0,
                 fast_evolve: bool = False):
        self.A_term = A_term
        self.dx = dx
        self.fft = fft
        self.ifft = ifft
        self.time_scale = time_scale
        self.fast_evolve = fast_evolve

    def _renorm(self, psi, axes):
        return psi / torch.sqrt(
            (psi.real**2 + psi.imag**2).sum(axes, keepdim=True) * self.dx**2)

    def step(self, rhs, y, t, dt):
        dt = dt * self.time_scale
        yc = torch.complex(y[..., 0], y[..., 1])
        axes = tuple(range(-self.A_term.ndim, 0))
        exp_A = torch.exp(self.A_term * 0.5 * dt)
        tmp = self.ifft(self.fft(yc) * exp_A)
        b = rhs(y, t)                    # B_terms, stacked (..., 2)
        tmp = tmp * torch.exp(torch.complex(b[..., 0], b[..., 1]) * dt)
        tmp = self._renorm(tmp, axes)
        y1c = self.ifft(self.fft(tmp) * exp_A)
        return torch.stack([y1c.real, y1c.imag], dim=-1), None

    def evolve(self, rhs, y0, t0, dt, n_steps):
        """Advance ``n_steps`` split steps (merged midpoint steps with
        ``fast_evolve``)."""
        if not self.fast_evolve:
            y = y0
            for i in range(n_steps):
                y = self.step(rhs, y, t0 + i * dt, dt)[0].to(y.dtype)
            return y

        dtc = dt * self.time_scale
        axes = tuple(range(-self.A_term.ndim, 0))
        # The complex working dtype follows the state's precision.
        cdtype = torch.promote_types(y0.dtype, torch.complex64)
        expA_half = torch.exp(self.A_term * 0.5 * dtc).to(cdtype)
        expA_full = expA_half * expA_half
        yc = torch.complex(y0[..., 0], y0[..., 1]).to(cdtype)

        def apply_B_renorm(psi, t):
            b = rhs(torch.stack([psi.real, psi.imag], dim=-1), t)
            psi = psi * torch.exp(torch.complex(b[..., 0], b[..., 1]) * dtc)
            return self._renorm(psi, axes).to(cdtype)

        psi = self.ifft(self.fft(yc) * expA_half)
        for i in range(n_steps - 1):
            psi = apply_B_renorm(psi, t0 + i * dt)
            psi = self.ifft(self.fft(psi) * expA_full).to(cdtype)
        psi = apply_B_renorm(psi, t0 + (n_steps - 1) * dt)
        psi = self.ifft(self.fft(psi) * expA_half)
        return torch.stack([psi.real, psi.imag], dim=-1).to(y0.dtype)


class FusedStrangControl(AbstractStepper):
    """Whole-macro-step fused Strang stepper for the GPE control env.

    All substeps of an ``evolve`` call run in one macro
    (:func:`pde_opt_tpu_torch.ops.gpe_cas.make_gpe_strang_cas_macro`), on
    CUDA tensors one launch of kernel K5.  Semantics: the midpoint
    ``StrangSplitting(fast_evolve=True)`` scheme at real time with the
    control held for the macro-step.  Differentiable with respect to the
    state and the control field through the checkpointed FFT oracle.  The
    trap potential and the meshes ``lights(t, x, y)`` reads come from the
    equation, which caches them per configuration and device, so a step
    copies nothing from the host.  The JAX stepper's
    ``block_envs``/``interpret`` (TPU tiling) have no counterpart.
    """

    required_equation_attrs = ("domain", "k", "lights", "kinetic", "xmesh", "ymesh",
                               "V_trap")
    order = 1

    def __init__(self, domain, k, lights, xmesh, ymesh, V_trap, kinetic=True,
                 mats_dtype: Optional[torch.dtype] = None):
        if not kinetic:
            raise ValueError(
                "FusedStrangControl integrates the full dispersion; "
                "construct the equation with kinetic=True (the zeroed-A "
                "Thomas-Fermi mode has no kinetic propagator to fuse: use "
                "StrangSplitting there)."
            )
        self.domain = domain
        self.g = float(k)
        self.lights = lights
        self.xmesh, self.ymesh, self.V_trap = xmesh, ymesh, V_trap
        self.mats_dtype = torch.bfloat16 if mats_dtype is None else mats_dtype

    def _macro_and_ctrl(self, y0, t0, dt, n_steps, epilogue=None):
        H, W = self.domain.points
        macro = make_gpe_strang_cas_macro(
            self.V_trap, self.g, H, W, float(self.domain.dx[0]), float(dt), int(n_steps),
            mats_dtype=self.mats_dtype, epilogue=epilogue,
        )
        ctrl = torch.broadcast_to(self.lights(t0, self.xmesh, self.ymesh), y0.shape[:-1])
        return macro, ctrl

    def evolve(self, rhs, y0, t0, dt, n_steps):
        del rhs
        macro, ctrl = self._macro_and_ctrl(y0, t0, dt, n_steps)
        return macro(y0, ctrl)

    def evolve_with_epilogue(self, rhs, y0, t0, dt, n_steps, ep_cfg):
        """Advance AND emit ``(y1, stats, obs)`` from the same macro: stats
        rows ``[sum(w rho), sum(rho), n_finite]`` with ``rho`` the
        NaN-masked final density and ``w = ep_cfg['weight']``; obs
        ``clip(rho obs_scale, 0, 255)`` uint8."""
        del rhs
        epilogue = {"obs_scale": float(ep_cfg.get("obs_scale", 2550.0)),
                    "weight": ep_cfg.get("weight")}
        macro, ctrl = self._macro_and_ctrl(y0, t0, dt, n_steps, epilogue)
        return macro(y0, ctrl)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


def _check_half_alpha(name: str, alpha) -> None:
    if float(alpha) != 0.5:
        raise ValueError(
            f"{name} implements the alpha=1/2 closed-form galvanostatic closure "
            f"(as the reference does); got alpha={alpha}"
        )


class FusedButlerVolmer(AbstractStepper):
    """Whole-macro-step fused RK4 stepper for the galvanostatic
    Butler-Volmer charging env.

    All substeps of an ``evolve`` call run in one macro
    (:func:`pde_opt_tpu_torch.ops.bv_cas.make_bv_cc_fused_macro`), on CUDA
    tensors one launch of kernel K6: FD Laplacians by cas transforms, the
    constant-current closure (per-env integrals, closed-form overpotential,
    alpha = 1/2) in the same kernel.  The per-env C-rate is the control.
    On CUDA ``mu`` must be a ``LogRatioMu`` and ``j0`` a ``SqrtJ0``.
    Differentiable with respect to the state and the C-rate through the
    checkpointed roll-stencil oracle.  ``mats_dtype`` defaults to bf16, as
    in JAX; the JAX stepper's ``block_envs``/``interpret`` (TPU tiling) have
    no counterpart.
    """

    required_equation_attrs = ("kappa", "mu", "j0", "alpha", "Crate", "domain")
    order = 4

    def __init__(self, kappa, mu, j0, alpha, Crate, domain,
                 mats_dtype: Optional[torch.dtype] = None):
        _check_half_alpha("FusedButlerVolmer", alpha)
        self.kappa = kappa
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.Crate = Crate
        self.domain = domain
        self.mats_dtype = torch.bfloat16 if mats_dtype is None else mats_dtype

    def _run(self, y0, dt, n_steps, epilogue=None):
        H, W = self.domain.points
        hx, hy = self.domain.dx
        macro = make_bv_cc_fused_macro(
            self.mu, self.j0, float(self.kappa), H, W, float(hx), float(hy), float(dt),
            int(n_steps), mats_dtype=self.mats_dtype, epilogue=epilogue,
        )
        crate = _normalize_per_env_control(self.Crate, y0.shape[:-2], "Crate",
                                           device=y0.device)
        return macro(y0, crate)

    def evolve(self, rhs, y0, t0, dt, n_steps):
        del rhs, t0
        return self._run(y0, dt, n_steps)

    def evolve_with_epilogue(self, rhs, y0, t0, dt, n_steps, ep_cfg):
        """Advance AND emit ``(y1, stats, obs)`` from the same macro (the
        contract of :meth:`FusedSemiImplicitSpectral.evolve_with_epilogue`,
        ``obs_downsample`` 1)."""
        del rhs, t0
        return self._run(y0, dt, n_steps, _epilogue_cfg(ep_cfg))

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class FusedSBMButlerVolmer(AbstractStepper):
    """Whole-macro-step fused RK4 stepper for the smoothed-boundary
    galvanostatic Butler-Volmer env.

    The SBM flux divergence ``div(ψ_face grad c)/ψ`` is a
    variable-coefficient stencil, not a circular convolution, so the macro
    (:func:`pde_opt_tpu_torch.ops.sbm_bv.make_sbm_bv_fused_macro`, on CUDA
    tensors one launch of kernel K7) runs stencils, the ψ-weighted
    integrals and the alpha = 1/2 closed-form overpotential, in f32.  On
    CUDA ``mu`` must be a ``LogRatioMu`` and ``j0`` a ``SqrtJ0``.
    Differentiable with respect to the state and the C-rate through the
    checkpointed roll-stencil oracle.
    """

    required_equation_attrs = ("kappa", "mu", "j0", "alpha", "Crate", "domain", "psi")
    order = 4

    def __init__(self, kappa, mu, j0, alpha, Crate, domain, psi):
        _check_half_alpha("FusedSBMButlerVolmer", alpha)
        self.kappa = kappa
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.Crate = Crate
        self.domain = domain
        self.psi = psi

    def _run(self, y0, dt, n_steps, epilogue=None):
        hx, hy = self.domain.dx
        macro = make_sbm_bv_fused_macro(
            self.mu, self.j0, float(self.kappa), self.psi, float(hx), float(hy), float(dt),
            int(n_steps), epilogue=epilogue,
        )
        crate = _normalize_per_env_control(self.Crate, y0.shape[:-2], "Crate",
                                           device=y0.device)
        return macro(y0, crate)

    def evolve(self, rhs, y0, t0, dt, n_steps):
        del rhs, t0
        return self._run(y0, dt, n_steps)

    def evolve_with_epilogue(self, rhs, y0, t0, dt, n_steps, ep_cfg):
        """Advance AND emit ``(y1, stats, obs)``: ψ-weighted stats
        ``[sum(ψ cell (u-c)), sum(ψ cell (u-c)^2), n_finite]`` and the
        ψ-masked uint8 obs, from the same macro."""
        del rhs, t0
        return self._run(y0, dt, n_steps, {
            "obs_scale": float(ep_cfg.get("obs_scale", 255.0)),
            "stats_center": float(ep_cfg.get("stats_center", 0.0)),
        })

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class DirectionalSplitting(AbstractStepper):
    """Directional (ADI) split step for the rotating-frame GPE.

    ``A_terms`` returns per-direction mixed-basis symbols (the −Ω·L_z term
    couples k_x with y and k_y with x), each diagonal under a 1D FFT along
    its own axis:

        ψ ← F_x⁻¹ e^{A_x δt/2} F_x ψ;  ψ ← F_y⁻¹ e^{A_y δt/2} F_y ψ;
        ψ ← e^{B(ψ,t) δt} ψ  (+ L² renormalisation);
        then the y- and x-sweeps again (Strang symmetry).

    Complex state with trailing 2D spatial axes (batch axes lead).
    ``time_scale=-1j`` selects imaginary-time ground-state search, where
    ``normalize`` defaults on.  Scheme: Bao & Cai, arXiv:1212.5341 §4.
    """

    required_equation_attrs = ("A_terms", "B_terms", "dx")
    order = 2

    def __init__(self, A_terms, B_terms, dx, time_scale=1.0, normalize=None):
        self.A_terms = A_terms
        self.B_terms = B_terms
        self.dx = dx
        self.time_scale = time_scale
        if normalize is None:
            normalize = complex(time_scale).imag != 0.0
        self.normalize = normalize

    def step(self, rhs, y, t, dt):
        del rhs  # the equation enters through A_terms/B_terms
        dt = dt * self.time_scale
        Ax, Ay = self.A_terms(None, t)
        expAx = torch.exp(0.5 * dt * Ax)
        expAy = torch.exp(0.5 * dt * Ay)

        def sweep_x(psi):
            return torch.fft.ifft(expAx * torch.fft.fft(psi, dim=-2), dim=-2)

        def sweep_y(psi):
            return torch.fft.ifft(expAy * torch.fft.fft(psi, dim=-1), dim=-1)

        psi = sweep_y(sweep_x(y))
        psi = psi * torch.exp(self.B_terms(psi, t) * dt)
        if self.normalize:
            psi = psi / torch.sqrt(
                (psi.real**2 + psi.imag**2).sum((-2, -1), keepdim=True) * self.dx**2)
        return sweep_x(sweep_y(psi)), None


class FusedRotatingSplitting(AbstractStepper):
    """Whole-segment matmul ADI stepper for the rotating-frame GPE.

    The fast path of :class:`DirectionalSplitting`: each sweep is a
    precomputed per-line propagator applied to the fleet as one batched
    product, and consecutive half-sweeps merge across the segment (3 sweeps
    an inner substep; :mod:`pde_opt_tpu_torch.ops.gpe_rot_fast`).
    ``A_terms`` must be fixed (trap and rotation constants: the sweep
    matrices are built once and cached); ``B_terms`` may close over per-env
    controls.  f32 matrices only, as in the JAX package.
    """

    required_equation_attrs = ("A_terms", "B_terms", "dx")
    order = 2

    def __init__(self, A_terms, B_terms, dx, time_scale=1.0, normalize=None,
                 mats_dtype: Optional[torch.dtype] = None, phase_poly: bool = True):
        self.A_terms = A_terms
        self.B_terms = B_terms
        self.dx = dx
        self.time_scale = time_scale
        if normalize is None:
            normalize = complex(time_scale).imag != 0.0
        self.normalize = normalize
        self.mats_dtype = torch.float32 if mats_dtype is None else mats_dtype
        self.phase_poly = phase_poly

    def evolve(self, rhs, y0, t0, dt, n_steps):
        del rhs
        H, W = y0.shape[-2:]
        macro = make_rot_adi_macro(
            self.A_terms, self.B_terms, float(self.dx), H, W, float(dt), int(n_steps),
            time_scale=self.time_scale, normalize=self.normalize,
            mats_dtype=self.mats_dtype, phase_poly=self.phase_poly,
        )
        return macro(y0, t0)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None
