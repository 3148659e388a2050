"""Plain reference of the Cahn-Hilliard control fleet, in float64.

Written from the deployment's equations, as the configuration file states
them, with nothing of the program: no kernel, no preset, no constant the
program built.  Per env, one RL step is

    kappa' = clip(kappa + kappa_step * a, kappa_min, kappa_max)
    n substeps of dt = step_dt / n of the stabilised semi-implicit update
        u^_{k+1} = u^_k + dt (lam F[mu(u_k)] - kappa' lam^2 u^_k)
                          / (1 + A dt kappa' lam^2)
    on the periodic grid, lam the symbol of the 5-point FD Laplacian,
    mu(c) the configuration's polynomial;
    reward = -var(u), obs = uint8(clip(255 * pool(u), 0, 255)),
    t' = t + step_dt in float32, terminated = t' >= end_time or u not finite,
    and, where terminated, a fresh episode: u = clip(mean + noise * z, 0, 1)
    (z the fleet's reset draw), kappa = kappa_reset, t = 0.

The spectrum is taken with ``torch.fft`` in float64.  ``rnd`` rounds each
transform's operand, its intermediate (after the first axis) and its
output, which turns the reference into the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


class FleetState(NamedTuple):
    y: torch.Tensor       # (b, H, W) float64
    kappa: torch.Tensor   # (b,) float64
    t: torch.Tensor       # (b,) float32 episode clock
    steps: torch.Tensor   # (b,) int64


def lap_symbol(H: int, W: int, dx: float, device) -> torch.Tensor:
    """Eigenvalues of the periodic 5-point Laplacian on an (H, W) grid."""
    kh = torch.arange(H, dtype=torch.float64, device=device)
    kw = torch.arange(W, dtype=torch.float64, device=device)
    lh = (2.0 * torch.cos(2.0 * math.pi * kh / H) - 2.0) / (dx * dx)
    lw = (2.0 * torch.cos(2.0 * math.pi * kw / W) - 2.0) / (dx * dx)
    return lh[:, None] + lw[None, :]


def polynomial(coeffs, c: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(c)
    for a in reversed(coeffs):
        out = out * c + a
    return out


def _round_c(z: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    if rnd is None:
        return z
    if z.is_complex():
        return torch.view_as_complex(rnd(torch.view_as_real(z).contiguous()))
    return rnd(z)


def _fwd(z: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    z = _round_c(z.to(torch.complex128), rnd)
    z = _round_c(torch.fft.fft(z, dim=-1), rnd)
    return _round_c(torch.fft.fft(z, dim=-2), rnd)


def _inv(z: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    z = _round_c(z, rnd)
    z = _round_c(torch.fft.ifft(z, dim=-1), rnd)
    return _round_c(torch.fft.ifft(z, dim=-2), rnd).real


def substeps(u: torch.Tensor, kappa: torch.Tensor, phys: dict, n: int, dt: float,
             lam: torch.Tensor, rnd: Rounding = None) -> torch.Tensor:
    """``n`` semi-implicit CH substeps of every env of ``u`` (b, H, W)."""
    k = kappa.reshape(-1, 1, 1)
    lam2 = lam * lam
    denom = 1.0 + phys["A"] * dt * k * lam2
    cm = dt * lam / denom
    cu = dt * k * lam2 / denom
    u_hat = _fwd(u, rnd)
    for _ in range(n):
        incr = cm * _fwd(polynomial(phys["mu_coeffs"], u), rnd) - cu * u_hat
        u_hat = u_hat + incr
        u = u + _inv(incr, rnd)
    return u


def observe(u: torch.Tensor, ds: int, scale: float) -> torch.Tensor:
    """uint8 observation (b, H/ds, W/ds): the pooled field times ``scale``,
    clipped to [0, 255] and truncated."""
    b, H, W = u.shape
    fin = torch.isfinite(u)
    u = torch.where(fin, u, torch.zeros_like(u))
    if ds > 1:
        u = u.reshape(b, H // ds, ds, W // ds, ds).mean(dim=(2, 4))
    return torch.clamp(u * scale, 0.0, 255.0).to(torch.uint8)


def reset_field(z: torch.Tensor, phys: dict) -> torch.Tensor:
    return torch.clamp(phys["reset_mean"] + phys["reset_noise"] * z.to(torch.float64),
                       0.0, 1.0)


def fleet_step(s: FleetState, action: torch.Tensor, reset_z: torch.Tensor, fleet: dict,
               phys: dict, ds: int, lam: torch.Tensor, rnd: Rounding = None):
    """One RL step of envs ``s`` under ``action`` (b, 1) with the reset draw
    ``reset_z`` (b, H, W).  Returns ``(state, reward, terminated, obs)``;
    ``obs`` is the next observation (of the reset field where terminated)."""
    n = int(fleet["substeps"])
    step_dt = float(fleet["step_dt"])
    kappa = torch.clamp(s.kappa + phys["kappa_step"] * action[..., 0].to(torch.float64),
                        phys["kappa_min"], phys["kappa_max"])
    y = substeps(s.y, kappa, phys, n, step_dt / n, lam, rnd)
    finite = torch.isfinite(y).reshape(y.shape[0], -1).all(dim=1)
    reward = torch.where(finite, -y.var(dim=(-2, -1), correction=0),
                         torch.zeros_like(kappa))
    t1 = s.t + torch.tensor(step_dt, dtype=torch.float32)
    terminated = (t1.to(torch.float64) >= float(fleet["end_time"]) - 1e-9) | ~finite
    y0 = reset_field(reset_z, phys)
    m = terminated.reshape(-1, 1, 1)
    y_next = torch.where(m, y0, y)
    nxt = FleetState(
        y=y_next,
        kappa=torch.where(terminated, torch.full_like(kappa, phys["kappa_reset"]), kappa),
        t=torch.where(terminated, torch.zeros_like(t1), t1),
        steps=torch.where(terminated, torch.zeros_like(s.steps), s.steps + 1),
    )
    return nxt, reward, terminated, observe(y_next, ds, phys["obs_scale"])


def fp8_rounding(z: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale an env (the leading axis), as an
    fp8 tensor-core path would: the scale maps each env's largest magnitude
    to the format's largest value."""
    lead = z.shape[0]
    amax = z.abs().reshape(lead, -1).amax(dim=1).clamp(min=1e-30)
    scale = (amax / torch.finfo(torch.float8_e4m3fn).max).reshape(
        (lead,) + (1,) * (z.ndim - 1))
    return (z / scale).to(torch.float8_e4m3fn).to(z.dtype) * scale


def _draw(gen_state, shape, device):
    """The fleet's reset draws, again, from the generator state the run
    started them at (the env draws one (B, H, W) normal field a step)."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    return lambda: torch.randn(shape, generator=g, dtype=torch.float32, device=device)


def _state(rec: dict, j: int) -> FleetState:
    return FleetState(rec["y"][j].to(torch.float64), rec["kappa"][j].to(torch.float64),
                      rec["t"][j].clone(), rec["steps"][j].to(torch.int64))


def check_steps(config: dict, meta: dict, rec: dict, idx, device) -> dict:
    """Follow the recorded run step by step: from each recorded state
    ``rec[...][j]`` of the envs ``idx``, one reference step under the run's
    action ``rec["actions"][j]`` and reset draw, against the recorded
    ``j + 1``.  ``rec`` holds ``y``, ``kappa``, ``t``, ``steps`` (n + 1
    states), ``actions``, ``rewards``, ``terms`` (n steps), ``last_obs``
    (the observation after step n - 2) and ``gen_state`` (the reset draws'
    generator at the first step).

    * ``field_gap``: the widest gap of a field after a step;
    * ``reward_gap``: the widest gap of a reward (-var, in field units
      squared: the fleet's fields relax to near-uniform, and a reward's
      size says nothing of its error);
    * ``obs_lsb``: the widest gap of an observation pixel, in levels;
    * ``state_mismatch``: episode ends, clocks, step counts and kappas
      (beyond 1e-6) that differ, counted over every step and env.
    """
    fleet, phys = config["fleet"], config["physics"]
    B, H, W = meta["B"], meta["H"], meta["W"]
    lam = lap_symbol(H, W, phys["dx"], device)
    draw = _draw(rec["gen_state"], (B, H, W), device)
    n = rec["actions"].shape[0]
    field = torch.zeros((), dtype=torch.float64, device=device)
    reward = torch.zeros((), dtype=torch.float64, device=device)
    mism = torch.zeros((), dtype=torch.int64, device=device)
    lsb = torch.zeros((), dtype=torch.int64, device=device)
    for j in range(n):
        z = draw().index_select(0, idx)
        s, r, term, obs = fleet_step(_state(rec, j), rec["actions"][j], z, fleet, phys,
                                     meta["ds"], lam)
        nxt = _state(rec, j + 1)
        field = torch.maximum(field, _gap(nxt.y, s.y))
        reward = torch.maximum(reward, _gap(rec["rewards"][j], r))
        mism += ((term != rec["terms"][j]).sum() + (nxt.t != s.t).sum()
                 + (nxt.steps != s.steps).sum() + ((nxt.kappa - s.kappa).abs() > 1e-6).sum())
        if j == n - 2:
            lsb = (rec["last_obs"].reshape(obs.shape).to(torch.int64)
                   - obs.to(torch.int64)).abs().max()
    return {"field_gap": float(field), "reward_gap": float(reward), "obs_lsb": float(lsb),
            "state_mismatch": float(mism)}


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The widest gap of ``a`` and ``b``; infinite where either is not finite."""
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return torch.where(torch.isfinite(d).all(), d.max(), torch.full_like(d.max(), math.inf))


def check_reset(config: dict, meta: dict, start: dict, gen_state0, idx, device) -> dict:
    """The fleet's first reset against the reference's from the same draw,
    both in float32 as the configuration states it: ``reset_mismatch``
    counts the field values and observation pixels that differ (an exact
    comparison)."""
    B, H, W = meta["B"], meta["H"], meta["W"]
    phys = config["physics"]
    z = _draw(gen_state0, (B, H, W), device)().index_select(0, idx)
    y0 = torch.clamp(phys["reset_mean"] + phys["reset_noise"] * z, 0.0, 1.0)
    obs0 = observe(y0, meta["ds"], phys["obs_scale"])
    n = (start["y"] != y0).sum() + (start["obs"].reshape(obs0.shape) != obs0).sum()
    return {"reset_mismatch": float(n)}


def check_rollout(config: dict, meta: dict, start: dict, gen_state0, rec: dict, idx,
                  device) -> dict:
    """Every number compared for a rollout cell."""
    with torch.no_grad():
        return {**check_steps(config, meta, rec, idx, device),
                **check_reset(config, meta, start, gen_state0, idx, device)}


def trajectory(config: dict, meta: dict, s: FleetState, gen_state, actions, idx, device,
               rnd: Rounding) -> dict:
    """A run of the envs ``idx`` computed by the reference itself from the
    state ``s`` (with ``rnd``, the control in the program's place), recorded
    in the form :func:`check_steps` reads."""
    fleet, phys = config["fleet"], config["physics"]
    B, H, W = meta["B"], meta["H"], meta["W"]
    lam = lap_symbol(H, W, phys["dx"], device)
    draw = _draw(gen_state, (B, H, W), device)
    states, rewards, terms, obs = [s], [], [], []
    for a in actions:
        s, r, term, o = fleet_step(s, a, draw().index_select(0, idx), fleet, phys,
                                   meta["ds"], lam, rnd)
        states.append(s)
        rewards.append(r)
        terms.append(term)
        obs.append(o)
    rec = {k: torch.stack([getattr(x, k) for x in states]) for k in ("y", "kappa", "t", "steps")}
    rec.update(actions=torch.stack(list(actions)), rewards=torch.stack(rewards),
               terms=torch.stack(terms), last_obs=obs[-2], gen_state=gen_state)
    return rec
