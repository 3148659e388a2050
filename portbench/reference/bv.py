"""Plain reference of the galvanostatic Butler-Volmer (BV) charging fleet,
in float64.

Written from the deployment's equations, as the configuration file states
them, with nothing of the program: no kernel, no preset, no constant the
program built.  Per env, one RL step is

    C' = clip(C + crate_step * a, crate_min, crate_max)
    n classical RK4 substeps of dt = step_dt / n; each stage, on its input z:
        m  = log(x / (1 - x)) + omega (1 - 2 z) - grad_kappa lap5(z),
             x = clip(z, mu_clip, 1 - mu_clip)
        j  = sqrt(max(z (1 - z), j0_floor)),   em = exp(m / 2)
        I+ = sum(j em) cell,   I- = sum(j / em) cell     (cell = hx hy, per env)
        y  = (-C' + sqrt(C'^2 + 4 I+ I-)) / (2 I+)        (alpha = 1/2, y = e^{v/2})
        k  = j (1 / (em y) - em y)
    reward = mean(u) - 10 var(u), obs = uint8(clip(255 u, 0, 255)),
    t' = t + step_dt in float32, terminated = t' >= end_time or u not finite,
    and, where terminated, a fresh episode: u = clip(reset_mean + reset_noise
    * z, reset_lo, reset_hi) (z the fleet's reset draw), C = the reset C-rate,
    t = 0.

``lap5`` is the periodic 5-point Laplacian on the box of side ``length``
(hx = length / H, hy = length / W), taken as ``ifft(lam fft(z))`` with
``lam`` its symbol: the same operator, since the stencil is a circular
convolution (the one departure from the equations as written).  The
regular-solution term and ``j`` take the unclipped ``z``, as the equations
say.

Since ``sum(k) cell = I- / y - I+ y = C'`` at every stage, whatever the
Laplacian's rounding, the mean filling rises by exactly ``C' step_dt`` a
step; :func:`check_steps` reads how far the program's own states stray from
that (``charge_gap``).

``rnd`` rounds each transform's operand, its intermediate and its output
(as in ``reference/ch.py``, with :func:`fp8_rounding`); ``closure`` rounds
the closure's ``em``, ``I+``, ``I-`` and ``y`` (with :func:`bf16_rounding`).
The configuration states bf16 transforms and a float32 closure, so the
control, the reference one precision below it everywhere, takes both
(:func:`trajectory`'s default, what ``controls.py`` runs as ``fp8``); each
alone is a control of its own (``controls_bv.py``): ``charge_gap`` sees
the closure's rounding and not the transforms'.

The harness keeps a fleet's control value under the name ``kappa`` (the
recorder's buffer, :class:`FleetState`, the configuration's
``kappa_reset``): here it holds the C-rate.
"""

from __future__ import annotations

import math

import torch

from .ch import FleetState, Rounding, _draw, _fwd, _gap, _inv, _state, fp8_rounding, observe

__all__ = ["FleetState", "lap_symbol", "stage", "substeps", "reset_field", "fleet_step",
           "charge_gaps", "fp8_rounding", "bf16_rounding", "check_steps", "check_reset",
           "check_rollout", "trajectory"]


def bf16_rounding(z: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (the cheap-closure control's rounding)."""
    return z.to(torch.bfloat16).to(z.dtype)


def _keep(z: torch.Tensor) -> torch.Tensor:
    return z


def lap_symbol(H: int, W: int, length: float, device) -> torch.Tensor:
    """Eigenvalues of the periodic 5-point Laplacian on an (H, W) grid of
    the box of side ``length``."""
    hx, hy = length / H, length / W
    kh = torch.arange(H, dtype=torch.float64, device=device)
    kw = torch.arange(W, dtype=torch.float64, device=device)
    lh = (2.0 * torch.cos(2.0 * math.pi * kh / H) - 2.0) / (hx * hx)
    lw = (2.0 * torch.cos(2.0 * math.pi * kw / W) - 2.0) / (hy * hy)
    return lh[:, None] + lw[None, :]


def stage(z: torch.Tensor, crate: torch.Tensor, phys: dict, lam: torch.Tensor, cell: float,
          rnd: Rounding = None, closure: Rounding = None) -> torch.Tensor:
    """The reaction ``k`` of every env of ``z`` (b, H, W) at the C-rates
    ``crate`` (b, 1, 1): one RK stage of the module's equations."""
    cr = closure or _keep
    lap = _inv(lam * _fwd(z, rnd), rnd)
    lo = phys["mu_clip"]
    x = torch.clamp(z, lo, 1.0 - lo)
    m = torch.log(x / (1.0 - x)) + phys["omega"] * (1.0 - 2.0 * z) - phys["grad_kappa"] * lap
    j = torch.sqrt(torch.clamp(z * (1.0 - z), min=phys["j0_floor"]))
    em = cr(torch.exp(0.5 * m))
    ip = cr((j * em).sum((-2, -1), keepdim=True) * cell)
    im = cr((j / em).sum((-2, -1), keepdim=True) * cell)
    y = cr((-crate + torch.sqrt(crate * crate + 4.0 * ip * im)) / (2.0 * ip))
    return j * (1.0 / (em * y) - em * y)


def substeps(u: torch.Tensor, crate: torch.Tensor, phys: dict, n: int, dt: float,
             lam: torch.Tensor, cell: float, rnd: Rounding = None,
             closure: Rounding = None) -> torch.Tensor:
    """``n`` classical RK4 substeps of every env of ``u`` (b, H, W) at the
    C-rates ``crate`` (b,)."""
    c = crate.reshape(-1, 1, 1)

    def k(z):
        return stage(z, c, phys, lam, cell, rnd, closure)

    for _ in range(n):
        k1 = k(u)
        k2 = k(u + 0.5 * dt * k1)
        k3 = k(u + 0.5 * dt * k2)
        k4 = k(u + dt * k3)
        u = u + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return u


def reset_field(z: torch.Tensor, phys: dict) -> torch.Tensor:
    return torch.clamp(phys["reset_mean"] + phys["reset_noise"] * z.to(torch.float64),
                       phys["reset_lo"], phys["reset_hi"])


def _geometry(config: dict, meta: dict, device):
    """``(lam, cell)`` of the cell's grid."""
    H, W = meta["H"], meta["W"]
    length = float(config["physics"]["length"])
    return lap_symbol(H, W, length, device), (length / H) * (length / W)


def fleet_step(s: FleetState, action: torch.Tensor, reset_z: torch.Tensor, fleet: dict,
               phys: dict, ds: int, lam: torch.Tensor, cell: float, rnd: Rounding = None,
               closure: Rounding = None):
    """One RL step of envs ``s`` under ``action`` (b, 1) with the reset draw
    ``reset_z`` (b, H, W).  Returns ``(state, reward, terminated, obs)``;
    ``obs`` is the next observation (of the reset field where terminated).
    ``s.kappa`` is the C-rate."""
    n = int(fleet["substeps"])
    step_dt = float(fleet["step_dt"])
    crate = torch.clamp(s.kappa + phys["crate_step"] * action[..., 0].to(torch.float64),
                        phys["crate_min"], phys["crate_max"])
    y = substeps(s.y, crate, phys, n, step_dt / n, lam, cell, rnd, closure)
    finite = torch.isfinite(y).reshape(y.shape[0], -1).all(dim=1)
    reward = torch.where(finite,
                         y.mean(dim=(-2, -1)) - 10.0 * y.var(dim=(-2, -1), correction=0),
                         torch.zeros_like(crate))
    t1 = s.t + torch.tensor(step_dt, dtype=torch.float32)
    terminated = (t1.to(torch.float64) >= float(fleet["end_time"]) - 1e-9) | ~finite
    m = terminated.reshape(-1, 1, 1)
    y_next = torch.where(m, reset_field(reset_z, phys), y)
    nxt = FleetState(
        y=y_next,
        kappa=torch.where(terminated, torch.full_like(crate, phys["kappa_reset"]), crate),
        t=torch.where(terminated, torch.zeros_like(t1), t1),
        steps=torch.where(terminated, torch.zeros_like(s.steps), s.steps + 1),
    )
    return nxt, reward, terminated, observe(y_next, ds, phys["obs_scale"])


def charge_gaps(y0: torch.Tensor, y1: torch.Tensor, crate: torch.Tensor, keep: torch.Tensor,
                step_dt: float, cell: float) -> torch.Tensor:
    """``|sum(y1 - y0) cell - crate step_dt|`` an env (b,), in float64, 0
    where ``keep`` is false or either field is not finite."""
    d = (y1.to(torch.float64) - y0.to(torch.float64)).sum(dim=(-2, -1)) * cell
    gap = (d - crate.to(torch.float64) * step_dt).abs()
    keep = keep & torch.isfinite(gap)
    return torch.where(keep, gap, torch.zeros_like(gap))


def check_steps(config: dict, meta: dict, rec: dict, idx, device) -> dict:
    """Follow the recorded run step by step: from each recorded state
    ``rec[...][j]`` of the envs ``idx``, one reference step under the run's
    action ``rec["actions"][j]`` and reset draw, against the recorded
    ``j + 1`` (``rec`` as ``reference/ch.py`` reads it; ``kappa`` holds the
    C-rate).

    * ``field_gap``: the widest gap of a field after a step;
    * ``reward_gap``: the widest gap of a reward (mean - 10 var);
    * ``obs_lsb``: the widest gap of an observation pixel, in levels;
    * ``state_mismatch``: episode ends, clocks, step counts and C-rates
      (beyond 1e-6) that differ, counted over every step and env;
    * ``charge_gap``: the widest ``|sum(u_{j+1} - u_j) cell - C'_j
      step_dt|`` of the recorded fields, over the steps and envs that
      neither ended nor went non-finite (``C'_j`` the C-rate the step
      applied): zero in exact arithmetic, whatever the Laplacian's rounding.
    """
    fleet, phys = config["fleet"], config["physics"]
    B, H, W = meta["B"], meta["H"], meta["W"]
    lam, cell = _geometry(config, meta, device)
    step_dt = float(fleet["step_dt"])
    draw = _draw(rec["gen_state"], (B, H, W), device)
    n = rec["actions"].shape[0]
    zero = torch.zeros((), dtype=torch.float64, device=device)
    field, reward, charge = zero, zero, zero
    mism = torch.zeros((), dtype=torch.int64, device=device)
    lsb = torch.zeros((), dtype=torch.int64, device=device)
    for j in range(n):
        z = draw().index_select(0, idx)
        s0 = _state(rec, j)
        s, r, term, obs = fleet_step(s0, rec["actions"][j], z, fleet, phys, meta["ds"], lam,
                                     cell)
        nxt = _state(rec, j + 1)
        field = torch.maximum(field, _gap(nxt.y, s.y))
        reward = torch.maximum(reward, _gap(rec["rewards"][j], r))
        mism += ((term != rec["terms"][j]).sum() + (nxt.t != s.t).sum()
                 + (nxt.steps != s.steps).sum() + ((nxt.kappa - s.kappa).abs() > 1e-6).sum())
        kept = ~(term | rec["terms"][j])
        charge = torch.maximum(charge, charge_gaps(rec["y"][j], rec["y"][j + 1], s.kappa,
                                                   kept, step_dt, cell).max())
        if j == n - 2:
            lsb = (rec["last_obs"].reshape(obs.shape).to(torch.int64)
                   - obs.to(torch.int64)).abs().max()
    return {"field_gap": float(field), "reward_gap": float(reward), "obs_lsb": float(lsb),
            "charge_gap": float(charge), "state_mismatch": float(mism)}


def check_reset(config: dict, meta: dict, start: dict, gen_state0, idx, device) -> dict:
    """The fleet's first reset against the reference's from the same draw,
    both in float32 as the configuration states it: ``reset_mismatch``
    counts the field values and observation pixels that differ (an exact
    comparison)."""
    B, H, W = meta["B"], meta["H"], meta["W"]
    phys = config["physics"]
    z = _draw(gen_state0, (B, H, W), device)().index_select(0, idx)
    y0 = torch.clamp(phys["reset_mean"] + phys["reset_noise"] * z, phys["reset_lo"],
                     phys["reset_hi"])
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
               rnd: Rounding, closure: Rounding = bf16_rounding) -> dict:
    """A run of the envs ``idx`` computed by the reference itself from the
    state ``s`` (with ``rnd`` and ``closure``, a control in the program's
    place: by default the closure one precision below the configuration's
    float32, beside whatever ``rnd`` does to the transforms), recorded in
    the form :func:`check_steps` reads."""
    fleet, phys = config["fleet"], config["physics"]
    B, H, W = meta["B"], meta["H"], meta["W"]
    lam, cell = _geometry(config, meta, device)
    draw = _draw(gen_state, (B, H, W), device)
    states, rewards, terms, obs = [s], [], [], []
    for a in actions:
        s, r, term, o = fleet_step(s, a, draw().index_select(0, idx), fleet, phys,
                                   meta["ds"], lam, cell, rnd, closure)
        states.append(s)
        rewards.append(r)
        terms.append(term)
        obs.append(o)
    rec = {k: torch.stack([getattr(x, k) for x in states]) for k in ("y", "kappa", "t", "steps")}
    rec.update(actions=torch.stack(list(actions)), rewards=torch.stack(rewards),
               terms=torch.stack(terms), last_obs=obs[-2], gen_state=gen_state)
    return rec
