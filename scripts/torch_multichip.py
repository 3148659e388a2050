#!/usr/bin/env python3
"""The port's scale-out on the cards of one host, one process a card (NCCL).

    python3 scripts/torch_multichip.py            # every card of the host (four expected)
    python3 scripts/torch_multichip.py --cpu 4    # rehearsal: 4 gloo processes, small sizes

The parent prints each card's name and power limit (``nvidia-smi``), builds
the CH macro's library once (``csrc/ch_cas_macro.cu``, K1-K3) so that the
ranks load it instead of running four ``nvcc`` at once, and spawns one rank
a card.  Every rank then runs, with rank 0 printing:

(a) Weak scaling of the flagship fleet (``make_cahn_hilliard_control_env``,
    fused macro with its epilogue, K1), ENVS envs x GRID^2 x SUBSTEPS a
    card, on 1, 2 and 4 ranks: env-steps/s over RUNS rollouts of STEPS
    random-action steps of each rank's ``ShardedVectorPDEEnv`` (host clock
    from one barrier to the next, each rank synchronised), REPEATS times in
    the order 1, 2, 4, 4, 2, 1; the medians' efficiency against linear from
    one rank; one K1 launch a step on every rank; each rank's host time a
    step to enqueue its steps and to its own sync; then all of it again
    with one intra-op thread a rank.
(b) The fleet of ENVS x world envs sharded over every rank against the same
    envs unsharded on card 0, from one numpy state and one action list,
    CHECK_STEPS steps: fields, rewards and obs bit for bit.
(c) The spatial decomposition: the halo Laplacian, the distributed FFT pair
    and the sharded SIF macros on one GRID2D^2 field and one GRID3D^3 volume
    split over every rank, each rank's block against the global op on its
    own card (f32; bounds TOL_*).  Each transform's split: the local FFTs
    against the all_to_all, CUDA events between barriers.
(d) ``ppo_train(mesh=...)`` at bench.py's run_ppo shape a card (ENVS envs,
    ``derivs="pallas"``, obs_downsample 4, the bf16 ActorCriticMLP, T 64,
    2 epochs x 4 minibatches): ms an update, the share of the collectives
    (against the same learner on the rank's envs alone; two runs each, in
    turns), the parameters bit for bit equal on every rank after every
    update, 64 K1 launches an update.
(e) ``dryrun_multichip(world)``'s ``MULTICHIP_SCALING`` line.

The last line is one JSON object of the numbers.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SIZES = {
    "card": dict(envs=4096, grid=64, substeps=10, steps=30, runs=2, repeats=3, check_steps=10,
                 grid2d=8192, grid3d=256, sif_substeps=10, ppo_t=64, ppo_warm=2, ppo_timed=4,
                 reps=5),
    "cpu": dict(envs=16, grid=16, substeps=2, steps=3, runs=1, repeats=1, check_steps=3, grid2d=64,
                grid3d=16, sif_substeps=2, ppo_t=4, ppo_warm=1, ppo_timed=1, reps=1),
}
HX = HY = 0.01                     # the CH preset's grid spacing
SIF = dict(A=1.0, dt=1e-3, kappa=0.004)   # the sharded macros' case (tests/test_halo.py's)
TOL_LAP = 1e-6                     # relative to max |lap|: f32, the same stencil
TOL_FFT = 1e-5                     # relative to max |coefficient|: f32 FFTs in another order
TOL_SIF = 1e-5                     # absolute, fields ~0.5 after SIF_SUBSTEPS f32 substeps


def _card_lines():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


class _Ctx:
    """A rank's run: its device, group, sizes and printer."""

    def __init__(self, rank, world, dev, sz):
        self.rank, self.world, self.dev, self.sz = rank, world, dev, sz

    def say(self, msg):
        if self.rank == 0:
            print(msg, flush=True)

    def sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def barrier(self, group=None):
        import torch
        import torch.distributed as dist

        if self.dev.type == "cuda":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)

    def gen(self, seed):
        import torch

        return torch.Generator(device=self.dev).manual_seed(seed)


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _flagship(c, num_envs, **kw):
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env

    return make_cahn_hilliard_control_env(num_envs, c.sz["grid"], c.sz["substeps"],
                                          spectral_solve="fused", device=c.dev, **kw)


def _weak_scaling(c):
    """(a): env-steps/s of 1, 2, 4 ... ranks at ENVS envs a rank, REPEATS
    times in the order 1, 2, 4, 4, 2, 1: the median and the range."""
    import statistics

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from pde_opt_tpu_torch.ops import kernels
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    sz = c.sz
    counts = [p for p in (1, 2, 4, 8) if p <= c.world]
    groups = {p: dist.new_group(list(range(p))) for p in counts}   # every rank makes each
    n_steps = sz["steps"] * sz["runs"]
    c.say(f"host: {len(os.sched_getaffinity(0))} cores for this rank, torch "
          f"{torch.get_num_threads()} intra-op threads")
    fleets = {}
    for p in counts:
        if c.rank < p:
            mesh = DeviceMesh.from_group(groups[p], c.dev.type, mesh_dim_names=("env",))
            senv = ShardedVectorPDEEnv(_flagship(c, sz["envs"] * p), mesh)
            state, _ = senv.reset(c.gen(p))
            # The rank's own rollout: a sharded step IS the local step, and a
            # generator seeded by rank needs no derived stream (no sync).
            local = senv.local
            run = local.make_rollout(lambda obs, g, e=local: e.sample_actions(g), sz["steps"])
            agen = c.gen(100 + c.rank)
            state, _, _ = run(state, agen)
            fleets[p] = [run, state, agen]
        c.barrier()
    rates = {p: [] for p in counts}
    ranks_ms = {p: [] for p in counts}
    for _ in range(sz["repeats"]):
        for p in counts + counts[::-1]:
            if c.rank < p:
                run, state, agen = fleets[p]
                c.sync()
                c.barrier(groups[p])
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                for _ in range(sz["runs"]):
                    state, rewards, _ = run(state, agen)
                enqueued = time.perf_counter() - t0
                c.sync()
                own = time.perf_counter() - t0
                c.barrier(groups[p])
                dt = time.perf_counter() - t0
                fleets[p][1] = state
                counts_k = kernels.launch_counts()
                # Each rank's own host time to enqueue its steps and to its
                # own synchronisation: equal when the host paces the rank.
                per_rank = [None] * p
                dist.all_gather_object(per_rank, (1e3 * enqueued / n_steps, 1e3 * own / n_steps),
                                       group=groups[p])
                _check(bool(rewards.isfinite().all()), f"weak scaling at {p}: rewards finite")
                _check(counts_k["ch_cas_macro_ep"] == n_steps
                       and sum(counts_k.values()) == n_steps,
                       f"weak scaling at {p}: one K1 a step ({counts_k})")
                rates[p].append(sz["envs"] * p * n_steps / dt)
                ranks_ms[p].append(per_rank)
            c.barrier()
    del fleets
    if c.rank != 0:               # rank 0 ran every count
        return None
    med = {p: statistics.median(v) for p, v in rates.items()}
    eff = {p: med[p] / (p * med[counts[0]]) for p in counts}
    for p in counts:
        enq = [a for rep in ranks_ms[p] for a, _ in rep]
        syn = [b for rep in ranks_ms[p] for _, b in rep]
        c.say(f"weak scaling: {p} rank(s), {sz['envs'] * p} envs x {sz['grid']}^2 x "
              f"{sz['substeps']}, {len(rates[p])} runs of {n_steps} steps: median "
              f"{med[p]:.1f} env-steps/s (range {min(rates[p]):.1f}-{max(rates[p]):.1f}); each "
              f"rank's ms a step, enqueued {min(enq):.4f}-{max(enq):.4f}, to its own sync "
              f"{min(syn):.4f}-{max(syn):.4f}; one K1 launch a step on each rank")
    c.say("weak scaling efficiency vs linear (medians): "
          + ", ".join(f"{p}: {e:.4f}" for p, e in eff.items()))
    return {"rates_env_steps_per_s": {str(p): v for p, v in rates.items()},
            "median_env_steps_per_s": {str(p): v for p, v in med.items()},
            "efficiency_vs_linear": {str(p): e for p, e in eff.items()},
            "rank_ms_per_step_enqueued_and_synced": {str(p): v for p, v in ranks_ms.items()}}


def _fleet_check(c):
    """(b): the sharded fleet against the unsharded one on card 0."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv, make_mesh

    sz = c.sz
    B, G, S = sz["envs"] * c.world, sz["grid"], sz["check_steps"]
    rng = np.random.default_rng(7)
    arrs = {"y": (0.5 + 0.05 * rng.standard_normal((B, G, G), dtype=np.float32)),
            "t": np.zeros(B, np.float32),
            "control_value": rng.uniform(2e-3, 1e-2, B).astype(np.float32),
            "step_count": np.zeros(B, np.int32), "done": np.zeros(B, bool)}
    acts = torch.from_numpy(rng.uniform(-1, 1, (S, B, 1)).astype(np.float32)).to(c.dev)
    senv = ShardedVectorPDEEnv(_flagship(c, B), make_mesh(c.dev.type))
    senv.reset(c.gen(1))
    rows = senv.rows
    state = env_state_from_numpy({k: v[rows] for k, v in arrs.items()}, c.dev)
    rewards, obs = [], []
    for t in range(S):
        state, o, r, *_ = senv.step(state, acts[t, rows])
        rewards.append(r.clone())
        obs.append(o.clone())
    local = {"y": state.y, "reward": torch.stack(rewards), "obs": torch.stack(obs)}
    gathered = {}
    for k, v in local.items():
        parts = [torch.empty_like(v) for _ in range(c.world)]
        dist.all_gather(parts, v.contiguous())
        gathered[k] = torch.cat(parts, dim=1 if k != "y" else 0)
    del senv, state, local
    out = None
    if c.rank == 0:
        env = _flagship(c, B)
        env.reset(c.gen(1))
        whole = env_state_from_numpy(arrs, c.dev)
        wr, wo = [], []
        for t in range(S):
            whole, o, r, *_ = env.step(whole, acts[t])
            wr.append(r)
            wo.append(o)
        same = {"y": torch.equal(gathered["y"], whole.y),
                "reward": torch.equal(gathered["reward"], torch.stack(wr)),
                "obs": torch.equal(gathered["obs"], torch.stack(wo))}
        _check(all(same.values()), f"the sharded fleet against one card: {same}")
        _check(bool(torch.stack(wr).isfinite().all()), "fleet check: rewards finite")
        print(f"fleet check: {B} envs x {G}^2 x {sz['substeps']} over {c.world} ranks against "
              f"one card, {S} steps from one numpy state: fields, rewards and obs bit for bit",
              flush=True)
        out = {"envs": B, "steps": S, "bit_for_bit": True}
    c.barrier()
    return out


def _events(c):
    import torch

    if c.dev.type == "cuda":
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    return None


def _timed_ms(c, fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls after one warm call, between
    barriers (the slowest rank's time); CUDA events on the card."""
    import torch

    fn()
    c.sync()
    c.barrier()
    if c.dev.type == "cuda":
        start, end = _events(c)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / reps
    c.barrier()
    return ms


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _sif3_reference(u, kappa, A, dt, n, h):
    """The FD-symbol semi-implicit 3D CH update with ``torch.fft`` on one card."""
    import numpy as np
    import torch

    N, M, K = u.shape[-3:]
    lam = sum(((2 * np.cos(2 * np.pi * np.arange(s) / s) - 2) / h**2).reshape(shape)
              for s, shape in ((N, (N, 1, 1)), (M, (1, M, 1)), (K, (1, 1, K))))
    lam = torch.from_numpy(lam).to(device=u.device, dtype=u.dtype)
    denom = 1.0 / (1.0 + A * dt * kappa * lam**2)
    for _ in range(n):
        incr = denom * (lam * torch.fft.fftn(u**3 - u, dim=(-3, -2, -1))
                        - kappa * lam**2 * torch.fft.fftn(u, dim=(-3, -2, -1)))
        u = u + dt * torch.fft.ifftn(incr, dim=(-3, -2, -1)).real
    return u


def _spatial(c):
    """(c): halo, distributed FFT and sharded SIF macros against the global op."""
    import torch

    from pde_opt_tpu_torch.ops.fused_spectral import ch_sif_macro_reference
    from pde_opt_tpu_torch.ops.stencils import lap_2nd_2d, lap_2nd_3d
    from pde_opt_tpu_torch.parallel import halo

    sz, P, r = c.sz, c.world, c.rank
    reps = sz["reps"]
    out = {}
    mu = lambda u: u**3 - u                                    # noqa: E731
    # --- 2D: one N x N field, rows split ---------------------------------
    N = sz["grid2d"]
    rows, cols = slice(r * N // P, (r + 1) * N // P), slice(r * N // P, (r + 1) * N // P)
    u = torch.randn((N, N), generator=c.gen(11), device=c.dev)     # the same on every card
    ul = u[rows].contiguous()
    lap_err = _rel(halo.sharded_lap_2nd_2d(ul, HX, HY), lap_2nd_2d(u, HX, HY)[rows])
    uc = u.to(torch.complex64)
    f_glob = torch.fft.fft2(uc)
    f_loc = halo.distributed_fft2(ul.to(torch.complex64))
    fft_err = _rel(f_loc, f_glob[:, cols])
    back_err = _rel(halo.distributed_ifft2(f_loc).real, ul)
    del f_glob
    a = torch.fft.fft(ul.to(torch.complex64), dim=-1).reshape(N // P, P, N // P)
    split = {
        "local_fft_rows_ms": _timed_ms(c, lambda: torch.fft.fft(ul.to(torch.complex64), dim=-1),
                                       reps),
        "all_to_all_ms": _timed_ms(c, lambda: halo._transpose(a, None, split=1, concat=0), reps),
        "local_fft_cols_ms": _timed_ms(c, lambda: torch.fft.fft(f_loc, dim=-2), reps),
        "distributed_fft2_ms": _timed_ms(c, lambda: halo.distributed_fft2(ul), reps),
        "one_card_fft2_ms": _timed_ms(c, lambda: torch.fft.fft2(uc), reps),
    }
    del a, uc, f_loc
    n = sz["sif_substeps"]
    us = 0.5 + 0.05 * torch.randn((N, N), generator=c.gen(12), device=c.dev)
    macro = halo.make_sharded_sif_ch_macro(mu, N, N, HX, HY, SIF["A"], SIF["dt"], n)
    got = macro(us[rows].contiguous(), SIF["kappa"])
    want = ch_sif_macro_reference(mu, HX, HY, SIF["A"], SIF["dt"], n)(us, SIF["kappa"])[rows]
    sif_err = float((got - want).abs().max())
    _check(bool(got.isfinite().all()), "SIF 2D finite")
    sif_ms = _timed_ms(c, lambda: macro(us[rows].contiguous(), SIF["kappa"]), max(1, reps // 2))
    del us, got, want
    out["2d"] = {"grid": N, "lap_rel_err": lap_err, "fft_rel_err": fft_err,
                 "ifft_rel_err": back_err, "sif_max_abs_err": sif_err, "sif_ms": sif_ms, **split}
    # --- 3D: one N3^3 volume, first axis split ---------------------------
    N3 = sz["grid3d"]
    rows3 = slice(r * N3 // P, (r + 1) * N3 // P)
    v = torch.randn((N3, N3, N3), generator=c.gen(13), device=c.dev)
    vl = v[rows3].contiguous()
    lap3_err = _rel(halo.sharded_lap_2nd_3d(vl, HX, HY, HX), lap_2nd_3d(v, HX, HY, HX)[rows3])
    f3 = halo.distributed_fft3(vl.to(torch.complex64))
    fft3_err = _rel(f3, torch.fft.fftn(v.to(torch.complex64))[:, rows3])
    back3_err = _rel(halo.distributed_ifft3(f3).real, vl)
    b = torch.fft.fftn(vl.to(torch.complex64), dim=(-2, -1)).reshape(N3 // P, P, N3 // P, N3)
    split3 = {
        "local_fft_planes_ms": _timed_ms(
            c, lambda: torch.fft.fftn(vl.to(torch.complex64), dim=(-2, -1)), reps),
        "all_to_all_ms": _timed_ms(c, lambda: halo._transpose(b, None, split=1, concat=0), reps),
        "local_fft_lines_ms": _timed_ms(c, lambda: torch.fft.fft(f3, dim=-3), reps),
        "distributed_fft3_ms": _timed_ms(c, lambda: halo.distributed_fft3(vl), reps),
        "one_card_fftn_ms": _timed_ms(c, lambda: torch.fft.fftn(v.to(torch.complex64)), reps),
    }
    del b, f3
    vs = 0.5 + 0.05 * torch.randn((N3, N3, N3), generator=c.gen(14), device=c.dev)
    macro3 = halo.make_sharded_sif_ch3d_macro(mu, N3, N3, N3, HX, HX, HX, SIF["A"], SIF["dt"], n)
    got3 = macro3(vs[rows3].contiguous(), SIF["kappa"])
    want3 = _sif3_reference(vs, SIF["kappa"], SIF["A"], SIF["dt"], n, HX)[rows3]
    sif3_err = float((got3 - want3).abs().max())
    _check(bool(got3.isfinite().all()), "SIF 3D finite")
    sif3_ms = _timed_ms(c, lambda: macro3(vs[rows3].contiguous(), SIF["kappa"]), max(1, reps // 2))
    out["3d"] = {"grid": N3, "lap_rel_err": lap3_err, "fft_rel_err": fft3_err,
                 "ifft_rel_err": back3_err, "sif_max_abs_err": sif3_err, "sif_ms": sif3_ms,
                 **split3}
    errs = {"lap": max(lap_err, lap3_err), "fft": max(fft_err, back_err, fft3_err, back3_err),
            "sif": max(sif_err, sif3_err)}
    _check(errs["lap"] <= TOL_LAP and errs["fft"] <= TOL_FFT and errs["sif"] <= TOL_SIF,
           f"spatial decomposition on rank {r}: {errs} against lap {TOL_LAP}, fft {TOL_FFT}, "
           f"sif {TOL_SIF}")
    c.say(f"spatial {N}^2 over {P} ranks: lap rel err {lap_err:.3e}, fft2 {fft_err:.3e}, ifft2 "
          f"{back_err:.3e}, SIF x{n} max abs err {sif_err:.3e} ({sif_ms:.4f} ms a call); split "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    c.say(f"spatial {N3}^3 over {P} ranks: lap rel err {lap3_err:.3e}, fft3 {fft3_err:.3e}, "
          f"ifft3 {back3_err:.3e}, SIF x{n} max abs err {sif3_err:.3e} ({sif3_ms:.4f} ms a "
          "call); split " + ", ".join(f"{k} {v:.4f}" for k, v in split3.items()))
    return out


def _ppo(c):
    """(d): ppo_train(mesh=...) at run_ppo's shape a card."""
    import torch
    import torch.distributed as dist

    from pde_opt_tpu_torch.ops import kernels
    from pde_opt_tpu_torch.parallel import make_mesh
    from pde_opt_tpu_torch.rl import ActorCriticMLP, PPOConfig, ppo_train

    sz = c.sz
    G, T = sz["grid"], sz["ppo_t"]
    n_updates = sz["ppo_warm"] + sz["ppo_timed"]
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=4, lr=3e-4)
    compute = torch.bfloat16 if c.dev.type == "cuda" else None

    def net():
        return ActorCriticMLP(1, (G // 4) ** 2, widths=(256,), features=64, compute_dtype=compute,
                              generator=c.gen(70), device=c.dev)

    def run(num_envs, mesh):
        env = _flagship(c, num_envs, derivs="pallas", obs_downsample=4)
        stamps, equal, counts = [], [], []
        model = net()

        def log(update, metrics):
            c.sync()
            stamps.append(time.perf_counter())
            counts.append(kernels.launch_counts()["ch_cas_macro_ep"])
            kernels.reset_launch_counts()
            if mesh is not None:
                flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
                parts = [torch.empty_like(flat) for _ in range(c.world)]
                dist.all_gather(parts, flat)
                equal.append(all(torch.equal(p, parts[0]) for p in parts))
            _check(all(math.isfinite(v) for v in metrics.values()), f"PPO metrics {metrics}")
            stamps.append(time.perf_counter())

        kernels.reset_launch_counts()
        ppo_train(env, model, cfg, n_updates, generator=c.gen(71), env_generator=c.gen(72),
                  log_fn=log, mesh=mesh)
        # Update i runs from the end of update i-1's log to the start of its own.
        ms = [1e3 * (stamps[2 * i] - stamps[2 * i - 1]) for i in range(1, n_updates)]
        return sum(ms[sz["ppo_warm"] - 1:]) / sz["ppo_timed"], equal, counts

    mesh = make_mesh(c.dev.type)
    ms = {"sharded": [], "local": []}
    for kind in ("sharded", "local", "local", "sharded"):          # in turns
        c.barrier()
        if kind == "sharded":
            t, equal, counts = run(sz["envs"] * c.world, mesh)
            _check(all(equal) and len(equal) == n_updates,
                   f"PPO parameters equal across ranks: {equal}")
            _check(all(k == T for k in counts[1:]), f"PPO: {T} K1 launches an update ({counts})")
        else:
            t, _, _ = run(sz["envs"], None)
        ms[kind].append(t)
    c.barrier()
    sharded_ms, local_ms = (sum(ms[k]) / len(ms[k]) for k in ("sharded", "local"))
    share = max(0.0, (sharded_ms - local_ms) / sharded_ms)
    c.say(f"ppo_train(mesh=...): {sz['envs']} envs a rank x {c.world} ranks, T {T}: "
          f"{sharded_ms:.4f} ms an update ({sz['envs'] * c.world * T / sharded_ms * 1e3:.1f} "
          f"trained env-steps/s; runs {ms['sharded'][0]:.4f}, {ms['sharded'][1]:.4f}) against "
          f"{local_ms:.4f} ms for one rank's envs alone (runs {ms['local'][0]:.4f}, "
          f"{ms['local'][1]:.4f}): collectives' share {share:.4f}; parameters equal on every "
          f"rank after each of {n_updates} updates; {T} K1 launches an update")
    return {"update_ms": sharded_ms, "local_update_ms": local_ms, "runs_ms": ms,
            "collective_share": share, "params_equal_every_update": True, "k1_per_update": T}


def _count_plain_launches():
    """The CPU rehearsal: the CH macro's plain versions, which CPU tensors
    run, count the launches the kernels would make on the card."""
    from pde_opt_tpu_torch.ops import cas_spectral, kernels

    fwd, bwd = cas_spectral.ch_cas_macro_plain, cas_spectral.ch_cas_macro_bwd_plain

    def counted(*args, **kw):
        kernels.count_launch("ch_cas_macro" if kw.get("epilogue") is None else "ch_cas_macro_ep")
        return fwd(*args, **kw)

    def counted_bwd(*args, **kw):
        kernels.count_launch("ch_cas_macro_bwd")
        return bwd(*args, **kw)

    cas_spectral.ch_cas_macro_plain = counted
    cas_spectral.ch_cas_macro_bwd_plain = counted_bwd


def _worker(rank, world, address, backend, size):
    import torch
    import torch.distributed as dist

    from pde_opt_tpu_torch.parallel import init_distributed
    from pde_opt_tpu_torch.parallel.dryrun import dryrun_multichip

    if backend == "gloo":
        torch.set_num_threads(1)
        _count_plain_launches()
    init_distributed(address, world, rank, backend=backend,
                     timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda" if backend == "nccl" else "cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    c = _Ctx(rank, world, dev, SIZES[size])
    try:
        t0 = time.perf_counter()
        result = {"weak_scaling": _weak_scaling(c)}
        # (a) again with one intra-op thread a rank: idle OpenMP threads of
        # four processes can take the cores that pace their hosts.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        result["weak_scaling_one_thread"] = _weak_scaling(c)
        torch.set_num_threads(threads)
        result["fleet_check"] = _fleet_check(c)
        result["spatial"] = _spatial(c)
        result["ppo"] = _ppo(c)
        result["multichip_scaling"] = dryrun_multichip(world)
        result["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(result), flush=True)


def main(argv=None):
    import socket

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="rehearse on N gloo processes at small sizes")
    args = p.parse_args(argv)
    if args.cpu:
        world, backend, size = args.cpu, "gloo", "cpu"
        print(f"rehearsal on the CPU: {world} gloo processes, small sizes", flush=True)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("torch_multichip.py needs CUDA cards (or --cpu N to rehearse)")
        world, backend, size = torch.cuda.device_count(), "nccl", "card"
        for line in _card_lines():
            print(line, flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {world} x "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        from pde_opt_tpu_torch.ops import kernels

        t0 = time.perf_counter()
        kernels.load_libraries("ch_cas_macro")
        print(f"build: ch_cas_macro (K1-K3) once for every rank, {time.perf_counter() - t0:.2f} s",
              flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(_worker, args=(world, f"127.0.0.1:{port}", backend, size),
                                nprocs=world)


if __name__ == "__main__":
    main()
