#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

The main path is the flagship Cahn-Hilliard control fleet at full size:
4096 envs on a 64x64 periodic grid, 10 semi-implicit substeps per RL step,
per-env kappa control, reward -var, uint8 observation, auto-reset on.
Phases (each passes or raises; nothing is caught):

1. Require a CUDA device; print the card's name and power limit.
2. Build the hand-written Hopper kernel from ``pde_opt_tpu_torch/csrc``.
3. Hold the kernel (K2 without, K1 with the env epilogue, obs_downsample 1
   and 4) against its plain-torch version on the card at the main-path
   shapes, with f32 and bf16 matrices, and against the FFT oracle.
4. Reset the launch counts, then drive the main path: a 120-step
   random-policy rollout of the fused-epilogue fleet (K1), which crosses
   the episode end and its auto-reset, and 10 steps of the same fleet
   without the fused epilogue (K2).  Check the rewards, the launch counts,
   the per-env mass drift and the epilogue reward against the env's own
   reward function; poison one env with NaN and check it is flagged and
   reset.
5. Time the kernels against their plain versions with CUDA events, the
   auto-reset block, and the rollout's env-steps/s.

The last two lines are a JSON object per kernel and the JSON result line.
"""

import json
import subprocess
import sys
import time

NUM_ENVS, GRID, SUBSTEPS, STEPS, K2_STEPS = 4096, 64, 10, 120, 10
HX = HY = 0.01                 # the preset's grid: L = 0.01 * grid_size
DT, A = 0.01 / SUBSTEPS, 1.0   # the preset's substep and splitting constant
CENTER = 0.5                   # the preset's stats_center
TOL_U = {"f32": 1e-5, "bf16": 1e-3}      # kernel vs plain, field
TOL_ORACLE = {"f32": 1e-5, "bf16": 5e-3}  # macro vs FFT oracle, field
SOURCE = "pde_opt_tpu_torch/csrc/ch_cas_macro.cu"
REPLACES = {"ch_cas_macro_ep": "pde_opt_tpu/ops/cas_spectral.py:630",
            "ch_cas_macro": "pde_opt_tpu/ops/cas_spectral.py:392"}


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def main():
    import torch

    from pde_opt_tpu_torch.envs.presets import CH_MU, make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.ops import kernels
    from pde_opt_tpu_torch.ops.cas_spectral import (
        Epilogue,
        cas_constants,
        ch_cas_macro_cuda,
        ch_cas_macro_plain,
        ch_cas_macro_reference,
    )

    # ---- 1. the card ----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    dev = torch.device("cuda")
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_library("ch_cas_macro")
    print(f"build: {SOURCE} in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel vs plain on the card, main-path shapes ---------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    # Around 0.45, so sum(u - CENTER) is far from 0 and its rtol is meaningful.
    u = 0.45 + 0.05 * torch.randn((NUM_ENVS, GRID, GRID), generator=gen, device=dev)
    kap = 2e-3 + 8e-3 * torch.rand((NUM_ENVS,), generator=gen, device=dev)
    max_err = {"ch_cas_macro": 0.0, "ch_cas_macro_ep": 0.0}
    for mats, mdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        consts = cas_constants(GRID, GRID, HX, HY, mdt, dev)
        for ep in (None, Epilogue(255.0, 0.0, CENTER, 1), Epilogue(255.0, 0.0, CENTER, 4)):
            kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS,
                      round_bf16=mdt == torch.bfloat16, epilogue=ep)
            got = ch_cas_macro_cuda(u, kap, consts, **kw)
            want = ch_cas_macro_plain(u, kap, consts, **kw)
            torch.cuda.synchronize()
            if ep is None:
                got, want = (got,), (want,)
            err = (got[0] - want[0]).abs().max().item()
            name = "ch_cas_macro_ep" if ep else "ch_cas_macro"
            line = f"check {name} mats={mats} ds={ep.ds if ep else '-'}: u1 max_abs_err {err:.3e}"
            _check(err <= TOL_U[mats], f"{line} > {TOL_U[mats]}")
            if ep is not None:
                _check(torch.equal(got[1][:, 2], want[1][:, 2]), f"{line}: n_finite differs")
                rel = ((got[1][:, :2] - want[1][:, :2]).abs()
                       / want[1][:, :2].abs()).max().item()
                lsb = (got[2].int() - want[2].int()).abs().max().item()
                line += f", stats max_rel_err {rel:.3e}, obs max_lsb {lsb}"
                _check(rel <= 1e-3, f"{line}: stats rtol 1e-3")
                _check(lsb <= 1, f"{line}: obs > 1 LSB")
                _check(got[2].shape == (NUM_ENVS, GRID // ep.ds, GRID // ep.ds)
                       and got[2].dtype == torch.uint8, f"{line}: obs shape/dtype")
            print(line, flush=True)
            if mats == "bf16":
                max_err[name] = max(max_err[name], err)
        oracle = ch_cas_macro_reference(CH_MU, HX, HY, A, DT, SUBSTEPS)(u, kap)
        got = ch_cas_macro_cuda(u, kap, consts, mu_fn=CH_MU, dt=DT, A=A,
                                n_steps=SUBSTEPS, round_bf16=mdt == torch.bfloat16)
        err = (got - oracle).abs().max().item()
        print(f"check ch_cas_macro mats={mats} vs FFT oracle: max_abs_err {err:.3e}",
              flush=True)
        _check(err <= TOL_ORACLE[mats], f"kernel vs FFT oracle {err} > {TOL_ORACLE[mats]}")

    # ---- 4. the main path ------------------------------------------------
    env = make_cahn_hilliard_control_env(
        num_envs=NUM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
        spectral_solve="fused", device=dev)
    env0 = make_cahn_hilliard_control_env(
        num_envs=NUM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
        spectral_solve="fused", fused_epilogue=False, device=dev)

    def policy(obs, g):
        return env.sample_actions(g)

    # Warm the env glue (allocator, generators) on a throwaway fleet.
    state, _ = env.reset(gen)
    env.make_rollout(policy, 2)(state, gen)
    state0, _ = env0.reset(gen)
    env0.make_rollout(policy, 2)(state0, gen)

    # The step at which the f32 episode clock first reaches end_time.
    t, end_step = torch.zeros((), dtype=torch.float32), 0
    while not bool(t >= env.end_time - 1e-9):
        t, end_step = t + env.step_dt, end_step + 1
    _check(end_step < STEPS, "the rollout must cross the episode end")

    state, _ = env.reset(gen)
    mean0 = state.y.mean(dim=(-2, -1))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    # A rollout step must never wait for the device: make any synchronising
    # call inside the timed windows an error.
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rew_a, term_a = env.make_rollout(policy, end_step - 1)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    mean1 = state.y.mean(dim=(-2, -1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    state, rew_b, term_b = env.make_rollout(policy, STEPS - end_step + 1)(state, gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    k1_launches = kernels.launch_counts()["ch_cas_macro_ep"]
    state0 = env.reset(gen)[0]
    state0, rew0, _ = env0.make_rollout(policy, K2_STEPS)(state0, gen)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    rewards = torch.cat([rew_a, rew_b])
    terms = torch.cat([term_a, term_b])
    print(f"main path: {STEPS}-step rollout of {NUM_ENVS} envs x {GRID}^2 x "
          f"{SUBSTEPS} substeps; episode end at step {end_step}; "
          f"launches {counts}", flush=True)
    _check(rewards.shape == (STEPS, NUM_ENVS), "rewards shape")
    _check(bool(torch.isfinite(rewards).all()), "non-finite rewards")
    _check(bool(torch.isfinite(rew0).all()), "non-finite rewards without the epilogue")
    _check(k1_launches == STEPS, f"K1 launches {k1_launches} != {STEPS}")
    _check(counts["ch_cas_macro_ep"] == STEPS, f"K1 launches {counts}")
    _check(counts["ch_cas_macro"] == K2_STEPS, f"K2 launches {counts}")
    _check(bool(terms[end_step - 1].all()), "every env must end its episode at the end step")
    kept = ~term_a.any(dim=0)
    _check(int(kept.sum()) > 0, "no env ran to the episode end")
    drift = (mean1 - mean0)[kept].abs().max().item()
    print(f"mass drift over {end_step - 1} steps on {int(kept.sum())} envs that "
          f"did not reset: max |mean change| {drift:.3e}", flush=True)
    _check(drift < 1e-3, f"per-env mean drift {drift} >= 1e-3")
    _check(bool(torch.isfinite(state.y).all()) and state.y.shape == (NUM_ENVS, GRID, GRID),
           "final field")
    _check(int(state.step_count.max()) == STEPS - end_step, "step counts after the reset")
    # The epilogue's reward equals the env's own -var on the field it emitted
    # (the last step reset no env, so state.y is that field).
    _check(not bool(term_b[-1].any()), "the last step must not reset")
    plain_reward = env.reward_function(state.y)
    rel = ((rew_b[-1] - plain_reward).abs() / plain_reward.abs()).max().item()
    print(f"epilogue reward vs -var of the field: max_rel_err {rel:.3e}", flush=True)
    _check(rel < 1e-3, "epilogue reward disagrees with -var")

    state.y[7] = float("nan")
    state, obs, reward, terminated, _, info = env.step(state, env.sample_actions(gen))
    torch.cuda.synchronize()
    _check(bool(info["diverged"][7]) and int(info["diverged"].sum()) == 1, "NaN env not flagged")
    _check(bool(terminated[7]) and float(reward[7]) == 0.0, "NaN env not terminated")
    _check(bool(torch.isfinite(state.y).all()) and int(state.step_count[7]) == 0,
           "NaN env not reset")
    _check(obs.shape == (NUM_ENVS, 1, GRID, GRID) and obs.dtype == torch.uint8, "obs")
    print("poisoned env 7: flagged diverged, reward 0, reset", flush=True)

    # ---- 5. timings ------------------------------------------------------
    consts = cas_constants(GRID, GRID, HX, HY, torch.bfloat16, dev)
    timings = {}
    for name, ep in (("ch_cas_macro_ep", Epilogue(255.0, 0.0, CENTER, 1)),
                     ("ch_cas_macro", None)):
        kw = dict(mu_fn=CH_MU, dt=DT, A=A, n_steps=SUBSTEPS, round_bf16=True, epilogue=ep)

        def plain():
            ch_cas_macro_plain(u, kap, consts, **kw)

        def kernel():
            ch_cas_macro_cuda(u, kap, consts, **kw)

        p1, k1, k2, p2 = (_time_ms(torch, f) for f in (plain, kernel, kernel, plain))
        timings[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        flops = 4 * GRID * GRID * (GRID + GRID) * SUBSTEPS * NUM_ENVS
        print(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
              f"at {NUM_ENVS}x{GRID}^2x{SUBSTEPS} bf16; kernel "
              f"{flops / (timings[name][0] * 1e-3) / 1e12:.2f} TFLOP/s [{card}]", flush=True)

    y1 = state.y.clone()
    cv1 = state.control_value.clone()
    obs1 = env.state_to_observation_func(y1)
    none = torch.zeros((NUM_ENVS,), dtype=torch.bool, device=dev)
    reset_ms = _time_ms(torch, lambda: env._auto_reset(none, y1, cv1, obs1))
    step_ms = (t_a + t_b) / STEPS * 1e3
    rate = NUM_ENVS * STEPS / (t_a + t_b)
    print(f"time auto-reset block (fleet-wide draw + selects): {reset_ms:.4f} ms per step, "
          f"{reset_ms / step_ms:.3%} of a {step_ms:.4f} ms env step [{card}]", flush=True)
    print(f"rollout: {rate:.1f} env-steps/s ({STEPS} steps in {t_a + t_b:.4f} s, "
          f"{NUM_ENVS} envs x {GRID}^2 x {SUBSTEPS} substeps) [{card}]", flush=True)

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": counts[name], "max_abs_err": max_err[name],
         "ms": timings[name][0], "plain_ms": timings[name][1]}
        for name in ("ch_cas_macro_ep", "ch_cas_macro")
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
