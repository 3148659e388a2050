"""Where one PPO update's time goes on one CUDA card, at bench.py's run_ppo
shape (the shape of chip_smoke.py's phase 8): 4096 envs x 64^2 x 10
substeps, derivs="pallas", the fused epilogue (kernel K1) with
obs_downsample 4, the bf16 ActorCriticMLP 256 -> 256 -> 64, T = 64, 2
epochs x 4 minibatches, lr 3e-4.

After WARM updates it prints:

* the update's wall time (host clock to one synchronisation, TIMED updates)
  and, the same way, the rollout alone (``train_step.rollout``) and a
  random-policy rollout of the same env (the physics floor);
* from ``torch.profiler`` over PROFILED updates: the host time of each of
  ``rl/ppo.py``'s named scopes (``ppo/rollout``, ``ppo/advantages``,
  ``ppo/epoch``), the number of kernels launched, the device's busy time
  (the union of the kernels' intervals) and its idle share over the
  kernels' span, and device time by kernel name (the top 15).

Needs one CUDA card; from the repository root:

    python3 scripts/torch_ppo_profile.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WARM, TIMED, PROFILED = 2, 4, 2
B, GRID, SUBSTEPS, T = 4096, 64, 10, 64


def _wall(torch, n, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.ops import kernels
    from pde_opt_tpu_torch.rl import ActorCriticMLP, PPOConfig, Sampler, make_ppo_train_step

    if not torch.cuda.is_available():
        raise SystemExit("torch_ppo_profile.py needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.load_libraries("ch_cas_macro")

    env = make_cahn_hilliard_control_env(B, GRID, SUBSTEPS, derivs="pallas",
                                         spectral_solve="fused", obs_downsample=4, device=dev)
    net = ActorCriticMLP(1, (GRID // 4) ** 2, widths=(256,), features=64,
                         compute_dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(70), device=dev)
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=4, lr=3e-4)
    train_step, optimizer = make_ppo_train_step(env, cfg)
    opt = optimizer(net.parameters())
    sampler = Sampler(torch.Generator(device=dev).manual_seed(71))
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(72))

    def update():
        nonlocal state
        state, _ = train_step(net, opt, state, sampler)

    def rollout():
        nonlocal state
        state, _, _ = train_step.rollout(net, state, sampler)

    run = env.make_rollout(lambda o, g: env.sample_actions(g), T)
    gen = torch.Generator(device=dev).manual_seed(74)

    def floor():
        nonlocal state
        state, _, _ = run(state, gen)

    for _ in range(WARM):
        update()
    out = {"update_ms": _wall(torch, TIMED, update),
           "rollout_ms": _wall(torch, TIMED, rollout),
           "physics_floor_ms": _wall(torch, TIMED, floor)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            update()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    scopes = {}
    for e in prof.events():
        if e.device_type != cuda and e.name.startswith("ppo/"):
            scopes[e.name] = (scopes.get(e.name, 0.0)
                              + (e.time_range.end - e.time_range.start) / 1e3 / PROFILED)
    # Device work: kernels, copies and fills; not the scopes' GPU-side ranges.
    kern = [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("ppo/", "Optimizer."))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (spans[-1][1] - spans[0][0]) if spans else 0.0
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    out.update({
        "scopes_host_ms": scopes,
        "kernels_per_update": len(kern) / PROFILED,
        "device_busy_ms": busy / 1e3 / PROFILED,
        "device_span_ms": span / 1e3 / PROFILED,
        "device_idle_share": (1.0 - busy / span) if span else None,
        "top_kernels_ms": {k[:110]: v / 1e3 / PROFILED for k, v in top},
    })
    print(json.dumps(out, indent=1) + f"\n[{card}]", flush=True)


if __name__ == "__main__":
    main()
