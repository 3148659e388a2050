"""What the port's spans (``utils/metrics.py`` ``named_scope``) cost and how
well they sit on the profiler's clock, on one CUDA card, at the shape of the
benchmark's ``ch64.rollout`` cell: 4096 CH envs of 64², 10 substeps, the
fused macro (K1) with its epilogue, the full uint8 obs, a uniform random
policy, 64-step segments each ended by ``torch.cuda.synchronize()``.

It prints one JSON object:

* ``flag``: whether ``torch.autograd.profiler._is_profiler_enabled`` (the
  spans' switch) is set inside a CUDA-only and a CPU + CUDA session;
  ``record_function``'s µs a call, and an empty span's µs, with no session,
  after ``record_spans(True)`` (the span) and inside each session;
* ``untraced``: host µs a step over untraced windows of SEGS segments,
  spans off (``record_spans(False)``) and on (``record_spans(True)``) in
  turns, RUNS windows each: each window's value, the medians and the
  spreads (quartile distance over the median), and the median of the
  paired differences (on less off);
* ``device_only``: the same inside a CUDA-only profiler session (spans on
  there), the env's spans as they are against the env's ``named_scope``
  replaced by the off context, in turns, DEV_RUNS windows each;
* ``clock``: over one ``trace_scope`` window, each ``vector_env.step``
  span of ``spans.json`` against its range in ``trace.json``: the median,
  smallest and largest distance of the starts and of the ends, in µs, the
  range's less the span's.

    python3 scripts/torch_spans_profile.py
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

B, GRID, SUBSTEPS, T = 4096, 64, 10, 64
SEGS, RUNS, DEV_SEGS, DEV_RUNS = 16, 6, 4, 3


def _spread(v):
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / statistics.median(v)


def _summary(v):
    return {"runs": v, "median": statistics.median(v), "spread": _spread(v)}


def _per_call_us(scope, n=20000):
    t0 = time.perf_counter()
    for _ in range(n):
        with scope("probe"):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def main():
    import torch
    import torch.autograd.profiler as ap
    from torch.profiler import ProfilerActivity, profile

    from pde_opt_tpu_torch.envs import vector_env
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.ops import kernels
    from pde_opt_tpu_torch.utils import metrics

    if not torch.cuda.is_available():
        raise SystemExit("torch_spans_profile.py needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, torch.__version__, flush=True)
    kernels.load_libraries("ch_cas_macro")

    rf = torch.profiler.record_function
    flag = {"none": ap._is_profiler_enabled, "rf_us_none": _per_call_us(rf),
            "span_us_none": _per_call_us(metrics.named_scope)}
    metrics.record_spans(True)
    flag["span_us_record_spans"] = _per_call_us(metrics.named_scope)
    metrics.record_spans(False)
    for key, acts in (("cuda_only", [ProfilerActivity.CUDA]),
                      ("cpu_cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        n = 2000 if key == "cpu_cuda" else 20000
        with profile(activities=acts):
            flag[key] = ap._is_profiler_enabled
            flag[key + "_c"] = torch._C._autograd._profiler_enabled()
            flag["rf_us_" + key] = _per_call_us(rf, n)
            flag["span_us_" + key] = _per_call_us(metrics.named_scope, n)
    metrics.clear_spans()
    out = {"card": card, "torch": torch.__version__, "flag": flag}

    env = make_cahn_hilliard_control_env(B, GRID, SUBSTEPS, spectral_solve="fused",
                                         obs_downsample=1, device=dev)
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    run = env.make_rollout(lambda o, g: env.sample_actions(g), T)

    def window(segs):
        """Host µs a step over ``segs`` segments, each ended by a sync."""
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(segs):
            state, _, _ = run(state, gen)
            torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / (segs * T)

    for _ in range(3):
        window(1)
    off, on = [], []
    for _ in range(RUNS):
        metrics.record_spans(False)
        off.append(window(SEGS))
        metrics.record_spans(True)
        on.append(window(SEGS))
        metrics.record_spans(False)
    metrics.clear_spans()
    out["untraced"] = {"spans_off_us": _summary(off), "spans_on_us": _summary(on),
                       "on_less_off_us": statistics.median(b - a for a, b in zip(off, on))}

    def traced(segs):
        with profile(activities=[ProfilerActivity.CUDA]):
            window(1)
            return window(segs)

    real = vector_env.named_scope
    kept, cut = [], []
    for _ in range(DEV_RUNS):
        kept.append(traced(DEV_SEGS))
        vector_env.named_scope = lambda *a, **k: metrics._OFF
        try:
            cut.append(traced(DEV_SEGS))
        finally:
            vector_env.named_scope = real
    metrics.clear_spans()
    out["device_only"] = {"spans_us": _summary(kept), "no_spans_us": _summary(cut),
                          "spans_less_none_us": statistics.median(
                              a - b for a, b in zip(kept, cut))}

    logdir = tempfile.mkdtemp(prefix="spans_profile_")
    with metrics.trace_scope(logdir):
        window(1)
    with open(os.path.join(logdir, "trace.json")) as f:
        ranges = sorted((e for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "user_annotation" and e.get("name") == "vector_env.step"),
                        key=lambda e: e["ts"])
    with open(os.path.join(logdir, "spans.json")) as f:
        mine = [s for s in json.load(f)["spans"] if s["name"] == "vector_env.step"]
    starts = [r["ts"] - s["ts"] for s, r in zip(mine, ranges)]
    ends = [r["ts"] + r["dur"] - s["ts"] - s["dur"] for s, r in zip(mine, ranges)]
    out["clock"] = {"steps": [len(mine), len(ranges)],
                    "start_gap_us": [statistics.median(starts), min(starts), max(starts)],
                    "end_gap_us": [statistics.median(ends), min(ends), max(ends)]}
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
