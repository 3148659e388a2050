"""Where the inverse-problem layer's time goes on one CUDA card, at the
shapes of chip_smoke.py's phase 11 (pde_opt_tpu_torch/bench/inverse.py):

* ``jacobian``: one Levenberg-Marquardt Jacobian of the 32^3 Legendre fit
  (``torch.func.jacfwd`` over 5 parameters through 2 windows x 8 substeps
  of the SIF step, f32);
* ``lm_loss``: one loss evaluation of the same fit (what each damping try
  costs);
* ``nn_value_grad``: one value and gradient of the 128^2 NN-mu fit's MSE
  (what each L-BFGS evaluation costs; checkpointed rollout).

For each it prints the wall time (host clock to a synchronisation, mean of
REPS calls after a warm-up) and, from ``torch.profiler`` over one call, the
kernels launched, the device's busy time (the union of the kernels'
intervals), its idle share over the wall time, the host time per kernel,
and the kernels by count (the top 8).

Needs one CUDA card; from the repository root:

    python3 scripts/torch_inverse_profile.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPS = 3


def _wall(torch, fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / REPS


def _profile(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]
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
    counts = {}
    for e in kern:
        counts[e.name[:90]] = counts.get(e.name[:90], 0) + 1
    aten = sum(1 for e in prof.events() if e.device_type != cuda and e.name.startswith("aten::"))
    return {"profiled_wall_ms": wall, "kernels": len(kern), "aten_calls": aten,
            "device_busy_ms": busy / 1e3, "device_idle_share": 1.0 - busy / 1e3 / wall,
            "host_us_per_kernel": 1e3 * wall / max(len(kern), 1),
            "top_kernels_by_count": dict(sorted(counts.items(), key=lambda kv: -kv[1])[:8])}


def main():
    import torch

    from pde_opt_tpu_torch.bench.inverse import legendre_fit_3d, nn_mu_fit_2d

    if not torch.cuda.is_available():
        raise SystemExit("torch_inverse_profile.py needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    fit3 = legendre_fit_3d(dev)
    nn = nn_mu_fit_2d(dev)

    def lm_loss():
        with torch.no_grad():
            return float(0.5 * fit3.residuals(fit3.start())[0].pow(2).sum())

    def nn_value_grad():
        net = nn.start()["mu"]
        loss = nn.residuals({"mu": net}, adjoint="checkpoint")[0].pow(2).mean()
        torch.autograd.grad(loss, list(net.parameters()))

    out = {}
    for name, fn in (("jacobian", fit3.jacobian), ("lm_loss", lm_loss),
                     ("nn_value_grad", nn_value_grad)):
        out[name] = {"wall_ms": _wall(torch, fn), **_profile(torch, fn)}
    print(json.dumps(out, indent=1) + f"\n[{card}]", flush=True)


if __name__ == "__main__":
    main()
