"""Where the rotating-frame GPE's and the Shape flow's time goes on one CUDA
card, at the shapes of chip_smoke.py's phase 12:

* ``adi_call`` / ``fft_call``: one call of bench.py's run_gpe_rot (512
  fields of 64^2, 50 imaginary-time substeps) through the matmul ADI macro
  and through ``DirectionalSplitting``;
* ``fleet_step_fused`` / ``fleet_step_fft``: one step of the stirring fleet
  (1024 envs x 64^2 x 10 substeps, a random action);
* ``shape_step``: one Tsit5 step and its error norm of the SBM preset's 64^2
  ``Shape`` smoothing flow (what each of its ~16k steps costs).

For each it prints the wall time (host clock to a synchronisation, mean of
REPS calls after a warm-up), the host's enqueue time of one call (host clock
without the synchronisation) and, from ``torch.profiler`` over one call, the
kernels launched, the device's busy time, its idle share, the host time per
kernel and the kernels by count (``torch_inverse_profile._profile``).

Needs one CUDA card; from the repository root:

    python3 scripts/torch_rot_profile.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_inverse_profile import _profile, _wall  # noqa: E402


def _enqueue_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def main():
    import numpy as np
    import torch

    from pde_opt_tpu_torch.envs.presets import make_gpe_rot_control_env
    from pde_opt_tpu_torch.geometry import Shape
    from pde_opt_tpu_torch.grid import Domain
    from pde_opt_tpu_torch.models.gross_pitaevskii import GPE2DTSRot
    from pde_opt_tpu_torch.ops.gpe_rot_fast import make_rot_adi_macro
    from pde_opt_tpu_torch.ops.integrate import _rms_norm, evolve
    from pde_opt_tpu_torch.ops.steppers import DirectionalSplitting, Tsit5
    from pde_opt_tpu_torch.utils import density, initialize_Psi

    if not torch.cuda.is_available():
        raise SystemExit("torch_rot_profile.py needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    B, N, n, dt = 512, 64, 50, 2e-4
    dom = Domain((N, N), ((-10.0, 10.0),) * 2)
    eq = GPE2DTSRot(dom, 500.0, 0.0, 0.9, device=dev)
    dx = float(dom.dx[0])
    psi0 = initialize_Psi(N, width=14, vortexnumber=1, device=dev)
    y0 = (psi0 / torch.sqrt(density(psi0).sum() * dx * dx)).expand(B, N, N).contiguous()
    macro = make_rot_adi_macro(eq.A_terms, eq.B_terms, dx, N, N, dt, n, time_scale=-1j)
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms, dx, time_scale=-1j)

    gen = torch.Generator(device=dev).manual_seed(0)
    fleets = {}
    for solve in ("fused", "fft"):
        env = make_gpe_rot_control_env(num_envs=1024, grid_size=N, substeps=10,
                                       spectral_solve=solve, device=dev)
        state, _ = env.reset(gen)
        fleets[solve] = (env, state)

    def fleet_step(solve):
        env, state = fleets[solve]
        return lambda: env.step(state, env.sample_actions(gen))

    X, Y = Domain((N, N), ((-0.5, 0.5),) * 2).mesh()
    shape = Shape((np.sqrt(X**2 + Y**2) < 0.35).astype(X.dtype), dx=(1 / N, 1 / N),
                  smooth_epsilon=4.0 / N, smooth_tf=1e-3, smooth_dt=1e-5, device=dev)
    u = shape.smooth.clone()

    def shape_step():
        y1, err = Tsit5().step(shape.flow_rhs, u, torch.tensor(0.0), torch.tensor(5e-5))
        return float(_rms_norm(err, u, y1, 1e-4, 1e-6))

    cases = {
        "adi_call": lambda: macro(y0),
        "fft_call": lambda: evolve(stepper, None, y0, 0.0, dt, n),
        "fleet_step_fused": fleet_step("fused"),
        "fleet_step_fft": fleet_step("fft"),
        "shape_step": shape_step,
    }
    out = {}
    for name, fn in cases.items():
        wall = _wall(torch, fn)
        out[name] = {"wall_ms": wall, "enqueue_ms": _enqueue_ms(torch, fn), **_profile(torch, fn)}
    print(json.dumps(out, indent=1) + f"\n[{card}]", flush=True)


if __name__ == "__main__":
    main()
