"""The controls of the comparison with the reference: the reference put in
the program's place at a lower precision than the configuration states,
compared by the cell's own comparison at the cell's own sizes.

    python3 -m portbench.controls --workload ch64.rollout --seeds 1 2 3

prints one JSON line of the control's readings a seed (and the limits).
On the card unless ``--cpu`` is given; a control that reads under a limit
has failed to separate the program from a lower precision.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402


def rollout_control(cell: core.Cell, seed: int, device) -> dict:
    """The numbers the rollout comparison reads when the reference, with its
    fp8 rounding, runs the fleet in the program's place: from a fresh reset,
    ``check_segments`` segments of uniform random actions with the fleet's
    reset draws, ``check_envs`` envs, followed step by step by the float64
    reference as the program's run is."""
    import torch

    ref = core.reference(cell)
    fleet, phys = cell.config["fleet"], cell.config["physics"]
    B, H = fleet["num_envs"], fleet["grid"]
    ds = int({**cell.config["preset_args"], **cell.traffic.get("env_overrides", {})}
             .get("obs_downsample", 1))
    meta = {"B": B, "H": H, "W": H, "substeps": fleet["substeps"], "ds": ds}
    s_env, s_pol, s_pick = core.seeds(seed, 3)
    pick = torch.Generator().manual_seed(s_pick)
    n_check = min(B, int(cell.limits["check_envs"]))
    idx = torch.randperm(B, generator=pick)[:n_check].sort().values.to(device)
    gen = torch.Generator(device=device).manual_seed(s_env)
    z0 = torch.randn((B, H, H), generator=gen, dtype=torch.float32, device=device)
    gpol = torch.Generator(device=device).manual_seed(s_pol)
    n = int(cell.traffic["check_segments"]) * int(cell.traffic["segment_steps"])
    actions = [(2.0 * torch.rand((B, 1), generator=gpol, device=device) - 1.0)
               .index_select(0, idx) for _ in range(n)]
    b = idx.numel()
    s0 = ref.FleetState(ref.reset_field(z0.index_select(0, idx), phys),
                        torch.full((b,), phys["kappa_reset"], dtype=torch.float64,
                                   device=device),
                        torch.zeros((b,), dtype=torch.float32, device=device),
                        torch.zeros((b,), dtype=torch.int64, device=device))
    with torch.no_grad():
        rec = ref.trajectory(cell.config, meta, s0, gen.get_state(), actions, idx, device,
                             ref.fp8_rounding)
        return ref.check_steps(cell.config, meta, rec, idx, device)


def control_readings(cell: core.Cell, seed: int, device) -> dict:
    return {"fp8": rollout_control(cell, seed, device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    import torch

    cell = core.resolve_cell(args.workload)
    if not args.cpu:
        core.check_devices(cell.chips)
    device = torch.device("cpu" if args.cpu else "cuda")
    out = {"workload": cell.name, "limits": cell.limits["limits"],
           "readings": {s: control_readings(cell, s, device) for s in args.seeds}}
    for seed, r in out["readings"].items():
        print(json.dumps({"seed": seed, **r}), file=sys.stderr, flush=True)
    if not args.cpu:
        out["card"] = core.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
