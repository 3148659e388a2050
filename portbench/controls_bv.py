"""The controls of a BV cell's comparison, each the reference in the
program's place below the precision the configuration states, compared by
the cell's own comparison at the cell's own sizes:

* ``fp8``: ``controls.py``'s control, the reference one precision below
  the configuration everywhere (fp8 transforms, a bf16 closure);
* ``fp8_transforms``: the transforms' operands, intermediates and outputs
  rounded to fp8 e4m3, the closure in float64;
* ``bf16_closure``: the closure's ``em``, ``I+``, ``I-`` and ``y`` rounded
  to bfloat16, the transforms exact (the cheap closure).

    python3 -m portbench.controls_bv --workload bv64.rollout --seeds 1 2 3

prints one JSON line of the controls' readings a seed (and the limits).
On the card unless ``--cpu`` is given; a control that reads under every
limit has failed to separate the program from a lower precision.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import controls, core  # noqa: E402


def half_control(cell: core.Cell, seed: int, device, rnd, closure) -> dict:
    """What the rollout comparison reads when the reference with the
    transforms' rounding ``rnd`` and the closure's ``closure`` runs the
    fleet in the program's place: the run of
    :func:`controls.rollout_control` (the same envs, actions and reset
    draws from ``seed``) with those roundings."""
    import torch

    ref = core.reference(cell)
    fleet, phys = cell.config["fleet"], cell.config["physics"]
    B, H = fleet["num_envs"], fleet["grid"]
    meta = {"B": B, "H": H, "W": H, "substeps": fleet["substeps"], "ds": 1}
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
                             rnd, closure=closure)
        return ref.check_steps(cell.config, meta, rec, idx, device)


def control_readings(cell: core.Cell, seed: int, device) -> dict:
    ref = core.reference(cell)
    return {"fp8": controls.rollout_control(cell, seed, device),
            "fp8_transforms": half_control(cell, seed, device, ref.fp8_rounding, None),
            "bf16_closure": half_control(cell, seed, device, None, ref.bf16_rounding)}


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
    out = {"workload": cell.name, "limits": cell.limits["limits"], "readings": {}}
    for seed in args.seeds:
        out["readings"][seed] = control_readings(cell, seed, device)
        print(json.dumps({"seed": seed, **out["readings"][seed]}), file=sys.stderr, flush=True)
    if not args.cpu:
        out["card"] = core.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
