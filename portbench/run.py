#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload ch64.rollout --seed 7 --seconds 10 --trace 0

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` runs a fixed traced window and reports its
per-layer metrics.  Every run checks what its timed path produced against
the plain reference and prints each number compared beside its limit, as
the last lines of standard error and under ``checks`` in the result line.
A run needs the CUDA device(s) its cell asks for and exits with code 2,
printing no result, without them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import core

    try:
        core.cache_env(ROOT)
        cell = core.resolve_cell(args.workload, ROOT)
        core.check_devices(cell.chips)
        try:
            import pde_opt_tpu_torch  # noqa: F401
        except ImportError as e:
            raise core.RunError(f"the port (pde_opt_tpu_torch) is not in this checkout: {e}")
        from portbench import runner

        out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0)
    except core.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value in out["result"]["readings"].items():
        if name not in out["checks"]:
            print(f"reading {name}: {value!r} (reported, not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} <= {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(out["line"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
