"""What every run shares: the manifest, a cell's files, seeds, the device
checks, the check of what is loaded, and the result line.

A cell of ``BENCHMARK.json`` is found by name; everything that belongs to
it sits in files of its own, found by the names in the manifest:

* ``portbench/configs/<config>.json``: the deployment (sizes, physics,
  precision), with its source;
* ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``driver``
  names the general generator in ``portbench/drivers/<driver>.py``;
* ``portbench/cells/<cell>.json``: the limits of the cell's comparison with
  the plain reference, ``portbench/reference/<reference>.py``;
* ``portbench/metrics/<metric>.py``: one reader a per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pde_opt_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (exit code 2, nothing printed)."""


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    run_seconds: int

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise RunError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(name: str, root: Path = ROOT, manifest: Optional[dict] = None) -> Cell:
    """The cell ``name`` of the manifest with its files, read by name."""
    manifest = manifest or load_manifest(root)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise RunError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(entries))})")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(root / "portbench" / "cells" / f"{name}.json")
    return Cell(
        name=name, entry=entry, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
        run_seconds=int(manifest["run_seconds"]),
    )


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier
    (``metrics/device_idle_share.rollout.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def reference(cell: Cell):
    return importlib.import_module(f"portbench.reference.{cell.config['reference']}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from ``--seed`` (any whole number)."""
    import numpy as np

    words = np.random.SeedSequence(int(seed) % (1 << 128)).generate_state(2 * n, np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1]) for i in range(n)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``pde_opt_tpu_torch`` is not one)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cache_env(root: Path = ROOT) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into ``build/kernels/`` there itself)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def check_devices(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the port on the card "
                       "and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, this machine has "
                       f"{torch.cuda.device_count()}")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def compare(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number compared beside its limit; a number passes when it is
    finite and at most its limit."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit,
                     "ok": value == value and value <= limit}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Any],
                device: Dict[str, Any], checks: Dict[str, Dict],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # A reading that is not finite (a field gone NaN) prints as null: JSON
    # has no infinity.
    out["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else None,
                         "limit": v["limit"]} for k, v in checks.items()}
    return json.dumps(out)
