"""One run of a cell: the traffic generator's window, the per-layer readers over a
traced window, the comparison with the reference, the result line."""

from __future__ import annotations

import sys
from typing import Dict

from . import core


def per_layer(cell: core.Cell, trace) -> Dict[str, Dict]:
    """Each of the cell's per-layer metrics its reader finds in the trace;
    a reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = core.metric_reader(m["name"]).read(trace, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: core.Cell, seed: int, seconds: float, traced: bool, t0: float,
             device=None) -> Dict:
    """Run ``cell`` once; returns ``{"line", "checks", "result"}``.  On the
    card unless ``device`` is given (the CPU tests give the CPU)."""
    import torch

    clock = {"t0": t0}
    dev = device if device is not None else torch.device("cuda", 0)
    res = core.driver(cell).run(cell, seed, seconds, traced, dev, clock)
    checks = core.compare(res["readings"], cell.limits["limits"])
    correct = all(c["ok"] for c in checks.values())
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        device_info = {"platform": "gpu", "kind": kind, "count": cell.chips}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1}
    device_info["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    breakdown = None
    if traced:
        trace = res["trace"]
        metrics = per_layer(cell, trace)
        dev_trace, rank0 = trace.device, trace.info.get("device")
        device_info["busy_s"] = dev_trace.busy_s(rank0)
        device_info["window_s"] = dev_trace.window_s
        breakdown = {"device_ops": dev_trace.breakdown(rank0)["device_ops"],
                     "idle_gaps": trace.breakdown(rank0)["idle_gaps"]}
    else:
        # A cell's end-to-end metric ``<quantity>`` or ``<quantity>.<suffix>``
        # reports the driver's ``<quantity>``.
        metrics = {m["name"]: res["metrics"][m["name"].split(".")[0]]
                   for m in cell.end_to_end if m["name"].split(".")[0] in res["metrics"]}
        metrics["setup_s"] = {"value": clock["setup_s"], "unit": "s"}
    if dev.type == "cuda":
        device_info["card"] = core.card_line()
        print(f"portbench: {cell.name} seed {seed} on {device_info['card']}", file=sys.stderr)
    line = core.result_line(correct, res["attempted"], res["failed"], metrics, device_info,
                            checks, breakdown)
    return {"line": line, "checks": checks, "result": res}
