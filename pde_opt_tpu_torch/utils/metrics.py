"""Lightweight metrics and profiling scopes (PyTorch port of
the JAX package's ``utils/metrics.py``).

A host-side metric logger fed with device scalars in one transfer, an
env-steps/s counter, a ``torch.profiler`` trace scope and named ranges
(``torch.profiler.record_function``) that show up in the trace.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional

import torch

__all__ = ["MetricLogger", "Throughput", "trace_scope", "named_scope", "to_host"]

named_scope = torch.profiler.record_function


def to_host(metrics: Mapping[str, Any]) -> Dict[str, float]:
    """``metrics`` as Python floats.  The tensors among them (scalars on one
    device) cross to the host in ONE transfer, which waits for the device
    once; a per-value ``float()`` would wait once per value."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().reshape(()).to(torch.float64)
                            for k in keys]).cpu().tolist()
        out.update(zip(keys, vals))
    return {k: out[k] for k in metrics}


class MetricLogger:
    """Append-only scalar metric stream with periodic flush to JSONL."""

    def __init__(self, path: Optional[str] = None, flush_every: int = 100):
        self.path = path
        self.flush_every = flush_every
        self._buffer = []
        self._history = defaultdict(list)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in to_host(metrics).items():
            rec[k] = v
            self._history[k].append((int(step), v))
        self._buffer.append(rec)
        if self.path and len(self._buffer) >= self.flush_every:
            self.flush()

    def history(self, key: str):
        return list(self._history[key])

    def flush(self) -> None:
        if self.path and self._buffer:
            with open(self.path, "a") as f:
                for rec in self._buffer:
                    f.write(json.dumps(rec) + "\n")
            self._buffer.clear()


class Throughput:
    """Env-steps/s counter on the host clock.  The device runs behind the
    host: synchronise before reading :attr:`rate` for a device rate."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def update(self, env_steps: int):
        self._steps += env_steps

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0


@contextmanager
def trace_scope(logdir: str):
    """Profile everything inside the scope with ``torch.profiler`` (CPU, and
    CUDA where available) and write ``logdir/trace.json`` (Chrome format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
