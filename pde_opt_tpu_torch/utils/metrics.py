"""Lightweight metrics, the port's spans and its trace scope (PyTorch port
of the JAX package's ``utils/metrics.py``).

A host-side metric logger fed with device scalars in one transfer, the
span recorder (:func:`named_scope`) and the ``torch.profiler`` trace scope
that exports the spans beside the trace.

Spans.  ``with named_scope(name, n):`` marks a stretch of host time: the
env fleet's ``vector_env.rollout``, ``vector_env.step``,
``vector_env.stepper`` and ``vector_env.auto_reset``, and the PPO update's
``ppo/rollout``, ``ppo/advantages`` and ``ppo/epoch``.  ``n`` is the work
the span covers (envs for a step, env-steps for a rollout).  A span is on
while a ``torch.profiler`` session records, or after ``record_spans(True)``:

* off, it reads two flags and returns a shared do-nothing context: no clock
  read, no profiler range, no allocation;
* on, it appends ``(name, start_ns, end_ns, parent, n)`` to a ring of
  :data:`SPAN_CAPACITY` entries, which counts what it drops.  The clock is
  ``time.time_ns()``, the clock a chrome trace of ``torch.profiler``
  counts from, less its ``baseTimeNanoseconds``; ``parent`` is the index
  (in :func:`spans`) of the enclosing span on the same thread, -1 for none.
  While a profiler session runs, the span also opens a profiler range of
  its name (what ``torch.profiler.record_function(name)`` opens, through
  the entry ``torch.profiler`` uses for its own step ranges: a fifth of the
  cost), so that the trace holds it as a ``user_annotation`` whose start
  and end lie a few µs after the span's.

A span never launches device work and never waits for the device.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["MetricLogger", "trace_scope", "named_scope", "record_spans", "spans",
           "clear_spans", "to_host", "SPAN_CAPACITY"]

SPAN_CAPACITY = 1 << 16

# Read through the module, so that a test can count the calls.
_clock = time.time_ns
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit


class _SpanRing:
    """The recorded spans: a ring of ``capacity`` finished spans, each
    ``(id, name, start_ns, end_ns, parent_id, n)``, with a count of those
    that fell out of it."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.ring = collections.deque(maxlen=self.capacity)
            self.ids = itertools.count()      # next() is one atomic call
            self.finished = 0

    def open_stack(self) -> List[int]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_SPANS = _SpanRing(SPAN_CAPACITY)
_forced = False       # record_spans(True): on with no profiler session


class _Off:
    """What :func:`named_scope` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "id", "parent", "start", "range", "stack")

    def __init__(self, name: str, n: int):
        self.name, self.n = name, n

    def __enter__(self):
        ring = _SPANS
        self.id = next(ring.ids)
        self.stack = ring.open_stack()
        self.parent = self.stack[-1] if self.stack else -1
        self.stack.append(self.id)
        # The clock before the range's entry (and before its exit below):
        # the profiler stamps a range early in each call, and the entry's
        # return takes longer than its start.
        self.start = _clock()
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _range_enter(self.name)
        return self

    def __exit__(self, *exc):
        end = _clock()
        if self.range is not None:
            _range_exit(self.range)
        self.stack.pop()
        ring = _SPANS
        with ring.lock:
            ring.ring.append((self.id, self.name, self.start, end, self.parent, self.n))
            ring.finished += 1
        return False


def named_scope(name: str, n: int = 0):
    """A span around the block (see the module): ``with named_scope(name, n):``."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, n)


def record_spans(on: bool) -> None:
    """Record spans with no profiler session running (``True``), or only
    while one runs (``False``, the default)."""
    global _forced
    _forced = bool(on)


def spans() -> Dict[str, Any]:
    """The recorded spans in the order they opened, ``{"spans": [(name,
    start_ns, end_ns, parent, n), ...], "dropped": k}``: ``parent`` indexes
    this list (-1: no enclosing span, or it is no longer held), ``dropped``
    counts the spans the ring let go since :func:`clear_spans`."""
    with _SPANS.lock:
        held = sorted(_SPANS.ring)
        dropped = _SPANS.finished - len(held)
    index = {rec[0]: i for i, rec in enumerate(held)}
    out = [(name, start, end, index.get(parent, -1), n)
           for _, name, start, end, parent, n in held]
    return {"spans": out, "dropped": dropped}


def clear_spans() -> None:
    """Forget every recorded span and the drop count."""
    _SPANS.clear()


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


@contextmanager
def trace_scope(logdir: str):
    """Profile everything inside the scope with ``torch.profiler`` (CPU, and
    CUDA where available) and write ``logdir/trace.json`` (Chrome format)
    and ``logdir/spans.json``: the spans that opened inside the scope, each
    ``{"name", "ts", "dur", "parent", "n"}`` in µs on the trace's clock
    (``parent`` indexes the file's list), and ``dropped``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base = int(json.load(f).get("baseTimeNanoseconds", 0))
    rec = spans()
    inside = [i for i, s in enumerate(rec["spans"]) if s[1] >= t0]
    index = {i: j for j, i in enumerate(inside)}
    out = []
    for i in inside:
        name, start, end, parent, n = rec["spans"][i]
        out.append({"name": name, "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                    "parent": index.get(parent, -1), "n": n})
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": out, "dropped": rec["dropped"]}, f)
