"""One traced window and its reduction: device operations, the benchmark's
own ranges around program calls, busy time, idle gaps and a breakdown.

Only a ``--trace 1`` run installs ranges and the profiler, over two
windows of the same work.  The first traces the device alone: tracing every
host operation as well more than doubles the host's time a step, and a
host-paced step would read idle time that an untraced run does not have.
Busy time (the union of the device operations' intervals), the window
(from the first operation's start to the last one's end) and the
operations by name come from it.  The second traces host and device: its
chrome trace ties each device operation (``kernel``, ``gpu_memcpy``,
``gpu_memset``) to the host call that launched it by its correlation id,
and so to every range (``user_annotation``) that was open on that host
thread at the launch; device time by range, host time in ranges and the
idle gaps named by what the host was doing come from it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench/window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@dataclass
class DeviceOp:
    name: str
    start: float          # us, the trace's clock
    end: float
    device: int
    ranges: frozenset     # names of the ranges open at its launch


@dataclass
class Trace:
    """A traced window, reduced.  Times in seconds unless named ``_us``."""

    ops: List[DeviceOp]
    ranges: Dict[str, List[Tuple[float, float]]]   # host intervals (us) by name
    window_us: Tuple[float, float]
    host_events: List[Tuple[float, float, str]]     # main thread, for idle gaps
    steps: int = 0            # env steps the window ran
    info: Dict = field(default_factory=dict)
    device: Optional["Trace"] = None   # the device-only window of the same work

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def device_ops(self, device: Optional[int] = None) -> List[DeviceOp]:
        return [o for o in self.ops if device is None or o.device == device]

    def busy_intervals(self, device: Optional[int] = None) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the window."""
        lo, hi = self.window_us
        spans = sorted((max(o.start, lo), min(o.end, hi)) for o in self.device_ops(device)
                       if o.end > lo and o.start < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, device: Optional[int] = None) -> float:
        return sum(e - s for s, e in self.busy_intervals(device)) * 1e-6

    def device_s_in(self, rng: str, exclude: Tuple[str, ...] = (),
                    device: Optional[int] = None) -> float:
        """Device seconds of the operations launched inside range ``rng``
        and inside none of ``exclude``."""
        return sum(o.end - o.start for o in self.device_ops(device)
                   if rng in o.ranges and not (o.ranges & set(exclude))) * 1e-6

    def launched_in(self, rng: str, device: Optional[int] = None) -> int:
        """How many device operations were launched inside range ``rng``."""
        return sum(1 for o in self.device_ops(device) if rng in o.ranges)

    def breakdown(self, device: Optional[int] = None, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps in the window, each named by what the host was doing."""
        by_name: Dict[str, float] = {}
        for o in self.device_ops(device):
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window_us
        edges = [lo]
        for s, e in self.busy_intervals(device):
            edges += [s, e]
        edges.append(hi)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host_events]
        idle = []
        for s, e in gaps[:top]:
            idle.append([self._host_at((s + e) / 2, starts), (e - s) * 1e-6])
        return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": idle}

    def _host_at(self, t: float, starts: List[float]) -> str:
        """The innermost host event on the main thread open at ``t``."""
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, name = self.host_events[j]
            if s <= t <= e and (best is None or s > best[0]):
                best = (s, e, name)
                break
        return best[2][:160] if best else "host: python between calls"


def _events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def reduce_chrome_trace(events: List[dict]) -> Trace:
    """:class:`Trace` from a chrome trace's events (see the module)."""
    launches: Dict[int, Tuple[float, object]] = {}
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    range_tid: Dict[str, object] = {}
    dev_raw = []
    host = []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            dev_raw.append((ev.get("name", "?"), ts, ts + dur,
                            int(args.get("device", 0) or 0), args.get("correlation")))
            continue
        if cat in LAUNCH_CATS and args.get("correlation") is not None:
            launches[int(args["correlation"])] = (ts, ev.get("tid"))
        if cat == "user_annotation":
            name = ev.get("name", "")
            if name == WINDOW:
                window = (ts, ts + dur)
                range_tid[name] = ev.get("tid")
            ranges.setdefault(name, []).append((ts, ts + dur))
            range_tid.setdefault(name, ev.get("tid"))
        if cat in HOST_CATS:
            host.append((ts, ts + dur, ev.get("name", "?"), ev.get("tid")))
    if window is None:
        # A device-only trace: the window is the device operations' span.
        window = (min((r[1] for r in dev_raw), default=0.0),
                  max((r[2] for r in dev_raw), default=0.0))
    main_tid = range_tid.get(WINDOW)
    for v in ranges.values():
        v.sort()
    starts = {k: [s for s, _ in v] for k, v in ranges.items()}

    def open_at(t: float, tid) -> frozenset:
        names = []
        for name, iv in ranges.items():
            if range_tid.get(name) != tid:
                continue
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                names.append(name)
        return frozenset(names)

    ops = []
    for name, s, e, dev, corr in dev_raw:
        launch = launches.get(int(corr)) if corr is not None else None
        tags = open_at(*launch) if launch else frozenset()
        ops.append(DeviceOp(name, s, e, dev, tags))
    host_main = sorted((s, e, n) for s, e, n, tid in host if tid == main_tid)
    return Trace(ops=ops, ranges=ranges, window_us=window, host_events=host_main)


@contextlib.contextmanager
def profiled(host: bool = True):
    """Profile the device (and, with ``host``, the host's operations and
    ranges); yields a dict that holds the reduced :class:`Trace` under
    ``"trace"`` once the block has ended.  With ``host`` the block opens
    the :data:`WINDOW` range around the work it measures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder: Dict[str, Trace] = {}
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder["trace"] = reduce_chrome_trace(_events(path))
    finally:
        os.unlink(path)


def ranged(fn, name: str):
    """``fn`` inside a profiler range ``name``."""
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    wrapped.__wrapped__ = fn
    return wrapped


def traced_windows(window, n: int, open_range):
    """Run ``window(n)`` twice, traced as the module says: first the device
    alone, then host and device inside ``open_range(WINDOW)``.  Returns the
    second window's :class:`Trace` with the first as its ``device``."""
    with profiled(host=False) as dev:
        window(n)
    with profiled() as full:
        with open_range(WINDOW):
            window(n)
    trace = full["trace"]
    trace.device = dev["trace"]
    return trace
