"""The port's own spans in a traced run, placed on the device trace's clock.

The port records spans in memory while a profiler session runs
(``pde_opt_tpu_torch.utils.metrics.named_scope``: ``vector_env.rollout``,
``vector_env.step``, ``vector_env.stepper``, ``vector_env.auto_reset``), on
the clock ``time.time_ns()``.  A ``--trace 1`` run traces the same work
twice (``portbench/trace.py``): device alone, then host and device.  In the
second window each span also stands in the chrome trace as a range of its
name, so matching the step spans with those ranges gives the offset from
the spans' clock to the trace's µs.  The offset is one a process, and it
places the first window's spans among that window's device operations.

A checkout whose port records no spans (before the recorder) gives
``None`` everywhere here, and the readers that use it report nothing.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

STEP = "vector_env.step"
STEPPER = "vector_env.stepper"
AUTORESET = "vector_env.auto_reset"


def port_spans() -> Optional[list]:
    """The port's recorded spans ``(name, start_ns, end_ns, parent, n)``, or
    None where the port has no recorder."""
    try:
        from pde_opt_tpu_torch.utils import metrics
    except ImportError:
        return None
    read = getattr(metrics, "spans", None)
    return read()["spans"] if read is not None else None


def align(trace, spans, name: str = STEP) -> Optional[Tuple[int, float]]:
    """``(offset_ns, error_us)``: a span's ``(start_ns + offset_ns) / 1e3``
    is its time on the trace's clock (whole ns: ``time_ns()`` has more
    digits than a float's µs keep).  The host+device window's ranges
    ``name`` are matched in order with the last as many spans ``name`` (the
    port records spans only while a session runs, and that window is the
    run's last); the offset is the median of the matched pairs' and the
    error the median distance of a pair's from it."""
    ranges = sorted(trace.ranges.get(name, []))
    starts = sorted(s[1] for s in spans if s[0] == name)
    k = len(ranges)
    if not k or len(starts) < k:
        return None
    offs = [round(r[0] * 1e3) - s for r, s in zip(ranges, starts[-k:])]
    mid = statistics.median_low(offs)      # an int: a float median rounds to 256 ns
    return mid, statistics.median(abs(o - mid) for o in offs) / 1e3


def device_window_steps(trace) -> Optional[List[Tuple[float, float]]]:
    """The step spans of the device-only window, ``(start_us, end_us)`` on
    the trace's clock: those that overlap its device operations' span and
    end before the host+device window opens.  None without spans."""
    spans = port_spans()
    if not spans or trace.device is None:
        return None
    fit = align(trace, spans)
    if fit is None:
        return None
    off = fit[0]
    lo, hi = trace.device.window_us
    opened = trace.window_us[0]
    steps = []
    for name, start, end, _, _ in spans:
        if name != STEP:
            continue
        a, b = (start + off) / 1e3, (end + off) / 1e3
        if b > lo and a < hi and b <= opened:
            steps.append((a, b))
    return sorted(steps) or None


def idle_us_inside(busy: List[Tuple[float, float]], window: Tuple[float, float],
                   spans: List[Tuple[float, float]]) -> float:
    """µs of ``window`` in which no busy interval runs, inside ``spans``
    (sorted, disjoint intervals both)."""
    lo, hi = window
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    total, i = 0.0, 0
    for a, b in spans:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += max(0.0, min(b, gaps[j][1]) - max(a, gaps[j][0]))
            j += 1
    return total
