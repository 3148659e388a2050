"""The readers of the port's spans (``portbench/spans.py`` and the metrics
``host_step_ms.rollout``, ``dispatch_idle_ms.rollout``,
``step_launches.rollout``) on a hand-built traced run: known device
operations, idle gaps and port spans at a known offset from the trace's
clock."""

import pytest

from portbench import core
from portbench import spans as sp
from portbench.trace import WINDOW, DeviceOp, Trace

OFF_NS = 1_790_000_000_123_456_789   # a span's time_ns minus its time on the trace's clock
READERS = ("host_step_ms.rollout", "dispatch_idle_ms.rollout", "step_launches.rollout")


def _ns(t_us: float) -> int:
    """A span time in ns whose trace time is ``t_us``."""
    return OFF_NS + round(t_us * 1e3)


def _span(name, a, b, parent=-1, n=4):
    return (name, _ns(a), _ns(b), parent, n)


def _op(a, b, ranges=()):
    return DeviceOp("k", a, b, 0, frozenset(ranges))


def _run():
    """Two steps in the device-only window (spans [10, 40] and [50, 80] µs,
    the device busy [12, 30], [45, 60], [70, 95]: idle [30, 40] and [60, 70]
    inside them), then the host+device window from 200 µs, whose two step
    ranges [210, 260] and [270, 320] launched 5 operations each."""
    device = Trace(ops=[_op(12, 20), _op(18, 30), _op(45, 60), _op(70, 95)], ranges={},
                   window_us=(12.0, 95.0), host_events=[], steps=2)
    inside = ("portbench/window", sp.STEP)
    ops = [_op(210 + 8 * i, 214 + 8 * i, inside) for i in range(5)]
    ops += [_op(270 + 8 * i, 274 + 8 * i, inside) for i in range(5)]
    ops += [_op(330 + i, 331 + i, ("portbench/window",)) for i in range(3)]
    trace = Trace(ops=ops, ranges={WINDOW: [(200.0, 400.0)],
                                   sp.STEP: [(210.0, 260.0), (270.0, 320.0)]},
                  window_us=(200.0, 400.0), host_events=[], steps=2,
                  info={"device": None}, device=device)
    recorded = [_span("vector_env.rollout", 5, 85, n=8),
                _span(sp.STEP, 10, 40, 0), _span(sp.STEPPER, 11, 20, 1),
                _span(sp.AUTORESET, 21, 38, 1),
                _span(sp.STEP, 50, 80, 0), _span(sp.STEPPER, 51, 60, 4),
                _span("vector_env.rollout", 205, 330, n=8),
                _span(sp.STEP, 210, 260, 6), _span(sp.STEP, 270, 320, 6)]
    return trace, recorded


def _read(name, trace):
    return core.metric_reader(name).read(trace, None)


def test_align_matches_the_second_window_and_reports_its_error():
    trace, recorded = _run()
    # The second window's spans open 2, 1 and 3 µs after their ranges.
    trace.ranges[sp.STEP].append((330.0, 380.0))
    recorded = recorded[:-2] + [_span(sp.STEP, 212, 260), _span(sp.STEP, 271, 320),
                                _span(sp.STEP, 333, 380)]
    off, err = sp.align(trace, recorded)
    assert off == -OFF_NS - 2000
    assert err == 1.0


def test_device_window_steps_on_the_trace_clock(monkeypatch):
    trace, recorded = _run()
    monkeypatch.setattr(sp, "port_spans", lambda: recorded)
    steps = sp.device_window_steps(trace)
    assert steps == [pytest.approx((10.0, 40.0), abs=1e-3),
                     pytest.approx((50.0, 80.0), abs=1e-3)]


def test_idle_inside_spans():
    busy = [(12.0, 30.0), (45.0, 60.0), (70.0, 95.0)]
    assert sp.idle_us_inside(busy, (12.0, 95.0), [(10.0, 40.0), (50.0, 80.0)]) == 20.0
    assert sp.idle_us_inside(busy, (0.0, 100.0), [(0.0, 100.0)]) == 12 + 15 + 10 + 5
    assert sp.idle_us_inside([], (0.0, 10.0), [(2.0, 3.0), (4.0, 6.0)]) == 3.0


@pytest.mark.parametrize("name,value", [("host_step_ms.rollout", 0.030),
                                        ("dispatch_idle_ms.rollout", 0.010),
                                        ("step_launches.rollout", 5.0)])
def test_reader_gives_the_hand_computed_value(monkeypatch, name, value):
    trace, recorded = _run()
    monkeypatch.setattr(sp, "port_spans", lambda: recorded)
    assert _read(name, trace) == pytest.approx(value, rel=1e-6)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("port", ["no_recorder", "nothing_recorded"])
def test_reader_reports_nothing_without_port_spans(monkeypatch, name, port):
    """A checkout before the recorder (no spans, no ranges of the port's
    names), or a run in which the port recorded none."""
    trace, _ = _run()
    del trace.ranges[sp.STEP]
    for o in trace.ops:
        o.ranges = o.ranges - {sp.STEP}
    if port == "no_recorder":
        from pde_opt_tpu_torch.utils import metrics

        monkeypatch.delattr(metrics, "spans")
    else:
        monkeypatch.setattr(sp, "port_spans", lambda: [])
    assert _read(name, trace) is None


def test_port_spans_reads_the_recorder():
    from pde_opt_tpu_torch.utils import metrics

    metrics.clear_spans()
    metrics.record_spans(True)
    try:
        with metrics.named_scope(sp.STEP, 3):
            pass
    finally:
        metrics.record_spans(False)
    recorded = sp.port_spans()
    metrics.clear_spans()
    assert [(s[0], s[3], s[4]) for s in recorded] == [(sp.STEP, -1, 3)]
