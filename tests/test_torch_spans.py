"""The port's spans (``utils/metrics.py`` ``named_scope``) at the env
fleet's boundaries: off with no profiler session, one tree a rollout under
one, on the chrome trace's clock, a ring that counts what it drops, and
``trace_scope``'s ``spans.json``."""

import json
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
from pde_opt_tpu_torch.utils import metrics

torch.set_num_threads(1)

B, N, STEPS = 4, 16, 3

# name -> preset kwargs: the fused macro with its epilogue (the stepper span
# around evolve_with_epilogue), the fft stepper (around macro_step) and
# per-env stepping (around the vmap).
PATHS = {
    "fused_epilogue": dict(spectral_solve="fused"),
    "fft": dict(spectral_solve="fft"),
    "per_env": dict(spectral_solve="fused", vectorized_control=False),
}


@pytest.fixture(autouse=True)
def _fresh_spans():
    metrics.record_spans(False)
    metrics.clear_spans()
    yield
    metrics.record_spans(False)
    metrics.clear_spans()


def _fleet(**kw):
    env = make_cahn_hilliard_control_env(num_envs=B, grid_size=N, substeps=2,
                                         end_time=0.02, device="cpu", **kw)
    state, _ = env.reset(torch.Generator().manual_seed(0))
    run = env.make_rollout(lambda obs, g: env.sample_actions(g), STEPS)
    return env, state, run


def _rollout(**kw):
    _, state, run = _fleet(**kw)
    return run(state, torch.Generator().manual_seed(1))


def test_no_spans_without_a_profiler():
    _rollout(**PATHS["fused_epilogue"])
    assert metrics.spans() == {"spans": [], "dropped": 0}


def test_off_reads_no_clock_and_opens_no_range(monkeypatch):
    calls = {"clock": 0, "range": 0}

    def clock():
        calls["clock"] += 1
        return 0

    def range_enter(name):
        calls["range"] += 1

    monkeypatch.setattr(metrics, "_clock", clock)
    monkeypatch.setattr(metrics, "_range_enter", range_enter)
    _rollout(**PATHS["fused_epilogue"])
    assert calls == {"clock": 0, "range": 0}
    # Off, every scope is the one shared do-nothing context.
    assert metrics.named_scope("a", 1) is metrics.named_scope("b", 2)


def test_record_spans_without_a_profiler_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(metrics, "_range_enter", opened.append)
    metrics.record_spans(True)
    _rollout(**PATHS["fused_epilogue"])
    names = [s[0] for s in metrics.spans()["spans"]]
    assert names.count("vector_env.step") == STEPS and opened == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_tree_a_rollout(path):
    with profile(activities=[ProfilerActivity.CPU]):
        _rollout(**PATHS[path])
    rec = metrics.spans()
    assert rec["dropped"] == 0
    spans = rec["spans"]
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in roots] == ["vector_env.rollout"]
    assert spans[roots[0]][4] == STEPS * B
    steps = [i for i, s in enumerate(spans) if s[0] == "vector_env.step"]
    assert len(steps) == STEPS
    for i in steps:
        name, start, end, parent, n = spans[i]
        assert parent == roots[0] and n == B and start <= end
        children = sorted(spans[j][0] for j, s in enumerate(spans) if s[3] == i)
        assert children == ["vector_env.auto_reset", "vector_env.stepper"]
        for j, s in enumerate(spans):
            if s[3] == i:
                assert s[4] == B and start <= s[1] <= s[2] <= end
    assert len(spans) == 1 + 3 * STEPS


@pytest.mark.parametrize("path", ["fused_epilogue", "per_env"])
def test_trace_scope_writes_spans_on_the_trace_clock(tmp_path, path):
    with metrics.trace_scope(str(tmp_path)):
        _rollout(**PATHS[path])
    assert (tmp_path / "trace.json").exists()
    trace = json.loads((tmp_path / "trace.json").read_text())
    out = json.loads((tmp_path / "spans.json").read_text())
    assert out["dropped"] == 0 and len(out["spans"]) == 1 + 3 * STEPS
    ranges = {}
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "user_annotation" and ev["name"].startswith("vector_env."):
            ranges.setdefault(ev["name"], []).append(ev)
    starts, ends = [], []
    for name in ("vector_env.rollout", "vector_env.step", "vector_env.stepper",
                 "vector_env.auto_reset"):
        mine = [s for s in out["spans"] if s["name"] == name]
        theirs = sorted(ranges[name], key=lambda ev: ev["ts"])
        assert len(mine) == len(theirs)
        for s, ev in zip(mine, theirs):
            # The span's clock is read just before the range's entry and
            # exit: each of its ends lies a little before the range's.
            starts.append(ev["ts"] - s["ts"])
            ends.append(ev["ts"] + ev["dur"] - s["ts"] - s["dur"])
    assert min(starts) > -5 and min(ends) > -5
    assert statistics.median(starts) < 50 and statistics.median(ends) < 50


def test_spans_outside_trace_scope_stay_out_of_its_file(tmp_path):
    metrics.record_spans(True)
    with metrics.named_scope("before", 1):
        pass
    with metrics.trace_scope(str(tmp_path)):
        with metrics.named_scope("inside", 2):
            with metrics.named_scope("child", 3):
                pass
    out = json.loads((tmp_path / "spans.json").read_text())
    assert [(s["name"], s["parent"], s["n"]) for s in out["spans"]] == [
        ("inside", -1, 2), ("child", 0, 3)]


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(metrics, "_SPANS", metrics._SpanRing(8))
    metrics.record_spans(True)
    with metrics.named_scope("outer", 20):
        for k in range(19):
            with metrics.named_scope("inner", k):
                pass
    rec = metrics.spans()
    assert rec["dropped"] == 12
    spans = rec["spans"]
    # The outer span finished last and is held; the inner ones held are the
    # last seven, whose parent is the outer span's index.
    assert [s[0] for s in spans] == ["outer"] + ["inner"] * 7
    assert [s[4] for s in spans[1:]] == list(range(12, 19))
    assert all(s[3] == 0 for s in spans[1:]) and spans[0][3] == -1
    metrics.clear_spans()
    assert metrics.spans() == {"spans": [], "dropped": 0}


def _bv_rollout(**kw):
    """``STEPS`` steps of a BV charging fleet of ``B`` envs of ``N``^2, two
    RK4 substeps a step."""
    from pde_opt_tpu_torch.envs.presets import make_butler_volmer_control_env

    env = make_butler_volmer_control_env(num_envs=B, grid_size=N, substeps=2, device="cpu",
                                         **kw)
    state, _ = env.reset(torch.Generator().manual_seed(0))
    run = env.make_rollout(lambda obs, g: env.sample_actions(g), STEPS)
    return run(state, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("epilogue", [True, False], ids=["epilogue", "no_epilogue"])
def test_bv_macro_span_once_a_step(epilogue):
    """The BV macro's call is one span ``bv_cas.macro`` a fleet step, its
    work envs x substeps, inside the step's stepper span (with the fused
    epilogue and without)."""
    metrics.record_spans(True)
    _bv_rollout(fused_epilogue=epilogue)
    spans = metrics.spans()["spans"]
    macro = [s for s in spans if s[0] == "bv_cas.macro"]
    assert len(macro) == STEPS
    for name, start, end, parent, n in macro:
        assert n == B * 2 and start <= end
        assert spans[parent][0] == "vector_env.stepper"
        assert spans[parent][1] <= start and end <= spans[parent][2]


def test_bv_macro_span_off_without_a_profiler():
    _bv_rollout()
    assert metrics.spans() == {"spans": [], "dropped": 0}


def test_bv_macro_span_is_a_profiler_range():
    """Under a profiler session the span also opens a range of its name,
    which the benchmark's ``bv_macro_roofline`` reads the macro's device time
    by."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _bv_rollout()
    names = [e.name for e in prof.events()]
    assert names.count("bv_cas.macro") == STEPS
