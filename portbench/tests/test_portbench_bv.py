"""The BV charging cell ``bv64.rollout``: a tiny run on the CPU against the
plain reference, the frozen work model of K6, the ``bv_macro_roofline``
reader on hand-built traces, and the cell's controls against its limits
(on the CPU at a tiny size and, marked ``cuda``, at the cell's own size)."""

import json

import pytest

from portbench import controls_bv, core, workmodel_bv
from portbench.trace import WINDOW, DeviceOp, Trace

from .tiny import CPU, run, tiny_cell

CELL = "bv64.rollout"
MACRO = "bv_cas.macro"


def _beyond(readings: dict, limits: dict) -> bool:
    return any(not readings[k] <= limits[k] for k in limits if k in readings)


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_tiny_run_passes_its_checks(traced):
    """A whole run of the cell on the CPU's plain macro (episodes of 4
    steps, so the checked steps cross episode ends): every number within
    its limit, and no early episode end."""
    cell = tiny_cell(CELL)
    cell.config["fleet"]["end_time"] = 0.02
    checks, res = run(cell, 2**35 + 3, traced=traced)
    assert all(c["ok"] for c in checks.values()), checks
    assert set(checks) == {"field_gap", "reward_gap", "obs_lsb", "charge_gap",
                           "state_mismatch", "reset_mismatch"}
    assert res["attempted"] > 0 and res["failed"] == 0
    if traced:
        assert res["trace"].ranges.get(MACRO)


def test_workmodel_at_the_cells_shape():
    """2048 x 64^2 x 10 substeps with the epilogue: 80 transforms an env at
    the bf16 peak plus 134 operations a pixel-substep at the f32 peak, the
    0.3415 ms bound of K6 (``PERF.md`` section 6)."""
    products, ew, nbytes = workmodel_bv.bv_macro_work(2048, 64, 64, 10)
    assert products == 80 * 1_048_576 * 2048
    assert ew == 134 * 4096 * 10 * 2048
    mats, lam = 4 * 2 * 64 * 64 * 4, 64 * 64 * 4
    assert nbytes == 2048 * 4096 * 8 + 2048 * 4 + mats + lam + 2048 * (4096 + 12)
    ms, what = workmodel_bv.bv_macro_bound_ms(2048, 64, 64, 10)
    assert what == "operations"
    assert ms == pytest.approx(0.3415, rel=5e-3)


def _trace(ranges, steps=2, ms=1.0):
    """A traced window of ``steps`` steps, each one device operation of
    ``ms`` launched inside ``ranges``, and one outside them."""
    ops = [DeviceOp("k", 1e3 * i, 1e3 * (i + ms), 0, frozenset(ranges)) for i in range(steps)]
    ops.append(DeviceOp("glue", 1e4, 1e4 + 50.0, 0, frozenset()))
    return Trace(ops=ops, ranges={WINDOW: [(0.0, 2e4)]}, window_us=(0.0, 2e4), host_events=[],
                 steps=steps, info={"B": 2048, "H": 64, "W": 64, "substeps": 10, "ds": 1})


def test_roofline_reads_the_macro_range():
    read = core.metric_reader("bv_macro_roofline").read
    cell = core.resolve_cell(CELL)
    bound, _ = workmodel_bv.bv_macro_bound_ms(2048, 64, 64, 10)
    assert read(_trace((WINDOW, MACRO), ms=2.0), cell) == pytest.approx(100 * bound / 2.0)


@pytest.mark.parametrize("case", ["ch_cell", "no_span", "no_steps"])
def test_roofline_reads_nothing_where_it_has_nothing(case):
    """``None`` on a CH cell, on a program without the span (the parent's
    trace holds no ``bv_cas.macro`` range) and on a window of no steps."""
    read = core.metric_reader("bv_macro_roofline").read
    cell = core.resolve_cell("ch64.rollout" if case == "ch_cell" else CELL)
    trace = _trace((WINDOW,) if case == "no_span" else (WINDOW, MACRO),
                   steps=0 if case == "no_steps" else 2)
    assert read(trace, cell) is None


def test_controls_fail_tiny():
    """At 16^2 the control of ``controls.py`` (fp8 transforms, bf16 closure)
    and the cheap closure read beyond a limit; the fp8 transforms alone do
    not there (a 16^2 Laplacian is 16 times smaller than a 64^2 one, and so
    is what their rounding does to it), and are held at the cell's size."""
    c = tiny_cell(CELL)
    readings = controls_bv.control_readings(c, 31, CPU)
    for kind in ("fp8", "bf16_closure"):
        assert _beyond(readings[kind], c.limits["limits"]), (kind, readings[kind])


@pytest.mark.cuda
def test_controls_fail_at_cell_size(cuda_device):
    c = core.resolve_cell(CELL)
    for seed in (1, 2, 3):
        for kind, readings in controls_bv.control_readings(c, seed, cuda_device).items():
            assert _beyond(readings, c.limits["limits"]), (seed, kind, readings)


# The cell's readings on the card (PERF.md section 2): the program's largest
# over its seeds, and the smallest of the control each limit was set against
# over 3 seeds (field_gap: the fp8 control; reward_gap: the fp8 transforms
# alone; charge_gap: the cheap closure).
PROGRAM_READINGS = {"field_gap": 5.52e-5, "reward_gap": 8.09e-7, "obs_lsb": 1.0,
                    "charge_gap": 1.31e-8}
UPPER_READINGS = {"field_gap": 1.86e-3, "reward_gap": 8.29e-6, "charge_gap": 2.95e-5}


def test_limits_lie_between_the_program_and_its_controls():
    limits = core.resolve_cell(CELL).limits["limits"]
    for name, value in PROGRAM_READINGS.items():
        assert core.compare({name: value}, {name: limits[name]})[name]["ok"], name
    for name, value in UPPER_READINGS.items():
        assert not core.compare({name: value}, {name: limits[name]})[name]["ok"], name


def test_config_is_a_deployment_of_its_own():
    """``bv-control-64`` names the upstream equation that defines it, so its
    source and reduced keys are those of no other configuration."""
    configs = json.loads((core.ROOT / "BENCHMARK.json").read_text())["configs"]
    bv = next(c for c in configs if c["name"] == "bv-control-64")
    assert "allen_cahn.py" in bv["source"]
    others = [(c["source"], c["reduced"]) for c in configs if c is not bv]
    assert (bv["source"], bv["reduced"]) not in others
