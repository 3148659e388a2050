"""The controls of each cell's comparison: the reference put in the
program's place at a lower precision than the configuration states must
read beyond a limit.  On the CPU at a tiny size, and (marked ``cuda``) at
the cell's own size on the card, three seeds each."""

import pytest

from portbench import controls, core

from .tiny import CPU, tiny_cell

CELLS = [w["name"] for w in core.load_manifest()["workloads"] if w["chips"] == 1]


def _beyond(readings: dict, limits: dict) -> bool:
    return any(not readings[k] <= limits[k] for k in limits if k in readings)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_tiny(cell):
    c = tiny_cell(cell)
    for kind, readings in controls.control_readings(c, 31, CPU).items():
        assert _beyond(readings, c.limits["limits"]), (kind, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell, cuda_device):
    c = core.resolve_cell(cell)
    for seed in (1, 2, 3):
        for kind, readings in controls.control_readings(c, seed, cuda_device).items():
            assert _beyond(readings, c.limits["limits"]), (seed, kind, readings)


# The smallest reading of each control or fault at the cell's own size on
# the card, for the numbers whose limits PERF.md sets from them.
UPPER_READINGS = {
    "ch64.rollout": {"obs_lsb": 7.0, "field_gap": 0.0307, "reward_gap": 1.56e-4},
    "ch128.rollout": {"obs_lsb": 7.0, "field_gap": 0.0292, "reward_gap": 1.54e-4},
}


@pytest.mark.parametrize("cell", sorted(UPPER_READINGS))
def test_upper_readings_fail_their_limits(cell):
    """Each limit lies below the reading it was set against, so
    ``core.compare`` fails that reading."""
    limits = core.resolve_cell(cell).limits["limits"]
    for name, value in UPPER_READINGS[cell].items():
        assert not core.compare({name: value}, {name: limits[name]})[name]["ok"], name
