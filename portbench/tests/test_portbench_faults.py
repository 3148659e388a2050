"""A run whose timed path is broken underneath must come out not correct:
each fault the cells can have, planted in the program, at a tiny size on
the CPU with the cells' own limits.  The look for a chip is skipped: the
runs go through ``runner.run_cell`` on the CPU."""

import pytest
import torch

from .tiny import run, tiny_cell


def _fails(checks):
    return not all(c["ok"] for c in checks.values())


@pytest.fixture
def stepper():
    from pde_opt_tpu_torch.ops.steppers import FusedSemiImplicitSpectral

    return FusedSemiImplicitSpectral


@pytest.mark.parametrize("cell", ["ch64.rollout", "ch128.rollout"])
def test_rollout_state_unchanged(monkeypatch, stepper, cell):
    """The stepper returns the field it was given."""
    orig = stepper.evolve_with_epilogue

    def unchanged(self, rhs, y0, t0, dt, n, ep):
        _, stats, obs = orig(self, rhs, y0, t0, dt, n, ep)
        return y0.clone(), stats, obs

    monkeypatch.setattr(stepper, "evolve_with_epilogue", unchanged)
    checks, _ = run(tiny_cell(cell), 21)
    assert _fails(checks), checks


@pytest.mark.parametrize("cell", ["ch64.rollout", "ch128.rollout"])
def test_rollout_half_the_fleet_left_out(monkeypatch, stepper, cell):
    """The stepper advances the first half of the fleet only."""
    orig = stepper.evolve_with_epilogue

    def half(self, rhs, y0, t0, dt, n, ep):
        y1, stats, obs = orig(self, rhs, y0, t0, dt, n, ep)
        h = y0.shape[0] // 2
        return torch.cat([y1[:h], y0[h:]]), stats, obs

    monkeypatch.setattr(stepper, "evolve_with_epilogue", half)
    checks, _ = run(tiny_cell(cell), 22)
    assert _fails(checks), checks


@pytest.mark.parametrize("cell", ["ch64.rollout", "ch128.rollout"])
def test_rollout_answer_altered(monkeypatch, cell):
    """Every reward raised by 1e-4 where the env produces it."""
    from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv

    orig = VectorPDEEnv.step

    def altered(self, state, actions):
        st, obs, reward, *rest = orig(self, state, actions)
        return (st, obs, reward + 1e-4, *rest)

    monkeypatch.setattr(VectorPDEEnv, "step", altered)
    checks, _ = run(tiny_cell(cell), 23)
    assert _fails(checks), checks

