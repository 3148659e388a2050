"""The plain references against the port's CPU path at tiny sizes."""

import pytest
import torch

from portbench import core
from portbench.reference import ch

from .tiny import CPU, run, tiny_cell


def test_ch_substeps_match_the_ports_unrounded_macro():
    """Ten semi-implicit substeps of the reference against the port's macro
    with float32 matrices (no bf16 rounding), 4 envs of 16^2."""
    from pde_opt_tpu_torch.envs.presets import CH_MU
    from pde_opt_tpu_torch.ops.cas_spectral import make_ch_cas_fused_macro

    cfg = core.resolve_cell("ch64.rollout").config
    phys = cfg["physics"]
    g = torch.Generator().manual_seed(3)
    u = 0.5 + 0.05 * torch.randn((4, 16, 16), generator=g)
    kappa = torch.tensor([0.002, 0.004, 0.007, 0.01])
    dt = 0.001
    macro = make_ch_cas_fused_macro(CH_MU, 16, 16, phys["dx"], phys["dx"], phys["A"], dt, 10,
                                    mats_dtype=torch.float32)
    got = macro(u, kappa)
    want = ch.substeps(u.double(), kappa.double(), phys, 10, dt,
                       ch.lap_symbol(16, 16, phys["dx"], CPU))
    assert (got.double() - want).abs().max() < 2e-6


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 17])
def test_rollout_cell_agrees(seed):
    """A whole run of the rollout cell on the CPU's plain macro: the
    reference follows its checked steps within the cell's limits."""
    checks, res = run(tiny_cell("ch64.rollout"), seed)
    assert all(c["ok"] for c in checks.values()), checks
    assert res["attempted"] > 0 and res["failed"] == 0


def test_rollout_traced_run_checks_too():
    checks, res = run(tiny_cell("ch128.rollout"), 9, traced=True)
    assert all(c["ok"] for c in checks.values()), checks
    assert res["trace"].steps > 0



def test_rollout_device_rate_window_checks_and_runs_whole_slices():
    """The window traced in slices (``ch64.rollout``'s device rate): every
    slice runs whole segments, the checked ones among them, and the reference
    follows them within the limits.  The CPU has no device operation to
    read, so the rate is left out rather than given as 0."""
    cell = tiny_cell("ch64.rollout")
    assert any(m["source"] == "device_trace" for m in cell.end_to_end)
    cell.traffic["window_trace_segments"] = 2
    checks, res = run(cell, 2**33 + 7)
    assert all(c["ok"] for c in checks.values()), checks
    assert res["failed"] == 0
    segments = res["attempted"] // (8 * cell.traffic["segment_steps"])
    assert segments >= 2 and segments % 2 == 0
    assert "device_env_steps_per_s" not in res["metrics"]


def test_rollout_traced_run_reads_the_host_rate_first():
    """A traced run of a cell with a per-layer host-clock rate runs an
    untraced window first and hands its rate to that metric's reader."""
    from portbench import runner

    cell = tiny_cell("ch64.rollout")
    checks, res = run(cell, 11, traced=True)
    assert all(c["ok"] for c in checks.values()), checks
    rate = res["trace"].info["env_steps_per_s"]
    assert rate > 0
    assert runner.per_layer(cell, res["trace"])["host_env_steps_per_s"]["value"] == rate


def test_device_bound_cell_keeps_its_host_rate_end_to_end():
    """``ch128.rollout`` keeps its host-clock rate end to end and runs no
    untraced window in a traced run."""
    cell = tiny_cell("ch128.rollout")
    _, res = run(cell, 5)
    assert res["metrics"]["env_steps_per_s"]["value"] > 0
    _, res = run(cell, 5, traced=True)
    assert "env_steps_per_s" not in res["trace"].info
