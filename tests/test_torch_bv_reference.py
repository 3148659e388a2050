"""The port's BV charging fleet held against the benchmark's plain float64
reference (``portbench/reference/bv.py``), which is written from the
equations alone: the fused macro's plain path (what CPU tensors run, and
what kernel K6 is held against on the card), one fleet step of the preset,
the reference's own charge balance and the ``charge_gap`` reading that the
``bv64.rollout`` cell compares.

Tolerances, each from the gap measured on the CPU (torch on 2 threads) with
room:

    macro, f32 matrices, 10 substeps       atol 1e-6  (2.0e-7 measured: f32
                                           rounding of fields near 0.3)
    macro, bf16 matrices, 10 substeps      atol 6e-5  (2.0e-5 at 24 x 32: the
                                           reference rounds the operands but
                                           keeps exact transforms, the macro
                                           also rounds its matrices)
    one fleet step, field                  atol 2e-6  (2.4e-7 measured, bf16
                                           matrices on 16^2)
    one fleet step, reward                 atol 2e-6  (3.5e-7 measured: f32
                                           moments of fields near 0.05)
    one fleet step, obs                    <= 1 LSB   (0 measured: truncation)
    one fleet step, C-rate                 atol 1e-6  (2.4e-8: the f32 clip)
    the reference's balance sum(k) cell    1e-12      (6e-15 measured, f64)
    charge_gap of the plain path           <= 1e-6    (2e-9 measured; the
                                           cheap closure reads 1e-5)
"""

import json
from pathlib import Path

import pytest
import torch

from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU, make_butler_volmer_control_env
from pde_opt_tpu_torch.ops.bv_cas import make_bv_cc_fused_macro
from portbench.reference import bv

torch.set_num_threads(2)

CPU = torch.device("cpu")
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                     / "bv-control-64.json").read_text())
PHYS = CONFIG["physics"]
KAPPA, DT, N = PHYS["grad_kappa"], 5e-4, 10
CRATES = torch.tensor([0.2, 1.0, 3.0])
TOL_MACRO = {torch.float32: 1e-6, torch.bfloat16: 6e-5}
TOL_FIELD, TOL_REWARD, TOL_CRATE = 2e-6, 2e-6, 1e-6
TOL_BALANCE = 1e-12
TOL_CHARGE = 1e-6


def _field(H, W, seed):
    """Three envs of fields around 0.3 (where the closure's terms are of a
    size), one each C-rate of ``CRATES``."""
    g = torch.Generator().manual_seed(seed)
    return torch.clamp(0.3 + 0.1 * torch.randn((3, H, W), generator=g), 0.01, 0.99)


def _geometry(H, W):
    return bv.lap_symbol(H, W, PHYS["length"], CPU), (PHYS["length"] ** 2) / (H * W)


@pytest.mark.parametrize("mats", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,W", [(16, 16), (24, 32)])
def test_plain_macro_matches_reference(H, W, mats):
    """Ten RK4 substeps of the macro's plain path against the reference's,
    at C-rates 0.2, 1 and 3; with bf16 matrices against the reference that
    rounds each transform's operand, intermediate and output to bf16."""
    u = _field(H, W, H * W)
    lam, cell = _geometry(H, W)
    macro = make_bv_cc_fused_macro(BV_MU, BV_J0, KAPPA, H, W, PHYS["length"] / H,
                                   PHYS["length"] / W, DT, N, mats_dtype=mats)
    got = macro(u, CRATES)
    rnd = bv.bf16_rounding if mats == torch.bfloat16 else None
    want = bv.substeps(u.double(), CRATES.double(), PHYS, N, DT, lam, cell, rnd)
    assert (got.double() - want).abs().max() < TOL_MACRO[mats]


def _fleet_step(seed):
    """One step of a 6-env 16^2 preset fleet five steps into its episodes,
    envs 0-2 at the episode's last step, beside the reference's step from the
    same state, action and reset draw."""
    env = make_butler_volmer_control_env(num_envs=6, grid_size=16, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    state, _ = env.reset(gen)
    pol = torch.Generator().manual_seed(100 + seed)
    for _ in range(5):
        state, *_ = env.step(state, env.sample_actions(pol))
    state.t[:3] = 0.199
    s0 = bv.FleetState(state.y.double(), state.control_value.double(), state.t.clone(),
                       state.step_count.long())
    draw = bv._draw(gen.get_state(), (6, 16, 16), CPU)
    action = env.sample_actions(pol)
    got = env.step(state, action)
    lam, cell = _geometry(16, 16)
    fleet = dict(CONFIG["fleet"], grid=16)
    want = bv.fleet_step(s0, action, draw(), fleet, PHYS, 1, lam, cell)
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_step_matches_reference(seed):
    """Field, reward, obs, episode ends, C-rate, clock and step count of one
    preset fleet step (fused macro, bf16 matrices, epilogue, auto-reset)."""
    (st, obs, reward, term, _, _), (s, r, t, o) = _fleet_step(seed)
    assert term.tolist() == [True] * 3 + [False] * 3
    assert torch.equal(term, t)
    assert (st.y.double() - s.y).abs().max() < TOL_FIELD
    assert (reward.double() - r).abs().max() < TOL_REWARD
    assert (obs.reshape(o.shape).int() - o.int()).abs().max() <= 1
    assert (st.control_value.double() - s.kappa).abs().max() < TOL_CRATE
    assert st.control_value[:3].tolist() == [PHYS["kappa_reset"]] * 3
    assert torch.equal(st.t, s.t) and torch.equal(st.step_count.long(), s.steps)


@pytest.mark.parametrize("H,W", [(16, 16), (24, 32), (64, 64)])
def test_reference_stage_is_galvanostatic(H, W):
    """``sum(k) cell = C`` at every stage of the reference, in f64."""
    lam, cell = _geometry(H, W)
    c = CRATES.double().reshape(-1, 1, 1)
    u = _field(H, W, 7).double()
    for _ in range(3):
        k = bv.stage(u, c, PHYS, lam, cell)
        assert (k.sum((-2, -1)) * cell - c.reshape(-1)).abs().max() < TOL_BALANCE
        u = u + DT * k


def _charge(y0, y1, crates, H, W):
    return bv.charge_gaps(y0, y1, crates, torch.ones(3, dtype=torch.bool), N * DT,
                          PHYS["length"] ** 2 / (H * W)).max()


@pytest.mark.parametrize("H,W", [(16, 16), (64, 64)])
def test_charge_gap_separates_the_cheap_closure(H, W):
    """``charge_gap`` of one step (10 substeps): within 1e-6 for the plain
    path, in f32 and with bf16 matrices, and beyond it for the reference
    with its closure rounded to bf16, alone (the cheap closure) and beside
    fp8 transforms (the cell's control).  The fp8 transforms alone the
    balance does not see: they read at f64 rounding (their field gap fails
    them instead, ``test_fp8_control_fails_on_the_field``)."""
    u = _field(H, W, 11)
    lam, cell = _geometry(H, W)
    for mats in (torch.float32, torch.bfloat16):
        macro = make_bv_cc_fused_macro(BV_MU, BV_J0, KAPPA, H, W, 1.0 / H, 1.0 / W, DT, N,
                                       mats_dtype=mats)
        assert _charge(u, macro(u, CRATES), CRATES, H, W) <= TOL_CHARGE
    ud = u.double()
    cheap = bv.substeps(ud, CRATES.double(), PHYS, N, DT, lam, cell, closure=bv.bf16_rounding)
    assert _charge(ud, cheap, CRATES, H, W) > TOL_CHARGE
    both = bv.substeps(ud, CRATES.double(), PHYS, N, DT, lam, cell, bv.fp8_rounding,
                       bv.bf16_rounding)
    assert _charge(ud, both, CRATES, H, W) > TOL_CHARGE
    fp8 = bv.substeps(ud, CRATES.double(), PHYS, N, DT, lam, cell, bv.fp8_rounding)
    assert _charge(ud, fp8, CRATES, H, W) < 1e-12


def test_fp8_control_fails_on_the_field():
    """The fp8 control's step sits much farther from the reference than the
    plain bf16 path at 64^2 (10.6x measured on rough fields around 0.3): the
    transforms' rounding it stands for shows in the field, where the charge
    balance cannot see it."""
    H = W = 64
    u = _field(H, W, 13)
    lam, cell = _geometry(H, W)
    want = bv.substeps(u.double(), CRATES.double(), PHYS, N, DT, lam, cell)
    fp8 = bv.substeps(u.double(), CRATES.double(), PHYS, N, DT, lam, cell, bv.fp8_rounding)
    macro = make_bv_cc_fused_macro(BV_MU, BV_J0, KAPPA, H, W, 1.0 / H, 1.0 / W, DT, N)
    prog = (macro(u, CRATES).double() - want).abs().max()
    assert (fp8 - want).abs().max() > 5 * prog


@pytest.mark.parametrize("ds", [1, 2])
def test_preset_obs_downsample(ds):
    """The fused BV epilogue emits the full-size observation: 1 builds, any
    other value raises."""
    kw = dict(num_envs=2, grid_size=16, device="cpu", obs_downsample=ds)
    if ds == 1:
        env = make_butler_volmer_control_env(**kw)
        _, obs = env.reset(torch.Generator().manual_seed(0))
        assert obs.shape == (2, 1, 16, 16)
    else:
        with pytest.raises(ValueError, match="obs_downsample"):
            make_butler_volmer_control_env(**kw)
