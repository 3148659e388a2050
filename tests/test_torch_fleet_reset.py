"""When an env fleet's auto-reset runs as the fleet-reset pass
(``ops/fleet_reset.py``), and the pass on the card against the plain-torch
auto-reset (this file imports no jax: its ``cuda`` test runs under
``--noconftest`` on a machine with a card and skips without one).

On the CPU: the rule that picks the pass reads only the env's reset
function, its fused epilogue and the tensors it holds.  The CH and BV
presets with the fused epilogue pass every condition but the device; a
pooled or offset observation, a reset that is no ``affine_normal_reset``
(AC, SBM), a step that autograd records and the CPU each send the step to
the torch path, and with ``auto_reset=False`` the step never auto-resets;
each of those presets' ``reset_func`` carries its tuple and is the clamp of
one normal draw by it.
On the card: CH fleets at 64² and 128² and a BV fleet at 64² through two
episode ends (and an env poisoned mid-episode), once through the pass and
once through the torch path, bit for bit, with the launch count equal to
the steps on the pass's side and 0 on the other.
"""

import functools

import pytest
import torch

from pde_opt_tpu_torch.envs.presets import (
    BV_RESET,
    CH_RESET,
    make_allen_cahn_control_env,
    make_butler_volmer_control_env,
    make_cahn_hilliard_control_env,
    make_sbm_butler_volmer_control_env,
)
from pde_opt_tpu_torch.envs.vector_env import _torch_auto_reset
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.fleet_reset import FLEET_RESET

torch.set_num_threads(1)

CPU = dict(num_envs=4, grid_size=16, substeps=2, device="cpu")


def _ch(**kw):
    return make_cahn_hilliard_control_env(**{**CPU, "spectral_solve": "fused", **kw})


def _step_args(env, seed=0):
    """The arguments one step of ``env`` hands its auto-reset (the step
    itself runs the torch path)."""
    seen = []

    def spy(*args):
        seen.append(args)
        return _torch_auto_reset(env, *args)

    gen = torch.Generator().manual_seed(seed)
    state, _ = env.reset(gen)
    env._auto_reset = spy
    env.step(state, env.sample_actions(gen))
    del env._auto_reset
    return seen[0]


@pytest.mark.parametrize("make", [_ch, lambda: make_butler_volmer_control_env(**CPU)],
                         ids=["ch", "bv"])
def test_ch_and_bv_fused_fleets_meet_every_condition_but_the_card(make):
    env = make()
    refusal = env._fleet_reset_refusal(*_step_args(env))
    assert refusal == "the fleet is on cpu, not a CUDA device"


@pytest.mark.parametrize("make,why", [
    (lambda: _ch(obs_downsample=2), "pooled or offset"),
    (lambda: make_allen_cahn_control_env(spectral_solve="fused", **CPU), "affine_normal_reset"),
    (lambda: make_sbm_butler_volmer_control_env(**CPU), "affine_normal_reset"),
    (lambda: _ch(spectral_solve="fft"), "no fused epilogue"),
], ids=["ch-pooled", "ac", "sbm", "ch-fft"])
def test_other_fleets_take_the_torch_path(make, why):
    env = make()
    assert why in env._fleet_reset_refusal(*_step_args(env))


def test_offset_observation_no_auto_reset_and_grad_take_the_torch_path():
    env = _ch()
    args = _step_args(env)
    state, terminated, y1, cv1, t1, steps1, obs = args
    offset = _ch()
    offset.fused_epilogue = {**offset.fused_epilogue, "obs_offset": 127.5}
    assert "pooled or offset" in offset._fleet_reset_refusal(*args)
    off = _ch(auto_reset=False)
    off.reset(torch.Generator().manual_seed(0))
    off._auto_reset = None                       # a step that called it would raise
    off.step(state, off.sample_actions(torch.Generator().manual_seed(1)))
    with torch.enable_grad():
        graded = (state, terminated, y1.detach().requires_grad_(), cv1, t1, steps1, obs)
        assert env._fleet_reset_refusal(*graded) == "autograd records the step"
    with torch.no_grad():
        graded = (state, terminated, y1.detach().requires_grad_(), cv1, t1, steps1, obs)
        assert "CUDA" in env._fleet_reset_refusal(*graded)


def test_torch_path_counts_no_launch():
    kernels.reset_launch_counts()
    for env in (_ch(), _ch(auto_reset=False), make_allen_cahn_control_env(
            spectral_solve="fused", **CPU)):
        gen = torch.Generator().manual_seed(1)
        state, _ = env.reset(gen)
        for _ in range(2):
            state, *_ = env.step(state, env.sample_actions(gen))
    assert kernels.launch_counts()[FLEET_RESET] == 0


@pytest.mark.parametrize("make,affine", [
    (_ch, CH_RESET), (lambda: make_butler_volmer_control_env(**CPU), BV_RESET),
], ids=["ch", "bv"])
def test_preset_reset_is_its_declared_affine_clamp(make, affine):
    env = make()
    assert env.reset_func.affine == affine
    mean, noise, lo, hi = affine
    got = env.reset_func(env.domain, torch.Generator().manual_seed(3), 5)
    z = torch.randn((5, 16, 16), generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, torch.clamp(mean + noise * z, lo, hi))


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(env, gen_seed, actions, poison):
    """Steps ``env`` through ``actions`` from a reset at ``gen_seed``,
    poisoning env 3's field before step ``poison``; returns what each step
    gave, the final state and the launches of the fleet-reset pass."""
    state, obs = env.reset(torch.Generator(device=env.device).manual_seed(gen_seed))
    out = [obs.clone()]
    kernels.reset_launch_counts()
    for i, a in enumerate(actions):
        if i == poison:
            state.y[3] = float("nan")
        state, obs, reward, terminated, _, info = env.step(state, a)
        out += [obs.clone(), info["final_observation"].clone(), reward.clone(),
                terminated.clone(), *(t.clone() for t in state)]
    torch.cuda.synchronize()
    return out, state, kernels.launch_counts()[FLEET_RESET]


@pytest.mark.cuda
@pytest.mark.parametrize("make,grid,kw", [
    (make_cahn_hilliard_control_env, 64, {"spectral_solve": "fused", "end_time": 0.05}),
    (make_cahn_hilliard_control_env, 128, {"spectral_solve": "fused", "end_time": 0.05}),
    (make_butler_volmer_control_env, 64, {"end_time": 0.02}),
], ids=["ch64", "ch128", "bv64"])
def test_fleet_reset_on_card_is_the_torch_path_bit_for_bit(cuda_device, make, grid, kw):
    envs = [make(num_envs=64, grid_size=grid, device=cuda_device, **kw) for _ in range(2)]
    env, twin = envs
    twin._auto_reset = functools.partial(_torch_auto_reset, twin)
    t, length = torch.zeros(()), 0                    # the episode on the f32 clock
    while not bool(t >= env.end_time - 1e-9):
        t, length = t + env.step_dt, length + 1
    agen = torch.Generator(device=cuda_device).manual_seed(2)
    actions = [env.sample_actions(agen) for _ in range(2 * length + 2)]
    want, _, n_twin = _run(twin, 9, actions, poison=1)   # also builds the macro's tables
    torch.cuda.set_sync_debug_mode("error")          # the pass reads nothing back
    try:
        got, state, n = _run(env, 9, actions, poison=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (n, n_twin) == (len(actions), 0)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    # Env 3, poisoned at step 1, ends there and restarts its episode; the
    # others end together every episode length.
    ends = torch.stack(got[4::9]).cpu()               # terminated, step by step
    others = torch.ones(64, dtype=torch.bool)
    others[3] = False
    for i in range(len(actions)):
        want_ends = others & ((i + 1) % length == 0)
        want_ends[3] = i == 1 or (i - 1) % length == 0 and i > 1
        assert torch.equal(ends[i], want_ends), i
    assert bool(torch.isfinite(state.y).all()) and not bool(state.done.any())
