"""Per-env stepping and checkpoints on the card (marked ``cuda``; this
file imports no jax, so it runs under ``--noconftest`` on a machine with a
card and skips without one)."""

import warnings

import pytest
import torch

from pde_opt_tpu_torch.envs.presets import (
    make_allen_cahn_control_env,
    make_cahn_hilliard_control_env,
)
from pde_opt_tpu_torch.envs.vector_env import EnvState
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("make,kw,extra,kernel,per_step", [
    (make_cahn_hilliard_control_env, dict(spectral_solve="fused"), {}, "ch_cas_macro", 1),
    (make_cahn_hilliard_control_env, dict(spectral_solve="fused"), {"algo": "dft"},
     "ch_sif_macro", 1),
    (make_cahn_hilliard_control_env, dict(spectral_solve="fft", derivs="pallas"), {},
     "ch_rhs_fd", 10),
    (make_cahn_hilliard_control_env, dict(spectral_solve="dense"), {}, None, 0),
    (make_allen_cahn_control_env, dict(spectral_solve="fused"), {}, "ac_cas_macro", 1),
    (make_allen_cahn_control_env, dict(spectral_solve="fused"), {"algo": "dft"},
     "ac_sif_macro", 1),
])
def test_per_env_fleet_launches_once_a_step_on_card(cuda_device, make, kw, extra, kernel,
                                                    per_step):
    """A per-env fleet launches its kernel once a step for the whole fleet
    (the fused rhs once a substep) with no batching-rule fallback, and steps
    as its batched twin, fields bit for bit."""
    envs = []
    for vc in (False, True):
        env = make(num_envs=64, grid_size=64, substeps=10, vectorized_control=vc,
                   fused_epilogue=False, device=cuda_device, **kw)
        env.solver_parameters.update(extra)
        envs.append(env)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state, _ = envs[0].reset(gen)
    twin = EnvState(*(t.clone() for t in state))
    envs[1].set_generator(torch.Generator(device=cuda_device).manual_seed(1))
    actions = [envs[0].sample_actions(gen) for _ in range(3)]
    kernels.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        for a in actions:
            state, *_ = envs[0].step(state, a)
    counts = kernels.launch_counts()
    for a in actions:
        twin, *_ = envs[1].step(twin, a)
    want = {n: 0 for n in counts}
    if kernel:
        want[kernel] = 3 * per_step
    assert counts == want
    assert torch.equal(state.y, twin.y) and bool(torch.isfinite(state.y).all())


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    """A tree saved from the card comes back there without a template, and
    onto the template's device and dtype with one."""
    tree = {"w": torch.arange(6.0, device=cuda_device), "g": torch.Generator(
        device=cuda_device).manual_seed(3).get_state()}
    ckpt.save_checkpoint(str(tmp_path), 0, tree)
    plain = ckpt.restore_checkpoint(str(tmp_path))
    assert plain["w"].is_cuda and torch.equal(plain["w"], tree["w"])
    back = ckpt.restore_checkpoint(str(tmp_path), template={
        "w": torch.zeros(6, dtype=torch.float64), "g": torch.Generator().get_state()})
    assert back["w"].device.type == "cpu" and back["w"].dtype == torch.float64
    gen = torch.Generator(device=cuda_device).set_state(back["g"])
    ref = torch.Generator(device=cuda_device).manual_seed(3)
    assert torch.equal(torch.rand(4, generator=gen, device=cuda_device),
                       torch.rand(4, generator=ref, device=cuda_device))
