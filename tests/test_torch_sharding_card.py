"""The sharded fleet and the distributed FFT on the card (marked ``cuda``;
this file imports no jax, so it runs under ``--noconftest`` on a machine
with a card and skips without one).  A world of one NCCL rank in this
process; two or more ranks, one a card, where the machine has the cards."""

import pytest
import torch
import torch.distributed as dist

from torch_dist_ranks import card_fleet, card_program, spawn_group, value


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_world_one_nccl_fleet_is_the_unsharded_fleet_on_card(cuda_device, tmp_path):
    """A world of one NCCL rank: the sharded flagship fleet (K1) is the
    unsharded one bit for bit across an episode end, one launch a step."""
    from pde_opt_tpu_torch.parallel import init_distributed

    init_distributed(num_processes=1, process_id=0, init_method=f"file://{tmp_path}/store")
    try:
        got = card_fleet(0, 1, cuda_device, 256, 12, 0.1)
    finally:
        dist.destroy_process_group()
    assert got["diff"] == 0.0 and got["ends"] > 0 and got["launches"] == 12


@pytest.mark.cuda
def test_two_or_more_cards_fleet_and_fft(cuda_device, tmp_path):
    """One NCCL rank a card: each rank launches K1 once a step on its own
    card, and its block of the distributed FFT of a 1024^2 field is the
    one-card FFT's column block (f32)."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices")
    results = spawn_group(card_program, world, tmp_path, {}, init="tcp", backend="nccl")()
    for rank, res in enumerate(results):
        fleet, fft = value(res, "fleet"), value(res, "fft")
        assert fleet["launches"] == 5
        assert fft["device"] == f"cuda:{rank}"
        assert fft["fft"] < 1e-5 and fft["back"] < 1e-5
