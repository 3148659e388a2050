"""The port's multi-process entry path: ``init_distributed`` in real OS
processes, and the multi-card dry run.

The counterparts of ``tests/test_distributed.py``, by name: two spawned
processes (``torch_dist_ranks.distributed_program``, torch only) join one
gloo group through ``init_distributed``'s coordinator address, see a world
of two and gather a tensor from each other; then they run
``dryrun_multichip(2)``, whose record carries the JAX dry run's keys.  Two
more processes join through torchrun's variables alone.
"""

import re
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from pde_opt_tpu_torch.parallel import init_distributed
from pde_opt_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_dist_ranks import distributed_program, spawn_group, value

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    torch.set_num_threads(1)
    # Both groups start at once; each test waits for the one it reads.
    return {
        "tcp": spawn_group(distributed_program, 2, tmp_path_factory.mktemp("tcp"),
                           {"dryrun": True}, init="tcp"),
        "torchrun": spawn_group(distributed_program, 2, tmp_path_factory.mktemp("torchrun"),
                                {}, init="torchrun"),
    }


def _check_collective(results):
    for pid, res in enumerate(results):
        got = value(res, "collective")
        assert got["world"] == 2 and got["rank"] == pid and got["backend"] == "gloo"
        assert got["gathered"].shape == (2, 4)
        assert (got["gathered"][0] == 1.0).all() and (got["gathered"][1] == 2.0).all()


def test_two_process_distributed_init_and_collective(groups):
    _check_collective(groups["tcp"]())


def test_init_distributed_reads_torchrun_variables(groups):
    """RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/PORT, no arguments."""
    _check_collective(groups["torchrun"]())


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    # No coordinator, no process count: a no-op (the same script runs
    # unchanged on one card).
    init_distributed()
    assert not dist.is_initialized()


def test_init_distributed_nccl_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("127.0.0.1:1", 2, 0)
    assert not dist.is_initialized()


def test_dryrun_multichip_record_has_the_jax_keys(groups):
    """The MULTICHIP_SCALING record of two gloo processes: the JAX dry run's
    keys (``__graft_entry__.py``), the platform named truthfully."""
    src = (ROOT / "__graft_entry__.py").read_text()
    block = src[src.index('print("MULTICHIP_SCALING "'):]
    jax_keys = re.findall(r'"(\w+)":', block[:block.index("flush=True")])
    assert jax_keys == ["n_devices", "envs_per_shard", "sharded_train_step_ms",
                        "local_only_step_ms", "collective_share", "platform"]
    records = [value(r, "dryrun") for r in groups["tcp"]()]
    for rec in records:
        assert list(rec) == jax_keys
        assert rec["n_devices"] == 2 and rec["envs_per_shard"] == 2
        assert rec["platform"] == "cpu"
        assert rec["sharded_train_step_ms"] > 0 and rec["local_only_step_ms"] > 0
        assert 0.0 <= rec["collective_share"] < 1.0


def test_dryrun_needs_an_initialised_world():
    with pytest.raises(RuntimeError, match="initialised world of 2"):
        dryrun_multichip(2)
