"""The multi-card dry run: one sharded training step through the fused
macro (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m pde_opt_tpu_torch.parallel.dryrun          # every card of the host

Each rank steps its shard of a Cahn-Hilliard control fleet (the flagship's
code path: ``vectorized_control=True`` through the fused cas macro, K2
forward and K3 backward on the card) for two env steps under a small
periodic-CNN policy, differentiates the pathwise loss with respect to the
policy's parameters, averages the gradients over the ranks (one
``all_reduce``) and takes an SGD step.  It then times that step against the
same per-rank program without the collectives, and rank 0 prints the
``MULTICHIP_SCALING`` line with the JAX dry run's keys.
"""

from __future__ import annotations

import json
import math
import socket
import time

import torch
import torch.distributed as dist

from ..envs.presets import make_cahn_hilliard_control_env
from ..models.functions.cnn import PeriodicCNN
from ..rl.ppo import _group_mean_
from .mesh import init_distributed, make_mesh
from .sharded_env import ShardedVectorPDEEnv

__all__ = ["dryrun_multichip"]

ENVS_PER_DEVICE, GRID, SUBSTEPS, ENV_STEPS, LR, REPS = 2, 16, 2, 2, 0.1, 5


def dryrun_multichip(n_devices: int) -> dict:
    """One sharded training step on an ``n_devices`` mesh at the JAX dry
    run's shapes (2 envs a rank, 16², 2 substeps an env step, 2 env steps),
    timed with and without the collectives.

    Runs in each of ``n_devices`` processes of an initialised world (NCCL:
    one card each; gloo: the CPU).  Raises if the loss is not finite or the
    gradient is zero or not finite.  Returns the
    ``MULTICHIP_SCALING`` record, which rank 0 prints.
    """
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) runs in each process of an initialised "
            f"world of {n_devices}; `python -m pde_opt_tpu_torch.parallel.dryrun` "
            "starts them")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = make_mesh(device_type)
    dev = torch.device(device_type)
    env = make_cahn_hilliard_control_env(
        num_envs=ENVS_PER_DEVICE * n_devices, grid_size=GRID, substeps=SUBSTEPS,
        spectral_solve="fused", vectorized_control=True, device=dev)
    senv = ShardedVectorPDEEnv(env, mesh)
    local, group = senv.local, senv.group
    # One seed on every rank: the same policy everywhere.
    policy = PeriodicCNN(1, (4,), 1, 3, generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    params = list(policy.parameters())
    state, _ = senv.reset(torch.Generator(device=dev).manual_seed(0))
    y, cv = state.y, state.control_value

    def rank_loss():
        yy, cc, rewards = y, cv, []
        for _ in range(ENV_STEPS):
            actions = policy(yy).mean(dim=(-2, -1))[..., None]
            yy, cc = local._advance_batched(yy, cc, actions)
            rewards.append(local.reward_function(yy))
        return -torch.stack(rewards).mean()

    def sharded_step():
        loss = rank_loss()
        grads = list(torch.autograd.grad(loss, params))
        # The rank's partial gradients to the global mean gradient.
        loss = loss.detach().reshape(1)
        _group_mean_(grads + [loss], group)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= LR * g
        return grads, loss

    def local_step():
        """The same per-rank program without the collectives (the timing
        foil); the gradients' norm keeps the backward live."""
        loss = rank_loss()
        grads = torch.autograd.grad(loss, params)
        return torch.stack([loss.detach(), sum((g * g).sum() for g in grads)])

    grads, loss = sharded_step()
    if not torch.isfinite(loss).all():
        raise RuntimeError(f"non-finite training loss: {float(loss)}")
    # A real gradient flowed through the rollout (the step it makes is far
    # below the parameters' f32 ulp at this shape).
    norm = float(sum((g * g).sum() for g in grads))
    if not (norm > 0.0 and math.isfinite(norm)):
        raise RuntimeError(f"the training step's gradient is {norm}")

    def timed(fn):
        def sync():
            if device_type == "cuda":
                torch.cuda.synchronize()

        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        sync()
        return (time.perf_counter() - t0) / REPS

    t_full = timed(sharded_step)
    t_local = timed(local_step)
    record = {
        "n_devices": n_devices,
        "envs_per_shard": ENVS_PER_DEVICE,
        "sharded_train_step_ms": 1e3 * t_full,
        "local_only_step_ms": 1e3 * t_local,
        "collective_share": max(0.0, (t_full - t_local) / t_full) if t_full > 0 else 0.0,
        "platform": "gpu" if device_type == "cuda" else "cpu",
    }
    if dist.get_rank() == 0:
        print("MULTICHIP_SCALING " + json.dumps(record), flush=True)
    return record


def _worker(rank: int, world: int, address: str) -> None:
    init_distributed(address, world, rank)
    try:
        dryrun_multichip(world)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the multi-card dry run needs CUDA devices")
    world = torch.cuda.device_count()
    torch.multiprocessing.spawn(_worker, args=(world, f"127.0.0.1:{_free_port()}"), nprocs=world)
    print("dryrun_multichip OK", flush=True)


if __name__ == "__main__":
    main()
