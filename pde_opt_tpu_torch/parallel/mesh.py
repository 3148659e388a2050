"""Device meshes and placements on ``torch.distributed`` (PyTorch port of
:mod:`pde_opt_tpu.parallel.mesh`).

The scaling axis of the PDE control workloads is the **env batch**:
thousands of lockstep envs split over a 1-D ``"env"`` mesh axis, one
process a card, pure data parallelism; the learner is co-located and
averages its gradients with an ``all_reduce``.  Spatial decomposition of
one large grid lives in :mod:`pde_opt_tpu_torch.parallel.halo`.

Where the JAX package lays one process's devices on a mesh, PyTorch runs one
process a card: :func:`init_distributed` starts the process group (NCCL on
the card, gloo for CPU processes), and :func:`make_mesh` lays a
:class:`~torch.distributed.device_mesh.DeviceMesh` over it.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "env_sharding", "replicated_sharding", "shard_map", "init_distributed"]


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available: {what} runs on the card by default; "
            "pass the CPU's settings (device_type='cpu', backend='gloo') to run there"
        )


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, backend: str = "nccl",
                     **kwargs) -> None:
    """Start this process's place in a multi-process run
    (``torch.distributed.init_process_group``).

    A no-op when the process group is already initialised, or in a single
    process: with no coordinator, no process count and none of torchrun's
    variables, so the same script runs unchanged on one card.  Otherwise it
    joins ``tcp://{coordinator_address}`` (``"host:port"``; under torchrun,
    ``env://``) as rank ``process_id`` of ``num_processes``.  torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` fill the arguments not given.

    ``backend="nccl"`` (the default) needs CUDA and raises ``RuntimeError``
    without it; before NCCL starts, the process takes card ``LOCAL_RANK``
    (default: ``process_id`` modulo the cards on the host).  A failure to
    start is raised, never replaced by another backend.  ``kwargs`` go to
    ``init_process_group`` (``init_method`` in place of the coordinator,
    e.g. a ``file://`` store; ``timeout``).
    """
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and process_id "
                         "(or torchrun's WORLD_SIZE and RANK)")
    init_method = kwargs.pop("init_method", None)
    if init_method is None:
        init_method = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    if backend == "nccl":
        _require_cuda("NCCL")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kwargs)


def make_mesh(device_type: str = "cuda", axis_names: Sequence[str] = ("env",),
              shape: Optional[Sequence[int]] = None):
    """A named :class:`~torch.distributed.device_mesh.DeviceMesh` over the
    initialised world (default: every process on one ``"env"`` axis).

    ``device_type="cuda"`` (the default) raises ``RuntimeError`` without
    CUDA; pass ``"cpu"`` for gloo processes.  The process group must be
    initialised first (:func:`init_distributed`).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda":
        _require_cuda("make_mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call init_distributed(...) first")
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axis_names)


def env_sharding(mesh, axis: str = "env"):
    """DTensor placements (a list, one a mesh axis) that split the leading
    (env-batch) axis over ``axis`` and replicate over the mesh's other axes
    (``P(axis)``)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicated_sharding(mesh):
    """Fully replicated placements (policy and learner parameters; ``P()``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def shard_map(f: Callable, mesh, in_specs, out_specs) -> Callable:
    """``f`` on the calling rank's local blocks
    (``torch.distributed.tensor.experimental.local_map``).

    DTensor arguments are unwrapped to their local tensors (the placements
    ``in_specs`` must match theirs), plain tensors pass through, and the
    outputs come back as DTensors with the placements ``out_specs``.  A
    spec is a placements list (:func:`env_sharding`); ``in_specs`` is one
    spec for a single argument or a tuple with a spec for each argument
    (``None`` for a non-tensor), ``out_specs`` one spec or a tuple with a
    spec for each output.  The JAX wrapper's ``check_vma`` has no
    counterpart: PyTorch has no checker of varying manual axes, so a
    collective inside ``f`` (an ``all_reduce`` of the gradients) is the
    caller's to place, as under JAX's ``check_vma=False``.
    """
    from torch.distributed.tensor.experimental import local_map

    if isinstance(in_specs, list):
        in_specs = (in_specs,)
    return local_map(f, out_placements=out_specs, in_placements=in_specs,
                     device_mesh=mesh)


def _mesh_axis(mesh, axis: str):
    """``(size, this rank's index, process group)`` of the mesh axis ``axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    dim = names.index(axis)
    return mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)
