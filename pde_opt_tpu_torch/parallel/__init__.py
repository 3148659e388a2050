"""Multi-card scale-out on ``torch.distributed``: meshes, sharded env
fleets, halo exchange and the distributed FFT (PyTorch port of
:mod:`pde_opt_tpu.parallel`).  One process a card; NCCL on the card, gloo
for CPU processes.  ``python -m pde_opt_tpu_torch.parallel.dryrun`` runs
the sharded training step on every card of the host."""

from . import halo
from .mesh import env_sharding, init_distributed, make_mesh, replicated_sharding, shard_map
from .sharded_env import ShardedVectorPDEEnv

__all__ = ["make_mesh", "env_sharding", "replicated_sharding", "shard_map", "init_distributed",
           "halo", "ShardedVectorPDEEnv"]
