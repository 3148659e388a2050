"""Env fleets sharded over a device mesh (PyTorch port of
:mod:`pde_opt_tpu.parallel.sharded_env`).

Each rank owns ``num_envs / P`` envs of the fleet as plain local tensors on
its own device: an :class:`~pde_opt_tpu_torch.envs.vector_env.EnvState` of
its rows, stepped by the rank's own copy of the env.  The state never leaves
its rank and a step makes no collective, so each rank launches the fleet's
macro once a step, as one card does; the only collectives are those the
caller's learner makes (an ``all_reduce`` of gradients and metrics).  No
DTensor is on the hot path: each DTensor op costs host dispatch, and the
fleet's step is paced by the host.

Random streams.  The port's fleet draws ``(B, *points)`` fields from one
``torch.Generator``, not per-env keys, so:

* ``reset(generator)``, given the same seed on every rank, draws the whole
  fleet of ``num_envs`` envs and keeps the rank's rows: the same fleet as
  the unsharded env's ``reset`` (a one-time cost of a whole fleet's draw).
* At world size 1 everything, auto-reset included, is bit for bit the
  unsharded fleet's.
* At world size P > 1 each rank draws its auto-reset fields, and a
  rollout's actions, from a stream of its own: ``P`` seeds drawn from the
  given generator (the same on every rank), the rank's seed for a new
  generator.  Ranks that shared one stream would reset their envs to the
  same fields.  Deriving a stream reads the seed back, so ``reset`` and
  each ``rollout`` wait for the device once at P > 1.  After an episode
  ends the sharded fleet therefore diverges from the unsharded one, as the
  port's streams diverge from the JAX package's.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from ..envs.vector_env import EnvState, VectorPDEEnv
from .mesh import _mesh_axis

__all__ = ["ShardedVectorPDEEnv"]


def _rank_stream(generator: torch.Generator, rank: int, n: int) -> torch.Generator:
    """The rank's own generator: ``generator`` itself in a world of one,
    else seeded with the rank's of ``n`` seeds drawn from ``generator``."""
    if n == 1:
        return generator
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(int(seeds[rank]))


def _check_device(device: torch.device, mesh_device_type: str) -> None:
    """The fleet must live on this rank's card of the mesh (or the CPU for a
    CPU mesh)."""
    if device.type != mesh_device_type:
        raise ValueError(f"the fleet is on {device}, the mesh on {mesh_device_type}")
    if device.type == "cuda" and device.index is not None \
            and device.index != torch.cuda.current_device():
        raise ValueError(f"the fleet is on {device}, this rank's card is "
                         f"cuda:{torch.cuda.current_device()}")


class ShardedVectorPDEEnv:
    """Shards a :class:`VectorPDEEnv` batch across a mesh axis.

    Args:
        env: the whole fleet's env, built on this rank's device (every rank
            builds the same one); ``env.num_envs`` must divide evenly over
            the mesh axis.
        mesh: a named device mesh (:func:`pde_opt_tpu_torch.parallel.make_mesh`).
        axis: mesh axis name to shard the env batch over.

    ``local`` is the rank's env of ``envs_per_device`` envs; ``reset``,
    ``step``, ``make_rollout`` and ``rollout`` take and return the rank's
    rows.
    """

    def __init__(self, env: VectorPDEEnv, mesh, axis: str = "env"):
        n_dev, rank, group = _mesh_axis(mesh, axis)
        if env.num_envs % n_dev != 0:
            raise ValueError(
                f"num_envs={env.num_envs} not divisible by mesh axis "
                f"'{axis}' size {n_dev}"
            )
        _check_device(env.device, mesh.device_type)
        self.env = env
        self.mesh = mesh
        self.axis = axis
        self.group = group
        self.rank = rank
        self.num_shards = n_dev
        self.envs_per_device = env.num_envs // n_dev
        self.rows = slice(rank * self.envs_per_device, (rank + 1) * self.envs_per_device)
        self.local = copy.copy(env)
        self.local.num_envs = self.envs_per_device

    def stream(self, generator: torch.Generator) -> torch.Generator:
        """This rank's stream derived from ``generator`` (see the module)."""
        return _rank_stream(generator, self.rank, self.num_shards)

    def reset(self, generator: torch.Generator):
        """Draw the whole fleet from ``generator`` and keep this rank's rows;
        later auto-resets draw from the rank's stream.  Returns the rank's
        ``(EnvState, obs)``."""
        env = self.env
        # The rows get their own memory: step() writes into them, and the
        # rest of the fleet's draw is freed.
        y0 = env.reset_func(env.domain, generator, env.num_envs)[self.rows].clone()
        self.local.set_generator(self.stream(generator))
        return self.local._initial_state(y0)

    def step(self, state: EnvState, actions):
        """The rank's fleet step (no collective); ``actions`` are its rows."""
        return self.local.step(state, actions)

    def make_rollout(self, policy_fn: Callable, n_steps: int):
        """An ``n_steps`` rollout of the rank's envs: ``run(state, generator)
        -> (state, rewards, terminateds)``, the loop of
        :meth:`VectorPDEEnv.make_rollout`; ``policy_fn(obs, generator)``
        draws from the rank's stream of ``generator``.  The port compiles
        nothing, so there is no executable to cache."""
        run = self.local.make_rollout(policy_fn, n_steps)

        def run_sharded(state: EnvState, generator: torch.Generator):
            return run(state, self.stream(generator))

        return run_sharded

    def rollout(self, state: EnvState, policy_fn: Callable, n_steps: int,
                generator: Optional[torch.Generator] = None):
        """Run ``n_steps`` on the rank's envs (default generator: seed 0 on
        the fleet's device)."""
        if generator is None:
            generator = torch.Generator(device=self.env.device).manual_seed(0)
        return self.make_rollout(policy_fn, n_steps)(state, generator)
