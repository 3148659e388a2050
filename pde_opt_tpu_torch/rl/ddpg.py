"""DDPG for continuous-action PDE control envs, on the env's device
(PyTorch port of the JAX package's ``rl/ddpg.py``).

A deterministic conv actor and a state-action critic, the device-resident
ring replay shared with DQN (:func:`~pde_opt_tpu_torch.rl.dqn.init_replay`),
Gaussian exploration noise clipped to the action bounds, and Polyak-averaged
target networks: one train step per env batch, none waiting for the device.

Reference algorithm: Lillicrap et al., arXiv:1509.02971.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.metrics import to_host
from .dqn import (
    ReplayState,
    _check_replay_env,
    _insert_batch,
    _sample,
    init_replay,
    polyak_,
    target_copy,
)
from .nets import check_device
from .sampling import Sampler

__all__ = ["DDPGConfig", "DDPGState", "make_ddpg_train_step", "ddpg_train"]


@dataclass(frozen=True)
class DDPGConfig:
    capacity: int = 10_000
    batch_size: int = 256
    gamma: float = 0.99
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    noise_std: float = 0.1          # exploration noise (action units)
    tau: float = 0.005              # Polyak target update
    learn_start: int = 1


class DDPGState(NamedTuple):
    actor: Any
    critic: Any
    target_actor: Any
    target_critic: Any
    actor_opt: Any
    critic_opt: Any


def make_ddpg_train_step(env, config: DDPGConfig, actor_optimizer: Optional[Callable] = None,
                         critic_optimizer: Optional[Callable] = None):
    """Build ``train_step(agent, replay, env_state, obs, step, sampler) ->
    (replay, env_state, next_obs, metrics)``.

    ``agent`` is a :class:`DDPGState`, updated in place; the actor maps obs
    to actions of shape ``env.action_shape``, the critic ``(obs, action)``
    to a scalar Q.  The optimizers are factories ``params -> optimizer``
    (default ``torch.optim.Adam`` at the configured rates).  Returns
    ``(train_step, (actor_optimizer, critic_optimizer))``.
    """
    if env.action_type != "continuous":
        raise ValueError("DDPG requires a continuous-action env")
    _check_replay_env(env, config, "ddpg")
    if actor_optimizer is None:
        def actor_optimizer(params):
            return torch.optim.Adam(params, lr=config.actor_lr, eps=1e-8)
    if critic_optimizer is None:
        def critic_optimizer(params):
            return torch.optim.Adam(params, lr=config.critic_lr, eps=1e-8)
    a_low, a_high = env.action_low, env.action_high

    def critic_loss(critic, target_q, obs, action):
        return F.huber_loss(critic(obs, action), target_q, delta=1.0)

    def actor_loss(actor, critic, obs):
        return -critic(obs, actor(obs)).mean()

    def train_step(agent: DDPGState, replay: ReplayState, env_state, obs, step, sampler):
        check_device(agent.actor, env.device)
        check_device(agent.critic, env.device)
        with torch.no_grad():
            action = agent.actor(obs)
            noise = config.noise_std * sampler.normal(action.shape)
            action = torch.clamp(action + noise, a_low, a_high)
            # The step's obs IS the next state's observation and the replay's
            # next_obs (a terminated env's target is masked).
            env_state, next_obs, reward, terminated, _, _ = env.step(env_state, action)
            replay = _insert_batch(replay, obs, action, reward, next_obs, terminated)
            b_obs, b_a, b_r, b_next, b_d = _sample(replay, sampler, config.batch_size)
            next_a = agent.target_actor(b_next)
            target_q = b_r + config.gamma * (1.0 - b_d.to(torch.float32)) * \
                agent.target_critic(b_next, next_a)

        actor_params = list(agent.actor.parameters())
        if step >= config.learn_start:
            # The critic steps first; the actor's loss then reads the UPDATED
            # critic.  Its gradient is taken for the actor's parameters only,
            # so the critic keeps no gradient for its next step.
            agent.critic_opt.zero_grad()
            c_loss = critic_loss(agent.critic, target_q, b_obs, b_a)
            c_loss.backward()
            agent.critic_opt.step()
            a_loss = actor_loss(agent.actor, agent.critic, b_obs)
            agent.actor_opt.zero_grad()
            for p, g in zip(actor_params, torch.autograd.grad(a_loss, actor_params)):
                p.grad = g
            agent.actor_opt.step()
        else:
            # Before learn_start neither optimizer is stepped: their moments
            # and step counts stay as they were.
            with torch.no_grad():
                c_loss = critic_loss(agent.critic, target_q, b_obs, b_a)
                a_loss = actor_loss(agent.actor, agent.critic, b_obs)
        polyak_(agent.target_actor, agent.actor, config.tau)
        polyak_(agent.target_critic, agent.critic, config.tau)
        metrics = {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                   "reward_mean": reward.mean()}
        return replay, env_state, next_obs, metrics

    train_step.critic_loss = critic_loss
    train_step.actor_loss = actor_loss
    return train_step, (actor_optimizer, critic_optimizer)


def ddpg_train(env, actor, critic, config: DDPGConfig, num_updates: int,
               generator: Optional[torch.Generator] = None,
               env_generator: Optional[torch.Generator] = None,
               log_fn: Optional[Callable] = None, metrics_every: int = 1):
    """Host loop: returns ``(DDPGState, metrics_history)``; trains ``actor``
    and ``critic`` in place.  The targets start as deep copies.  Generators
    and ``metrics_every`` as in :func:`~pde_opt_tpu_torch.rl.ppo.ppo_train`."""
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    if env_generator is None:
        env_generator = torch.Generator(device=env.device).manual_seed(1)
    train_step, (a_opt, c_opt) = make_ddpg_train_step(env, config)
    agent = DDPGState(
        actor=actor, critic=critic,
        target_actor=target_copy(actor), target_critic=target_copy(critic),
        actor_opt=a_opt(actor.parameters()), critic_opt=c_opt(critic.parameters()),
    )
    sampler = Sampler(generator)
    env_state, obs = env.reset(env_generator)
    replay = init_replay(config, obs.shape[1:], obs.dtype,
                         action_shape=tuple(env.action_shape),
                         action_dtype=torch.float32, device=env.device)
    history = []
    for step in range(num_updates):
        replay, env_state, obs, metrics = train_step(agent, replay, env_state, obs, step,
                                                     sampler)
        if (step + 1) % metrics_every == 0 or step == num_updates - 1:
            metrics = to_host(metrics)
            history.append(metrics)
            if log_fn is not None:
                log_fn(step, metrics)
    return agent, history
