"""DQN for discrete-action PDE control envs, on the env's device (PyTorch
port of the JAX package's ``rl/dqn.py``).

The replay buffer is a device-resident ring of tensors (uint8
observations).  One ``train_step``: act epsilon-greedily with the whole env
batch, insert the batch's transitions, sample a minibatch, take a double-DQN
TD step and Polyak-update the target network.  Nothing in it waits for the
device: the ring's write position and fill are host ints, since every
insert adds exactly ``num_envs`` transitions.

Reference algorithm: Mnih et al., Nature 518 (2015); double-DQN target from
van Hasselt et al., arXiv:1509.06461.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.metrics import to_host
from .nets import check_device
from .sampling import Sampler

__all__ = ["DQNConfig", "ReplayState", "init_replay", "make_dqn_train_step", "dqn_train"]


@dataclass(frozen=True)
class DQNConfig:
    capacity: int = 10_000          # transitions (flattened over envs)
    batch_size: int = 256
    gamma: float = 0.99
    lr: float = 1e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 500
    tau: float = 0.01               # Polyak target update
    learn_start: int = 1            # updates before learning begins


class ReplayState(NamedTuple):
    obs: torch.Tensor        # (capacity, *obs_shape) uint8
    action: torch.Tensor     # (capacity, *action_shape) int32 (DQN) / f32 (DDPG)
    reward: torch.Tensor     # (capacity,) f32
    next_obs: torch.Tensor   # (capacity, *obs_shape) uint8
    done: torch.Tensor       # (capacity,) bool
    ptr: int                 # next write slot (host int)
    size: int                # filled slots (host int)


def init_replay(config, obs_shape, obs_dtype=torch.uint8, action_shape=(),
                action_dtype=torch.int32, device="cuda") -> ReplayState:
    """Device-resident ring replay; shared by DQN (int actions) and DDPG
    (float action vectors)."""
    cap = config.capacity
    return ReplayState(
        obs=torch.zeros((cap, *obs_shape), dtype=obs_dtype, device=device),
        action=torch.zeros((cap, *action_shape), dtype=action_dtype, device=device),
        reward=torch.zeros((cap,), dtype=torch.float32, device=device),
        next_obs=torch.zeros((cap, *obs_shape), dtype=obs_dtype, device=device),
        done=torch.zeros((cap,), dtype=torch.bool, device=device),
        ptr=0,
        size=0,
    )


def _insert_batch(replay: ReplayState, obs, action, reward, next_obs, done) -> ReplayState:
    """Ring-insert a whole env batch (B consecutive slots, wrapping), in
    place; returns the replay with its new ``ptr`` and ``size``."""
    B = obs.shape[0]
    cap = replay.obs.shape[0]
    idx = (torch.arange(B, device=replay.obs.device) + replay.ptr) % cap
    replay.obs.index_copy_(0, idx, obs)
    replay.action.index_copy_(0, idx, action.to(replay.action.dtype))
    replay.reward.index_copy_(0, idx, reward.to(torch.float32))
    replay.next_obs.index_copy_(0, idx, next_obs)
    replay.done.index_copy_(0, idx, done)
    return replay._replace(ptr=(replay.ptr + B) % cap, size=min(replay.size + B, cap))


def _sample(replay: ReplayState, sampler: Sampler, batch_size: int):
    """``batch_size`` uniform draws (with replacement) from the filled slots."""
    idx = sampler.randint(max(replay.size, 1), (batch_size,))
    return tuple(x.index_select(0, idx) for x in replay[:5])


def _check_replay_env(env, config, name):
    if not env.auto_reset:
        raise ValueError(
            f"make_{name}_train_step requires an auto_reset=True env: without "
            "auto-reset a terminated env stays terminal forever and keeps "
            "pushing frozen post-terminal transitions into the replay."
        )
    if config.capacity < env.num_envs:
        raise ValueError(
            f"replay capacity ({config.capacity}) < num_envs "
            f"({env.num_envs}): the batched ring insert would scatter a "
            "step's transitions to duplicate slots and silently drop "
            f"{env.num_envs - config.capacity} of them."
        )


def polyak_(target: torch.nn.Module, online: torch.nn.Module, tau: float) -> None:
    """``target <- target + tau (online - target)``, in place."""
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_(t + tau * (o - t))


def target_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A frozen deep copy: a target net shares no tensor with ``net``."""
    return copy.deepcopy(net).requires_grad_(False)


def make_dqn_train_step(env, config: DQNConfig, optimizer: Optional[Callable] = None):
    """Build ``train_step(qnet, target, opt, replay, env_state, obs, step,
    sampler) -> (replay, env_state, next_obs, metrics)``.

    ``qnet(obs) -> (B, num_actions)``; ``qnet``, ``target``, ``opt`` and
    ``env_state`` are updated in place.  ``optimizer`` is a factory
    ``params -> optimizer`` (default ``torch.optim.Adam(lr)``).  Epsilon
    anneals linearly over ``eps_decay_steps`` updates; ``step`` is a host
    int.  Returns ``(train_step, optimizer)``.
    """
    if env.action_type != "discrete":
        raise ValueError("DQN requires a discrete-action env")
    _check_replay_env(env, config, "dqn")
    num_actions = env.num_actions
    if optimizer is None:
        def optimizer(params):
            return torch.optim.Adam(params, lr=config.lr, eps=1e-8)

    def epsilon(step):
        frac = min(max(step / config.eps_decay_steps, 0.0), 1.0)
        return config.eps_start + frac * (config.eps_end - config.eps_start)

    def td_loss(qnet, target, batch_obs, batch_a, batch_r, batch_next, batch_d):
        q = qnet(batch_obs)
        q_a = q.gather(1, batch_a.long()[:, None])[:, 0]
        with torch.no_grad():
            # double DQN: argmax under the online net, value under the target
            next_a = torch.argmax(qnet(batch_next), dim=1)
            next_q = target(batch_next).gather(1, next_a[:, None])[:, 0]
            tgt = batch_r + config.gamma * next_q * (1.0 - batch_d.to(torch.float32))
        return F.huber_loss(q_a, tgt, delta=1.0)

    def train_step(qnet, target, opt, replay, env_state, obs, step, sampler):
        check_device(qnet, env.device)
        with torch.no_grad():
            q = qnet(obs)
            greedy = torch.argmax(q, dim=1)
            # Independent draws for the random action and the explore coin:
            # one draw for both would tie WHETHER an env explores to WHICH
            # action it takes.
            rand = sampler.randint(num_actions, greedy.shape)
            explore = sampler.uniform(greedy.shape) < epsilon(step)
            actions = torch.where(explore, rand, greedy)
            # The step's obs IS the next state's observation, and the right
            # next_obs for the replay (a terminated env's target is masked).
            env_state, next_obs, reward, terminated, _, _ = env.step(env_state, actions)
            replay = _insert_batch(replay, obs, actions, reward, next_obs, terminated)

        batch = _sample(replay, sampler, config.batch_size)
        if step >= config.learn_start:
            opt.zero_grad()
            loss = td_loss(qnet, target, *batch)
            loss.backward()
            opt.step()
        else:
            # Before learn_start the optimizer is not stepped at all: its
            # moments and step count stay as they were.
            with torch.no_grad():
                loss = td_loss(qnet, target, *batch)
        polyak_(target, qnet, config.tau)
        metrics = {"loss": loss.detach(), "reward_mean": reward.mean(),
                   "epsilon": epsilon(step), "q_mean": q.mean()}
        return replay, env_state, next_obs, metrics

    train_step.td_loss = td_loss
    return train_step, optimizer


def dqn_train(env, qnet, config: DQNConfig, num_updates: int,
              generator: Optional[torch.Generator] = None,
              env_generator: Optional[torch.Generator] = None,
              log_fn: Optional[Callable] = None, metrics_every: int = 1):
    """Host loop: returns ``(qnet, metrics_history)``; trains ``qnet`` in
    place.  Generators and ``metrics_every`` as in
    :func:`~pde_opt_tpu_torch.rl.ppo.ppo_train`."""
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    if env_generator is None:
        env_generator = torch.Generator(device=env.device).manual_seed(1)
    train_step, optimizer = make_dqn_train_step(env, config)
    opt = optimizer(qnet.parameters())
    target = target_copy(qnet)
    sampler = Sampler(generator)
    env_state, obs = env.reset(env_generator)
    replay = init_replay(config, obs.shape[1:], obs.dtype, device=env.device)
    history = []
    for step in range(num_updates):
        replay, env_state, obs, metrics = train_step(
            qnet, target, opt, replay, env_state, obs, step, sampler)
        if (step + 1) % metrics_every == 0 or step == num_updates - 1:
            metrics = to_host(metrics)
            history.append(metrics)
            if log_fn is not None:
                log_fn(step, metrics)
    return qnet, history
