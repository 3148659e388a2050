"""PPO over batched PDE control envs, on the env's device (PyTorch port of
the JAX package's ``rl/ppo.py``).

One update is a ``rollout_steps`` rollout of the whole fleet (physics
included), GAE, and ``epochs`` x ``minibatches`` clipped-surrogate steps.
PyTorch runs eagerly, so an update is a Python loop of device work that
never waits for the device: the metrics come back as device tensors, and
:func:`ppo_train` moves them to the host in one transfer every
``metrics_every`` updates.

Standard PPO (Schulman et al., arXiv:1707.06347) with clipped value loss
and advantage normalization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.metrics import named_scope, to_host
from .nets import check_device
from .sampling import Sampler

__all__ = ["PPOConfig", "Transition", "ClippedAdam", "gae", "advantages",
           "make_ppo_train_step", "ppo_train"]

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2PIE = math.log(2.0 * math.pi * math.e)


@dataclass(frozen=True)
class PPOConfig:
    rollout_steps: int = 16
    epochs: int = 2
    minibatches: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    # Shuffle granularity: permute contiguous chunks of this many samples
    # (same-timestep, independent envs) instead of single samples when the
    # batch divides evenly; 1 forces a per-sample permutation.
    shuffle_chunk: int = 256


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation over a (T, B) rollout.

    ``dones[t]`` marks that the episode ended AT step t (no bootstrap across
    it).  Returns ``(advantages, returns)`` with ``returns = adv + values``.
    """
    adv_next, v_next = torch.zeros_like(last_value), last_value
    advs = []
    for t in reversed(range(rewards.shape[0])):
        nonterminal = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * v_next * nonterminal - values[t]
        adv_next = delta + gamma * lam * nonterminal * adv_next
        v_next = values[t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def advantages(traj: Transition, last_value, config: PPOConfig):
    """GAE over the rollout, then ``(normalized advantages, returns)``; the
    advantages are normalised with the population std, as in JAX."""
    adv, ret = gae(traj.reward, traj.value, traj.done, last_value, config.gamma, config.lam)
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8), ret


def _gaussian_sample_logp(noise, mean, log_std):
    std = torch.exp(log_std)
    a = mean + std * noise
    logp = -0.5 * (((a - mean) / std) ** 2 + 2.0 * log_std + _LOG_2PI).sum(dim=-1)
    return a, logp


def _gaussian_logp_entropy(mean, log_std, action):
    std = torch.exp(log_std)
    logp = -0.5 * (((action - mean) / std) ** 2 + 2.0 * log_std + _LOG_2PI).sum(dim=-1)
    ent = (log_std + 0.5 * _LOG_2PIE).sum() * torch.ones(mean.shape[:-1], device=mean.device)
    return logp, ent


def _categorical_sample_logp(gumbel, logits):
    a = torch.argmax(logits + gumbel, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, a[..., None])[..., 0]
    return a, logp


def _categorical_logp_entropy(logits, action):
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action[..., None])[..., 0]
    ent = -(torch.exp(logp_all) * logp_all).sum(dim=-1)
    return logp, ent


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` over
    ``torch.optim.Adam``.

    The gradients are scaled by ``max_norm / norm`` where their global norm
    reaches ``max_norm``, as optax does (``clip_grad_norm_`` would add 1e-6
    to the norm), on the device without a host sync.  ``torch.optim.Adam``'s
    update equals ``optax.adam``'s (eps 1e-8, outside the square root).
    """

    def __init__(self, params, lr: float, max_norm: float):
        self.params = list(params)
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, eps=1e-8)

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < self.max_norm, g, g / norm * self.max_norm))
        self.adam.step()


def make_ppo_train_step(env, config: PPOConfig, optimizer: Optional[Callable] = None):
    """Build ``train_step(net, opt, env_state, sampler) -> (env_state, metrics)``.

    ``env`` is a :class:`~pde_opt_tpu_torch.envs.vector_env.VectorPDEEnv`
    (continuous or discrete actions); ``net(obs)`` returns ``(dist_params,
    value)`` (:class:`~pde_opt_tpu_torch.rl.nets.ActorCriticMLP` and
    friends).  ``optimizer`` is a factory ``params -> optimizer`` (an object
    with ``zero_grad()`` and ``step()``); the default is
    :class:`ClippedAdam`.  ``train_step`` updates ``net``, ``opt`` and
    ``env_state`` in place and draws from ``sampler``
    (:class:`~pde_opt_tpu_torch.rl.sampling.Sampler`).

    Returns ``(train_step, optimizer)``; the metrics are device scalars:
    mean reward, losses, entropy, the fraction of clipped ratios and the
    mean value.
    """
    discrete = env.action_type == "discrete"
    if not env.auto_reset:
        raise ValueError(
            "make_ppo_train_step requires an auto_reset=True env: without "
            "auto-reset a terminated env stays terminal forever and keeps "
            "feeding frozen post-terminal transitions into every minibatch."
        )
    if optimizer is None:
        def optimizer(params):
            return ClippedAdam(params, config.lr, config.max_grad_norm)
    M = config.minibatches

    def policy_step(net, obs, sampler):
        dist, value = net(obs)
        if discrete:
            a, logp = _categorical_sample_logp(sampler.gumbel(dist.shape, dist.dtype), dist)
        else:
            mean, log_std = dist
            a, logp = _gaussian_sample_logp(sampler.normal(mean.shape, mean.dtype), mean,
                                            log_std)
        return a, logp, value

    @torch.no_grad()
    def rollout(net, env_state, sampler):
        # The obs a step returns IS the next state's observation: each state
        # is observed once (with the fused epilogue, by the macro itself).
        obs = env.state_to_observation_func(env_state.y)
        steps = []
        for _ in range(config.rollout_steps):
            a, logp, v = policy_step(net, obs, sampler)
            # The env sees the declared action space; the surrogate ratio
            # keeps the UNCLIPPED sample's logp.
            a_env = a if discrete else torch.clamp(a, env.action_low, env.action_high)
            # step() writes env_state's tensors in place: keep only what it
            # returns, never views of the state.
            env_state, obs1, reward, terminated, _, _ = env.step(env_state, a_env)
            steps.append(Transition(obs, a, logp, v, reward, terminated))
            obs = obs1
        _, last_value = net(obs)
        return env_state, Transition(*(torch.stack(x) for x in zip(*steps))), last_value

    def loss_fn(net, batch, adv, ret):
        dist, value = net(batch.obs)
        if discrete:
            logp, ent = _categorical_logp_entropy(dist, batch.action)
        else:
            logp, ent = _gaussian_logp_entropy(*dist, batch.action)
        ratio = torch.exp(logp - batch.logp)
        clipped = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
        pg_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
        v_clip = batch.value + torch.clamp(value - batch.value, -config.clip_eps,
                                           config.clip_eps)
        v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
        ent_mean = ent.mean()
        total = pg_loss + config.vf_coef * v_loss - config.ent_coef * ent_mean
        frac_clipped = ((ratio - 1.0).abs() > config.clip_eps).to(torch.float32).mean()
        return total, (pg_loss, v_loss, ent_mean, frac_clipped)

    def train_step(net, opt, env_state, sampler):
        check_device(net, env.device)
        with named_scope("ppo/rollout"):
            env_state, traj, last_value = rollout(net, env_state, sampler)
        with named_scope("ppo/advantages"):
            adv, ret = advantages(traj, last_value, config)

        # flatten (T, B, ...) -> (T*B, ...), time-major
        T, B = traj.reward.shape
        N = T * B
        flat = Transition(*(x.reshape(N, *x.shape[2:]) for x in traj))
        adv_f, ret_f = adv.reshape(N), ret.reshape(N)
        # Ceil-sized minibatches: the permutation is extended cyclically, so
        # every sample is used each epoch (a few twice).
        mb = -(-N // M)
        # Chunks of C consecutive samples hold C distinct same-timestep envs
        # only when C divides B: shrink C to gcd(C, B).
        C = math.gcd(config.shuffle_chunk, B)
        chunked = C > 1 and N % (M * mb) == 0 and mb % C == 0

        stats = []
        for _ in range(config.epochs):
            with named_scope("ppo/epoch"):
                # ONE gather per epoch into (M, mb, ...) stacks.
                if chunked:
                    perm = sampler.permutation(N // C)

                    def stack(x):
                        xc = x.reshape(N // C, C, *x.shape[1:])
                        return xc.index_select(0, perm).reshape(M, mb, *x.shape[1:])
                else:
                    perm = sampler.permutation(N)
                    idxs = perm.repeat(-(-M * mb // N))[:M * mb]

                    def stack(x):
                        return x.index_select(0, idxs).reshape(M, mb, *x.shape[1:])
                batches = Transition(*(stack(x) for x in flat))
                adv_s, ret_s = stack(adv_f), stack(ret_f)
                for i in range(M):
                    opt.zero_grad()
                    loss, aux = loss_fn(net, Transition(*(x[i] for x in batches)),
                                        adv_s[i], ret_s[i])
                    loss.backward()
                    opt.step()
                    stats.append(torch.stack([loss.detach(), *(a.detach() for a in aux)]))
        loss, pg, vl, ent, fc = torch.stack(stats).mean(dim=0)
        metrics = {
            "reward_mean": traj.reward.mean(),
            "loss": loss, "pg_loss": pg, "v_loss": vl,
            "entropy": ent, "clip_frac": fc,
            "value_mean": traj.value.mean(),
        }
        return env_state, metrics

    train_step.rollout = rollout
    train_step.loss_fn = loss_fn
    return train_step, optimizer


def ppo_train(env, net, config: PPOConfig, num_updates: int,
              generator: Optional[torch.Generator] = None,
              env_generator: Optional[torch.Generator] = None,
              log_fn: Optional[Callable] = None, metrics_every: int = 1):
    """Host loop: returns ``(net, metrics_history)``; trains ``net`` in place.

    ``generator`` feeds the learner's draws (default: seed 0 on the fleet's
    device), ``env_generator`` the env's resets (default: seed 1).  The
    metrics cross to the host in one transfer every ``metrics_every``
    updates (and after the last), so the updates in between stay enqueued.
    """
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    if env_generator is None:
        env_generator = torch.Generator(device=env.device).manual_seed(1)
    train_step, optimizer = make_ppo_train_step(env, config)
    opt = optimizer(net.parameters())
    sampler = Sampler(generator)
    env_state, _ = env.reset(env_generator)
    history = []
    for update in range(num_updates):
        env_state, metrics = train_step(net, opt, env_state, sampler)
        if (update + 1) % metrics_every == 0 or update == num_updates - 1:
            metrics = to_host(metrics)
            history.append(metrics)
            if log_fn is not None:
                log_fn(update, metrics)
    return net, history
