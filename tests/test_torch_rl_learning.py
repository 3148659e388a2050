"""The port's RL learners must LEARN, not merely run: tests/test_rl_learning.py's
gates on the port.

Each of PPO (conv and MLP torso, per-sample and chunked shuffle), DQN and
DDPG trains on the same small controllable Cahn-Hilliard κ-control fleet:
on a dx = 0.05 box the first Fourier mode grows for κ below ~4e-3 and
decays above it, so with reward = −Var(c) the optimal policy pushes κ UP.
The trained policy's deterministic eval return must beat a random policy's
by MARGIN and reach NEAR_OPT; the lr = 0 counterfactual must fail the
margin.  The initial weights are the JAX nets' built from the same
``PRNGKey``s, carried across with ``params_from_numpy``, so every learner
starts in the same bad basin as in JAX (mean action < 0, return ~ -0.24).
The envs' and learners' random streams are the port's own.
"""

import jax
import numpy as np
import pytest
import torch

from pde_opt_tpu import rl as jrl
from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic
from pde_opt_tpu_torch.ops.steppers import SemiImplicitFourierSpectral
from pde_opt_tpu_torch.rl import (
    ActorCriticConv,
    ActorCriticMLP,
    DDPGConfig,
    DeterministicActorConv,
    DQNConfig,
    PPOConfig,
    QCriticConv,
    QNetConv,
    ddpg_train,
    dqn_train,
    params_from_numpy,
    ppo_train,
)

torch.set_num_threads(1)

B, N, T = 32, 16, 8
MARGIN = 3e-3        # random ≈ −8e-3; untrained(init) ≈ −0.24
NEAR_OPT = -1e-3     # absolute quality gate: optimal return is ~−3e-5
DX = 0.05


def _make_env(discrete=False, num_envs=B):
    L = DX * N
    if discrete:
        asc = {"type": "discrete", "num_actions": 3,
               "action_mapping": {0: [0.0], 1: [1.0], 2: [-1.0]}}
    else:
        asc = {"type": "continuous", "shape": (1,)}
    return VectorPDEEnv(
        equation_type=CahnHilliard2DPeriodic,
        domain=tgrid.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2))),
        solver_type=SemiImplicitFourierSpectral,
        end_time=0.32, step_dt=0.04, numeric_dt=0.002,
        state_to_observation_func=lambda y: torch.clamp(y * 255.0, 0, 255)
        .to(torch.uint8)[..., None, :, :],
        reward_function=lambda y: -y.var(dim=(-2, -1), correction=0),
        reset_func=lambda domain, g, n: torch.clamp(
            0.5 + 0.05 * torch.randn((n, *domain.points), generator=g, device=g.device),
            0.0, 1.0),
        reset_control_value=0.002,
        update_control_value=lambda off, old: torch.clamp(old + 0.003 * off[..., 0],
                                                          0.002, 0.012),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config=asc,
        static_equation_parameters={"mu": lambda c: c**3 - c, "D": torch.ones_like,
                                    "derivs": "fd"},
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        num_envs=num_envs,
        auto_reset=True,
        vectorized_control=True,
        device="cpu",
    )


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _from_jax(tnet, jnet):
    """Load the JAX net's initial weights (keyed by pytree path)."""
    arrays = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jnet)[0]:
        name = ".".join(str(k.name) if isinstance(k, jax.tree_util.GetAttrKey) else str(k.idx)
                        for k in path)
        arrays[name] = np.asarray(leaf, np.float32)
    return params_from_numpy(tnet, arrays)


def _ep_return(env, policy, seed=5):
    """Mean per-env episode return of ``policy`` on a fresh fixed-seed fleet."""
    state, _ = env.reset(_gen(seed))
    with torch.no_grad():
        _, rewards, _ = env.rollout(state, policy, T, generator=_gen(seed + 100))
    return float(rewards.sum(dim=0).mean())


def _random_continuous(env):
    return lambda o, g: 2.0 * torch.rand((env.num_envs, 1), generator=g) - 1.0


def _mean_policy(net):
    return lambda obs, g: net(obs)[0][0]


def _ppo_conv(key=1):
    jnet = jrl.ActorCriticConv(action_dim=1, channels=(4,), features=16,
                               key=jax.random.PRNGKey(key))
    return _from_jax(ActorCriticConv(1, channels=(4,), features=16, device="cpu"), jnet)


def _ppo_mlp():
    jnet = jrl.ActorCriticMLP(action_dim=1, in_features=N * N, widths=(64,), features=32,
                              key=jax.random.PRNGKey(1))
    return _from_jax(ActorCriticMLP(1, N * N, widths=(64,), features=32, device="cpu"), jnet)


@pytest.mark.slow
def test_ppo_learns_kappa_control():
    env = _make_env()
    net = _ppo_conv()
    init_ = _ep_return(env, _mean_policy(net))
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=3e-3, ent_coef=0.0)
    net, _ = ppo_train(env, net, cfg, num_updates=30, generator=_gen(1))
    trained = _ep_return(env, _mean_policy(net))
    random_ = _ep_return(env, _random_continuous(env))
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > init_ + 0.05, (trained, init_)
    assert trained > NEAR_OPT, trained


@pytest.mark.slow
def test_ppo_zero_gradient_counterfactual_fails_the_margin():
    """lr = 0 (the no-gradient mutation): the SAME protocol must NOT pass
    the learning assertion."""
    env = _make_env()
    net = _ppo_conv()
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=0.0, ent_coef=0.0)
    net, _ = ppo_train(env, net, cfg, num_updates=5, generator=_gen(1))
    trained = _ep_return(env, _mean_policy(net))
    random_ = _ep_return(env, _random_continuous(env))
    assert not (trained > random_ + MARGIN), (trained, random_)


@pytest.mark.slow
def test_dqn_learns_kappa_control():
    env = _make_env(discrete=True)
    jq = jrl.QNetConv(num_actions=3, channels=(4,), features=16, key=jax.random.PRNGKey(0))
    qnet = _from_jax(QNetConv(3, channels=(4,), features=16, device="cpu"), jq)
    with torch.no_grad():
        init_ = _ep_return(env, lambda o, g: qnet(o).argmax(dim=-1))
    cfg = DQNConfig(capacity=4096, batch_size=256, eps_decay_steps=120, lr=3e-3, gamma=0.8,
                    tau=0.02)
    qnet, _ = dqn_train(env, qnet, cfg, num_updates=300, generator=_gen(1))
    trained = _ep_return(env, lambda o, g: qnet(o).argmax(dim=-1))
    random_ = _ep_return(env, lambda o, g: torch.randint(0, 3, (env.num_envs,), generator=g))
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > init_ + 0.05, (trained, init_)
    assert trained > NEAR_OPT, trained


@pytest.mark.slow
def test_ddpg_learns_kappa_control():
    env = _make_env()
    ja = jrl.DeterministicActorConv(action_dim=1, channels=(4,), features=16,
                                    key=jax.random.PRNGKey(1))
    jc = jrl.QCriticConv(action_dim=1, channels=(4,), features=16, key=jax.random.PRNGKey(2))
    actor = _from_jax(DeterministicActorConv(1, channels=(4,), features=16, device="cpu"), ja)
    critic = _from_jax(QCriticConv(1, channels=(4,), features=16, device="cpu"), jc)
    init_ = _ep_return(env, lambda o, g: actor(o))
    cfg = DDPGConfig(capacity=4096, batch_size=128, noise_std=0.5, actor_lr=1e-3,
                     critic_lr=2e-3, gamma=0.9, tau=0.02)
    agent, _ = ddpg_train(env, actor, critic, cfg, num_updates=250, generator=_gen(2))
    trained = _ep_return(env, lambda o, g: agent.actor(o))
    random_ = _ep_return(env, _random_continuous(env))
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > init_ + 0.05, (trained, init_)
    assert trained > NEAR_OPT, trained


def _ppo_mlp_gate(shuffle_chunk):
    env = _make_env()
    net = _ppo_mlp()
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=3e-3, ent_coef=0.0,
                    shuffle_chunk=shuffle_chunk)
    net, _ = ppo_train(env, net, cfg, num_updates=30, generator=_gen(1))
    trained = _ep_return(env, _mean_policy(net))
    random_ = _ep_return(env, _random_continuous(env))
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > NEAR_OPT, trained


@pytest.mark.slow
def test_ppo_mlp_torso_learns_kappa_control():
    """The flattened-MLP policy (the PPO bench's learner) clears the same
    gate as the conv policy."""
    _ppo_mlp_gate(256)


@pytest.mark.slow
def test_ppo_chunked_shuffle_learns():
    """The chunked minibatch shuffle: N = 256 samples, minibatches of 128,
    chunk gcd(64, 32) = 32 => chunking active."""
    _ppo_mlp_gate(64)


@pytest.mark.slow
def test_ppo_trains_on_gpe_control_env():
    """tests/test_presets_gpe_ac.py's PPO smoke run on the port's GPE fleet."""
    from pde_opt_tpu_torch.envs.presets import make_gpe_control_env

    env = make_gpe_control_env(num_envs=6, grid_size=16, substeps=2, device="cpu")
    jnet = jrl.ActorCriticConv(action_dim=1, channels=(4,), features=16,
                               key=jax.random.PRNGKey(4))
    net = _from_jax(ActorCriticConv(1, channels=(4,), features=16, device="cpu"), jnet)
    w0 = [p.detach().clone() for p in net.parameters()]
    cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2, lr=1e-3)
    net, history = ppo_train(env, net, cfg, num_updates=2, generator=_gen(5))
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["reward_mean"]) for m in history)
    assert sum(float((p - q).abs().sum()) for p, q in zip(net.parameters(), w0)) > 0.0


@pytest.mark.slow
def test_ppo_per_sample_shuffle_learns():
    """shuffle_chunk = 1 forces the per-sample permutation path."""
    _ppo_mlp_gate(1)
