"""RL learners on the batched PDE envs' device (PyTorch port of
the JAX package's ``rl``).

PPO, DQN and DDPG are ported, with their nets: each learner's rollout,
physics included, advantage estimation and updates run on the fleet's
device (the card by default), and the host only enqueues work and reads
back metrics.  Each learner draws from its own ``torch.Generator``, apart
from the env's reset generator.
"""

from .ddpg import DDPGConfig, DDPGState, ddpg_train, make_ddpg_train_step
from .dqn import DQNConfig, ReplayState, dqn_train, init_replay, make_dqn_train_step
from .nets import (
    MLP,
    ActorCriticConv,
    ActorCriticMLP,
    ConvTorso,
    DeterministicActorConv,
    FlatMLPTorso,
    Linear,
    QCriticConv,
    QNetConv,
    params_from_numpy,
)
from .ppo import PPOConfig, gae, make_ppo_train_step, ppo_train
from .sampling import Sampler

__all__ = [
    "ActorCriticConv", "ActorCriticMLP", "ConvTorso", "FlatMLPTorso",
    "DeterministicActorConv", "Linear",
    "MLP", "QCriticConv", "QNetConv", "params_from_numpy", "Sampler",
    "PPOConfig", "gae", "make_ppo_train_step", "ppo_train",
    "DQNConfig", "ReplayState", "init_replay", "make_dqn_train_step",
    "dqn_train",
    "DDPGConfig", "DDPGState", "make_ddpg_train_step", "ddpg_train",
]
