"""Policy/value networks for PDE-control RL (PyTorch port of
the JAX package's ``rl/nets.py``).

Circular (torus) convolutions with stride-2 downsampling, since periodic
boundaries are part of the physics, followed by dense heads; or, for the
small downsampled observations, a flattened dense torso.  Every layer keeps
the JAX module's layout: ``Linear.w`` is ``(out, in)`` like
``nn.Linear.weight``, convolution weights are OIHW.  Parameter names are the
JAX modules' pytree paths (``"torso.layers.0.w"``, ``"log_std"``), so
:func:`params_from_numpy` loads a JAX net's weights by name.

The JAX activations are kept exactly: JAX's ``nn.gelu`` is the tanh
approximation (``F.gelu(approximate="tanh")``), ``MLP`` defaults to tanh.
``compute_dtype=torch.bfloat16`` casts weights and activations per layer;
parameters stay f32 and the torsos return f32.
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["Linear", "MLP", "conv2d_circular_strided", "ConvTorso", "ActorCriticConv",
           "FlatMLPTorso", "ActorCriticMLP", "DeterministicActorConv", "QCriticConv",
           "QNetConv", "gelu", "check_device", "params_from_numpy"]

# JAX's nn.gelu defaults to the tanh approximation.
gelu = functools.partial(F.gelu, approximate="tanh")


def _gen(generator: Optional[torch.Generator]) -> torch.Generator:
    """The init generator: ``generator``, else seed 0 on the CPU.  A module
    hands its one generator to its layers, so they draw different values."""
    return torch.Generator().manual_seed(0) if generator is None else generator


def _uniform(shape, lim, generator, device):
    """``U(-lim, lim)`` drawn from ``generator`` on its device, moved to ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return nn.Parameter((2.0 * lim * u - lim).to(device))


def _as_float(obs: torch.Tensor) -> torch.Tensor:
    """f32 observation; uint8 fields scaled to [0, 1]."""
    x = obs.to(torch.float32)
    return x / 255.0 if obs.dtype == torch.uint8 else x


class Linear(nn.Module):
    """Dense layer: ``(..., in) -> (..., out)``."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        device = resolve_device(device)
        lim = 1.0 / in_features**0.5
        self.w = _uniform((out_features, in_features), lim, generator, device)
        self.b = _uniform((out_features,), lim, generator, device)

    def forward(self, x):
        return F.linear(x, self.w, self.b)


class MLP(nn.Module):
    """Dense stack with activation between layers (linear final layer)."""

    def __init__(self, sizes: Sequence[int], act: Callable = torch.tanh, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        self.layers = nn.ModuleList(
            Linear(a, b, generator=generator, device=device)
            for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.act = act

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)


def conv2d_circular_strided(x, w, b=None, stride: int = 2):
    """Circularly padded conv with stride (downsampling torso block).

    Args: x (..., C_in, H, W); w (C_out, C_in, k, k) with odd k.
    """
    *batch, c, h, wd = x.shape
    p = w.shape[-1] // 2
    xb = F.pad(x.reshape(-1, c, h, wd).to(w.dtype), (p, p, p, p), mode="circular")
    out = F.conv2d(xb, w, b, stride=stride)
    return out.reshape(*batch, *out.shape[1:])


class ConvTorso(nn.Module):
    """Stride-2 circular conv stack -> global mean pool -> dense features."""

    def __init__(self, in_channels: int, channels: Sequence[int], features: int,
                 kernel: int = 3, act: Callable = gelu, compute_dtype=None, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        device = resolve_device(device)
        conv_w, conv_b = [], []
        c_prev = in_channels
        for c in channels:
            lim = 1.0 / (c_prev * kernel * kernel) ** 0.5
            conv_w.append(_uniform((c, c_prev, kernel, kernel), lim, generator, device))
            conv_b.append(_uniform((c,), lim, generator, device))
            c_prev = c
        self.conv_w = nn.ParameterList(conv_w)
        self.conv_b = nn.ParameterList(conv_b)
        self.head = Linear(c_prev, features, generator=generator, device=device)
        self.act = act
        self.compute_dtype = compute_dtype

    def forward(self, obs):
        """obs: (..., C, H, W) uint8 or float -> (..., features) f32."""
        x = _as_float(obs)
        cd = self.compute_dtype or torch.float32
        for w, b in zip(self.conv_w, self.conv_b):
            x = self.act(conv2d_circular_strided(x, w.to(cd), b.to(cd), stride=2))
        x = x.mean(dim=(-2, -1))               # global average pool
        feat = self.act(F.linear(x, self.head.w.to(cd), self.head.b.to(cd)))
        return feat.to(torch.float32)


class FlatMLPTorso(nn.Module):
    """Flatten the observation and run a dense stack.

    ``in_features`` is the flattened observation size (``16*16`` for the
    4x-downsampled flagship obs).
    """

    def __init__(self, in_features: int, widths: Sequence[int], features: int,
                 act: Callable = gelu, compute_dtype=None, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        sizes = (in_features, *widths, features)
        self.layers = nn.ModuleList(
            Linear(a, b, generator=generator, device=device)
            for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.act = act
        self.compute_dtype = compute_dtype

    def forward(self, obs):
        """obs: (..., C, H, W) or (..., F) uint8/float -> (..., features) f32."""
        x = _as_float(obs)
        in_f = self.layers[0].w.shape[1]
        # Collapse ONLY a trailing (C, H, W) group into the feature axis: an
        # already-flat obs whose batch dims multiply to in_f must not have
        # its batch axes flattened.
        if (x.ndim >= 3 and x.shape[-1] != in_f
                and x.shape[-3] * x.shape[-2] * x.shape[-1] == in_f):
            x = x.reshape(*x.shape[:-3], in_f)
        cd = self.compute_dtype or torch.float32
        for layer in self.layers:
            x = self.act(F.linear(x.to(cd), layer.w.to(cd), layer.b.to(cd)))
        return x.to(torch.float32)


class _ActorCritic(nn.Module):
    """Shared torso, a policy head and a value head.

    Continuous: ``pi_head`` is the Gaussian mean and ``log_std`` a
    state-independent learned vector (-0.5 at init).  Discrete: ``pi_head``
    gives logits and ``log_std`` is an unused scalar leaf, as in JAX.
    """

    def _heads(self, action_dim, features, discrete, generator, device):
        device = resolve_device(device)
        self.pi_head = Linear(features, action_dim, generator=generator, device=device)
        self.v_head = Linear(features, 1, generator=generator, device=device)
        self.log_std = nn.Parameter(
            torch.zeros((), device=device) if discrete
            else torch.full((action_dim,), -0.5, device=device))
        self.discrete = discrete

    def forward(self, obs):
        """``(dist_params, value)``: Gaussian ``(mean, log_std)`` or
        categorical logits; value ``(...,)``."""
        feat = self.torso(obs)
        v = self.v_head(feat)[..., 0]
        if self.discrete:
            return self.pi_head(feat), v
        return (self.pi_head(feat), self.log_std), v


class ActorCriticConv(_ActorCritic):
    """Actor-critic over a :class:`ConvTorso` for image-like observations."""

    def __init__(self, action_dim: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64,
                 discrete: bool = False, compute_dtype=None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        self.torso = ConvTorso(in_channels, channels, features, compute_dtype=compute_dtype,
                               generator=generator, device=device)
        self._heads(action_dim, features, discrete, generator, device)


class ActorCriticMLP(_ActorCritic):
    """Actor-critic over a :class:`FlatMLPTorso` (the PPO bench's policy)."""

    def __init__(self, action_dim: int, in_features: int, *,
                 widths: Sequence[int] = (256,), features: int = 64,
                 discrete: bool = False, compute_dtype=None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        self.torso = FlatMLPTorso(in_features, widths, features, compute_dtype=compute_dtype,
                                  generator=generator, device=device)
        self._heads(action_dim, features, discrete, generator, device)


class DeterministicActorConv(nn.Module):
    """Deterministic policy for DDPG: ``obs -> scale * tanh(head(torso))``.

    ``scale`` is a parameter, as it is a data leaf of the JAX module.
    """

    def __init__(self, action_dim: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64,
                 action_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        device = resolve_device(device)
        self.torso = ConvTorso(in_channels, channels, features, generator=generator,
                               device=device)
        self.a_head = Linear(features, action_dim, generator=generator, device=device)
        self.scale = nn.Parameter(torch.full((), float(action_scale), device=device))

    def forward(self, obs):
        return self.scale * torch.tanh(self.a_head(self.torso(obs)))


class QCriticConv(nn.Module):
    """State-action critic for DDPG: conv state features + action -> Q."""

    def __init__(self, action_dim: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        self.torso = ConvTorso(in_channels, channels, features, generator=generator,
                               device=device)
        self.a_proj = Linear(action_dim, features, generator=generator, device=device)
        self.q_mlp = MLP((features, features, 1), act=gelu, generator=generator,
                         device=device)

    def forward(self, obs, action):
        feat = self.torso(obs) + self.a_proj(action.to(torch.float32))
        return self.q_mlp(feat)[..., 0]


class QNetConv(nn.Module):
    """Conv Q-network for discrete-action PDE control (DQN)."""

    def __init__(self, num_actions: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        generator = _gen(generator)
        self.torso = ConvTorso(in_channels, channels, features, generator=generator,
                               device=device)
        self.q_head = Linear(features, num_actions, generator=generator, device=device)

    def forward(self, obs):
        return self.q_head(self.torso(obs))


def check_device(net: nn.Module, device: torch.device) -> None:
    """Raise unless ``net``'s parameters live on ``device`` (the fleet's)."""
    device = torch.device(device)
    for p in net.parameters():
        # "cuda" names the current card, which a parameter records as "cuda:0".
        if p.device.type != device.type or (
                device.index is not None and (p.device.index or 0) != device.index):
            raise ValueError(f"the net's parameters are on {p.device}, the fleet on {device}")


def params_from_numpy(net: nn.Module, arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Load ``arrays`` (keyed by parameter path, ``"torso.layers.0.w"``)
    into ``net``'s parameters, in place; returns ``net``.

    Raises ``KeyError`` on a missing or an extra key and ``ValueError`` on
    a shape mismatch.  Values keep each parameter's dtype and device.
    """
    params = dict(net.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"params_from_numpy: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape} != parameter {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a)).to(p.device, p.dtype))
    return net
