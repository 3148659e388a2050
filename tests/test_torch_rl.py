"""The port's RL learners (``pde_opt_tpu_torch.rl``) held against the JAX
package's (``pde_opt_tpu.rl``) on the same inputs.

Weights cross as numpy arrays keyed by the JAX pytree path
(:func:`params_from_numpy`); env states as numpy; the JAX learners' random
draws are recovered by repeating their key splits and handed to the port
through a recorded sampler.  JAX's internal loss functions are read from
the jitted train steps' closures, so both sides run their own code.
Tolerances:

    nets, forward                     f32 atol 1e-5; bf16 2e-2 of max |out|
    gae                               1e-5 (JAX and the numpy oracle)
    logp / entropy helpers            1e-5
    one PPO train step (SGD)          trajectory, metrics, parameters 1e-4
    clip + Adam chain vs optax        1e-6
    DQN / DDPG losses and gradients   1e-5 (gradients: of max |grad|)
    discrete env step                 field 1e-5, reward rtol 1e-4, obs 1 LSB

Tests marked ``cuda`` run the same train steps on the card against the
CPU and skip without one; they import no JAX
(``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env as tpreset
from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv as TEnv
from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy, env_state_to_numpy
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic as TCH
from pde_opt_tpu_torch.ops.steppers import SemiImplicitFourierSpectral as TSIF
from pde_opt_tpu_torch.rl import (
    ActorCriticConv,
    ActorCriticMLP,
    ConvTorso,
    DDPGConfig,
    DeterministicActorConv,
    DQNConfig,
    FlatMLPTorso,
    Linear,
    MLP,
    PPOConfig,
    QCriticConv,
    QNetConv,
    ddpg_train,
    dqn_train,
    gae,
    init_replay,
    make_ddpg_train_step,
    make_dqn_train_step,
    make_ppo_train_step,
    params_from_numpy,
    ppo_train,
)
from pde_opt_tpu_torch.rl import ppo as tppo
from pde_opt_tpu_torch.rl.dqn import _insert_batch, target_copy
from pde_opt_tpu_torch.rl.nets import check_device, conv2d_circular_strided

torch.set_num_threads(1)

B, N, T = 8, 16, 4


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _jax_f32(net):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), net)


def _jax_arrays(net):
    """The JAX module's leaves keyed by path (``"torso.layers.0.w"``)."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(net)[0]:
        name = ".".join(str(k.name) if isinstance(k, jax.tree_util.GetAttrKey) else str(k.idx)
                        for k in path)
        out[name] = np.asarray(leaf, np.float32)
    return out


def _port(tnet, jnet):
    return params_from_numpy(tnet, _jax_arrays(jnet))


def _closure(jitted, name):
    """A function the jitted JAX train step closes over (its loss, its
    rollout): the JAX package's own code, called directly."""
    fn = getattr(jitted, "__wrapped__", jitted)
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return cells[name]


def _grads_by_name(net):
    return {n: (p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32))
            for n, p in net.named_parameters()}


def _assert_grads(tgrads, jgrads, tol):
    assert set(tgrads) == set(jgrads)
    for name, jg in jgrads.items():
        scale = max(float(np.abs(jg).max()), 1e-12)
        err = float(np.abs(tgrads[name] - jg).max()) / scale
        assert err <= tol, (name, err)


def _obs(rng, n=B, h=N):
    return rng.integers(0, 256, (n, 1, h, h)).astype(np.uint8)


class RecordedSampler:
    """Hands out prescribed draws in order (the JAX step's own)."""

    def __init__(self, normals=(), perms=(), uniforms=(), ints=()):
        self.normals, self.perms = list(normals), list(perms)
        self.uniforms, self.ints = list(uniforms), list(ints)

    def normal(self, shape, dtype=torch.float32):
        x = torch.as_tensor(self.normals.pop(0))
        assert tuple(x.shape) == tuple(shape)
        return x.to(dtype)

    def uniform(self, shape, dtype=torch.float32):
        x = torch.as_tensor(self.uniforms.pop(0))
        assert tuple(x.shape) == tuple(shape)
        return x.to(dtype)

    def randint(self, high, shape):
        x = torch.as_tensor(self.ints.pop(0)).long()
        assert tuple(x.shape) == tuple(shape) and int(x.max()) < high
        return x

    def permutation(self, n):
        p = torch.as_tensor(self.perms.pop(0)).long()
        assert p.shape == (n,)
        return p


# --------------------------------------------------------------------------
# nets
# --------------------------------------------------------------------------

def _net_pairs():
    """(name, jax builder(key, cd), torch builder(cd), inputs(rng))."""
    from pde_opt_tpu import rl as jrl

    obs = lambda rng: (_obs(rng),)
    return {
        "Linear": (lambda k, cd: jrl.Linear(6, 5, key=k), lambda cd: Linear(6, 5, device="cpu"),
                   lambda rng: (rng.normal(size=(B, 6)).astype(np.float32),)),
        "MLP": (lambda k, cd: jrl.MLP((6, 7, 3), key=k), lambda cd: MLP((6, 7, 3), device="cpu"),
                lambda rng: (rng.normal(size=(B, 6)).astype(np.float32),)),
        "ConvTorso": (lambda k, cd: jrl.ConvTorso(1, (4, 8), 16, compute_dtype=cd, key=k),
                      lambda cd: ConvTorso(1, (4, 8), 16, compute_dtype=cd, device="cpu"), obs),
        "FlatMLPTorso": (lambda k, cd: jrl.FlatMLPTorso(N * N, (32,), 16, compute_dtype=cd,
                                                        key=k),
                         lambda cd: FlatMLPTorso(N * N, (32,), 16, compute_dtype=cd,
                                                 device="cpu"), obs),
        "ActorCriticConv": (
            lambda k, cd: jrl.ActorCriticConv(2, channels=(4,), features=16, compute_dtype=cd,
                                              key=k),
            lambda cd: ActorCriticConv(2, channels=(4,), features=16, compute_dtype=cd,
                                       device="cpu"), obs),
        "ActorCriticConv_discrete": (
            lambda k, cd: jrl.ActorCriticConv(3, channels=(4,), features=16, discrete=True,
                                              compute_dtype=cd, key=k),
            lambda cd: ActorCriticConv(3, channels=(4,), features=16, discrete=True,
                                       compute_dtype=cd, device="cpu"), obs),
        "ActorCriticMLP": (
            lambda k, cd: jrl.ActorCriticMLP(1, N * N, widths=(32,), features=16,
                                             compute_dtype=cd, key=k),
            lambda cd: ActorCriticMLP(1, N * N, widths=(32,), features=16, compute_dtype=cd,
                                      device="cpu"), obs),
        "DeterministicActorConv": (
            lambda k, cd: jrl.DeterministicActorConv(1, channels=(4,), features=16,
                                                     action_scale=0.7, key=k),
            lambda cd: DeterministicActorConv(1, channels=(4,), features=16, action_scale=0.7,
                                              device="cpu"), obs),
        "QCriticConv": (
            lambda k, cd: jrl.QCriticConv(1, channels=(4,), features=16, key=k),
            lambda cd: QCriticConv(1, channels=(4,), features=16, device="cpu"),
            lambda rng: (_obs(rng), rng.uniform(-1, 1, (B, 1)).astype(np.float32))),
        "QNetConv": (lambda k, cd: jrl.QNetConv(3, channels=(4, 8), features=16, key=k),
                     lambda cd: QNetConv(3, channels=(4, 8), features=16, device="cpu"), obs),
    }


def _leaves(out):
    """A net's outputs as a flat list of f32 numpy arrays."""
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    if torch.is_tensor(out):
        out = out.detach().numpy()
    return [np.asarray(out, np.float32)]


NETS = ("Linear", "MLP", "ConvTorso", "FlatMLPTorso", "ActorCriticConv",
        "ActorCriticConv_discrete", "ActorCriticMLP", "DeterministicActorConv", "QCriticConv",
        "QNetConv")
BF16_NETS = ("ConvTorso", "FlatMLPTorso", "ActorCriticConv", "ActorCriticMLP")


@pytest.mark.parametrize("name,mats", [(n, "f32") for n in NETS]
                         + [(n, "bf16") for n in BF16_NETS])
def test_net_forward_matches_jax(name, mats):
    import jax
    import jax.numpy as jnp

    jbuild, tbuild, inputs = _net_pairs()[name]
    jcd, tcd = (None, None) if mats == "f32" else (jnp.bfloat16, torch.bfloat16)
    jnet = _jax_f32(jbuild(jax.random.PRNGKey(NETS.index(name)), jcd))
    tnet = _port(tbuild(tcd), jnet)
    args = inputs(np.random.default_rng(1))
    want = _leaves(jax.jit(lambda n, *a: n(*a))(jnet, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = _leaves(tnet(*map(torch.from_numpy, args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if mats == "f32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        else:
            assert np.abs(g - w).max() <= 2e-2 * max(np.abs(w).max(), 1e-6)


def test_net_parameter_names_and_init():
    """Names are the JAX pytree paths; a discrete head keeps its scalar
    log_std leaf; params_from_numpy refuses missing, extra and misshapen
    keys; the layers of one net draw different values."""
    import jax

    from pde_opt_tpu import rl as jrl

    jnet = jrl.ActorCriticConv(3, channels=(4,), features=16, discrete=True,
                               key=jax.random.PRNGKey(0))
    tnet = ActorCriticConv(3, channels=(4,), features=16, discrete=True, device="cpu")
    assert set(_jax_arrays(jnet)) == {n for n, _ in tnet.named_parameters()}
    assert tnet.log_std.shape == () and float(tnet.log_std.detach()) == 0.0
    cont = ActorCriticConv(2, channels=(4,), features=16, device="cpu")
    assert torch.equal(cont.log_std.detach(), torch.full((2,), -0.5))
    arrays = _jax_arrays(jnet)
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy(tnet, {k: v for k, v in arrays.items() if k != "log_std"})
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(tnet, {**arrays, "torso.bogus": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tnet, {**arrays, "pi_head.b": np.zeros(5, np.float32)})
    mlp = MLP((4, 4, 4), device="cpu")
    assert not torch.equal(mlp.layers[0].w, mlp.layers[1].w)
    a = ActorCriticMLP(1, 16, device="cpu", generator=torch.Generator().manual_seed(3))
    b = ActorCriticMLP(1, 16, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_conv_and_flat_torso_shapes_match_jax():
    """The circular strided conv alone, and the flat torso's guard: an
    already-flat obs (..., 1, 1, in_f) keeps its batch axes."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu import rl as jrl
    from pde_opt_tpu.rl.nets import conv2d_circular_strided as jconv

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 2, 16, 12)).astype(np.float32)
    w = rng.normal(size=(5, 2, 3, 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = np.asarray(jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv2d_circular_strided(*map(torch.from_numpy, (x, w, b))).numpy()
    assert got.shape == want.shape == (2, 3, 5, 8, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    jnet = _jax_f32(jrl.FlatMLPTorso(N * N, (32,), 16, key=jax.random.PRNGKey(4)))
    tnet = _port(FlatMLPTorso(N * N, (32,), 16, device="cpu"), jnet)
    flat = rng.normal(size=(3, 1, 1, N * N)).astype(np.float32)
    want = np.asarray(jnet(jnp.asarray(flat)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(flat)).numpy()
    assert got.shape == want.shape == (3, 1, 1, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# gae and the distribution helpers
# --------------------------------------------------------------------------

def _gae_numpy(rewards, values, dones, last_value, gamma, lam):
    steps, nb = rewards.shape
    adv = np.zeros((steps, nb))
    next_adv = np.zeros(nb)
    next_val = np.asarray(last_value)
    for t in reversed(range(steps)):
        nonterm = 1.0 - dones[t].astype(float)
        delta = rewards[t] + gamma * next_val * nonterm - values[t]
        next_adv = delta + gamma * lam * nonterm * next_adv
        adv[t] = next_adv
        next_val = values[t]
    return adv, adv + values


def test_gae_matches_jax_and_numpy():
    import jax.numpy as jnp

    from pde_opt_tpu.rl import gae as jgae

    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(7, 3)).astype(np.float32)
    values = rng.normal(size=(7, 3)).astype(np.float32)
    dones = rng.random((7, 3)) < 0.25
    last = rng.normal(size=(3,)).astype(np.float32)
    adv, ret = gae(*map(torch.from_numpy, (rewards, values, dones, last)), 0.97, 0.9)
    jadv, jret = jgae(*map(jnp.asarray, (rewards, values, dones, last)), 0.97, 0.9)
    nadv, nret = _gae_numpy(rewards, values, dones, last, 0.97, 0.9)
    for got, want in ((adv, jadv), (ret, jret), (adv, nadv), (ret, nret)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_distribution_helpers_match_jax():
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.rl import ppo as jppo

    rng = np.random.default_rng(5)
    mean = rng.normal(size=(6, 2)).astype(np.float32)
    log_std = np.array([-0.5, 0.3], np.float32)
    action = rng.normal(size=(6, 2)).astype(np.float32)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    act_d = rng.integers(0, 4, 6)
    key = jax.random.PRNGKey(9)
    T_ = lambda x: torch.from_numpy(np.asarray(x))

    ja, jlogp = jppo._gaussian_sample_logp(key, jnp.asarray(mean), jnp.asarray(log_std))
    noise = jax.random.normal(key, mean.shape, dtype=jnp.float32)
    ta, tlogp = tppo._gaussian_sample_logp(T_(noise), T_(mean), T_(log_std))
    jl, je = jppo._gaussian_logp_entropy(jnp.asarray(mean), jnp.asarray(log_std),
                                         jnp.asarray(action))
    tl, te = tppo._gaussian_logp_entropy(T_(mean), T_(log_std), T_(action))
    jca, jclogp = jppo._categorical_sample_logp(key, jnp.asarray(logits))
    gumbel = jax.random.gumbel(key, logits.shape, dtype=jnp.float32)
    tca, tclogp = tppo._categorical_sample_logp(T_(gumbel), T_(logits))
    jcl, jce = jppo._categorical_logp_entropy(jnp.asarray(logits), jnp.asarray(act_d))
    tcl, tce = tppo._categorical_logp_entropy(T_(logits), T_(act_d))
    assert np.array_equal(tca.numpy(), np.asarray(jca))
    for got, want in ((ta, ja), (tlogp, jlogp), (tl, jl), (te, je), (tclogp, jclogp),
                      (tcl, jcl), (tce, jce)):
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_clipped_adam_matches_optax_chain():
    """The default optimizer against optax's clip_by_global_norm + adam, on
    gradients with a global norm above max_grad_norm and below it."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(6)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    steps = [{k: (s * rng.normal(size=v.shape)).astype(np.float32) for k, v in p0.items()}
             for s in (3.0, 0.01, 1.0)]            # norms ~ 6.9, 0.02, 2.3 vs max 0.5
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = tppo.ClippedAdam(tp.values(), lr=1e-2, max_norm=0.5)
    for g in steps:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad()
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=0)


# --------------------------------------------------------------------------
# one whole PPO train step
# --------------------------------------------------------------------------

def _np_state(seed, n=B):
    rng = np.random.default_rng(seed)
    # Amplitudes from 0.02 to 0.15: rewards (-var) spread over the envs, so
    # the advantages' std is not tiny.  Normalising by a tiny std would
    # magnify the f32 FFT roundings (an obs pixel 1 LSB apart) into the
    # update.
    amp = np.linspace(0.02, 0.15, n)[:, None, None]
    return {
        "y": (0.5 + amp * rng.standard_normal((n, N, N))).astype(np.float32),
        "t": np.zeros(n, np.float32),
        "control_value": rng.uniform(2e-3, 1e-2, n).astype(np.float32),
        "step_count": np.zeros(n, np.int32),
        "done": np.zeros(n, bool),
    }


def _jax_state(arrs):
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs.vector_env import EnvState as JState

    return JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                  control_value=jnp.asarray(arrs["control_value"]),
                  key=jax.random.split(jax.random.PRNGKey(0), len(arrs["t"])),
                  step_count=jnp.asarray(arrs["step_count"]),
                  done=jnp.asarray(arrs["done"]))


def _torch_state(env, arrs, seed=0):
    env.reset(torch.Generator(device=env.device).manual_seed(seed))   # the env's generator
    return env_state_from_numpy(arrs, env.device)


def _ppo_draws(key, cfg, n_batch):
    """The JAX train step's Gaussian noise and permutations, from its own
    key splits (rl/ppo.py: train_step, rollout, epoch)."""
    import math

    import jax
    import jax.numpy as jnp

    _, rkey, pkey = jax.random.split(key, 3)
    normals, k = [], rkey
    for _ in range(cfg.rollout_steps):
        k, ak = jax.random.split(k)
        normals.append(np.asarray(jax.random.normal(ak, (n_batch, 1), dtype=jnp.float32)))
    n = cfg.rollout_steps * n_batch
    mb = -(-n // cfg.minibatches)
    C = math.gcd(cfg.shuffle_chunk, n_batch)
    chunked = C > 1 and n % (cfg.minibatches * mb) == 0 and mb % C == 0
    perms = [np.asarray(jax.random.permutation(ek, n // C if chunked else n))
             for ek in jax.random.split(pkey, cfg.epochs)]
    return rkey, normals, perms, chunked


@pytest.mark.parametrize("chunk,minibatches", [(256, 2), (1, 3)])
def test_ppo_train_step_matches_jax(chunk, minibatches):
    """CH preset, 8 x 16^2 x 2 substeps, 4 rollout steps (no episode end),
    2 epochs, SGD on both sides: the trajectory, the metrics and the final
    parameters to 1e-4; the value loss (~5e-7, under that bound) also to
    1e-2 of itself.  chunk 256 with 2 minibatches shuffles chunks of
    gcd(256, 8) = 8 samples; chunk 1 with 3 minibatches shuffles samples
    and extends the permutation cyclically (3 x 11 = 33 of 32 samples)."""
    import jax
    import optax

    from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env as jpreset
    from pde_opt_tpu.rl import ActorCriticConv as JACC
    from pde_opt_tpu.rl import PPOConfig as JCfg
    from pde_opt_tpu.rl import make_ppo_train_step as jmake

    lr = 0.05
    kw = dict(rollout_steps=T, epochs=2, minibatches=minibatches, lr=lr, shuffle_chunk=chunk)
    env_kw = dict(num_envs=B, grid_size=N, substeps=2)
    jenv, tenv = jpreset(**env_kw), tpreset(device="cpu", **env_kw)
    jnet = _jax_f32(JACC(1, channels=(4,), features=16, key=jax.random.PRNGKey(0)))
    tnet = _port(ActorCriticConv(1, channels=(4,), features=16, device="cpu"), jnet)
    jstep, _ = jmake(jenv, JCfg(**kw), optimizer=optax.sgd(lr))
    tstep, _ = make_ppo_train_step(tenv, PPOConfig(**kw),
                                   optimizer=lambda p: torch.optim.SGD(p, lr=lr))
    arrs = _np_state(11)
    key = jax.random.PRNGKey(3)
    rkey, normals, perms, chunked = _ppo_draws(key, PPOConfig(**kw), B)
    assert chunked == (chunk == 256)

    # The rollout alone: JAX's own rollout function against the port's.
    _, jtraj, jlast = _closure(jstep, "rollout")(jnet, _jax_state(arrs), rkey)
    _, ttraj, tlast = tstep.rollout(tnet, _torch_state(tenv, arrs), RecordedSampler(normals))
    assert np.abs(ttraj.obs.numpy().astype(int) - np.asarray(jtraj.obs).astype(int)).max() <= 1
    assert not ttraj.done.any() and not np.asarray(jtraj.done).any()
    for name in ("action", "logp", "value", "reward"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4, rtol=1e-4)

    # The whole step.
    jparams, _, jstate1, _, jmetrics = jstep(jnet, optax.sgd(lr).init(jnet), _jax_state(arrs),
                                             key)
    opt = torch.optim.SGD(tnet.parameters(), lr=lr)
    tstate1, tmetrics = tstep(tnet, opt, _torch_state(tenv, arrs),
                              RecordedSampler(normals, perms))
    assert set(tmetrics) == set(jmetrics) and len(tmetrics) == 7
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(tmetrics["v_loss"]), float(jmetrics["v_loss"]), rtol=1e-2)
    moved = 0.0
    for name, p in tnet.named_parameters():
        want = _jax_arrays(jparams)[name]
        np.testing.assert_allclose(p.detach().numpy(), want, atol=1e-4, rtol=0, err_msg=name)
        moved += float(np.abs(want - _jax_arrays(jnet)[name]).sum())
    assert moved > 1e-3
    got = env_state_to_numpy(tstate1)
    np.testing.assert_allclose(got["y"], np.asarray(jstate1.y), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["control_value"], np.asarray(jstate1.control_value),
                               atol=1e-7, rtol=0)
    assert np.array_equal(got["step_count"], np.asarray(jstate1.step_count))


# --------------------------------------------------------------------------
# replay, DQN, DDPG
# --------------------------------------------------------------------------

def test_replay_ring_wraparound():
    cfg = DQNConfig(capacity=8, batch_size=4)
    replay = init_replay(cfg, (1, 4, 4), device="cpu")
    obs = torch.ones((6, 1, 4, 4), dtype=torch.uint8)
    a = torch.arange(6)
    r = torch.ones(6)
    d = torch.zeros(6, dtype=torch.bool)
    replay = _insert_batch(replay, obs, a, r, obs, d)
    assert replay.size == 6 and replay.ptr == 6
    replay = _insert_batch(replay, 2 * obs, a + 10, r, obs, d)
    assert replay.size == 8 and replay.ptr == 4
    # wrapped slots hold the newest data
    assert int(replay.action[0]) == 12 and int(replay.obs[0].max()) == 2
    assert int(replay.action[4]) == 4   # first batch idx 4 still present
    assert replay.action.dtype == torch.int32


def _discrete_tenv(num_envs=6, n=N, device="cpu"):
    """The port's counterpart of tests/test_rl.py's ``_discrete_env``."""
    L = 0.01 * n
    return TEnv(
        equation_type=TCH,
        domain=tgrid.Domain((n, n), ((-L / 2, L / 2), (-L / 2, L / 2))),
        solver_type=TSIF,
        end_time=0.04, step_dt=0.01, numeric_dt=0.005,
        state_to_observation_func=lambda y: torch.clamp(y * 255.0, 0, 255)
        .to(torch.uint8)[..., None, :, :],
        reward_function=lambda y: -y.var(dim=(-2, -1), correction=0),
        reset_func=lambda domain, g, b: torch.clamp(
            0.5 + 0.01 * torch.randn((b, *domain.points), generator=g, device=g.device),
            0.0, 1.0),
        reset_control_value=0.004,
        update_control_value=lambda off, old: torch.clamp(old + off[..., 0], 0.002, 0.01),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={
            "type": "discrete",
            "num_actions": 3,
            "action_mapping": {0: [0.0], 1: [0.0005], 2: [-0.0005]},
        },
        static_equation_parameters={"mu": lambda c: c**3 - c, "D": torch.ones_like,
                                    "derivs": "fd"},
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        num_envs=num_envs,
        vectorized_control=True,
        device=device,
    )


def _jax_discrete_env():
    from test_rl import _discrete_env

    return _discrete_env()


def test_discrete_env_step_matches_jax():
    """The discrete VectorPDEEnv against JAX's ``_discrete_env`` from the
    same numpy state: each action's offset from the table on the device."""
    jenv, tenv = _jax_discrete_env(), _discrete_tenv()
    rng = np.random.default_rng(12)
    arrs = {
        # float64, as the JAX env's own reset makes it under x64 (its
        # auto-reset branch must match the field's dtype).
        "y": 0.5 + 0.05 * rng.standard_normal((6, N, N)),
        "t": np.zeros(6, np.float32),
        "control_value": rng.uniform(2.5e-3, 9.5e-3, 6).astype(np.float32),
        "step_count": np.zeros(6, np.int32),
        "done": np.zeros(6, bool),
    }
    assert tenv.num_actions == 3 and tenv._action_table.shape == (3, 1)
    jstate, tstate = _jax_state(arrs), _torch_state(tenv, arrs)
    for acts in ([0, 1, 2, 2, 1, 0], [1, 1, 1, 2, 2, 0]):
        jstate, jobs, jrew, jterm, _, _ = jenv.step(jstate, np.asarray(acts, np.int32))
        tstate, tobs, trew, tterm, _, _ = tenv.step(tstate, torch.tensor(acts))
        got = env_state_to_numpy(tstate)
        np.testing.assert_allclose(got["y"], np.asarray(jstate.y), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["control_value"], np.asarray(jstate.control_value),
                                   atol=1e-8, rtol=0)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-4, atol=0)
        assert np.abs(tobs.numpy().astype(int) - np.asarray(jobs).astype(int)).max() <= 1
        assert np.array_equal(tterm.numpy(), np.asarray(jterm))
    acts = tenv.sample_actions(torch.Generator().manual_seed(0))
    assert acts.shape == (6,) and int(acts.min()) >= 0 and int(acts.max()) < 3


def _replay_batch(rng, n=16, action_dim=None):
    a = (rng.integers(0, 3, n).astype(np.int32) if action_dim is None
         else rng.uniform(-1, 1, (n, action_dim)).astype(np.float32))
    return (_obs(rng, n), a, rng.normal(size=n).astype(np.float32), _obs(rng, n),
            rng.random(n) < 0.3)


def test_dqn_td_loss_matches_jax():
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.rl import DQNConfig as JCfg
    from pde_opt_tpu.rl import QNetConv as JQ
    from pde_opt_tpu.rl import make_dqn_train_step as jmake

    cfg = dict(capacity=64, batch_size=16)
    jstep, _ = jmake(_jax_discrete_env(), JCfg(**cfg))
    tstep, _ = make_dqn_train_step(_discrete_tenv(), DQNConfig(**cfg))
    jq = _jax_f32(JQ(3, channels=(4,), features=16, key=jax.random.PRNGKey(0)))
    jt = _jax_f32(JQ(3, channels=(4,), features=16, key=jax.random.PRNGKey(1)))
    tq = _port(QNetConv(3, channels=(4,), features=16, device="cpu"), jq)
    tt = _port(QNetConv(3, channels=(4,), features=16, device="cpu"), jt).requires_grad_(False)
    batch = _replay_batch(np.random.default_rng(7))
    jloss, jgrads = jax.value_and_grad(_closure(jstep, "td_loss"))(
        jq, jt, *map(jnp.asarray, batch))
    tloss = tstep.td_loss(tq, tt, *map(torch.from_numpy, batch))
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-6)
    _assert_grads(_grads_by_name(tq), _jax_arrays(jgrads), 1e-5)


def test_ddpg_losses_match_jax():
    """The critic's Huber loss on a replay batch and the actor's loss through
    the critic: values and gradients; the actor's gradient leaves none on
    the critic."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env as jpreset
    from pde_opt_tpu.rl import DDPGConfig as JCfg
    from pde_opt_tpu.rl import DeterministicActorConv as JA
    from pde_opt_tpu.rl import QCriticConv as JC
    from pde_opt_tpu.rl import make_ddpg_train_step as jmake

    cfg = dict(capacity=48, batch_size=12)
    env_kw = dict(num_envs=6, grid_size=N, substeps=2)
    jstep, _ = jmake(jpreset(**env_kw), JCfg(**cfg))
    tstep, _ = make_ddpg_train_step(tpreset(device="cpu", **env_kw), DDPGConfig(**cfg))
    ja = _jax_f32(JA(1, channels=(4,), features=16, key=jax.random.PRNGKey(0)))
    jc = _jax_f32(JC(1, channels=(4,), features=16, key=jax.random.PRNGKey(1)))
    ta = _port(DeterministicActorConv(1, channels=(4,), features=16, device="cpu"), ja)
    tc = _port(QCriticConv(1, channels=(4,), features=16, device="cpu"), jc)
    obs, act, tq, _, _ = _replay_batch(np.random.default_rng(8), 12, action_dim=1)

    jl, jg = jax.value_and_grad(_closure(jstep, "critic_loss"))(
        jc, jnp.asarray(tq), jnp.asarray(obs), jnp.asarray(act))
    tl = tstep.critic_loss(tc, torch.from_numpy(tq), torch.from_numpy(obs),
                           torch.from_numpy(act))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    _assert_grads(_grads_by_name(tc), _jax_arrays(jg), 1e-5)

    tc.zero_grad(set_to_none=True)
    jl, jg = jax.value_and_grad(_closure(jstep, "actor_loss"))(ja, jc, jnp.asarray(obs))
    tl = tstep.actor_loss(ta, tc, torch.from_numpy(obs))
    params = list(ta.parameters())
    grads = torch.autograd.grad(tl, params)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    _assert_grads({n: g.numpy() for (n, _), g in zip(ta.named_parameters(), grads)},
                  _jax_arrays(jg), 1e-5)
    assert all(p.grad is None for p in tc.parameters())


def _assert_params(tnet, jnet, atol, what):
    want = _jax_arrays(jnet)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=atol, rtol=0,
                                   err_msg=f"{what}: {name}")


def test_dqn_train_step_matches_jax():
    """One whole DQN step (SGD, learning on) from the same numpy state,
    fed the JAX step's own draws: act, insert, sample, TD step, Polyak.
    The online net, the target, the replay and the metrics to 1e-5."""
    import jax
    import jax.numpy as jnp
    import optax

    from pde_opt_tpu.rl import DQNConfig as JCfg
    from pde_opt_tpu.rl import QNetConv as JQ
    from pde_opt_tpu.rl import init_replay as jinit
    from pde_opt_tpu.rl import make_dqn_train_step as jmake

    lr, nb = 0.05, 6
    kw = dict(capacity=64, batch_size=16, tau=0.1)
    jenv, tenv = _jax_discrete_env(), _discrete_tenv()
    jq = _jax_f32(JQ(3, channels=(4,), features=16, key=jax.random.PRNGKey(0)))
    jt = _jax_f32(JQ(3, channels=(4,), features=16, key=jax.random.PRNGKey(1)))
    tq = _port(QNetConv(3, channels=(4,), features=16, device="cpu"), jq)
    tt = _port(QNetConv(3, channels=(4,), features=16, device="cpu"), jt).requires_grad_(False)
    arrs = {**_np_state(14, nb), "y": _np_state(14, nb)["y"].astype(np.float64)}
    step, key = 1, jax.random.PRNGKey(6)
    _, akey, ekey, skey = jax.random.split(key, 4)
    # The replay holds nb transitions when the batch is drawn.
    draws = dict(ints=[np.asarray(jax.random.randint(akey, (nb,), 0, 3)),
                       np.asarray(jax.random.randint(skey, (16,), 0, nb))],
                 uniforms=[np.asarray(jax.random.uniform(ekey, (nb,)))])
    jstep, _ = jmake(jenv, JCfg(**kw), optimizer=optax.sgd(lr))
    jstate = _jax_state(arrs)
    jobs = jenv.state_to_observation_func(jstate.y)
    jq1, jt1, _, jrep, _, jnext, _, jm = jstep(
        jq, jt, optax.sgd(lr).init(jq), jinit(JCfg(**kw), jobs.shape[1:]), jstate, jobs,
        jnp.asarray(step), key)

    tstep, _ = make_dqn_train_step(tenv, DQNConfig(**kw))
    tstate = _torch_state(tenv, arrs)
    tobs = tenv.state_to_observation_func(tstate.y)
    trep = init_replay(DQNConfig(**kw), tobs.shape[1:], device="cpu")
    trep, _, tnext, tm = tstep(tq, tt, torch.optim.SGD(tq.parameters(), lr=lr), trep, tstate,
                               tobs, step, RecordedSampler(**draws))
    _assert_params(tq, jq1, 1e-5, "online")
    _assert_params(tt, jt1, 1e-5, "target")
    assert (trep.ptr, trep.size) == (int(jrep.ptr), int(jrep.size)) == (nb, nb)
    assert np.array_equal(trep.action.numpy(), np.asarray(jrep.action))
    np.testing.assert_allclose(trep.reward.numpy(), np.asarray(jrep.reward), rtol=1e-4)
    assert np.abs(tnext.numpy().astype(int) - np.asarray(jnext).astype(int)).max() <= 1
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_ddpg_train_step_matches_jax():
    """One whole DDPG step (SGD, learning on) from the same numpy state, fed
    the JAX step's own draws: the critic steps first, the actor's loss reads
    the updated critic, both targets move by Polyak.  Parameters of all four
    nets and the metrics to 1e-5."""
    import jax
    import jax.numpy as jnp
    import optax

    from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env as jpreset
    from pde_opt_tpu.rl import DDPGConfig as JCfg
    from pde_opt_tpu.rl import DDPGState as JState
    from pde_opt_tpu.rl import DeterministicActorConv as JA
    from pde_opt_tpu.rl import QCriticConv as JC
    from pde_opt_tpu.rl import init_replay as jinit
    from pde_opt_tpu.rl import make_ddpg_train_step as jmake
    from pde_opt_tpu_torch.rl import DDPGState

    a_lr, c_lr, nb = 0.05, 0.1, 6
    kw = dict(capacity=48, batch_size=12, tau=0.1, noise_std=1.0)   # some actions clip
    env_kw = dict(num_envs=nb, grid_size=N, substeps=2)
    jenv, tenv = jpreset(**env_kw), tpreset(device="cpu", **env_kw)
    ja = _jax_f32(JA(1, channels=(4,), features=16, key=jax.random.PRNGKey(0)))
    jc = _jax_f32(JC(1, channels=(4,), features=16, key=jax.random.PRNGKey(1)))
    ta = _port(DeterministicActorConv(1, channels=(4,), features=16, device="cpu"), ja)
    tc = _port(QCriticConv(1, channels=(4,), features=16, device="cpu"), jc)
    arrs = _np_state(15, nb)
    step, key = 1, jax.random.PRNGKey(7)
    _, nkey, skey = jax.random.split(key, 3)
    draws = dict(normals=[np.asarray(jax.random.normal(nkey, (nb, 1), dtype=jnp.float32))],
                 ints=[np.asarray(jax.random.randint(skey, (12,), 0, nb))])
    jstep, _ = jmake(jenv, JCfg(**kw), actor_optimizer=optax.sgd(a_lr),
                     critic_optimizer=optax.sgd(c_lr))
    jstate = _jax_state(arrs)
    jobs = jenv.state_to_observation_func(jstate.y)
    jagent = JState(ja, jc, ja, jc, optax.sgd(a_lr).init(ja), optax.sgd(c_lr).init(jc))
    jrep = jinit(JCfg(**kw), jobs.shape[1:], action_shape=(1,), action_dtype=jnp.float32)
    jagent, jrep, _, _, _, jm = jstep(jagent, jrep, jstate, jobs, jnp.asarray(step), key)

    tstep, _ = make_ddpg_train_step(tenv, DDPGConfig(**kw))
    agent = DDPGState(ta, tc, target_copy(ta), target_copy(tc),
                      torch.optim.SGD(ta.parameters(), lr=a_lr),
                      torch.optim.SGD(tc.parameters(), lr=c_lr))
    tstate = _torch_state(tenv, arrs)
    tobs = tenv.state_to_observation_func(tstate.y)
    trep = init_replay(DDPGConfig(**kw), tobs.shape[1:], action_shape=(1,),
                       action_dtype=torch.float32, device="cpu")
    trep, _, _, tm = tstep(agent, trep, tstate, tobs, step, RecordedSampler(**draws))
    for net, jnet, what in ((ta, jagent.actor, "actor"), (tc, jagent.critic, "critic"),
                            (agent.target_actor, jagent.target_actor, "target actor"),
                            (agent.target_critic, jagent.target_critic, "target critic")):
        _assert_params(net, jnet, 1e-5, what)
    np.testing.assert_allclose(trep.action[:nb].numpy(), np.asarray(jrep.action[:nb]),
                               atol=1e-6)
    assert bool((trep.action[:nb].abs() == 1.0).any())      # the clip to the bounds acted
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# the learners' own checks
# --------------------------------------------------------------------------

def test_learners_refuse_what_jax_refuses():
    cont = tpreset(device="cpu", num_envs=6, grid_size=N, substeps=2)
    no_reset = tpreset(device="cpu", num_envs=6, grid_size=N, substeps=2, auto_reset=False)
    with pytest.raises(ValueError, match="auto_reset"):
        make_ppo_train_step(no_reset, PPOConfig())
    with pytest.raises(ValueError, match="discrete"):
        make_dqn_train_step(cont, DQNConfig())
    with pytest.raises(ValueError, match="continuous"):
        make_ddpg_train_step(_discrete_tenv(), DDPGConfig())
    with pytest.raises(ValueError, match="capacity"):
        make_dqn_train_step(_discrete_tenv(), DQNConfig(capacity=4))
    with pytest.raises(ValueError, match="capacity"):
        make_ddpg_train_step(cont, DDPGConfig(capacity=4))
    with pytest.raises(ValueError, match="auto_reset"):
        make_ddpg_train_step(no_reset, DDPGConfig())
    # A net on another device than the fleet's is refused, not moved.
    train_step, optimizer = make_ppo_train_step(cont, PPOConfig(rollout_steps=1))
    net = ActorCriticConv(1, channels=(4,), features=16, device="cpu")
    check_device(net, torch.device("cpu", 0))      # an index names the same device
    with pytest.raises(ValueError, match="fleet"):
        train_step(net.to("meta"), None, None, None)


def test_optimizer_state_untouched_before_learn_start():
    """Before learn_start no optimizer step is taken: Adam's state stays
    empty and the online nets keep their weights; from learn_start on
    they move."""
    from pde_opt_tpu_torch.rl import DDPGState, Sampler

    gen = torch.Generator().manual_seed(0)
    denv = _discrete_tenv()
    qnet = QNetConv(3, channels=(4,), features=16, device="cpu")
    step, optim = make_dqn_train_step(denv, DQNConfig(capacity=64, batch_size=16,
                                                      learn_start=2))
    opt, target = optim(qnet.parameters()), target_copy(qnet)
    state, obs = denv.reset(torch.Generator().manual_seed(1))
    replay = init_replay(DQNConfig(capacity=64), obs.shape[1:], device="cpu")
    w0 = [p.detach().clone() for p in qnet.parameters()]
    for k in range(2):
        replay, state, obs, _ = step(qnet, target, opt, replay, state, obs, k, Sampler(gen))
    assert opt.state_dict()["state"] == {}
    assert all(torch.equal(p, q) for p, q in zip(qnet.parameters(), w0))
    replay, state, obs, _ = step(qnet, target, opt, replay, state, obs, 2, Sampler(gen))
    assert len(opt.state_dict()["state"]) > 0
    assert any(not torch.equal(p, q) for p, q in zip(qnet.parameters(), w0))

    cenv = tpreset(device="cpu", num_envs=6, grid_size=N, substeps=2)
    actor = DeterministicActorConv(1, channels=(4,), features=16, device="cpu")
    critic = QCriticConv(1, channels=(4,), features=16, device="cpu")
    step, (ao, co) = make_ddpg_train_step(cenv, DDPGConfig(capacity=48, batch_size=12,
                                                           learn_start=1))
    agent = DDPGState(actor, critic, target_copy(actor), target_copy(critic),
                      ao(actor.parameters()), co(critic.parameters()))
    state, obs = cenv.reset(torch.Generator().manual_seed(2))
    replay = init_replay(DDPGConfig(capacity=48), obs.shape[1:], action_shape=(1,),
                         action_dtype=torch.float32, device="cpu")
    a0 = [p.detach().clone() for p in actor.parameters()]
    replay, state, obs, _ = step(agent, replay, state, obs, 0, Sampler(gen))
    assert agent.actor_opt.state_dict()["state"] == {}
    assert agent.critic_opt.state_dict()["state"] == {}
    assert all(torch.equal(p, q) for p, q in zip(actor.parameters(), a0))
    replay, state, obs, _ = step(agent, replay, state, obs, 1, Sampler(gen))
    assert len(agent.actor_opt.state_dict()["state"]) > 0
    assert all(p.grad is None or p.grad.abs().sum() > 0 for p in critic.parameters())
    # The targets are copies: they trail, they do not alias.
    assert all(t.data_ptr() != o.data_ptr()
               for t, o in zip(agent.target_actor.parameters(), actor.parameters()))


# --------------------------------------------------------------------------
# the smoke runs of tests/test_rl.py, on the port
# --------------------------------------------------------------------------

def _moved(a, b):
    return sum(float((p - q).abs().sum()) for p, q in zip(a, b))


def test_ppo_trains_on_ch_control_env():
    env = tpreset(device="cpu", num_envs=8, grid_size=16, substeps=2)
    net = ActorCriticConv(1, channels=(4,), features=16, device="cpu")
    w0 = [p.detach().clone() for p in net.parameters()]
    cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2, lr=1e-3)
    net, history = ppo_train(env, net, cfg, num_updates=3)
    assert len(history) == 3 and len(history[0]) == 7
    for m in history:
        assert np.isfinite(m["loss"]) and np.isfinite(m["reward_mean"])
    assert _moved(net.parameters(), w0) > 0.0


def test_ppo_discrete_actions():
    env = _discrete_tenv()
    net = ActorCriticConv(3, channels=(4,), features=16, discrete=True, device="cpu")
    cfg = PPOConfig(rollout_steps=3, epochs=1, minibatches=2)
    net, history = ppo_train(env, net, cfg, num_updates=2, metrics_every=2)
    assert len(history) == 1
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["entropy"]) for m in history)


def test_dqn_trains_on_discrete_env():
    env = _discrete_tenv()
    qnet = QNetConv(3, channels=(4,), features=16, device="cpu")
    w0 = [p.detach().clone() for p in qnet.parameters()]
    cfg = DQNConfig(capacity=64, batch_size=16, eps_decay_steps=5)
    qnet, history = dqn_train(env, qnet, cfg, num_updates=4)
    assert all(np.isfinite(m["loss"]) for m in history)
    assert history[-1]["epsilon"] < history[0]["epsilon"]
    assert _moved(qnet.parameters(), w0) > 0.0


def test_ddpg_trains_on_continuous_env():
    env = tpreset(device="cpu", num_envs=6, grid_size=16, substeps=2)
    actor = DeterministicActorConv(1, channels=(4,), features=16, device="cpu")
    critic = QCriticConv(1, channels=(4,), features=16, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    a0 = [p.detach().clone() for p in actor.parameters()]
    cfg = DDPGConfig(capacity=48, batch_size=12)
    agent, history = ddpg_train(env, actor, critic, cfg, num_updates=4)
    assert all(np.isfinite(m["critic_loss"]) and np.isfinite(m["actor_loss"])
               for m in history)
    assert _moved(agent.actor.parameters(), a0) > 0.0
    # target nets trail the online nets (Polyak, tau < 1)
    assert _moved(agent.target_actor.parameters(), agent.actor.parameters()) > 0.0


def test_metrics_logger_pulls_tensors_in_one_transfer():
    from pde_opt_tpu_torch.utils.metrics import MetricLogger, to_host

    m = {"a": torch.tensor(1.5), "b": 2, "c": torch.tensor([3.0])}
    assert to_host(m) == {"a": 1.5, "b": 2.0, "c": 3.0}
    log = MetricLogger()
    log.log(0, loss=torch.tensor(0.25), eps=0.5)
    assert log.history("loss") == [(0, 0.25)] and log.history("eps") == [(0, 0.5)]


# --------------------------------------------------------------------------
# on the card: the same train steps against the CPU
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spectral_solve", ["fft", "fused"])
def test_ppo_train_step_on_card_matches_cpu(cuda_device, spectral_solve):
    """One PPO step (SGD, prescribed draws) on the card and on the CPU from
    the same numpy state and weights.  The card's fields round otherwise
    than the CPU's (cuFFT against pocketfft on the fft fleet; K1's bf16
    tensor-core sums against the plain macro on the fused one), so an obs
    pixel may sit 1 LSB apart, and the advantages' normalisation magnifies
    that: the parameters are held at 2e-2 of their change (2.7e-3 measured
    on the fft fleet on an H100)."""
    rng = np.random.default_rng(21)
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=0.05)
    normals = [rng.standard_normal((B, 1)).astype(np.float32) for _ in range(T)]
    perms = [rng.permutation(T) for _ in range(cfg.epochs)]   # chunks of gcd(256, 8)
    arrs = _np_state(13)
    out = {}
    for dev in ("cpu", cuda_device):
        env = tpreset(device=dev, num_envs=B, grid_size=N, substeps=2,
                      spectral_solve=spectral_solve)
        net = ActorCriticConv(1, channels=(4,), features=16, device=dev)
        w0 = [p.detach().cpu().clone() for p in net.parameters()]
        step, _ = make_ppo_train_step(env, cfg, optimizer=lambda p: torch.optim.SGD(p, lr=0.05))
        sampler = RecordedSampler([torch.from_numpy(x).to(dev) for x in normals],
                                  [torch.from_numpy(p).to(dev) for p in perms])
        _, metrics = step(net, torch.optim.SGD(net.parameters(), lr=0.05),
                          _torch_state(env, arrs), sampler)
        out[str(dev)] = ([p.detach().cpu() for p in net.parameters()],
                         {k: float(v) for k, v in metrics.items()})
    (pc, mc), (pg, mg) = out["cpu"], out[str(cuda_device)]
    tol = 2e-2
    for a, b, w in zip(pc, pg, w0):
        assert float((a - b).abs().max()) <= tol * max(float((a - w).abs().max()), 1e-3)
    for k in mc:
        assert abs(mc[k] - mg[k]) <= tol * max(abs(mc[k]), 1.0), k


@pytest.mark.cuda
def test_dqn_and_ddpg_losses_on_card_match_cpu(cuda_device):
    rng = np.random.default_rng(22)
    obs, act, r, nxt, done = _replay_batch(rng)
    _, cact, tq, _, _ = _replay_batch(rng, action_dim=1)
    res = {}
    for dev in ("cpu", cuda_device):
        dstep, _ = make_dqn_train_step(_discrete_tenv(device=dev), DQNConfig(capacity=64))
        q = QNetConv(3, channels=(4,), features=16, device=dev)
        tgt = target_copy(q)
        T_ = lambda x, d=dev: torch.from_numpy(x).to(d)
        loss = dstep.td_loss(q, tgt, T_(obs), T_(act), T_(r), T_(nxt), T_(done))
        loss.backward()
        cenv = tpreset(device=dev, num_envs=6, grid_size=N, substeps=2)
        cstep, _ = make_ddpg_train_step(cenv, DDPGConfig(capacity=48))
        critic = QCriticConv(1, channels=(4,), features=16, device=dev)
        closs = cstep.critic_loss(critic, T_(tq), T_(obs), T_(cact))
        closs.backward()
        res[str(dev)] = (float(loss.detach()), float(closs.detach()),
                         [p.grad.cpu() for p in q.parameters()],
                         [p.grad.cpu() for p in critic.parameters()])
    c, g = res["cpu"], res[str(cuda_device)]
    assert abs(c[0] - g[0]) <= 1e-5 * max(abs(c[0]), 1.0)
    assert abs(c[1] - g[1]) <= 1e-5 * max(abs(c[1]), 1.0)
    for a, b in zip(c[2] + c[3], g[2] + g[3]):
        assert float((a - b).abs().max()) <= 1e-5 * max(float(a.abs().max()), 1e-12)

