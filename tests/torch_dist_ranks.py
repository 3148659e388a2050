"""Rank programs of the port's multi-process tests (torch only).

The ranks are processes started by ``torch.multiprocessing.spawn``: they
import this module and the port, never jax, so a rank never pays for (or
depends on) the JAX package.  A test file starts ONE group of ranks (a
module-scoped fixture) that runs all of the file's cases in turn; each case
records its value or its traceback, so every test function still passes or
fails on its own.  CPU groups run gloo and meet through a ``file://`` store
under the test's ``tmp_path``, so parallel test workers never share a port.
The parent reads each rank's results back from a pickle the rank wrote.
"""

from __future__ import annotations

import copy
import datetime
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120          # a collective that waits longer raises on its rank


class Failed:
    """A case that raised on a rank: its traceback."""

    def __init__(self, tb: str):
        self.traceback = tb


def value(results: dict, name: str):
    """The case's value on one rank; a case that failed raises here with the
    rank's traceback."""
    v = results[name]
    if isinstance(v, Failed):
        raise AssertionError(f"case {name!r} raised on its rank:\n{v.traceback}")
    return v


def spawn_group(program, world: int, tmp_path, inputs, init: str = "file", backend: str = "gloo"):
    """Start ``program(rank, world, inputs) -> dict`` on ``world`` spawned
    ranks; returns ``results()``, which waits for the ranks and returns each
    rank's dict, so the parent can work meanwhile.  ``init``: ``"file"`` (a
    ``file://`` store), ``"tcp"`` (``init_distributed``'s coordinator address
    on a free local port) or ``"torchrun"`` (torchrun's variables, no
    arguments)."""
    out = Path(tmp_path)
    address = f"127.0.0.1:{_free_port()}" if init in ("tcp", "torchrun") else None
    ctx = torch.multiprocessing.spawn(_rank_main, nprocs=world, join=False,
                                      args=(program, world, str(out), inputs, init, address,
                                            backend))
    loaded = []

    def results():
        if not loaded:
            deadline = time.monotonic() + 5 * TIMEOUT_S
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"the ranks of {program.__name__} did not finish")
            for r in range(world):
                with open(out / f"rank{r}.pkl", "rb") as f:
                    loaded.append(pickle.load(f))
        return loaded

    return results


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, program, world, out, inputs, init, address, backend):
    from pde_opt_tpu_torch.parallel import init_distributed

    if backend == "gloo":
        torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if init == "file":
        init_distributed(num_processes=world, process_id=rank, backend=backend,
                         init_method=f"file://{out}/store", timeout=timeout)
    elif init == "tcp":
        init_distributed(address, world, rank, backend=backend, timeout=timeout)
    else:
        host, port = address.split(":")
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR=host, MASTER_PORT=port)
        init_distributed(backend=backend, timeout=timeout)
    try:
        results = program(rank, world, inputs)
    finally:
        dist.destroy_process_group()
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


def _run_cases(cases, *args) -> dict:
    results = {}
    for name, fn in cases:
        try:
            results[name] = fn(*args)
        except Exception:  # recorded for the parent's test of this case
            results[name] = Failed(traceback.format_exc())
    return results


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.numpy().copy()


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _rows_state(arrs, rows):
    from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy

    return env_state_from_numpy({k: np.asarray(v)[rows] for k, v in arrs.items()}, "cpu")


def _full_state(arrs):
    from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy

    return env_state_from_numpy(arrs, "cpu")


# ---------------------------------------------------------------------------
# The fleets of tests/test_sharding.py, built by the port
# ---------------------------------------------------------------------------

def ch_env(num_envs: int):
    """The port's twin of tests/test_sharding.py's ``_ch_env`` (per env: a
    scalar κ an env, a scalar reward an env; obs = the field)."""
    from pde_opt_tpu_torch.envs.vector_env import VectorPDEEnv
    from pde_opt_tpu_torch.grid import Domain
    from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic
    from pde_opt_tpu_torch.ops.steppers import SemiImplicitFourierSpectral

    N = 16
    L = 0.01 * N
    return VectorPDEEnv(
        equation_type=CahnHilliard2DPeriodic,
        domain=Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)), dtype=torch.float32),
        solver_type=SemiImplicitFourierSpectral,
        end_time=0.05, step_dt=0.01, numeric_dt=0.002,
        state_to_observation_func=lambda y: y,
        reward_function=lambda y: -torch.var(y, correction=0),
        reset_func=lambda domain, g, n: torch.clamp(
            0.5 + 0.01 * torch.randn((n, *domain.points), generator=g), 0.0, 1.0),
        reset_control_value=0.002,
        update_control_value=lambda off, old: torch.clamp(old + 0.0005 * off[..., 0], 1e-4, 0.01),
        update_control_parameter=lambda old, new: new,
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={"mu": lambda c: c**3 - c, "D": torch.ones_like,
                                    "derivs": "fd", "device": "cpu"},
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        num_envs=num_envs, device="cpu")


def flagship_env(num_envs: int, mats=None, grid_size=16, **kw):
    """tests/test_sharding.py's ``_fused_flagship_env`` (grid 16, 4 substeps,
    the fused macro, batched control); ``mats="f32"`` runs f32 matrices."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env

    env = make_cahn_hilliard_control_env(num_envs=num_envs, grid_size=grid_size, substeps=4,
                                         spectral_solve="fused", vectorized_control=True,
                                         device="cpu", **kw)
    if mats == "f32":
        env.solver_parameters = {"A": 1.0, "mats_dtype": torch.float32}
    return env


def gpe_env(num_envs: int):
    from pde_opt_tpu_torch.envs.presets import make_gpe_control_env

    env = make_gpe_control_env(num_envs=num_envs, grid_size=16, substeps=2, end_time=0.2,
                               step_dt=0.02, spectral_solve="fused", fused_epilogue=True,
                               device="cpu")
    env.solver_parameters = {"mats_dtype": torch.float32}
    return env


def rot_env(num_envs: int):
    from pde_opt_tpu_torch.envs.presets import make_gpe_rot_control_env

    return make_gpe_rot_control_env(num_envs=num_envs, grid_size=16, substeps=2, end_time=0.32,
                                    step_dt=0.04, dtype=torch.float64, device="cpu")


def ppo_env(num_envs: int):
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env

    return make_cahn_hilliard_control_env(num_envs=num_envs, grid_size=16, substeps=2,
                                          vectorized_control=True, device="cpu")


def ppo_net(seed: int):
    from pde_opt_tpu_torch.rl import ActorCriticConv

    return ActorCriticConv(1, channels=(4,), features=16, generator=_gen(seed), device="cpu")


def _flat(net) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


class RowsSampler:
    """A learner's sampler whose Gaussian draws are the rows ``rows`` of the
    whole fleet's draw: a shard's rollout noise equal to the unsharded
    run's."""

    def __init__(self, generator, rows, num_envs):
        from pde_opt_tpu_torch.rl import Sampler

        self.inner, self.rows, self.num_envs = Sampler(generator), rows, num_envs
        self.device = generator.device

    def normal(self, shape, dtype=torch.float32):
        return self.inner.normal((self.num_envs, *shape[1:]), dtype)[self.rows]

    def permutation(self, n):
        return self.inner.permutation(n)


# ---------------------------------------------------------------------------
# tests/test_torch_sharding.py: 4 ranks
# ---------------------------------------------------------------------------

def _mesh():
    from pde_opt_tpu_torch.parallel import make_mesh

    return make_mesh("cpu")


def _case_mesh(rank, world, inp):
    from torch.distributed.tensor import distribute_tensor

    from pde_opt_tpu_torch.parallel import env_sharding, replicated_sharding, shard_map

    mesh = _mesh()
    x = distribute_tensor(torch.from_numpy(inp["mesh_x"]), mesh, env_sharding(mesh))
    f = shard_map(lambda b: 2.0 * b.sum(0, keepdim=True), mesh,
                  in_specs=env_sharding(mesh), out_specs=env_sharding(mesh))
    out = f(x)
    return {"shape": tuple(mesh.shape), "names": tuple(mesh.mesh_dim_names),
            "device_type": mesh.device_type, "local_rank": mesh.get_local_rank("env"),
            "env_sharding": [type(p).__name__ for p in env_sharding(mesh)],
            "replicated": [type(p).__name__ for p in replicated_sharding(mesh)],
            "x_local": _np(x.to_local()), "local": _np(out.to_local()),
            "full": _np(out.full_tensor())}


def _case_env_step(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    env = ch_env(2 * world)
    senv = ShardedVectorPDEEnv(env, _mesh())
    _, obs_s = senv.reset(_gen(0))
    _, obs_l = env.reset(_gen(0))
    state = _rows_state(inp["ch"], senv.rows)
    state, obs, reward, *_ = senv.step(state, torch.zeros(senv.envs_per_device, 1))
    return {"reset_obs_equal": bool(torch.equal(obs_s, obs_l[senv.rows])),
            "y": _np(state.y), "reward": _np(reward), "rows": (senv.rows.start, senv.rows.stop)}


def _case_placement(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    env = ch_env(2 * world)
    senv = ShardedVectorPDEEnv(env, _mesh())
    state, obs = senv.reset(_gen(1))
    blocks = [torch.empty_like(state.y) for _ in range(world)]
    dist.all_gather(blocks, state.y)
    whole, _ = env.reset(_gen(1))
    return {"devices": sorted({str(t.device) for t in (*state, obs)}),
            "shapes": [tuple(t.shape) for t in state], "envs_per_device": senv.envs_per_device,
            "gathered_is_the_fleet": bool(torch.equal(torch.cat(blocks), whole.y)),
            "local_env_size": senv.local.num_envs, "global_env_size": senv.env.num_envs}


def _case_rollout(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    senv = ShardedVectorPDEEnv(ch_env(2 * world), _mesh())
    senv.reset(_gen(2))
    state = _rows_state(inp["ch"], senv.rows)
    n = senv.envs_per_device
    state, rewards, terms = senv.rollout(state, lambda obs, g: torch.zeros(n, 1), 4)
    return {"rewards": _np(rewards), "terms": _np(terms)}


def _steps(env, state, actions, n):
    out = {"y": [], "obs": [], "reward": []}
    for _ in range(n):
        state, obs, reward, *_ = env.step(state, actions)
        out["y"].append(_np(state.y))
        out["obs"].append(_np(obs))
        out["reward"].append(_np(reward))
    return {k: np.stack(v) for k, v in out.items()}


def _case_flagship(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    B = 2 * world
    acts = torch.linspace(-1.0, 1.0, B)[:, None]
    res = {}
    for mats in ("f32", "bf16"):
        env = flagship_env(B, mats if mats == "f32" else None)
        senv = ShardedVectorPDEEnv(env, _mesh())
        senv.reset(_gen(7))
        env.reset(_gen(7))
        s = _steps(senv, _rows_state(inp["flag"], senv.rows), acts[senv.rows], 3)
        w = _steps(env, _full_state(inp["flag"]), acts, 3)
        res[mats] = {"sharded": s, "whole": {k: v[:, senv.rows] for k, v in w.items()}}
    return res


def _case_flagship_grad(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    B = 2 * world
    env = flagship_env(B, "f32", grid_size=inp["flag64"]["y"].shape[-1])
    senv = ShardedVectorPDEEnv(env, _mesh())
    st = _rows_state(inp["flag64"], senv.rows)
    acts = torch.linspace(-1.0, 1.0, B)[:, None]
    a = acts[senv.rows].clone().requires_grad_()
    y1, _ = senv.local._advance_batched(st.y, st.control_value, a)
    loss = y1.var(dim=(-2, -1), correction=0).sum() / B
    (g,) = torch.autograd.grad(loss, a)
    total = loss.detach().reshape(1)
    dist.all_reduce(total)
    whole = _full_state(inp["flag64"])
    al = acts.clone().requires_grad_()
    y1l, _ = env._advance_batched(whole.y, whole.control_value, al)
    loss_l = y1l.var(dim=(-2, -1), correction=0).mean()
    (gl,) = torch.autograd.grad(loss_l, al)
    return {"g": _np(g), "g_whole": _np(gl[senv.rows]), "loss": float(total),
            "loss_whole": float(loss_l.detach())}


def _case_psum(rank, world, inp):
    x_all = torch.from_numpy(inp["psum_x"])
    n = x_all.shape[0]
    rows = slice(rank * n // world, (rank + 1) * n // world)
    w = torch.ones(4, requires_grad=True)
    local = ((x_all[rows] @ w) ** 2).sum()
    (g,) = torch.autograd.grad(local, w)
    both = torch.cat([local.detach().reshape(1), g])
    dist.all_reduce(both)          # the global sum of the loss and of its gradient
    both /= n
    return {"loss": float(both[0]), "grad": _np(both[1:])}


def _case_gpe(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    B = 2 * world
    env = gpe_env(B)
    senv = ShardedVectorPDEEnv(env, _mesh())
    senv.reset(_gen(5))
    env.reset(_gen(5))
    acts = torch.full((B, 1), 0.3)
    s = _steps(senv, _rows_state(inp["gpe"], senv.rows), acts[senv.rows], 2)
    w = _steps(env, _full_state(inp["gpe"]), acts, 2)
    return {"sharded": s, "whole": {k: v[:, senv.rows] for k, v in w.items()}}


def _case_rot(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    B = 2 * world
    env = rot_env(B)
    senv = ShardedVectorPDEEnv(env, _mesh())
    senv.reset(_gen(3))
    env.reset(_gen(3))
    n = senv.envs_per_device
    ss = _rows_state(inp["rot"], senv.rows)
    sl = _full_state(inp["rot"])
    s = _steps(senv, ss, torch.full((n, 1), 0.7), 1)
    w = _steps(env, sl, torch.full((B, 1), 0.7), 1)
    _, rew_s, _ = senv.rollout(ss, lambda obs, g: torch.full((n, 1), 0.5), 3)
    _, rew_l, _ = env.rollout(sl, lambda obs, g: torch.full((B, 1), 0.5), 3)
    return {"sharded": s, "whole": {k: v[:, senv.rows] for k, v in w.items()},
            "rollout": _np(rew_s), "rollout_whole": _np(rew_l[:, senv.rows]),
            "dtype": str(ss.y.dtype)}


def _case_ppo(rank, world, inp):
    from pde_opt_tpu_torch.rl import PPOConfig, ppo_train

    # Each rank starts from its own parameters: ppo_train takes rank 0's.
    net = ppo_net(10 + rank)
    start = _flat(ppo_net(10))
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    net, history = ppo_train(ppo_env(16), net, cfg, num_updates=2, generator=_gen(1),
                             env_generator=_gen(2), mesh=_mesh())
    return {"history": history, "params": _np(_flat(net)), "moved": float((_flat(net) - start).abs().max())}


def _case_ppo_one_minibatch(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv
    from pde_opt_tpu_torch.rl import PPOConfig, Sampler, make_ppo_train_step

    B = 16
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=1)

    def sgd(params):
        return torch.optim.SGD(params, lr=1.0)

    env = ppo_env(B)
    senv = ShardedVectorPDEEnv(env, _mesh())
    net_s = ppo_net(10)
    net_w = copy.deepcopy(net_s)
    start = _flat(net_s)
    step_s, _ = make_ppo_train_step(senv.local, cfg, optimizer=sgd, group=senv.group)
    step_w, _ = make_ppo_train_step(env, cfg, optimizer=sgd)
    state_s, _ = senv.reset(_gen(3))
    state_w, _ = env.reset(_gen(3))
    _, m_s = step_s(net_s, sgd(net_s.parameters()), state_s, RowsSampler(_gen(4), senv.rows, B))
    _, m_w = step_w(net_w, sgd(net_w.parameters()), state_w, Sampler(_gen(4)))
    return {"step": _np(_flat(net_s) - start), "step_whole": _np(_flat(net_w) - start),
            "metrics": {k: float(v) for k, v in m_s.items()},
            "metrics_whole": {k: float(v) for k, v in m_w.items()}}


def _case_auto_reset(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    senv = ShardedVectorPDEEnv(ch_env(2 * world), _mesh())
    state, _ = senv.reset(_gen(3))
    before = state.y.clone()
    n = senv.envs_per_device
    state, rewards, terms = senv.rollout(state, lambda obs, g: torch.zeros(n, 1), 6)
    blocks = [torch.empty_like(state.y) for _ in range(world)]
    dist.all_gather(blocks, state.y.contiguous())
    return {"terms": _np(terms), "fields": _np(torch.stack(blocks)), "first": _np(before)}


def _case_indivisible(rank, world, inp):
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    try:
        ShardedVectorPDEEnv(ch_env(2 * world - 2), _mesh())
    except ValueError as e:
        return str(e)
    return None


def _case_world_one(rank, world, inp):
    """A mesh of one rank (each rank its own): the sharded fleet is the
    unsharded one bit for bit, across an episode end."""
    from torch.distributed.device_mesh import DeviceMesh

    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv

    groups = [dist.new_group([r]) for r in range(world)]     # every rank makes every group
    mesh = DeviceMesh.from_group(groups[rank], "cpu", mesh_dim_names=("env",))
    B = 8
    env = flagship_env(B, end_time=0.05)
    senv = ShardedVectorPDEEnv(env, mesh)
    ss, os_ = senv.reset(_gen(5 + rank))
    sl, ol = env.reset(_gen(5 + rank))
    diffs = [float((os_.int() - ol.int()).abs().max())]
    agen = _gen(6)
    ends = 0
    for _ in range(8):
        a = env.sample_actions(agen)
        ss, os_, rs, ts, *_ = senv.step(ss, a)
        sl, ol, rl, tl, *_ = env.step(sl, a)
        diffs += [float((ss.y - sl.y).abs().max()), float((os_.int() - ol.int()).abs().max()),
                  float((rs - rl).abs().max()), float((ts != tl).sum())]
        ends += int(tl.sum())
    return {"max_diff": max(diffs), "episode_ends": ends, "size": senv.num_shards}


SHARDING_CASES = [
    ("mesh", _case_mesh), ("env_step", _case_env_step), ("placement", _case_placement),
    ("rollout", _case_rollout), ("flagship", _case_flagship),
    ("flagship_grad", _case_flagship_grad), ("psum", _case_psum), ("gpe", _case_gpe),
    ("rot", _case_rot), ("ppo", _case_ppo), ("ppo_one_minibatch", _case_ppo_one_minibatch),
    ("auto_reset", _case_auto_reset), ("indivisible", _case_indivisible),
    ("world_one", _case_world_one),
]


def sharding_program(rank, world, inputs):
    return _run_cases(SHARDING_CASES, rank, world, inputs)


# ---------------------------------------------------------------------------
# tests/test_torch_halo.py: 4 ranks, and groups of two and of one
# ---------------------------------------------------------------------------

def _rows_of(u: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = u.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(u[rank * n:(rank + 1) * n]))


def _case_lap2d(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import sharded_lap_2nd_2d

    return _np(sharded_lap_2nd_2d(_rows_of(inp["lap2d"], rank, world), 0.1, 0.2))


def _case_pad2(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import halo_pad_rows

    return _np(halo_pad_rows(_rows_of(inp["pad2"], rank, world), halo=2))


def _case_fft2(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import distributed_fft2

    return _np(distributed_fft2(_rows_of(inp["fft2"], rank, world).to(torch.complex128)))


def _case_fft_roundtrip(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import distributed_fft2, distributed_ifft2

    u = _rows_of(inp["fft_rt"], rank, world)
    sym = torch.from_numpy(inp["symbol"])
    m = sym.shape[1] // world
    fhat = distributed_fft2(u.to(torch.complex128)) * sym[:, rank * m:(rank + 1) * m]
    return _np(distributed_ifft2(fhat).real)


def _case_sif2(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import make_sharded_sif_ch_macro

    u = _rows_of(inp["sif2"], rank, world)
    N, M = inp["sif2"].shape
    macro = make_sharded_sif_ch_macro(lambda c: c**3 - c, N, M, 0.01, 0.015, 1.0, 1e-3, 3)
    out = {"u": _np(macro(u, 0.004))}
    # Per-instance κ on a batch of two fields: κ reshaped against each field.
    pair = torch.stack([u, 1.0 - u])
    out["batch"] = _np(macro(pair, torch.tensor([0.004, 0.006], dtype=u.dtype)))
    out["f32"] = _np(macro(u.float(), 0.004))
    return out


def _case_lap3d(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import sharded_lap_2nd_3d

    return _np(sharded_lap_2nd_3d(_rows_of(inp["lap3d"], rank, world), 0.1, 0.2, 0.3))


def _case_fft3(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import distributed_fft3, distributed_ifft3

    u = _rows_of(inp["fft3"], rank, world).to(torch.complex128)
    f = distributed_fft3(u)
    return {"fwd": _np(f), "roundtrip": _np(distributed_ifft3(f).real)}


def _case_sif3(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import make_sharded_sif_ch3d_macro

    u = _rows_of(inp["sif3"], rank, world)
    N, M, K = inp["sif3"].shape
    macro = make_sharded_sif_ch3d_macro(lambda c: c**3 - c, N, M, K, 0.01, 0.01, 0.01,
                                        0.5, 1e-5, 6)
    return _np(macro(u, 2e-3))


def _case_small_groups(rank, world, inp):
    """Rings of two ranks (next and previous are one peer) and of one rank
    (the local wrap, no message to itself)."""
    from pde_opt_tpu_torch.ops.stencils import lap_2nd_2d
    from pde_opt_tpu_torch.parallel.halo import (
        distributed_fft2,
        distributed_ifft2,
        halo_pad_rows,
        sharded_lap_2nd_2d,
    )

    pairs = [dist.new_group([2 * i, 2 * i + 1]) for i in range(world // 2)]
    singles = [dist.new_group([r]) for r in range(world)]
    pair, me = pairs[rank // 2], singles[rank]
    u = torch.from_numpy(inp["small"])                  # (8, 6): a pair's field
    half = _rows_of(inp["small"], rank % 2, 2)
    f = distributed_fft2(half.to(torch.complex128), pair)
    return {"pair_pad": _np(halo_pad_rows(half, pair, halo=1)),
            "pair_pad3": _np(halo_pad_rows(half, pair, halo=3)),
            "pair_fft": _np(f), "pair_back": _np(distributed_ifft2(f, pair).real),
            "single_pad": _np(halo_pad_rows(u, me, halo=2)),
            "single_lap": _np(sharded_lap_2nd_2d(u, 0.1, 0.2, me)),
            "lap": _np(lap_2nd_2d(u, 0.1, 0.2)),
            "single_fft_err": float((distributed_fft2(u.to(torch.complex128), me)
                                     - torch.fft.fft2(u.to(torch.complex128))).abs().max())}


HALO_CASES = [
    ("lap2d", _case_lap2d), ("pad2", _case_pad2), ("fft2", _case_fft2),
    ("fft_roundtrip", _case_fft_roundtrip), ("sif2", _case_sif2), ("lap3d", _case_lap3d),
    ("fft3", _case_fft3), ("sif3", _case_sif3), ("small_groups", _case_small_groups),
]


def halo_program(rank, world, inputs):
    return _run_cases(HALO_CASES, rank, world, inputs)


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py: 2 processes
# ---------------------------------------------------------------------------

def _case_collective(rank, world, inp):
    x = torch.full((4,), float(rank + 1))
    gathered = [torch.empty(4) for _ in range(world)]
    dist.all_gather(gathered, x)
    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": dist.get_backend(), "gathered": _np(torch.stack(gathered))}


def _case_dryrun(rank, world, inp):
    from pde_opt_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(world)


def distributed_program(rank, world, inputs):
    cases = [("collective", _case_collective)]
    if inputs.get("dryrun"):
        cases.append(("dryrun", _case_dryrun))
    return _run_cases(cases, rank, world, inputs)


# ---------------------------------------------------------------------------
# tests/test_torch_sharding_card.py: one NCCL rank a card
# ---------------------------------------------------------------------------

def card_fleet(rank, world, dev, num_envs, steps, end_time):
    """The flagship fleet (fused macro with its epilogue, K1) sharded over
    the world against the same envs unsharded on this rank's card, from one
    state and one action list: the largest difference of fields, rewards
    and obs, the episode ends, and the sharded run's launches."""
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_tpu_torch.ops import kernels
    from pde_opt_tpu_torch.parallel import ShardedVectorPDEEnv, make_mesh

    def env():
        return make_cahn_hilliard_control_env(num_envs, 64, 10, end_time=end_time,
                                              spectral_solve="fused", device=dev)

    whole_env = env()
    senv = ShardedVectorPDEEnv(env(), make_mesh("cuda"))
    ss, _ = senv.reset(torch.Generator(device=dev).manual_seed(3))
    sw, _ = whole_env.reset(torch.Generator(device=dev).manual_seed(3))
    agen = torch.Generator(device=dev).manual_seed(4)
    actions = [whole_env.sample_actions(agen) for _ in range(steps)]
    diff, ends, launches = 0.0, 0, 0
    for a in actions:
        kernels.reset_launch_counts()
        ss, os_, rs, ts, *_ = senv.step(ss, a[senv.rows])
        launches += kernels.launch_counts()["ch_cas_macro_ep"]
        sw, ow, rw, tw, *_ = whole_env.step(sw, a)
        rows = senv.rows
        if world == 1:       # after an episode end the streams differ at world > 1
            diff = max(diff, float((ss.y - sw.y[rows]).abs().max()),
                       float((os_.int() - ow[rows].int()).abs().max()),
                       float((rs - rw[rows]).abs().max()), float((ts != tw[rows]).sum()))
        ends += int(tw.sum())
    return {"diff": diff, "ends": ends, "launches": launches}


def _case_card_fleet(rank, world, inp):
    dev = torch.device("cuda", torch.cuda.current_device())
    return card_fleet(rank, world, dev, 512, 5, 1.0)


def _case_card_fft(rank, world, inp):
    from pde_opt_tpu_torch.parallel.halo import distributed_fft2, distributed_ifft2

    dev = torch.device("cuda", torch.cuda.current_device())
    N = 1024
    u = torch.randn((N, N), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    rows = slice(rank * N // world, (rank + 1) * N // world)
    f = distributed_fft2(u[rows].contiguous())
    want = torch.fft.fft2(u.to(torch.complex64))[:, rows]
    return {"fft": float((f - want).abs().max() / want.abs().max()),
            "back": float((distributed_ifft2(f).real - u[rows]).abs().max()),
            "device": str(f.device)}


def card_program(rank, world, inputs):
    return _run_cases([("fleet", _case_card_fleet), ("fft", _case_card_fft)], rank, world, inputs)
