"""The port's sharded env fleets and data-parallel PPO held against the JAX
package, on four gloo processes.

The counterparts of every test of ``tests/test_sharding.py`` (and of
``tests/test_rl.py::test_ppo_data_parallel_over_mesh``), by name.  One group
of four ranks (``torch_dist_ranks.sharding_program``, torch only) runs every
case once for the whole file; each test reads its case's results from all
ranks.  The same numpy states go to the ranks and to the JAX
``ShardedVectorPDEEnv`` on a 4-device sub-mesh of conftest's 8 virtual
devices (2 envs a device, the ranks' layout), and each rank's block is
compared with JAX's.  Tolerances are the port's single-fleet ones
(``test_torch_env.py``, ``test_torch_per_env.py``, ``test_torch_gpe.py``,
``test_torch_gpe_rot.py``); a sharded fleet against the port's unsharded
fleet is bit for bit.  The random streams of the two packages differ, so
nothing random is compared across them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pde_opt_tpu.envs.presets import make_gpe_control_env as jgpe
from pde_opt_tpu.envs.presets import make_gpe_rot_control_env as jrot
from pde_opt_tpu.envs.vector_env import EnvState as JState
from pde_opt_tpu.parallel import ShardedVectorPDEEnv as JSharded
from pde_opt_tpu.parallel import make_mesh as jmake_mesh
from pde_opt_tpu.parallel.mesh import shard_map as jshard_map
from test_sharding import _ch_env, _fused_flagship_env
from torch_dist_ranks import sharding_program, spawn_group, value

WORLD = 4
B = 2 * WORLD
N = 16
GRAD_GRID = 64


def _state(y, cv):
    n = y.shape[0]
    return {"y": y, "t": np.zeros(n, np.float32), "control_value": cv.astype(np.float32),
            "step_count": np.zeros(n, np.int32), "done": np.zeros(n, bool)}


def _inputs():
    rng = np.random.default_rng(0)
    # CH: around the 0.5 operating point; an f64 field, as the JAX env's
    # own reset makes under x64 (tests/test_torch_per_env.py).
    ch = _state(0.5 + 0.05 * rng.standard_normal((B, N, N)), np.full(B, 0.002))
    flag = _state((0.5 + 0.05 * rng.standard_normal((B, N, N))).astype(np.float32),
                  rng.uniform(2e-3, 1e-2, B))
    flag64 = _state((0.5 + 0.05 * rng.standard_normal((B, GRAD_GRID, GRAD_GRID))).astype(
        np.float32), rng.uniform(2e-3, 1e-2, B))
    dx = 16.0 / N
    x = (np.arange(N) + 0.5) * dx - 8.0
    X, Y = np.meshgrid(x, x, indexing="ij")
    psi = np.exp(-(X**2 + Y**2) / 4.0)[None] * (1 + 0.02 * rng.standard_normal((B, N, N)))
    psi = psi / np.sqrt((psi**2).sum((-2, -1), keepdims=True) * dx * dx)
    gpe = _state(np.stack([psi, np.zeros_like(psi)], -1).astype(np.float32),
                 rng.uniform(0.0, 20.0, B))
    dx = 20.0 / N
    x = (np.arange(N) + 0.5) * dx - 10.0
    X, Y = np.meshgrid(x, x, indexing="ij")
    phi = np.exp(-(X**2 + Y**2) / 16.0)[None] * (1 + 0.05 * rng.standard_normal((B, N, N)))
    phi = phi * np.exp(0.3j * rng.standard_normal((B, N, N)))
    phi = phi / np.sqrt((np.abs(phi) ** 2).sum((-2, -1), keepdims=True) * dx * dx)
    rot = _state(phi.astype(np.complex128), rng.uniform(0.0, 2.0, B))
    return {"mesh_x": np.arange(B * 3, dtype=np.float32).reshape(B, 3), "ch": ch, "flag": flag,
            "flag64": flag64, "gpe": gpe, "rot": rot,
            "psum_x": np.arange(8 * WORLD * 4, dtype=np.float32).reshape(8 * WORLD, 4)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(1)
    inputs = _inputs()
    results = spawn_group(sharding_program, WORLD, tmp_path_factory.mktemp("sharding"), inputs)
    return inputs, results


def _case(run, name):
    """The case's value on every rank."""
    return [value(r, name) for r in run[1]()]


def _rows(rank):
    return slice(2 * rank, 2 * rank + 2)


def _jstate(arrs):
    return JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                  control_value=jnp.asarray(arrs["control_value"]),
                  key=jax.random.split(jax.random.PRNGKey(0), arrs["y"].shape[0]),
                  step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))


def _jmesh():
    return jmake_mesh(jax.devices()[:WORLD])


def _jsteps(senv, js, acts, n):
    out = {"y": [], "obs": [], "reward": []}
    for _ in range(n):
        js, obs, reward, *_ = senv.step(js, acts)
        for k, v in (("y", js.y), ("obs", obs), ("reward", reward)):
            out[k].append(np.asarray(v))
    return js, {k: np.stack(v) for k, v in out.items()}


def _assert_obs(got, want):
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_mesh_construction(run):
    assert _jmesh().shape["env"] == WORLD
    for rank, got in enumerate(_case(run, "mesh")):
        assert got["shape"] == (WORLD,) and got["names"] == ("env",)
        assert got["device_type"] == "cpu" and got["local_rank"] == rank
        assert got["env_sharding"] == ["Shard"] and got["replicated"] == ["Replicate"]


def test_shard_map_runs_on_the_local_blocks(run):
    x = run[0]["mesh_x"]
    want = np.asarray(jax.jit(jshard_map(lambda b: 2.0 * b.sum(0, keepdims=True), mesh=_jmesh(),
                                         in_specs=P("env"), out_specs=P("env")))(x))
    for rank, got in enumerate(_case(run, "mesh")):
        np.testing.assert_array_equal(got["x_local"], x[_rows(rank)])
        np.testing.assert_array_equal(got["local"], want[rank:rank + 1])
        np.testing.assert_array_equal(got["full"], want)


def test_sharded_env_matches_single_device(run):
    """One step of zeros from one numpy state: each rank's block against the
    JAX sharded fleet's; the sharded reset is the unsharded one's rows."""
    senv = JSharded(_ch_env(B), _jmesh())
    js, _, jr, *_ = senv.step(_jstate(run[0]["ch"]), jnp.zeros((B, 1)))
    for rank, got in enumerate(_case(run, "env_step")):
        assert got["reset_obs_equal"] and got["rows"] == (2 * rank, 2 * rank + 2)
        np.testing.assert_allclose(got["y"], np.asarray(js.y)[_rows(rank)], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["reward"], np.asarray(jr)[_rows(rank)], rtol=1e-3)


def test_sharded_state_device_placement(run):
    senv = JSharded(_ch_env(B), _jmesh())
    state, _ = senv.reset(jax.random.PRNGKey(1))
    assert len(state.y.sharding.device_set) == WORLD
    for got in _case(run, "placement"):
        # Each rank holds its own rows, on its own device; together they are
        # the fleet the unsharded reset draws from the same seed.
        assert got["devices"] == ["cpu"] and got["envs_per_device"] == 2
        assert got["shapes"] == [(2, N, N), (2,), (2,), (2,), (2,)]
        assert got["local_env_size"] == 2 and got["global_env_size"] == B
        assert got["gathered_is_the_fleet"]


def test_sharded_rollout_runs(run):
    senv = JSharded(_ch_env(B), _jmesh())
    _, jrew, _ = senv.rollout(_jstate(run[0]["ch"]), lambda obs, k: jnp.zeros((B, 1)), 4)
    for rank, got in enumerate(_case(run, "rollout")):
        assert got["rewards"].shape == (4, 2) and np.isfinite(got["rewards"]).all()
        assert not got["terms"].any()
        np.testing.assert_allclose(got["rewards"], np.asarray(jrew)[:, _rows(rank)], rtol=1e-3)


def test_sharded_fused_flagship_matches_single_device(run):
    """The fused flagship fleet: bit for bit against the port's unsharded
    fleet (bf16 and f32 matrices); with f32 matrices against the JAX sharded
    fleet, 3 steps at the f32 bound."""
    jenv = _fused_flagship_env(B)
    jenv.solver_parameters = {"A": 1.0, "mats_dtype": jnp.float32}
    acts = jnp.linspace(-1.0, 1.0, B)[:, None]
    _, want = _jsteps(JSharded(jenv, _jmesh()), _jstate(run[0]["flag"]), acts, 3)
    # A = 1 damps every mode of a 16^2 field within a step (deadbeat), so the
    # reward -var sits at the field's f32 noise: hold it at what the field's
    # bound allows, |d var| <= 2 max|u - mean| du + du^2.
    spread = np.abs(want["y"] - want["y"].mean((-2, -1), keepdims=True)).max()
    r_atol = 2.0 * spread * 1e-5 + 1e-10
    for rank, got in enumerate(_case(run, "flagship")):
        for mats in ("f32", "bf16"):
            for k in ("y", "obs", "reward"):
                np.testing.assert_array_equal(got[mats]["sharded"][k], got[mats]["whole"][k])
        g = got["f32"]["sharded"]
        np.testing.assert_allclose(g["y"], want["y"][:, _rows(rank)], rtol=0, atol=1e-5)
        _assert_obs(g["obs"], want["obs"][:, _rows(rank)])
        np.testing.assert_allclose(g["reward"], want["reward"][:, _rows(rank)], rtol=1e-3,
                                   atol=r_atol)


def test_sharded_fused_flagship_rollout_and_grad(run):
    """Pathwise gradient through the sharded fused macro (f32 matrices)
    with respect to each rank's actions: against the port's unsharded
    gradient (the JAX test's 1e-5) and against JAX's.  At 64^2: on the JAX
    test's 16^2 grid A = 1 damps every mode within a step, and the loss and
    its gradient are f32 noise."""
    from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env

    jenv = make_cahn_hilliard_control_env(num_envs=B, grid_size=GRAD_GRID, substeps=4,
                                          spectral_solve="fused", vectorized_control=True)
    jenv.solver_parameters = {"A": 1.0, "mats_dtype": jnp.float32}
    js = _jstate(run[0]["flag64"])

    def loss_local(acts):
        y1, _ = jenv._advance_batched(js.y, js.control_value, acts)
        return jnp.mean(jnp.var(y1, axis=(-2, -1)))

    acts = jnp.linspace(-1.0, 1.0, B)[:, None].astype(jnp.float32)
    jloss, jg = jax.value_and_grad(loss_local)(acts)
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0.0
    for rank, got in enumerate(_case(run, "flagship_grad")):
        assert np.isfinite(got["g"]).all() and np.abs(got["g"]).max() > 0.0
        np.testing.assert_allclose(got["g"], got["g_whole"], rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(got["loss"], got["loss_whole"], rtol=1e-5)
        np.testing.assert_allclose(got["g"], jg[_rows(rank)], rtol=1e-3,
                                   atol=1e-5 * np.abs(jg).max())
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-4)


def test_learner_psum_gradients(run):
    """The co-located learner: per-rank rows, replicated parameters, the
    loss and its gradient summed over the ranks (``all_reduce``)."""
    x = run[0]["psum_x"].astype(np.float64)
    n = x.shape[0]
    w = np.ones(4)
    loss_ref = float(((x @ w) ** 2).sum() / n)
    grad_ref = 2.0 * x.T @ (x @ w) / n
    for got in _case(run, "psum"):
        np.testing.assert_allclose(got["loss"], loss_ref, rtol=1e-6)
        np.testing.assert_allclose(got["grad"], grad_ref, rtol=1e-6)


def test_sharded_gpe_strang_env_matches_single_device(run):
    """The GPE Strang fleet with the fused epilogue (f32 matrices): the
    kernel's obs and stats shard with the fleet."""
    jenv = jgpe(num_envs=B, grid_size=N, substeps=2, end_time=0.2, step_dt=0.02,
                spectral_solve="fused", fused_epilogue=True)
    jenv.solver_parameters = {"mats_dtype": jnp.float32}
    _, want = _jsteps(JSharded(jenv, _jmesh()), _jstate(run[0]["gpe"]), jnp.full((B, 1), 0.3), 2)
    for rank, got in enumerate(_case(run, "gpe")):
        s = got["sharded"]
        for k in ("y", "obs"):
            np.testing.assert_array_equal(s[k], got["whole"][k])
        np.testing.assert_allclose(s["reward"], got["whole"]["reward"], rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(s["y"], want["y"][:, _rows(rank)], rtol=0, atol=5e-6)
        _assert_obs(s["obs"], want["obs"][:, _rows(rank)])
        np.testing.assert_allclose(s["reward"], want["reward"][:, _rows(rank)], rtol=1e-5)


def test_sharded_rot_gpe_env_matches_single_device(run):
    """The rotating GPE fleet (complex state, the matmul ADI), in f64 on
    both sides: a step and a 3-step rollout."""
    jenv = jrot(num_envs=B, grid_size=N, substeps=2, end_time=0.32, step_dt=0.04,
                dtype=jnp.float64)
    senv = JSharded(jenv, _jmesh())
    js, want = _jsteps(senv, _jstate(run[0]["rot"]), jnp.full((B, 1), 0.7), 1)
    _, jrew, _ = senv.rollout(js, lambda obs, k: jnp.full((B, 1), 0.5), 3,
                              key=jax.random.PRNGKey(5))
    want_y = np.stack([want["y"].real, want["y"].imag], -1)
    for rank, got in enumerate(_case(run, "rot")):
        assert got["dtype"] == "torch.complex128"
        s = got["sharded"]
        for k in ("y", "obs", "reward"):
            np.testing.assert_array_equal(s[k], got["whole"][k])
        np.testing.assert_array_equal(got["rollout"], got["rollout_whole"])
        np.testing.assert_allclose(s["y"], want_y[:, _rows(rank)], rtol=0, atol=2e-5)
        np.testing.assert_allclose(s["reward"], want["reward"][:, _rows(rank)], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["rollout"], np.asarray(jrew)[:, _rows(rank)], rtol=0,
                                   atol=1e-4)


def test_ppo_data_parallel_over_mesh(run):
    """``ppo_train(mesh=...)`` at tests/test_rl.py's shape (16 envs of 16²,
    2 substeps, ActorCriticConv (4,) → 16, T 2, 2 minibatches, 2 updates)."""
    for got in _case(run, "ppo"):
        history = got["history"]
        assert len(history) == 2
        assert all(np.isfinite(m["loss"]) for m in history)
        assert all(np.isfinite(m["reward_mean"]) for m in history)
        assert got["moved"] > 0.0


def test_ppo_mesh_parameters_identical_across_ranks(run):
    """Every rank started from its own parameters; after two updates all
    hold rank 0's, updated by the same averaged gradients, bit for bit, and
    log the same (global) metrics."""
    results = _case(run, "ppo")
    for got in results[1:]:
        np.testing.assert_array_equal(got["params"], results[0]["params"])
        assert got["history"] == results[0]["history"]


def test_ppo_one_minibatch_update_equals_unsharded(run):
    """minibatches=1, epochs=1, SGD at lr 1 and the same rollout noise (the
    rows of the whole fleet's draw): the sharded update is the unsharded
    update over the same 16 envs, up to summation order."""
    for got in _case(run, "ppo_one_minibatch"):
        step, whole = got["step"], got["step_whole"]
        assert np.abs(whole).max() > 0.0
        np.testing.assert_allclose(step, whole, rtol=0, atol=1e-5 * np.abs(whole).max())
        # A loss is a mean of T x B = 32 terms of size ~1 (the normalised
        # advantages): summed in another order it moves by ~32 f32 ulps.
        for k, v in got["metrics_whole"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=32 * 2.0**-24)


def test_two_ranks_auto_reset_fields_differ(run):
    """At world size 4 each rank draws its auto-resets from its own stream:
    the fields every env restarts from after the episode end (step 6) are
    fresh draws, and no two ranks' are the same."""
    results = _case(run, "auto_reset")
    terms = results[0]["terms"]
    assert terms[-1].all() and not terms[:-1].any()
    fields = results[0]["fields"]                       # (rank, env, H, W)
    for got in results:
        np.testing.assert_array_equal(got["fields"], fields)
    assert abs(fields.mean() - 0.5) < 2e-3 and 0.005 < fields.std() < 0.02
    for a in range(WORLD):
        assert not np.array_equal(fields[a], results[a]["first"])
        for b in range(a + 1, WORLD):
            assert np.abs(fields[a] - fields[b]).max() > 1e-3


def test_sharded_env_indivisible_raises(run):
    for got in _case(run, "indivisible"):
        assert got == f"num_envs={B - 2} not divisible by mesh axis 'env' size {WORLD}"


def test_world_one_is_the_unsharded_fleet_bit_for_bit(run):
    """On a mesh of one rank (each rank its own, from a subgroup) the
    sharded flagship fleet is the unsharded one bit for bit: fields, obs,
    rewards and terminations over 8 steps across an episode end."""
    for got in _case(run, "world_one"):
        assert got["size"] == 1 and got["episode_ends"] > 0
        assert got["max_diff"] == 0.0


def test_make_mesh_without_cuda_raises(monkeypatch):
    from pde_opt_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
