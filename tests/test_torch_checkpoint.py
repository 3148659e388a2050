"""The port's checkpoints (``utils.checkpoint``): the JAX package's tests
(tests/test_utils_aux.py) on the port, ``max_to_keep``, an env state and
its auto-reset generator resumed bit for bit, and restoring onto a
template's devices and dtypes."""

import os

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env
from pde_opt_tpu_torch.envs.vector_env import EnvState
from pde_opt_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)},
        "step": 7,
        "env_state": torch.ones((4, 8, 8)),
    }
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 7, tree)
    assert ckpt.latest_step(d) == 7
    out = ckpt.restore_checkpoint(d, template=tree)
    np.testing.assert_array_equal(out["params"]["w"].numpy(), tree["params"]["w"].numpy())
    assert out["step"] == 7


def test_checkpoint_resume_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        ckpt.save_checkpoint(d, step, {"x": torch.full((2,), float(step))})
    out = ckpt.restore_checkpoint(d, template={"x": torch.zeros(2)})
    np.testing.assert_array_equal(out["x"].numpy(), [3.0, 3.0])


def test_max_to_keep_and_missing(tmp_path):
    d = str(tmp_path / "ckpt")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d)
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, step, {"x": torch.full((2,), float(step))}, max_to_keep=3)
    assert sorted(os.listdir(d)) == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]
    assert ckpt.latest_step(d) == 4
    assert float(ckpt.restore_checkpoint(d, step=2)["x"][0]) == 2.0


def test_plain_containers_without_a_template(tmp_path):
    """Without a template: nested dicts, lists and tuples; a NamedTuple
    comes back as a dict of its fields, a numpy array as a tensor."""
    state = EnvState(y=torch.rand(2, 4, 4), t=torch.zeros(2), control_value=torch.ones(2),
                     step_count=torch.zeros(2, dtype=torch.int32),
                     done=torch.zeros(2, dtype=torch.bool))
    tree = {"env": state, "hist": [1.5, (2, "a"), None], "np": np.arange(3.0),
            "opt": {"state": {0: {"step": torch.tensor(3.0)}}, "betas": (0.9, 0.999)}}
    d = str(tmp_path / "c")
    ckpt.save_checkpoint(d, 0, tree)
    out = ckpt.restore_checkpoint(d)
    assert set(out["env"]) == set(EnvState._fields)
    assert torch.equal(out["env"]["y"], state.y) and out["env"]["done"].dtype == torch.bool
    assert out["hist"] == [1.5, (2, "a"), None]
    assert torch.equal(out["np"], torch.arange(3.0, dtype=torch.float64))
    assert out["opt"]["betas"] == (0.9, 0.999) and float(out["opt"]["state"][0]["step"]) == 3.0
    with pytest.raises(TypeError, match="leaf"):
        ckpt.save_checkpoint(d, 1, {"f": lambda x: x})


def test_restore_onto_the_template_device_and_dtype(tmp_path):
    """A template puts each tensor on its leaf's device and dtype, numpy
    leaves back to numpy, and keeps the template's container types."""
    d = str(tmp_path / "c")
    ckpt.save_checkpoint(d, 3, {"a": torch.linspace(0, 1, 5), "n": np.ones(2, np.float32),
                                "k": torch.tensor(4)})
    template = {"a": torch.zeros(5, dtype=torch.float64, device="meta"),
                "n": np.zeros(2, np.float64), "k": 0}
    out = ckpt.restore_checkpoint(d, template={**template, "a": torch.zeros(5, dtype=torch.float64)})
    assert out["a"].dtype == torch.float64 and out["a"].device.type == "cpu"
    np.testing.assert_array_equal(out["a"].numpy(), np.linspace(0, 1, 5, dtype=np.float32))
    assert isinstance(out["n"], np.ndarray) and out["n"].dtype == np.float64
    assert out["k"] == 4 and isinstance(out["k"], int)
    meta = ckpt.restore_checkpoint(d, template=template)
    assert meta["a"].device.type == "meta"
    with pytest.raises(KeyError, match="b"):
        ckpt.restore_checkpoint(d, template={"b": torch.zeros(1)})


def test_env_state_and_generator_resume_bit_for_bit(tmp_path):
    """Save a fleet mid-rollout with its auto-reset generator; a fresh env
    restored from the checkpoint (``set_generator``, no redraw of the
    fleet) runs the same steps, across an episode end, bit for bit."""
    def fleet():
        return make_cahn_hilliard_control_env(num_envs=6, grid_size=16, substeps=2,
                                              end_time=0.05, device="cpu")

    env = fleet()
    gen = torch.Generator().manual_seed(1)
    state, _ = env.reset(gen)
    for _ in range(3):
        state, *_ = env.step(state, env.sample_actions(gen))
    agen = torch.Generator().manual_seed(2)
    actions = [env.sample_actions(agen) for _ in range(4)]
    d = str(tmp_path / "run")
    ckpt.save_checkpoint(d, 3, {"env": state, "generator": gen.get_state()})
    rewards, terms = [], []
    for a in actions:
        state, _, r, te, *_ = env.step(state, a)
        rewards.append(r)
        terms.append(te)
    assert bool(torch.stack(terms).any())                 # an episode ended

    env2 = fleet()
    template, _ = env2.reset(torch.Generator().manual_seed(9))
    back = ckpt.restore_checkpoint(d, template={"env": template,
                                                "generator": torch.Generator().get_state()})
    assert isinstance(back["env"], EnvState)
    env2.set_generator(torch.Generator().set_state(back["generator"]))
    state2 = back["env"]
    for a, r, te in zip(actions, rewards, terms):
        state2, _, r2, te2, *_ = env2.step(state2, a)
        assert torch.equal(r2, r) and torch.equal(te2, te)
    for f in EnvState._fields:
        assert torch.equal(getattr(state2, f), getattr(state, f))
