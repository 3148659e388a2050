"""The fleet-reset pass (``csrc/fleet_reset.cu``) compiled for the CPU
against the stub headers of ``tests/cuda_stub/``, as
``test_torch_cuda_cpu_build.py`` builds the macros, and held bit for bit
against the plain-torch auto-reset and the step's in-place write-back
(``vector_env._torch_auto_reset``, then ``copy_`` into the state).

Three envs at 16², 24 x 40, 64² and 128² (one to four blocks an env), with
the CH and BV presets' reset constants, reset controls and observations,
and a wide draw observed at a scale above 255 (both clamps engage); no
env, some envs and every env ended; an env whose field went NaN and ended
beside one whose NaN field is carried; fields and observations one
element off their 16-byte alignment, and 6 x 10 pixels (not a multiple of
16), which take the kernel's element-wise path.  Compared: the state's
field, control, clock, step count and done flag, the next observation,
and the step's observation left unchanged.  The state starts from
sentinel values, so an entry the pass leaves unwritten shows.
"""

from types import SimpleNamespace

import pytest
import torch

from pde_opt_tpu_torch.envs.presets import (
    BV_RESET,
    CH_RESET,
    make_butler_volmer_control_env,
    make_cahn_hilliard_control_env,
)
from pde_opt_tpu_torch.envs.vector_env import (
    EnvState,
    _normal_draw,
    _torch_auto_reset,
    affine_normal_reset,
)
from pde_opt_tpu_torch.ops.fleet_reset import _bind_library, _fleet_reset_launch
from test_torch_cuda_cpu_build import build_for_cpu

torch.set_num_threads(1)

B = 3
SHAPES = [(16, 16), (24, 40), (64, 64), (128, 128)]
TERMINATED = {"none": [False] * B, "some": [True, False, True], "all": [True] * B}
PRESETS = {"ch": (CH_RESET, make_cahn_hilliard_control_env, {"spectral_solve": "fused"}),
           "bv": (BV_RESET, make_butler_volmer_control_env, {})}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """``fleet_reset.cu`` built for the CPU and bound by its module's own
    ``_bind_library``."""
    built = build_for_cpu(tmp_path_factory.mktemp("fleet_reset_cpu_build"), ["fleet_reset"])
    return _bind_library(built["fleet_reset"], "fleet_reset")


@pytest.fixture(scope="module")
def presets():
    """Each preset's ``(affine, reset control, observation, obs_scale)``, from
    a 16² CPU fleet (the observation does not depend on the grid)."""
    out = {}
    for name, (affine, make, kw) in PRESETS.items():
        env = make(num_envs=1, grid_size=16, device="cpu", **kw)
        out[name] = (affine, env.reset_control_value, env.state_to_observation_func,
                     env.fused_epilogue["obs_scale"])
    out["wide"] = ((0.5, 0.6, 0.0, 1.0), 0.004, lambda y: torch.clamp(
        y * 300.0, 0, 255).to(torch.uint8)[..., None, :, :], 300.0)
    return out


def _dense(shape, dtype, offset):
    """An empty dense tensor ``offset`` elements into its storage."""
    n = 1
    for s in shape:
        n *= s
    return torch.empty(n + offset, dtype=dtype)[offset:].view(shape)


def _sentinel_state(H, W, offset):
    y = _dense((B, H, W), torch.float32, offset).fill_(-7.0)
    return EnvState(y=y, t=torch.full((B,), -1.0), control_value=torch.full((B,), -1.0),
                    step_count=torch.full((B,), -5, dtype=torch.int32),
                    done=torch.ones((B,), dtype=torch.bool))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _check(lib, preset, H, W, ended, seed, nan=False, offset=0):
    affine, reset_cv, observe, obs_scale = preset
    g = torch.Generator().manual_seed(seed)
    y1 = _dense((B, H, W), torch.float32, offset)
    y1.copy_(0.5 + 0.3 * torch.randn((B, H, W), generator=g))
    if nan:
        y1[0, 1, 2] = float("nan")                 # carried: env 0 goes on
        y1[1] = float("nan")                       # ended: env 1 resets
    obs = _dense((B, 1, H, W), torch.uint8, offset)
    obs.copy_(torch.randint(0, 256, (B, 1, H, W), generator=g, dtype=torch.uint8))
    obs0 = obs.clone()
    cv1 = torch.rand((B,), generator=g)
    t1 = torch.rand((B,), generator=g)
    steps1 = torch.randint(1, 100, (B,), generator=g, dtype=torch.int32)
    terminated = torch.tensor(ended)

    env = SimpleNamespace(
        reset_func=affine_normal_reset(affine), domain=SimpleNamespace(points=(H, W)),
        _generator=torch.Generator().manual_seed(seed + 1),
        _reset_cv=torch.tensor(reset_cv, dtype=torch.float32),
        state_to_observation_func=observe)
    want = _sentinel_state(H, W, 0)
    nxt, want_obs = _torch_auto_reset(env, want, terminated, y1, cv1, t1, steps1, obs)
    for dst, src in zip(want, nxt):
        dst.copy_(src)

    got = _sentinel_state(H, W, offset)
    z = _normal_draw(env.domain, torch.Generator().manual_seed(seed + 1), B, torch.float32)
    got_obs = _fleet_reset_launch(lib, got, terminated, y1, z, obs, cv1, t1, steps1, affine,
                                  float(torch.tensor(reset_cv, dtype=torch.float32)), obs_scale,
                                  None)

    for f in EnvState._fields:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    assert got_obs.shape == obs.shape and torch.equal(got_obs, want_obs)
    assert torch.equal(obs, obs0)
    assert bool(torch.isfinite(got.y[terminated]).all())


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("preset", ["bv", "ch", "wide"])
@pytest.mark.parametrize("ended", sorted(TERMINATED))
def test_fleet_reset_matches_torch_auto_reset(lib, presets, H, W, preset, ended):
    _check(lib, presets[preset], H, W, TERMINATED[ended], seed=H * W)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("preset", ["bv", "ch", "wide"])
def test_fleet_reset_with_nan_fields(lib, presets, H, W, preset):
    """A NaN env that ended gets the reset field; one that goes on keeps its
    NaN pixel, bit for bit."""
    _check(lib, presets[preset], H, W, [False, True, False], seed=H + W, nan=True)


@pytest.mark.parametrize("H,W,offset", [(16, 16, 1), (24, 40, 1), (6, 10, 0)])
@pytest.mark.parametrize("preset", ["bv", "ch", "wide"])
def test_fleet_reset_element_wise_path(lib, presets, H, W, offset, preset):
    """Planes one element off 16-byte alignment, or of a pixel count that
    is not a multiple of 16, go through the element-wise path."""
    _check(lib, presets[preset], H, W, TERMINATED["some"], seed=7 * H + W, offset=offset)
