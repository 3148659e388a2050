"""An env fleet's auto-reset and in-place state write-back as one pass
(``csrc/fleet_reset.cu``).

Where a fleet's reset is ``clamp(mean + noise z, lo, hi)`` of one standard
normal draw ``z`` and its observation ``uint8(clamp(y obs_scale, 0, 255))``,
:func:`fleet_reset` selects, for the envs that ended, the reset field, its
observation, the reset control and a zero clock and step count, and writes
the next state into the state's own tensors, in one launch.  Its plain-torch
twin is the auto-reset that every other fleet runs
(:func:`pde_opt_tpu_torch.envs.vector_env._torch_auto_reset`); the two agree
bit for bit.  :func:`fleet_reset_refusal` says which tensors the kernel takes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from .kernels import count_launch, load_library

__all__ = ["FLEET_RESET", "fleet_reset", "fleet_reset_refusal"]

# The launch count's key: dotted, as a count that no macro's total includes.
FLEET_RESET = "vector_env.fleet_reset"


def _bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the pass's C interface on ``lib`` (``csrc/fleet_reset.cu``
    built for the card, or for the CPU by the tests' stub build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fleet_reset_launch.argtypes = [
        p, p, p, p, p, p, p,             # terminated, y1, z, obs, cv1, t1, steps1
        p, p, p, p, p, p,                # y, obs_next, cv, t, steps, done
        i, ctypes.c_longlong,            # B, pixels an env
        f, f, f, f, f, f,                # mean, noise, lo, hi, reset cv, obs_scale
        p,                               # stream
    ]
    lib.fleet_reset_launch.restype = ctypes.c_int
    lib.fleet_reset_error_string.argtypes = [ctypes.c_int]
    lib.fleet_reset_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return _bind_library(load_library("fleet_reset"))


def fleet_reset_refusal(state: Sequence[torch.Tensor], terminated, y1, cv1, t1, steps1,
                        obs) -> Optional[str]:
    """Why :func:`fleet_reset` does not take these tensors, or None where it
    does.  ``state`` holds the fleet's ``(y, t, control_value, step_count,
    done)``, which the pass writes; the rest are the step's.  It takes dense
    tensors on one CUDA device: f32 fields ``y1`` and ``y`` and a uint8
    ``obs`` of as many pixels, and ``(B,)`` rows (f32 clock and control,
    int32 step counts, bool flags), none of which autograd records."""
    y, t, cv, steps, done = state
    if torch.is_grad_enabled() and any(x.requires_grad for x in (y1, cv1, t1, y, t, cv)):
        return "autograd records the step"
    B, dev = y1.shape[0], y1.device
    fields = ((y1, torch.float32), (y, torch.float32), (obs, torch.uint8))
    rows = ((terminated, torch.bool), (cv1, torch.float32), (t1, torch.float32),
            (steps1, torch.int32), (cv, torch.float32), (t, torch.float32),
            (steps, torch.int32), (done, torch.bool))
    if not (all(x.dtype == dt and x.device == dev and x.is_contiguous()
                and x.numel() == y1.numel() for x, dt in fields)
            and all(x.dtype == dt and x.device == dev and x.is_contiguous()
                    and tuple(x.shape) == (B,) for x, dt in rows)):
        return "a tensor of another dtype, shape, layout or device than the pass takes"
    if dev.type != "cuda":
        return f"the fleet is on {dev}, not a CUDA device"
    return None


def _launch(lib, state, terminated, y1, z, obs, cv1, t1, steps1, affine, reset_cv: float,
            obs_scale: float, stream) -> torch.Tensor:
    """One launch of ``lib``'s pass on ``stream``; returns the next
    observation (a new tensor shaped as ``obs``)."""
    y, t, cv, steps, done = state
    obs_next = torch.empty_like(obs)
    B = y1.shape[0]
    rc = lib.fleet_reset_launch(
        terminated.data_ptr(), y1.data_ptr(), z.data_ptr(), obs.data_ptr(), cv1.data_ptr(),
        t1.data_ptr(), steps1.data_ptr(), y.data_ptr(), obs_next.data_ptr(), cv.data_ptr(),
        t.data_ptr(), steps.data_ptr(), done.data_ptr(), B, y1.numel() // B, *affine,
        reset_cv, obs_scale, stream)
    if rc != 0:
        raise RuntimeError(
            f"fleet_reset launch failed: {lib.fleet_reset_error_string(rc).decode()}")
    return obs_next


def fleet_reset(state: Sequence[torch.Tensor], terminated, y1, z, obs, cv1, t1, steps1,
                affine, reset_cv: float, obs_scale: float) -> torch.Tensor:
    """Auto-reset the fleet and write its next state into ``state``'s
    tensors ``(y, t, control_value, step_count, done)``, in one launch on
    the current stream, with no synchronisation.

    ``terminated`` selects per env: the reset field ``clamp(mean + noise z,
    lo, hi)`` from the draw ``z`` (``affine = (mean, noise, lo, hi)``), its
    observation, ``reset_cv``, a zero clock and step count, or else the
    step's ``y1``, ``obs``, ``cv1``, ``t1`` and ``steps1``; ``done`` becomes
    False.  ``z`` is a dense f32 tensor of ``y1``'s shape on its device; the
    others as :func:`fleet_reset_refusal` accepts them.  Returns the next
    observation; ``obs`` is left as it was.  Counts one launch under
    :data:`FLEET_RESET`.
    """
    dev = y1.device
    with torch.cuda.device(dev):
        obs_next = _launch(_library(), state, terminated, y1, z, obs, cv1, t1, steps1, affine,
                           reset_cv, obs_scale, torch.cuda.current_stream(dev).cuda_stream)
    count_launch(FLEET_RESET)
    return obs_next
