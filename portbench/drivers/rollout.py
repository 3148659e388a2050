"""The rollout traffic: a data collector drives the env fleet under a
uniform random policy and hands on a batch every ``segment_steps`` steps.

Set-up builds the configuration's preset fleet on the card, resets it from
the seed and runs ``warmup_segments`` segments, which warm every shape the
window uses.  The window then runs whole segments of
``VectorPDEEnv.make_rollout``, each ended by ``torch.cuda.synchronize()``,
until ``--seconds`` have passed.  What the window reports follows the
sources of the cell's metrics in ``BENCHMARK.json``:

* ``env_steps_per_s`` (an end-to-end metric on the host clock): every
  env-step of an untraced window over the window's seconds;
* ``device_env_steps_per_s`` (an end-to-end metric from the device trace):
  every env-step of the window over the seconds in which a device operation
  ran.  The whole window is traced, device alone, in slices of
  ``window_trace_segments`` segments (each slice's trace stays small), and
  busy time is the union of the operations' intervals in each slice.  The
  tracer's start and its reading of each slice take host time inside the
  window, in which the device runs nothing, so they leave the rate alone;
  the checked segments fall in the first slice;
* a per-layer metric on the host clock (``host_env_steps_per_s``): a
  ``--trace 1`` run first runs an untraced window of ``--seconds`` and
  reports its rate beside what its traced windows read (the ranges of a
  traced run are installed after that window).

The check: the window records ``check_segments`` consecutive segments,
drawn from the seed, for ``check_envs`` envs drawn from the seed.  Once
the window has closed, the plain reference follows them step by step: from
the program's state before each step, one step under the window's own
action and reset draw, against the program's state after it.  The fleet's
first reset is checked by itself.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict

from .. import core, trace as tr

STEPPER = "portbench/stepper"
AUTORESET = "portbench/auto_reset"
ENV_STEP = "portbench/env.step"


def build_env(cell: core.Cell, device):
    from pde_opt_tpu_torch.envs import presets

    fleet = cell.config["fleet"]
    kwargs = dict(cell.config["preset_args"])
    kwargs.update(cell.traffic.get("env_overrides", {}))
    make = getattr(presets, cell.config["preset"])
    return make(num_envs=fleet["num_envs"], grid_size=fleet["grid"],
                substeps=fleet["substeps"], end_time=fleet["end_time"],
                step_dt=fleet["step_dt"], device=device, **kwargs)


def install_ranges(env) -> None:
    """Open the benchmark's ranges around the fleet's step, its stepper call
    and its auto-reset (a traced run only)."""
    env.step = tr.ranged(env.step, ENV_STEP)
    env._auto_reset = tr.ranged(env._auto_reset, AUTORESET)
    base = env.solver_type
    methods = {m: tr.ranged(getattr(base, m), STEPPER)
               for m in ("evolve", "evolve_with_epilogue") if hasattr(base, m)}
    env.solver_type = type(base.__name__, (base,), methods)


class Recorder:
    """The checked steps' record, in buffers allocated at set-up, so that
    recording allocates nothing inside the window: the state of the envs
    ``idx`` before each step and after the last, each step's action,
    reward and episode end, and the observation after the last step but one."""

    def __init__(self, env, state, obs, idx, n: int):
        import torch

        b, dev = idx.numel(), idx.device

        def buf(x, lead):
            return torch.empty((lead, b, *x.shape[1:]), dtype=x.dtype, device=dev)

        self.idx, self.n = idx, n
        self.y, self.kappa = buf(state.y, n + 1), buf(state.control_value, n + 1)
        self.t, self.steps = buf(state.t, n + 1), buf(state.step_count, n + 1)
        self.actions = buf(env.sample_actions(torch.Generator(dev).manual_seed(0)), n)
        self.rewards = torch.empty((n, b), dtype=torch.float32, device=dev)
        self.terms = torch.empty((n, b), dtype=torch.bool, device=dev)
        self.last_obs = buf(obs, 1)[0]
        self.j = None              # the checked step the next call records

    def state(self, state, j: int):
        import torch

        for src, dst in ((state.y, self.y), (state.control_value, self.kappa),
                         (state.t, self.t), (state.step_count, self.steps)):
            torch.index_select(src, 0, self.idx, out=dst[j])

    def step(self, state, action, obs):
        import torch

        j = self.j
        self.state(state, j)
        torch.index_select(action, 0, self.idx, out=self.actions[j])
        if j == self.n - 1:
            torch.index_select(obs, 0, self.idx, out=self.last_obs)
        self.j += 1

    def segment(self, rewards, terms, offset: int):
        import torch

        T = rewards.shape[0]
        torch.index_select(rewards, 1, self.idx, out=self.rewards[offset:offset + T])
        torch.index_select(terms, 1, self.idx, out=self.terms[offset:offset + T])

    def as_dict(self, gen_state) -> Dict[str, Any]:
        return {"y": self.y, "kappa": self.kappa, "t": self.t, "steps": self.steps,
                "actions": self.actions, "rewards": self.rewards, "terms": self.terms,
                "last_obs": self.last_obs, "gen_state": gen_state}


class Policy:
    """Uniform random actions from the policy's generator
    (``VectorPDEEnv.sample_actions``); while ``rec.j`` is set, each call
    records the step it starts."""

    def __init__(self, env, rec: Recorder):
        self.env, self.rec, self.state = env, rec, None

    def __call__(self, obs, generator):
        a = self.env.sample_actions(generator)
        if self.rec.j is not None:
            self.rec.step(self.state, a, obs)
        return a


def run(cell: core.Cell, seed: int, seconds: float, traced: bool, device, clock) -> Dict:
    """One run of a rollout cell; returns what ``run.py`` prints."""
    import torch

    traffic = cell.traffic
    T = int(traffic["segment_steps"])
    n_chk = int(traffic["check_segments"])
    s_env, s_pol, s_pick = core.seeds(seed, 3)
    gen_env = torch.Generator(device=device).manual_seed(s_env)
    gen_pol = torch.Generator(device=device).manual_seed(s_pol)
    pick = torch.Generator().manual_seed(s_pick)

    env = build_env(cell, device)
    B = env.num_envs
    n_check = min(B, int(cell.limits["check_envs"]))
    idx = torch.randperm(B, generator=pick)[:n_check].sort().values.to(device)
    gen_state0 = gen_env.get_state()
    state, obs0 = env.reset(gen_env)
    start = {"y": state.y.index_select(0, idx), "obs": obs0.index_select(0, idx)}
    rec = Recorder(env, state, obs0, idx, n_chk * T)
    policy = Policy(env, rec)
    policy.state = state
    seg = env.make_rollout(policy, T)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def segment(offset=None):
        """One segment; with ``offset``, recorded as checked steps from there."""
        nonlocal state
        rec.j = offset
        state, rewards, terms = seg(state, gen_pol)
        if offset is not None:
            rec.segment(rewards, terms, offset)
        rec.j = None
        return terms

    device_rate = any(m["source"] == "device_trace" for m in cell.end_to_end)
    host_rate = traced and any(m["source"] == "host_clock" for m in cell.per_layer)
    for _ in range(int(traffic["warmup_segments"])):
        segment()
    sync()
    t_w = time.perf_counter()
    segment(0)                     # also warms the recording's own kernels
    sync()
    t_seg = time.perf_counter() - t_w

    n_fixed = int(traffic["trace_segments"]) if traced else 0
    n_slice = int(traffic["window_trace_segments"])
    if traced:
        span = 2 * n_fixed
    elif device_rate:
        span = n_slice             # the first slice, whatever the tracer's pace
    else:
        span = max(1, int(0.5 * seconds / t_seg))
    first = int(torch.randint(0, max(1, span - n_chk + 1), (1,), generator=pick))
    term = torch.zeros((), dtype=torch.int64, device=device)
    gen_state = {}
    count = {"segs": 0}

    def window(n: int = 0):
        """Segments until ``--seconds`` have passed (or ``n`` of them), and
        on until the checked ones have run; returns its seconds."""
        nonlocal term
        t0 = time.perf_counter()
        clock.setdefault("setup_s", t0 - clock["t0"])
        done = 0
        while True:
            segs = count["segs"]
            inside = first <= segs < first + n_chk
            if segs == first:
                gen_state["run"] = gen_env.get_state()
            term += segment((segs - first) * T if inside else None).sum()
            if segs == first + n_chk - 1:
                rec.state(state, rec.n)
            sync()
            count["segs"] += 1
            done += 1
            elapsed = time.perf_counter() - t0
            enough = done >= n if n else elapsed >= seconds
            if enough and (n or count["segs"] >= first + n_chk):
                return elapsed

    trace, metrics = None, {}
    if traced:
        if host_rate:
            segs0, elapsed = count["segs"], window()
            metrics["env_steps_per_s"] = (count["segs"] - segs0) * T * B / elapsed
        install_ranges(env)
        trace = tr.traced_windows(window, n_fixed, torch.profiler.record_function)
        trace.steps = trace.device.steps = n_fixed * T
        if count["segs"] < first + n_chk:
            window(first + n_chk - count["segs"])
    elif device_rate:
        busy, t0 = 0.0, time.perf_counter()
        clock.setdefault("setup_s", t0 - clock["t0"])
        while (time.perf_counter() - t0 < seconds or count["segs"] < first + n_chk):
            with tr.profiled(host=False) as sliced:
                window(n_slice)
            busy += sliced["trace"].busy_s()
        print(f"portbench: device-traced window: {count['segs']} segments, device busy "
              f"{busy!r} s of {time.perf_counter() - t0!r} s", file=sys.stderr)
        if busy > 0:
            metrics["device_env_steps_per_s"] = count["segs"] * T * B / busy
    else:
        elapsed = window()
        metrics["env_steps_per_s"] = count["segs"] * T * B / elapsed
    segs = count["segs"]
    steps = segs * T
    before = (int(traffic["warmup_segments"]) + 1) * T
    extra_terms = int(term) - B * _episode_ends(env, steps, before)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    meta = {"B": B, "H": env.domain.points[0], "W": env.domain.points[1],
            "substeps": env.n_substeps, "ds": _ds(cell)}
    del state, seg, policy, obs0, env
    readings = core.reference(cell).check_rollout(
        cell.config, meta, start, gen_state0, rec.as_dict(gen_state["run"]), idx, device)
    out = {"attempted": steps * B, "failed": max(0, extra_terms), "readings": readings,
           "memory_peak_bytes": peak, "trace": trace,
           "metrics": {} if traced else {
               k: {"value": v, "unit": "env-steps/s"} for k, v in metrics.items()}}
    if trace is not None:
        trace.info.update(meta, **metrics)
    return out


def _ds(cell) -> int:
    return int({**cell.config["preset_args"], **cell.traffic.get("env_overrides", {})}
               .get("obs_downsample", 1))


def _episode_ends(env, n_steps: int, before: int) -> int:
    """Episode ends among steps ``before .. before + n_steps`` of a fleet
    reset at step 0 (the float32 clock of the env)."""
    import torch

    t = torch.zeros((), dtype=torch.float32)
    length = 0
    while not bool(t >= env.end_time - 1e-9):
        t, length = t + env.step_dt, length + 1
    return (before + n_steps) // length - before // length
