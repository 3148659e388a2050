"""Host ms a step inside the port's ``vector_env.step`` spans, in the
device-only traced window (``portbench/spans.py``): the host's time to
enqueue a fleet step, CUPTI's cost a launch included.  Layer: host
dispatch.  Moves ``device_env_steps_per_s``."""

from portbench import spans


def read(trace, cell):
    steps = spans.device_window_steps(trace)
    if not steps:
        return None
    return sum(b - a for a, b in steps) * 1e-3 / len(steps)
