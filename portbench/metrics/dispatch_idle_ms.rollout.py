"""Device-idle ms a step inside the port's ``vector_env.step`` spans: the
gaps between the device operations of the device-only traced window (the
complement of their union in the window) that fall inside the window's step
spans, placed on the trace's clock (``portbench/spans.py``), over the
window's steps.  The part of the idle share that the env's own dispatch
leaves; the rest falls in the policy, the loop and the collector's sync.
Layer: host dispatch.  Moves ``device_env_steps_per_s``."""

from portbench import spans


def read(trace, cell):
    steps = spans.device_window_steps(trace)
    if not steps:
        return None
    dev = trace.device
    busy = dev.busy_intervals(trace.info.get("device"))
    return spans.idle_us_inside(busy, dev.window_us, steps) * 1e-3 / len(steps)
