"""Device operations a step launched inside the port's ``vector_env.step``
span, tied to it by correlation id in the host+device traced window.
Layer: env fleet.  Moves ``device_env_steps_per_s``."""

from portbench.spans import STEP


def read(trace, cell):
    n = trace.launched_in(STEP, trace.info.get("device"))
    if not trace.steps or not n:
        return None
    return n / trace.steps
