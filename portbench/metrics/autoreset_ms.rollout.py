"""Device ms a step of the operations launched inside
``VectorPDEEnv._auto_reset``.  Layer: env fleet.  Moves ``device_env_steps_per_s``."""

from portbench.drivers.rollout import AUTORESET


def read(trace, cell):
    if not trace.steps or not trace.launched_in(AUTORESET):
        return None
    return trace.device_s_in(AUTORESET) * 1e3 / trace.steps
