"""Device ms a step of the operations launched inside ``VectorPDEEnv.step``
but neither in its stepper call nor in its auto-reset.  Layer: env fleet.
Moves ``device_env_steps_per_s``."""

from portbench.drivers.rollout import AUTORESET, ENV_STEP, STEPPER


def read(trace, cell):
    if not trace.steps or not trace.launched_in(ENV_STEP):
        return None
    return trace.device_s_in(ENV_STEP, exclude=(STEPPER, AUTORESET)) * 1e3 / trace.steps
