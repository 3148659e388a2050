"""Share of the work model's bound that the fleet's stepper call reaches:
the bound (``portbench/workmodel.py``, from the cell's shapes alone) over
the device time a step of every operation launched inside the stepper call,
whatever its name.  Layer: stepper and macro.  Moves ``device_env_steps_per_s``."""

from portbench import workmodel
from portbench.drivers.rollout import STEPPER


def read(trace, cell):
    if not trace.steps or cell.config.get("work_model") != "ch_macro":
        return None
    if not trace.launched_in(STEPPER):
        return None
    ms = trace.device_s_in(STEPPER) * 1e3 / trace.steps
    i = trace.info
    bound, _ = workmodel.ch_macro_bound_ms(i["B"], i["H"], i["W"], i["substeps"], i["ds"])
    return 100.0 * bound / ms
