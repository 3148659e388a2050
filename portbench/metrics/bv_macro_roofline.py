"""Share of the BV work model's bound that the port's BV macro reaches: the
bound (``portbench/workmodel_bv.py``, from the cell's shapes alone) over
the device time a step of every operation launched inside the port's
``bv_cas.macro`` range (K6 on the card), whatever its name.  Layer:
stepper and macro.  Moves ``device_env_steps_per_s``.

A program without that span (before it was added) leaves the range out of
the trace, and the reader reports nothing."""

from portbench import workmodel_bv

MACRO = "bv_cas.macro"


def read(trace, cell):
    if not trace.steps or cell.config.get("work_model") != "bv_macro":
        return None
    if not trace.launched_in(MACRO):
        return None
    ms = trace.device_s_in(MACRO) * 1e3 / trace.steps
    i = trace.info
    bound, _ = workmodel_bv.bv_macro_bound_ms(i["B"], i["H"], i["W"], i["substeps"])
    return 100.0 * bound / ms
