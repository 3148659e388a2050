"""Share of the device-only traced window (``portbench/trace.py``) in
which no device operation runs (busy time is the union of the operations'
intervals).  Layer: device.  Moves
``device_env_steps_per_s``."""


def read(trace, cell):
    rank0, trace = trace.info.get("device"), trace.device
    if not trace.steps or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s(rank0) / trace.window_s)
