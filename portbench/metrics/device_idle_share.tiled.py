"""``device_idle_share.rollout`` for the cells that report
``env_steps_per_s.tiled``: share of the device-only traced window in which
no device operation runs.  Layer: device.  Moves ``env_steps_per_s.tiled``."""

from portbench import core

read = core.metric_reader("device_idle_share.rollout").read
