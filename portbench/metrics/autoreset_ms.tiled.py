"""``autoreset_ms.rollout`` for the cells that report
``env_steps_per_s.tiled``: device ms a step launched inside
``VectorPDEEnv._auto_reset``.  Layer: env fleet.  Moves
``env_steps_per_s.tiled``."""

from portbench import core

read = core.metric_reader("autoreset_ms.rollout").read
