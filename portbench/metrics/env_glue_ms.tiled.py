"""``env_glue_ms.rollout`` for the cells that report
``env_steps_per_s.tiled``: device ms a step inside ``VectorPDEEnv.step``
but neither in its stepper call nor in its auto-reset.  Layer: env fleet.
Moves ``env_steps_per_s.tiled``."""

from portbench import core

read = core.metric_reader("env_glue_ms.rollout").read
