"""``macro_roofline`` for the cells that report ``env_steps_per_s.tiled``:
the work model's bound over the device time a step of everything launched
inside the stepper call (at 128^2 the tiled K1).  Layer: stepper and macro.
Moves ``env_steps_per_s.tiled``."""

from portbench import core

read = core.metric_reader("macro_roofline").read
