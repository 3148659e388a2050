"""Env-steps a second on the host's clock: every env-step of the untraced
window that a ``--trace 1`` run runs first, over its seconds.  The cells
whose step the host paces report their rate so, per layer, beside the
end-to-end rate over the device's busy time.  Layer: host dispatch.  Moves
``device_env_steps_per_s``."""


def read(trace, cell):
    return trace.info.get("env_steps_per_s")
