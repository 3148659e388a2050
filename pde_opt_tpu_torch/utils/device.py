"""Where the port's entry points put their tensors.

Every entry point (the presets, ``VectorPDEEnv``, ``env_state_from_numpy``
and the initializers) takes ``device="cuda"`` unless the caller names
another device.  A CUDA device on a machine without one is an error, never
a quiet move to the CPU: pass ``device="cpu"`` to run there.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` if it
    is a CUDA device and CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return device
