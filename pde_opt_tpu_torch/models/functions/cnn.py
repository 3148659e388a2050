"""Periodic (torus) convolutional networks for learnable PDE coefficients
(PyTorch port of :mod:`pde_opt_tpu.models.functions.cnn`).

Stride-1 circularly padded convolutions, hence equivariant to translations
of the periodic domain: the inductive bias for a chemical-potential field
μ(u).  Circular padding is :func:`torch.nn.functional.pad` (``"circular"``)
followed by a VALID :func:`torch.nn.functional.conv2d`, where the JAX
package pads with ``mode="wrap"`` and calls ``lax.conv_general_dilated``.
Any leading axes are batch: one convolution call serves them all.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.device import resolve_device

__all__ = ["PeriodicCNN", "conv2d_circular", "gelu_tanh", "cnn_from_numpy"]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh approximation, the default of ``jax.nn.gelu``
    (torch's own default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def conv2d_circular(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """2D convolution with periodic padding.

    Args:
        x: ``(..., C_in, H, W)`` input.
        w: ``(C_out, C_in, kh, kw)`` kernel (odd kh, kw).
        b: optional ``(C_out,)`` bias.
    Returns:
        ``(..., C_out, H, W)``.
    """
    *batch, c, h, wd = x.shape
    ph, pw = w.shape[-2] // 2, w.shape[-1] // 2
    xb = F.pad(x.reshape(-1, c, h, wd), (pw, pw, ph, ph), mode="circular")
    return F.conv2d(xb, w, b).reshape(*batch, w.shape[0], h, wd)


def _uniform(generator: torch.Generator, shape, lim: float, dtype, device):
    """U(−lim, lim), drawn on the generator's device, then moved: one seed
    gives the same numbers on every device."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)
    return ((2.0 * u - 1.0) * lim).to(device)


class PeriodicCNN(nn.Module):
    """Stack of circular conv blocks; the final conv is linear.

    With ``in_channels == 1`` (the μ(u)-field use) the call is
    field-in/field-out: ``(..., H, W) -> (..., H, W)``, leading axes batch.
    With ``in_channels > 1`` inputs are ``(..., C, H, W)``.  Weights and
    biases start from U(±1/√(in·k²)) drawn from ``generator``; ``act``
    defaults to :func:`gelu_tanh`, as ``jax.nn.gelu`` does.
    """

    def __init__(self, in_channels: int, hidden_channels: Sequence[int] = (32, 64, 64),
                 out_channels: Optional[int] = None, kernel_size: int = 3,
                 act: Callable = gelu_tanh, *, generator: torch.Generator,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("PeriodicCNN needs an odd kernel_size")
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = in_channels if out_channels is None else out_channels
        self.kernel_size = kernel_size
        self.act = act
        weights, biases = [], []
        widths = [in_channels, *hidden_channels, self.out_channels]
        for c_in, c_out in zip(widths[:-1], widths[1:]):
            lim = 1.0 / (c_in * kernel_size * kernel_size) ** 0.5
            weights.append(_uniform(generator, (c_out, c_in, kernel_size, kernel_size), lim,
                                    dtype, device))
            biases.append(_uniform(generator, (c_out,), lim, dtype, device))
        self.weights = nn.ParameterList(weights)
        self.biases = nn.ParameterList(biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze_channel = False
        if self.in_channels == 1 and (x.ndim == 2 or x.shape[-3] != 1):
            # Field-style input (..., H, W): add the channel axis.
            x = x[..., None, :, :]
            squeeze_channel = self.out_channels == 1
        layers = list(zip(self.weights, self.biases))
        for w, b in layers[:-1]:
            x = self.act(conv2d_circular(x, w, b))
        x = conv2d_circular(x, *layers[-1])
        return x[..., 0, :, :] if squeeze_channel else x


def cnn_from_numpy(weights, biases, device, act: Callable = gelu_tanh) -> PeriodicCNN:
    """The port's :class:`PeriodicCNN` with a JAX ``PeriodicCNN``'s
    ``weights`` and ``biases`` tuples (numpy arrays or anything with
    ``__array__``) on ``device``, in their own dtype; the widths and kernel
    size are read from the shapes."""
    ws = [np.array(w) for w in weights]
    cnn = PeriodicCNN(ws[0].shape[1], tuple(w.shape[0] for w in ws[:-1]), ws[-1].shape[0],
                      ws[0].shape[-1], act, generator=torch.Generator(), device=device,
                      dtype=torch.from_numpy(ws[0]).dtype)
    with torch.no_grad():
        for param, a in zip([*cnn.weights, *cnn.biases], [*ws, *(np.array(b) for b in biases)]):
            param.copy_(torch.from_numpy(a))
    return cnn
