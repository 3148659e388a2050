"""MLP-Mixer for 2D fields (PyTorch port of
:mod:`pde_opt_tpu.models.functions.mixer`).

Patchify with a strided projection, alternate token (patch) mixing and
channel mixing MLPs with LayerNorms, un-patchify with the transposed
projection.  Kernel size equals stride, so both projections are
:func:`torch.einsum` contractions over reshaped patches, as in the JAX
package.  Inputs are ``(..., H, W)`` fields, leading axes batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.device import resolve_device
from .cnn import _uniform

__all__ = ["MixerBlock", "Mixer2d", "mixer_from_numpy"]

_EPS = 1e-5


class _MLP(nn.Module):
    """Two-layer MLP (ReLU hidden) on the last axis; U(±1/√fan_in) init."""

    def __init__(self, in_f: int, out_f: int, width: int, *, generator, device, dtype):
        super().__init__()
        lim1, lim2 = 1.0 / in_f**0.5, 1.0 / width**0.5
        self.w1 = nn.Parameter(_uniform(generator, (width, in_f), lim1, dtype, device))
        self.b1 = nn.Parameter(_uniform(generator, (width,), lim1, dtype, device))
        self.w2 = nn.Parameter(_uniform(generator, (out_f, width), lim2, dtype, device))
        self.b2 = nn.Parameter(_uniform(generator, (out_f,), lim2, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x @ self.w1.T + self.b1) @ self.w2.T + self.b2


class _LayerNorm(nn.Module):
    """LayerNorm over the trailing ``shape`` axes with a learnable affine.

    The variance is the biased one (``correction=0``), as ``jnp.var``'s;
    ε = 1e-5."""

    def __init__(self, shape, *, device, dtype):
        super().__init__()
        self.shape = tuple(shape)
        self.weight = nn.Parameter(torch.ones(self.shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.shape, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(-len(self.shape), 0))
        mean = x.mean(dim=dims, keepdim=True)
        var = torch.var(x, dim=dims, keepdim=True, correction=0)
        return (x - mean) / torch.sqrt(var + _EPS) * self.weight + self.bias


class MixerBlock(nn.Module):
    """One mixer block: token-mixing MLP, then channel-mixing MLP, pre-norm."""

    def __init__(self, num_patches: int, hidden_size: int, mix_patch_size: int,
                 mix_hidden_size: int, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.patch_mixer = _MLP(num_patches, num_patches, mix_patch_size, **kw)
        self.hidden_mixer = _MLP(hidden_size, hidden_size, mix_hidden_size, **kw)
        self.norm1 = _LayerNorm((hidden_size, num_patches), device=device, dtype=dtype)
        self.norm2 = _LayerNorm((num_patches, hidden_size), device=device, dtype=dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        # y: (..., hidden_size, num_patches)
        y = y + self.patch_mixer(self.norm1(y))
        y = y.transpose(-1, -2)                          # (..., patches, hidden)
        y = y + self.hidden_mixer(self.norm2(y))
        return y.transpose(-1, -2)


class Mixer2d(nn.Module):
    """MLP-Mixer mapping a field ``(..., H, W) -> (..., H, W)``.

    ``img_size = (C, H, W)``, ``patch_size``, ``hidden_size``,
    ``mix_patch_size``, ``mix_hidden_size`` and ``num_blocks`` as in the
    JAX package; the weights start from uniform draws of ``generator``.
    """

    def __init__(self, img_size, patch_size: int, hidden_size: int, mix_patch_size: int,
                 mix_hidden_size: int, num_blocks: int, *, generator: torch.Generator,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, w = img_size
        if h % patch_size or w % patch_size:
            raise ValueError(f"patch_size {patch_size} must divide the image {h} x {w}")
        device = resolve_device(device)
        num_patches = (h // patch_size) * (w // patch_size)
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        kw = dict(generator=generator, device=device, dtype=dtype)
        lim_in = 1.0 / (c * patch_size**2) ** 0.5
        lim_out = 1.0 / (hidden_size * patch_size**2) ** 0.5
        proj = (hidden_size, c, patch_size, patch_size)
        self.w_in = nn.Parameter(_uniform(generator, proj, lim_in, dtype, device))
        self.b_in = nn.Parameter(_uniform(generator, (hidden_size,), lim_in, dtype, device))
        self.w_out = nn.Parameter(_uniform(generator, proj, lim_out, dtype, device))
        self.b_out = nn.Parameter(_uniform(generator, (c,), lim_out, dtype, device))
        self.blocks = nn.ModuleList(
            MixerBlock(num_patches, hidden_size, mix_patch_size, mix_hidden_size, **kw)
            for _ in range(num_blocks))
        self.norm = _LayerNorm((hidden_size, num_patches), device=device, dtype=dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        c_img, _, _ = self.img_size
        p = self.patch_size
        squeeze_channel = False
        if c_img == 1 and (y.ndim == 2 or y.shape[-3] != 1):
            y = y[..., None, :, :]
            squeeze_channel = True
        *batch, c, h, w = y.shape
        hp, wp = h // p, w // p
        # Patchify: (..., C, hp, p, wp, p) x (hid, C, p, p) -> (..., hid, hp, wp)
        yp = y.reshape(*batch, c, hp, p, wp, p)
        z = torch.einsum("...ciujv,hcuv->...hij", yp, self.w_in) + self.b_in[..., None, None]
        z = z.reshape(*batch, self.hidden_size, hp * wp)
        for block in self.blocks:
            z = block(z)
        z = self.norm(z).reshape(*batch, self.hidden_size, hp, wp)
        # Un-patchify: (..., hid, hp, wp) x (hid, C, p, p) -> (..., C, H, W)
        out = torch.einsum("...hij,hcuv->...ciujv", z, self.w_out).reshape(
            *batch, c_img, h, w) + self.b_out[..., None, None]
        return out[..., 0, :, :] if squeeze_channel else out


def mixer_from_numpy(src, device) -> Mixer2d:
    """The port's :class:`Mixer2d` with the numbers of a JAX ``Mixer2d``
    (``src``: that module, or any object with its attributes ``img_size``,
    ``patch_size``, ``w_in``, ``b_in``, ``w_out``, ``b_out``, ``blocks[i]
    .{patch_mixer,hidden_mixer}.{w1,b1,w2,b2}``, ``blocks[i].norm{1,2}
    .{weight,bias}`` and ``norm.{weight,bias}``, as numpy arrays or
    anything with ``__array__``) on ``device``, in their own dtype."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    w_in = t(src.w_in)
    blocks = list(src.blocks)
    mix_patch = blocks[0].patch_mixer.w1.shape[0] if blocks else 1
    mix_hidden = blocks[0].hidden_mixer.w1.shape[0] if blocks else 1
    mixer = Mixer2d(tuple(src.img_size), int(src.patch_size), w_in.shape[0], mix_patch,
                    mix_hidden, len(blocks), generator=torch.Generator(), device=device,
                    dtype=w_in.dtype)
    arrays = {"w_in": src.w_in, "b_in": src.b_in, "w_out": src.w_out, "b_out": src.b_out,
              "norm.weight": src.norm.weight, "norm.bias": src.norm.bias}
    for i, blk in enumerate(blocks):
        for part in ("patch_mixer", "hidden_mixer"):
            for leaf in ("w1", "b1", "w2", "b2"):
                arrays[f"blocks.{i}.{part}.{leaf}"] = getattr(getattr(blk, part), leaf)
        for part in ("norm1", "norm2"):
            for leaf in ("weight", "bias"):
                arrays[f"blocks.{i}.{part}.{leaf}"] = getattr(getattr(blk, part), leaf)
    with torch.no_grad():
        for name, param in mixer.named_parameters():
            value = t(arrays[name])
            if value.shape != param.shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(param.shape)}")
            param.copy_(value)
    return mixer
