"""Learnable coefficient functions (PyTorch port of
:mod:`pde_opt_tpu.models.functions`): the Legendre expansions, the
periodic CNN and the MLP-Mixer, each a :class:`torch.nn.Module`."""

from .cnn import PeriodicCNN, cnn_from_numpy, conv2d_circular, gelu_tanh
from .legendre import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomialExpansion2D,
    LegendrePolynomials,
    legendre_from_numpy,
    legval,
)
from .mixer import Mixer2d, MixerBlock, mixer_from_numpy

__all__ = [
    "LegendrePolynomialExpansion",
    "LegendrePolynomialExpansion2D",
    "DiffusionLegendrePolynomials",
    "ChemicalPotentialLegendrePolynomials",
    "LegendrePolynomials",
    "legendre_from_numpy",
    "legval",
    "PeriodicCNN",
    "conv2d_circular",
    "gelu_tanh",
    "cnn_from_numpy",
    "Mixer2d",
    "MixerBlock",
    "mixer_from_numpy",
    "function_from_numpy",
]

_LEGENDRE_KINDS = {
    "LegendrePolynomialExpansion": ("expansion", lambda m: m.params),
    "LegendrePolynomialExpansion2D": ("expansion_2d", lambda m: m.params),
    "DiffusionLegendrePolynomials": ("diffusion", lambda m: m.expansion.params),
    "ChemicalPotentialLegendrePolynomials": ("chemical_potential",
                                             lambda m: m.expansion.params),
}


def function_from_numpy(obj, device):
    """The port's counterpart of a JAX coefficient module (recognised by its
    class name: the four Legendre modules, ``PeriodicCNN``, ``Mixer2d``)
    with the same numbers on ``device``; ``None`` for any other object.  A
    chemical potential with a prior, or a CNN whose activation is not
    ``jax.nn.gelu``, cannot be carried and raises ``ValueError``."""
    name = type(obj).__name__
    if name in _LEGENDRE_KINDS:
        if getattr(obj, "prior_fn", None) is not None:
            raise ValueError("a JAX prior_fn cannot be carried into the port")
        kind, params = _LEGENDRE_KINDS[name]
        return legendre_from_numpy(kind, params(obj), device)
    if name == "PeriodicCNN" and hasattr(obj, "weights") and hasattr(obj, "biases"):
        if getattr(obj.act, "__name__", None) != "gelu":
            raise ValueError(f"PeriodicCNN act {obj.act!r}: only jax.nn.gelu is carried")
        return cnn_from_numpy(obj.weights, obj.biases, device)
    if name == "Mixer2d" and hasattr(obj, "w_in"):
        return mixer_from_numpy(obj, device)
    return None
