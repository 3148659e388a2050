"""Legendre-polynomial coefficient functions (PyTorch port of
:mod:`pde_opt_tpu.models.functions.legendre`).

``LegendrePolynomialExpansion`` (Σ pₙ·Pₙ(x)), ``LegendrePolynomialExpansion2D``
(Σ p_mn·P_m(x)·P_n(y)), ``DiffusionLegendrePolynomials`` (exp of the
expansion at 2u − 1, positive for a mobility) and
``ChemicalPotentialLegendrePolynomials`` (the expansion at 2u − 1 plus an
optional fixed prior) are :class:`torch.nn.Module`\\ s whose coefficients are
one :class:`torch.nn.Parameter`; ``LegendrePolynomials`` is the
``f(params, x)`` evaluator.  All are elementwise, so they act on a whole
batch of fields at once.

The fused FD rhs kernel (K8, :mod:`pde_opt_tpu_torch.ops.fused`) evaluates
these three modules from their coefficient tensors on the card, in the
same order of operations as :func:`legval`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "legval",
    "LegendrePolynomialExpansion",
    "LegendrePolynomialExpansion2D",
    "DiffusionLegendrePolynomials",
    "ChemicalPotentialLegendrePolynomials",
    "LegendrePolynomials",
    "legendre_from_numpy",
]


def _legendre_basis(v: torch.Tensor, degree: int) -> torch.Tensor:
    """``[P_0(v), ..., P_degree(v)]`` stacked along a new leading axis, by
    Bonnet's recursion ``(n+1)·P_{n+1} = (2n+1)·v·P_n − n·P_{n−1}``."""
    basis = [torch.ones_like(v)]
    if degree >= 1:
        basis.append(v)
    for n in range(1, degree):
        basis.append(((2 * n + 1) * v * basis[n] - n * basis[n - 1]) / (n + 1))
    return torch.stack(basis, dim=0)


def legval(params, x: torch.Tensor, max_degree: int) -> torch.Tensor:
    """Σ_n params[n]·P_n(x) by in-recurrence accumulation.

    Bonnet's recursion ``P_{n+1} = ((2n+1)·x·P_n − n·P_{n−1}) / (n+1)``, each
    term added as it is formed, in the JAX package's order of operations
    (a true division by ``n+1``)."""
    coeffs = torch.as_tensor(params)
    if coeffs.shape[0] < max_degree + 1:
        raise ValueError(
            f"legval needs at least max_degree+1 = {max_degree + 1} "
            f"coefficients, got {coeffs.shape[0]}"
        )
    p_prev = torch.ones_like(x)
    acc = coeffs[0] * p_prev
    if max_degree >= 1:
        p_cur = x
        acc = acc + coeffs[1] * p_cur
        for n in range(1, max_degree):
            p_prev, p_cur = p_cur, ((2 * n + 1) * x * p_cur - n * p_prev) / (n + 1)
            acc = acc + coeffs[n + 1] * p_cur
    return acc


class LegendrePolynomialExpansion(nn.Module):
    """Σ params[n]·P_n(x); inputs assumed in [-1, 1]."""

    def __init__(self, params):
        super().__init__()
        self.params = nn.Parameter(torch.as_tensor(params))
        self.max_degree = self.params.shape[0] - 1

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return legval(self.params, inputs, self.max_degree)


class LegendrePolynomialExpansion2D(nn.Module):
    """Tensor-product expansion Σ_{mn} params[m,n]·P_m(x)·P_n(y); inputs
    assumed in [-1, 1], ``x`` and ``y`` of one shape."""

    def __init__(self, params):
        super().__init__()
        self.params = nn.Parameter(torch.as_tensor(params))
        self.max_degree_x = self.params.shape[0] - 1
        self.max_degree_y = self.params.shape[1] - 1

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        px = _legendre_basis(x, self.max_degree_x)
        py = _legendre_basis(y, self.max_degree_y)
        return torch.einsum("mn,m...,n...->...", self.params, px, py)


class DiffusionLegendrePolynomials(nn.Module):
    """Positive mobility/diffusivity: exp(Legendre(2u−1)) for u ∈ [0,1]."""

    def __init__(self, params):
        super().__init__()
        self.expansion = LegendrePolynomialExpansion(params)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.expansion(2.0 * inputs - 1.0))


class ChemicalPotentialLegendrePolynomials(nn.Module):
    """Chemical potential: Legendre(2u−1) plus an optional fixed prior.

    The prior (e.g. the ideal-solution ``log(u/(1−u))``) carries the known
    physics so the learnable expansion only models the correction.
    """

    def __init__(self, params, prior_fn: Optional[Callable] = None):
        super().__init__()
        self.expansion = LegendrePolynomialExpansion(params)
        self.prior_fn = prior_fn

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        result = self.expansion(2.0 * inputs - 1.0)
        if self.prior_fn is not None:
            result = result + self.prior_fn(inputs)
        return result


@dataclasses.dataclass
class LegendrePolynomials:
    """``f(params, x)`` evaluator for degree ≤ ``max_degree``."""

    max_degree: int

    def __call__(self, params, inputs: torch.Tensor) -> torch.Tensor:
        return legval(params, inputs, self.max_degree)


_KINDS = {
    "expansion": LegendrePolynomialExpansion,
    "expansion_2d": LegendrePolynomialExpansion2D,
    "diffusion": DiffusionLegendrePolynomials,
    "chemical_potential": ChemicalPotentialLegendrePolynomials,
}


def legendre_from_numpy(kind: str, params, device):
    """The port's Legendre module of ``kind`` (``"expansion"``,
    ``"expansion_2d"``, ``"diffusion"`` or ``"chemical_potential"``, without
    a prior) with the coefficients of a JAX module (``module.params``, or
    ``module.expansion.params``, as a numpy array or anything with
    ``__array__``) on ``device``, in their own dtype."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    return _KINDS[kind](torch.as_tensor(np.array(params), device=torch.device(device)))
