"""Generic method-of-manufactured-solutions (MMS) builder (PyTorch port of
:mod:`pde_opt_tpu.models.symbolic.mms`).

A :class:`MMS` problem is a Domain, a manufactured solution ``u*`` (a sympy
expression in the coordinate symbols and ``t``) and a symbolic *operator*:
a callable that receives ``u*``, the coordinate symbols and ``t`` and
returns the exact right-hand side F(u*).  The Domain's rank picks the
coordinate symbols, so one engine serves 1D/2D/3D twins.  The expressions
are lambdified to numpy and evaluated on the host on the domain's mesh;
the samples come back as tensors in the domain's dtype on ``device``
(default: the card, ``"cuda"``, as every entry point of the port).
Test-only; needs sympy.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import sympy as sp
import torch

from ...utils.device import resolve_device

__all__ = [
    "MMS",
    "sym_lap",
    "sym_div",
    "sym_grad",
    "allen_cahn_operator",
    "cahn_hilliard_operator",
    "advection_diffusion_operator",
]

_COORD_NAMES = ("x", "y", "z", "w")


# ---------------------------------------------------------------------------
# symbolic differential-operator helpers
# ---------------------------------------------------------------------------

def sym_grad(expr: sp.Expr, syms: Sequence[sp.Symbol]):
    """Symbolic gradient: tuple of ∂expr/∂xᵢ."""
    return tuple(sp.diff(expr, s) for s in syms)


def sym_div(vec: Sequence[sp.Expr], syms: Sequence[sp.Symbol]) -> sp.Expr:
    """Symbolic divergence of a vector field."""
    return sum(sp.diff(v, s) for v, s in zip(vec, syms))


def sym_lap(expr: sp.Expr, syms: Sequence[sp.Symbol]) -> sp.Expr:
    """Symbolic Laplacian: Σᵢ ∂²expr/∂xᵢ²."""
    return sum(sp.diff(expr, s, 2) for s in syms)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _lambdified(argspec, expr):
    """``expr`` simplified and lambdified to numpy, once per expression (a
    grid ladder builds one twin a grid from the same expressions)."""
    return sp.lambdify(argspec, sp.simplify(expr), "numpy")


class MMS:
    """Manufactured-solution problem: exact field and exact RHS on a grid.

    Args:
        domain: a :class:`pde_opt_tpu_torch.grid.Domain`; its rank selects
            the coordinate symbols ``x, y, z, ...`` and its ``mesh()``
            supplies the evaluation points.
        u_star: manufactured solution, a sympy expression in the
            coordinate symbols (named ``x``/``y``/``z``) and ``t``.
        operator: ``operator(u_star, syms, t) -> sympy expr``, the exact
            right-hand side F(u*).
        device: where the sampled tensors go (default: the card).
    """

    def __init__(self, domain, u_star: sp.Expr, operator: Callable, device=None):
        ndim = len(domain.points)
        if ndim > len(_COORD_NAMES):
            raise ValueError(f"unsupported spatial rank {ndim}")
        self.domain = domain
        self.device = resolve_device("cuda" if device is None else device)
        # sp.symbols on a tuple of names returns a tuple (rank 1 included).
        syms = sp.symbols(_COORD_NAMES[:ndim], real=True)
        t = sp.Symbol("t", real=True)
        rhs_expr = operator(u_star, syms, t)
        argspec = (*syms, t)
        self._u = _lambdified(argspec, u_star)
        self._rhs = _lambdified(argspec, rhs_expr)

    def _eval(self, fn, t: float) -> torch.Tensor:
        meshes = self.domain.mesh()
        if not isinstance(meshes, (tuple, list)):
            meshes = (meshes,)
        # A constant expression lambdifies to a scalar: broadcast it.
        out = np.broadcast_to(fn(*meshes, float(t)), meshes[0].shape)
        return torch.from_numpy(np.ascontiguousarray(out)).to(self.device, self.domain.dtype)

    def u_exact(self, t: float) -> torch.Tensor:
        """u*(·, t) sampled on the domain grid."""
        return self._eval(self._u, t)

    def rhs_exact(self, t: float) -> torch.Tensor:
        """F(u*)(·, t) sampled on the domain grid."""
        return self._eval(self._rhs, t)


# ---------------------------------------------------------------------------
# operator factories for the shipped equations
# ---------------------------------------------------------------------------

def allen_cahn_operator(kappa, mu_sym: Callable, R_sym: Callable):
    """Allen-Cahn (nonconserved relaxation): F(u) = −R(u)·(μ(u) − κ∆u)."""

    def op(u, syms, t):
        return -R_sym(u) * (mu_sym(u) - kappa * sym_lap(u, syms))

    return op


def cahn_hilliard_operator(kappa, mu_sym: Callable, D_sym: Callable):
    """Cahn-Hilliard (conserved flux form): F(u) = ∇·(D(u)∇(μ(u) − κ∆u))."""

    def op(u, syms, t):
        chem = mu_sym(u) - kappa * sym_lap(u, syms)
        flux = tuple(D_sym(u) * g for g in sym_grad(chem, syms))
        return sym_div(flux, syms)

    return op


def advection_diffusion_operator(diffusion_coeff, v_sym: Callable):
    """Advection-diffusion: F(u) = −∇·(u·v(t,·)) + D∆u."""

    def op(u, syms, t):
        v = v_sym(t, *syms)
        return (
            -sym_div(tuple(u * vi for vi in v), syms)
            + diffusion_coeff * sym_lap(u, syms)
        )

    return op
