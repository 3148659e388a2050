"""Spatial order-of-accuracy harness for the MMS tests (PyTorch port of
:mod:`pde_opt_tpu.utils.testing`).

Measures how fast a numeric equation's RHS converges to the symbolically
exact RHS (:mod:`pde_opt_tpu_torch.models.symbolic`) as the grid refines: a
grid-ladder sweep returning a :class:`ConvergenceResult` whose ``order()``
is the fitted log-log slope.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..grid import Domain
from .device import resolve_device

__all__ = [
    "l2_rel_err",
    "ConvergenceResult",
    "check_convergence",
    "fit_order",
    "plot_convergence",
]


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def l2_rel_err(numeric, exact) -> float:
    """Relative L2 error ‖numeric − exact‖₂ / ‖exact‖₂ (tensors or arrays),
    in float64 on the host."""
    numeric, exact = _f64(numeric), _f64(exact)
    return float(np.linalg.norm(numeric - exact) / np.linalg.norm(exact))


class ConvergenceResult(NamedTuple):
    """Grid-ladder sweep outcome.  Unpacks as ``(dxs, errors)``."""

    dxs: tuple
    errors: tuple

    def order(self) -> float:
        """Fitted log-log slope (the observed order of accuracy)."""
        return fit_order(self.dxs, self.errors)


def fit_order(dxs, errors) -> float:
    """Least-squares slope of log(error) against log(dx)."""
    logx = np.log(np.asarray(dxs, np.float64))
    logy = np.log(np.asarray(errors, np.float64))
    return float(np.polyfit(logx, logy, 1)[0])


def _square_domain(N: int, L: float, ndim: int, dtype) -> Domain:
    box = tuple((-L / 2, L / 2) for _ in range(ndim))
    kwargs = {"dtype": dtype} if dtype is not None else {}
    return Domain((N,) * ndim, box, "dimensionless", **kwargs)


def check_convergence(
    numeric,
    symbolic,
    numeric_args: dict,
    symbolic_args: dict,
    Ns: Sequence[int],
    L: float,
    dtype=None,
    ndim: int = 2,
    t: float = 0.0,
    device=None,
) -> ConvergenceResult:
    """Sweep the grid ladder ``Ns`` on a centered [−L/2, L/2]^ndim box.

    For each N: build the numeric equation and its symbolic twin on the
    same Domain and ``device`` (default: the card; either's own
    ``"device"`` argument wins), evaluate the numeric RHS *at the exact
    manufactured solution*, and record its relative L2 error against the
    exact RHS.  Returns a :class:`ConvergenceResult`: assert on
    ``.order()``.
    """
    device = resolve_device("cuda" if device is None else device)
    dxs, errors = [], []
    for N in Ns:
        domain = _square_domain(int(N), float(L), ndim, dtype)
        num_eq = numeric(**{"device": device, **numeric_args, "domain": domain})
        sym_eq = symbolic(**{"device": device, **symbolic_args, "domain": domain})
        u_star = sym_eq.u_exact(t)
        err = l2_rel_err(num_eq.rhs(u_star, t), sym_eq.rhs_exact(t))
        dxs.append(float(domain.dx[0]))
        errors.append(err)
    return ConvergenceResult(tuple(dxs), tuple(errors))


def plot_convergence(dx, err, orders=(1.0, 2.0, 4.0)):
    """Log-log error-vs-spacing plot with slope guide lines (host-side;
    imports matplotlib when called).

    Guides pass through the geometric center of the measured data so they
    bracket it visually regardless of absolute error level.
    """
    import matplotlib.pyplot as plt

    dx = np.asarray(dx, np.float64)
    err = np.asarray(err, np.float64)
    order = np.argsort(dx)
    dx, err = dx[order], err[order]

    fig, ax = plt.subplots()
    ax.loglog(dx, err, marker="o", label="measured")
    # Anchor guide lines at the data's log-space centroid.
    cx = np.exp(np.mean(np.log(dx)))
    cy = np.exp(np.mean(np.log(err)))
    for q in orders:
        ax.loglog(dx, cy * (dx / cx) ** q, linestyle="--", alpha=0.6,
                  label=rf"$\propto \Delta x^{{{q:g}}}$")
    ax.set_xlabel(r"grid spacing $\Delta x$")
    ax.set_ylabel("relative $L_2$ error")
    ax.set_title(f"observed order ≈ {fit_order(dx, err):.2f}")
    ax.legend()
    fig.tight_layout()
    return fig, ax
