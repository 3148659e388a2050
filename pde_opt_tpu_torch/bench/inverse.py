"""The JAX package's two training examples as workloads of the port's
inverse-problem layer: ``examples/optimize_3d.py`` (Legendre μ and D at
32³, fitted by Levenberg-Marquardt) and ``examples/optimize_nn.py`` (a
``PeriodicCNN`` μ fitted by L-BFGS; ``--grid 128`` is the reference's
128² NN-μ workload).  Both observe a Cahn-Hilliard trajectory (κ 0.002,
``SemiImplicitFourierSpectral`` with A 0.5 on the FD rhs, dt0 2.5e-4, saves
at ``linspace(0, 0.004, 9)``) through the windows ``[[0, 2, 4], [4, 6, 8]]``,
from a field ``clip(0.5 + 0.01 N(0, 1), 0, 1)`` drawn by numpy from seed 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import jacfwd

from ..grid import Domain
from ..models.cahn_hilliard import CahnHilliard2DPeriodic, CahnHilliard3DPeriodic
from ..models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    PeriodicCNN,
)
from ..models.pde_model import PDEModel
from ..ops.steppers import SemiImplicitFourierSpectral
from ..utils import ptree

__all__ = ["FitProblem", "legendre_fit_3d", "nn_mu_fit_2d", "flory_huggins_mu",
           "LEGENDRE_MU", "LEGENDRE_D"]

KAPPA, A, DT0 = 0.002, 0.5, 2.5e-4
TS = np.linspace(0.0, 0.004, 9)
INDS = [[0, 2, 4], [4, 6, 8]]
LEGENDRE_MU, LEGENDRE_D = (0.0, 1.0, 0.5), (0.3, 0.2)


def flory_huggins_mu(c: torch.Tensor) -> torch.Tensor:
    """``examples/optimize_nn.py``'s true μ: log(c/(1−c)) + 3(1 − 2c), c
    clipped to [1e-3, 1 − 1e-3] inside the log."""
    cc = c.clamp(1e-3, 1.0 - 1e-3)
    return torch.log(cc / (1.0 - cc)) + 3.0 * (1.0 - 2.0 * c)


@dataclasses.dataclass
class FitProblem:
    """A fit of ``start()``'s parameters to the trajectory ``ys``.

    ``other`` holds the fixed parameters (the device among them); ``train``
    runs :meth:`PDEModel.train` as a user would call it; ``residuals`` and
    ``jacobian`` are the pieces its Levenberg-Marquardt evaluates."""

    model: PDEModel
    ys: List[torch.Tensor]
    start: Callable[[], Dict[str, Any]]
    other: Dict[str, Any]
    truth: Dict[str, Any]

    @property
    def ts_rel(self) -> np.ndarray:
        return TS[INDS[0]] - TS[INDS[0][0]]

    def windows(self):
        """The initial conditions and observations ``train`` slices."""
        y0s = torch.stack([self.ys[i[0]] for i in INDS])
        vals = torch.stack([torch.stack([self.ys[j] for j in i[1:]]) for i in INDS])
        return y0s, vals

    def residuals(self, params, adjoint: str = "forward"):
        weights = {k: None for k in params}
        return self.model.residuals({**params, **self.other}, self.windows(), {"A": A},
                                    self.ts_rel, weights, 0.0, adjoint=adjoint, dt0=DT0)

    def jacobian(self) -> torch.Tensor:
        """The Jacobian of the flat residual at ``start()``, as the LM of
        ``train(method="least_squares")`` builds it (``reg`` is 0 here)."""
        flat0, unravel = ptree.ravel_params(self.start())
        return jacfwd(lambda th: self.residuals(unravel(th))[0].reshape(-1))(flat0)

    def train(self, method: str, max_steps: int, verbose: bool = False):
        params = self.start()
        return self.model.train({"ys": self.ys, "ts": list(TS)}, INDS, opt_parameters=params,
                                other_parameters=self.other, solver_parameters={"A": A},
                                weights={k: None for k in params}, lambda_reg=0.0,
                                method=method, max_steps=max_steps, dt0=DT0, verbose=verbose)


def _box(n: int, dim: int):
    return ((-0.005 * n, 0.005 * n),) * dim


def _trajectory(model, params, n, dim, device, dtype):
    y0 = np.clip(0.01 * np.random.default_rng(0).standard_normal((n,) * dim) + 0.5, 0.0, 1.0)
    with torch.no_grad():
        sol = model.solve(params, torch.tensor(y0, dtype=dtype, device=device), TS, {"A": A},
                          dt0=DT0)
    return list(sol)


def legendre_fit_3d(device, dtype: torch.dtype = torch.float32, grid: int = 32,
                    ys: Optional[List[torch.Tensor]] = None) -> FitProblem:
    """``examples/optimize_3d.py``: Legendre μ (truth ``LEGENDRE_MU``) and D
    (``LEGENDRE_D``) fitted from zeros; the trajectory is made on ``device``
    unless ``ys`` is given (then moved there, in ``dtype``)."""
    device = torch.device(device)
    model = PDEModel(CahnHilliard3DPeriodic, Domain((grid,) * 3, _box(grid, 3), dtype=dtype),
                     SemiImplicitFourierSpectral)
    other = {"kappa": KAPPA, "derivs": "fd", "device": device}

    def legendre(mu, d):
        return {"mu": ChemicalPotentialLegendrePolynomials(
                    torch.tensor(mu, dtype=dtype, device=device)),
                "D": DiffusionLegendrePolynomials(torch.tensor(d, dtype=dtype, device=device))}

    truth = legendre(LEGENDRE_MU, LEGENDRE_D)
    if ys is None:
        ys = _trajectory(model, {**truth, **other}, grid, 3, device, dtype)
    return FitProblem(model, [y.to(device, dtype) for y in ys],
                      lambda: legendre((0.0,) * 3, (0.0,) * 2), other, truth)


def nn_mu_fit_2d(device, dtype: torch.dtype = torch.float32, grid: int = 128,
                 hidden=(16, 16), seed: int = 1, ys: Optional[List[torch.Tensor]] = None,
                 cnn: Optional[PeriodicCNN] = None) -> FitProblem:
    """``examples/optimize_nn.py --grid {grid}``: a ``PeriodicCNN(1, hidden,
    1, 3)`` μ, its weights drawn from ``seed`` (or the module ``cnn``, on
    ``device`` in ``dtype``), fitted to the trajectory of
    :func:`flory_huggins_mu`."""
    device = torch.device(device)
    model = PDEModel(CahnHilliard2DPeriodic, Domain((grid, grid), _box(grid, 2), dtype=dtype),
                     SemiImplicitFourierSpectral)
    other = {"kappa": KAPPA, "D": torch.ones_like, "derivs": "fd", "device": device}
    if ys is None:
        ys = _trajectory(model, {"mu": flory_huggins_mu, **other}, grid, 2, device, dtype)
    if cnn is None:
        cnn = PeriodicCNN(1, hidden, 1, 3, generator=torch.Generator().manual_seed(seed),
                          device=device, dtype=dtype)
    return FitProblem(model, [y.to(device, dtype) for y in ys], lambda: {"mu": cnn}, other,
                      {"mu": flory_huggins_mu})
