"""PDEModel — forward solving, parameter estimation and optimal control
(PyTorch port of :mod:`pde_opt_tpu.models.pde_model`).

Rollouts are fixed-step integrations (:func:`pde_opt_tpu_torch.ops.integrate.integrate`),
reverse-differentiable through checkpointed save segments; a whole batch of
initial conditions integrates as one batched rollout.  The optimizers are
``torch.optim`` L-BFGS and Adam (:mod:`pde_opt_tpu_torch.optim.minimize`).
On the fused macro stepper each segment is one launch of the macro kernel
forward and one of its backward kernel K3 in the backward pass.

A parameter that is an :class:`torch.nn.Module` (the Legendre coefficient
modules of ``models/functions``) trains through its parameters, as the JAX
package's pytree modules do (:mod:`pde_opt_tpu_torch.utils.ptree`).

Not ported yet: the adaptive integrator behind ``PIDController`` and
Levenberg-Marquardt (``train(method="least_squares")``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np
import torch

from .. import grid as domains
from ..ops.integrate import ConstantStepSize, integrate
from ..optim.minimize import minimize_adam, minimize_lbfgs
from ..utils import ptree
from ..utils.compat import check_equation_solver_compatibility, prepare_solver_params
from .base import BaseEquation

__all__ = ["PDEModel"]


class PDEModel:
    """Manage solving and optimization of PDEs.

    Args:
        equation_type: equation class (subclass of
            :class:`pde_opt_tpu_torch.models.base.BaseEquation`).
        domain: spatial :class:`pde_opt_tpu_torch.grid.Domain`.
        solver_type: stepper class from :mod:`pde_opt_tpu_torch.ops.steppers`.
            Solver↔equation compatibility is checked at construction.
    """

    def __init__(
        self,
        equation_type: Type[BaseEquation],
        domain: domains.Domain,
        solver_type,
    ):
        self.equation_type = equation_type
        self.domain = domain
        self.solver_type = solver_type
        check_equation_solver_compatibility(solver_type, equation_type)

    def _build(self, parameters: Dict[str, Any], solver_parameters: Dict[str, Any]):
        equation = self.equation_type(domain=self.domain, **parameters)
        full = prepare_solver_params(self.solver_type, solver_parameters, equation)
        return equation, self.solver_type(**full)

    def solve(
        self,
        parameters: Dict[str, Any],
        y0,
        ts,
        solver_parameters: Optional[Dict[str, Any]] = None,
        adjoint: str = "forward",
        dt0: float = 0.000001,
        max_steps: int = 1_000_000,
        stepsize_controller=None,
    ) -> torch.Tensor:
        """Forward-simulate; returns the solution, shape ``(len(ts), *y0.shape)``.

        ``y0`` may carry leading batch axes: the whole batch integrates in
        one rollout.  ``adjoint``: ``"forward"`` or ``"checkpoint"``.
        Fixed steps only (``None`` or :class:`ConstantStepSize`; the
        adaptive :class:`PIDController` is not ported yet).
        """
        if not (stepsize_controller is None
                or isinstance(stepsize_controller, ConstantStepSize)):
            raise ValueError(f"unknown stepsize_controller: {stepsize_controller!r}")
        equation, solver = self._build(parameters, solver_parameters or {})
        ts_np = np.asarray(ts, dtype=np.float64)
        n_total = int(np.sum(np.maximum(1, np.round(np.diff(ts_np) / dt0))))
        if n_total > max_steps:
            raise ValueError(
                f"rollout needs {n_total} steps > max_steps={max_steps}; "
                "raise max_steps or dt0"
            )
        return integrate(solver, equation.rhs, torch.as_tensor(y0), ts_np, dt0,
                         adjoint=adjoint)

    def residual_single(self, parameters, solver_parameters, y0, values, ts,
                        adjoint: str = "forward", dt0: float = 0.000001):
        """Residuals for one trajectory: ``values - pred[1:]`` (``values``
        excludes the initial condition)."""
        pred = self.solve(parameters, y0, ts, solver_parameters, adjoint=adjoint, dt0=dt0)
        return values - pred[1:]

    def regularization(self, parameters, weights, lambda_reg):
        """Weighted L2 penalty: λ·Σᵢ wᵢ pᵢ² over matching tree leaves.

        ``weights`` mirrors ``parameters``; ``None`` weights, and leaves that
        are not inexact arrays or floats, add nothing.  A module weight
        against a module parameter pairs their parameters by name.
        """

        def weighted_square(w, v):
            if ptree.is_inexact_array_like(w) and ptree.is_inexact_array_like(v):
                return torch.sum(torch.as_tensor(w) * torch.as_tensor(v) ** 2)
            return 0.0

        reg = 0.0
        for key in weights.keys():
            for term in ptree.tree_leaves(
                ptree.tree_map(weighted_square, weights[key], parameters[key])
            ):
                reg = reg + lambda_reg * term
        return reg

    def residuals(self, parameters, y0s__values, solver_parameters, ts, weights,
                  lambda_reg, adjoint: str = "forward", dt0: float = 0.000001):
        """Batched residuals ``(B, T-1, ...)`` and the regularization."""
        y0s, values = y0s__values
        pred = self.solve(parameters, y0s, ts, solver_parameters, adjoint=adjoint,
                          dt0=dt0)                                   # (T, B, ...)
        batch_residuals = values - torch.movedim(pred, 0, 1)[:, 1:]
        return batch_residuals, self.regularization(parameters, weights, lambda_reg)

    def mse(self, parameters, y0s__values, solver_parameters, ts, weights,
            lambda_reg, adjoint: str = "checkpoint", dt0: float = 0.000001):
        """Mean squared error + regularization (the ``train(method="mse")`` loss)."""
        batch_residuals, reg = self.residuals(
            parameters, y0s__values, solver_parameters, ts, weights, lambda_reg,
            adjoint=adjoint, dt0=dt0,
        )
        return torch.mean(batch_residuals**2) + reg

    def train(
        self,
        data,
        inds,
        opt_parameters,
        other_parameters,
        solver_parameters,
        weights,
        lambda_reg,
        method: str = "least_squares",
        max_steps: int = 100,
        dt0: float = 0.000001,
        verbose: bool = False,
        learning_rate: float = 1e-2,
    ):
        """Fit ``opt_parameters`` to observed trajectories.

        ``inds[k] = [i0, i1, ...]`` selects ``data["ys"][i0]`` as the k-th
        initial condition and the remaining indices as its observations;
        all trajectories share the time offsets of ``inds[0]``.

        ``method``: ``"mse"`` (L-BFGS) or ``"adam"``, both reverse-mode
        through checkpointed rollouts.  ``"least_squares"`` (the JAX
        package's default) needs Levenberg-Marquardt, not ported yet.
        """
        if method in ("least_squares", "least_squares_jit"):
            raise NotImplementedError(
                f"train(method={method!r}) needs Levenberg-Marquardt "
                "(pde_opt_tpu/optim/lm.py), which is not ported yet; use "
                "method='mse' or 'adam'"
            )
        if method not in ("mse", "adam"):
            raise ValueError(f"unknown train method: {method!r}")
        ys = data["ys"]
        y0s = torch.stack([torch.as_tensor(ys[ind[0]]) for ind in inds])
        values = torch.stack([
            torch.stack([torch.as_tensor(ys[ind[i]]) for i in range(1, len(ind))])
            for ind in inds
        ])
        ts = np.array([
            float(data["ts"][inds[0][i]]) - float(data["ts"][inds[0][0]])
            for i in range(len(inds[0]))
        ])

        opt_params, opt_static = ptree.partition(opt_parameters)
        opt_params = ptree.as_arrays(opt_params)

        def loss_fn(_opt_params, y0s_, values_):
            full = ptree.combine(_opt_params, opt_static)
            return self.mse(
                {**full, **other_parameters}, (y0s_, values_), solver_parameters,
                ts, weights, lambda_reg, adjoint="checkpoint", dt0=dt0,
            )

        if method == "mse":
            sol = minimize_lbfgs(loss_fn, opt_params, args=(y0s, values),
                                 max_steps=max_steps, rtol=1e-8, atol=1e-8,
                                 verbose=verbose)
        else:
            sol = minimize_adam(loss_fn, opt_params, args=(y0s, values),
                                max_steps=max_steps, learning_rate=learning_rate,
                                verbose=verbose)
        return {**ptree.combine(sol.params, opt_static), **other_parameters}

    def optimize(
        self,
        objective_function: Callable,
        y0,
        ts,
        opt_parameters,
        other_parameters,
        solver_parameters,
        weights,
        lambda_reg,
        max_steps: int = 100,
        dt0: float = 0.000001,
        method: str = "lbfgs",
        verbose: bool = False,
        learning_rate: float = 1e-2,
    ):
        """Minimize a scalar function of the solution over parameters
        (reverse mode through a checkpointed rollout)."""
        ts = np.asarray(ts, dtype=np.float64)
        opt_params, opt_static = ptree.partition(opt_parameters)
        opt_params = ptree.as_arrays(opt_params)

        def objective(_opt_params, y0_):
            full = ptree.combine(_opt_params, opt_static)
            all_params = {**full, **other_parameters}
            solution = self.solve(all_params, y0_, ts, solver_parameters,
                                  adjoint="checkpoint", dt0=dt0)
            return objective_function(solution) + self.regularization(
                all_params, weights, lambda_reg)

        if method == "lbfgs":
            sol = minimize_lbfgs(objective, opt_params, args=(y0,),
                                 max_steps=max_steps, rtol=1e-8, atol=1e-8,
                                 verbose=verbose)
        elif method == "adam":
            sol = minimize_adam(objective, opt_params, args=(y0,),
                                max_steps=max_steps, learning_rate=learning_rate,
                                verbose=verbose)
        else:
            raise ValueError(f"unknown optimize method: {method!r}")
        return {**ptree.combine(sol.params, opt_static), **other_parameters}
