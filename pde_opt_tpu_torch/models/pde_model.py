"""PDEModel — forward solving, parameter estimation and optimal control
(PyTorch port of :mod:`pde_opt_tpu.models.pde_model`).

Rollouts are fixed-step integrations (:func:`pde_opt_tpu_torch.ops.integrate.integrate`),
forward-differentiable for Levenberg-Marquardt and reverse-differentiable
through checkpointed save segments, or adaptive ones
(:func:`~pde_opt_tpu_torch.ops.integrate.integrate_adaptive`, under a
``PIDController``); a whole batch of initial conditions integrates as one
batched rollout.  The optimizers are Levenberg-Marquardt
(:mod:`pde_opt_tpu_torch.optim.lm`, Jacobians by :func:`torch.func.jacfwd`)
and ``torch.optim`` L-BFGS and Adam (:mod:`pde_opt_tpu_torch.optim.minimize`).
On the fused macro stepper each segment is one launch of the macro kernel
forward and one of its backward kernel K3 in the backward pass; the macros
have no forward-mode rule, so Levenberg-Marquardt runs the roll-chain and
FFT steppers, as in the JAX package.

A parameter that is an :class:`torch.nn.Module` (the coefficient modules
of ``models/functions``) trains through its parameters, as the JAX
package's pytree modules do (:mod:`pde_opt_tpu_torch.utils.ptree`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np
import torch

from .. import grid as domains
from ..ops.integrate import ConstantStepSize, PIDController, integrate, integrate_adaptive
from ..optim.lm import least_squares_lm, least_squares_lm_jitted
from ..optim.minimize import minimize_adam, minimize_lbfgs
from ..utils import ptree
from ..utils.compat import check_equation_solver_compatibility, prepare_solver_params
from .base import BaseEquation

__all__ = ["PDEModel", "OptimizationModel"]


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
        ``stepsize_controller``: ``None``/:class:`ConstantStepSize` for fixed
        steps, or a :class:`PIDController` for the adaptive integrator
        (single-instance solves; it syncs once a step).
        """
        equation, solver = self._build(parameters, solver_parameters or {})
        if isinstance(stepsize_controller, PIDController):
            return integrate_adaptive(solver, equation.rhs, torch.as_tensor(y0), ts, dt0,
                                      rtol=stepsize_controller.rtol,
                                      atol=stepsize_controller.atol, max_steps=max_steps)
        if not (stepsize_controller is None
                or isinstance(stepsize_controller, ConstantStepSize)):
            raise ValueError(f"unknown stepsize_controller: {stepsize_controller!r}")
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

        ``method``: ``"least_squares"`` (Levenberg-Marquardt over the flat
        parameter vector, forward mode through ``adjoint="forward"``
        rollouts: small parameter vectors), ``"least_squares_jit"``, ``"mse"``
        (L-BFGS) or ``"adam"`` (both reverse mode through checkpointed
        rollouts).  As in the JAX package, ``"least_squares"`` runs the
        jitted variant unless ``verbose=True`` and ``"least_squares_jit"``
        always does; in the port both variants run the same host loop, the
        first printing each iteration.
        """
        if method not in ("least_squares", "least_squares_jit", "mse", "adam"):
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

        if method in ("least_squares", "least_squares_jit"):
            flat0, unravel = ptree.ravel_params(opt_parameters)

            def residuals_flat(theta, y0s_, values_):
                return self.residuals(
                    {**unravel(theta), **other_parameters}, (y0s_, values_),
                    solver_parameters, ts, weights, lambda_reg, adjoint="forward", dt0=dt0,
                )

            lm_kw = dict(args=(y0s, values), max_steps=max_steps, rtol=1e-8, atol=1e-8)
            if method == "least_squares_jit" or not verbose:
                sol = least_squares_lm_jitted(residuals_flat, flat0.to(values.device), **lm_kw)
            else:
                sol = least_squares_lm(residuals_flat, flat0.to(values.device),
                                       verbose=verbose, **lm_kw)
            return {**unravel(sol.params), **other_parameters}

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


# The JAX package's legacy name for PDEModel.
OptimizationModel = PDEModel
