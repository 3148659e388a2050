"""Optimizers (PyTorch port): L-BFGS and Adam over parameter trees,
Levenberg-Marquardt over a flat parameter vector."""

from .lm import LMResult, least_squares_lm, least_squares_lm_jitted
from .minimize import MinimizeResult, minimize_adam, minimize_lbfgs

__all__ = ["minimize_lbfgs", "minimize_adam", "MinimizeResult", "least_squares_lm",
           "least_squares_lm_jitted", "LMResult"]
