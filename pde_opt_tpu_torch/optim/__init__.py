"""Optimizers (PyTorch port): L-BFGS and Adam over parameter trees.

Levenberg-Marquardt (``optim/lm.py`` in the JAX package) is not ported yet.
"""

from .minimize import MinimizeResult, minimize_adam, minimize_lbfgs

__all__ = ["minimize_lbfgs", "minimize_adam", "MinimizeResult"]
