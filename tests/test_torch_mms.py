"""Order-of-accuracy (MMS) tests on the port: tests/test_rhs_convergence.py
and tests/test_mms_fuzz.py with the port's equations, symbolic twins and
``check_convergence``, at the JAX tests' assertions (the CH fuzz marked
slow, as in JAX), all in f64 on the CPU; and the port's MMS samples against
JAX's on the same domain (1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch

from pde_opt_tpu import grid as jgrid
from pde_opt_tpu.models import symbolic as jsym
from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.models import (
    AdvectionDiffusion2D,
    AllenCahn2DPeriodic,
    CahnHilliard2DPeriodic,
    CahnHilliard3DPeriodic,
)
from pde_opt_tpu_torch.models import symbolic as tsym
from pde_opt_tpu_torch.models.symbolic import (
    SymbolicAdvectionDiffusion2D,
    SymbolicAllenCahn2DPeriodic,
    SymbolicCahnHilliard2DPeriodic,
)
from pde_opt_tpu_torch.utils.testing import (
    ConvergenceResult,
    check_convergence,
    fit_order,
    l2_rel_err,
)

torch.set_num_threads(1)

X, Y, T = sp.symbols("x y t", real=True)
U_STAR = sp.sin(2 * X) * sp.cos(3 * Y) * sp.exp(-0.7 * T)
NS = [32, 64, 128, 256, 512]
L = 2 * np.pi
CPU = {"device": "cpu"}


def test_rhs_convergence_allen_cahn():
    mu_sym = lambda u: u**3 - u
    R_sym = lambda u: 1 + u**2
    dx, errors = check_convergence(
        AllenCahn2DPeriodic,
        SymbolicAllenCahn2DPeriodic,
        {"kappa": 1e-2, "mu": mu_sym, "R": R_sym, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_sym, "R_sym": R_sym, "u_star": U_STAR},
        NS, L, dtype=torch.float64, **CPU,
    )
    np.testing.assert_allclose(fit_order(dx, errors), 2.0, rtol=0.1)


def test_rhs_convergence_cahn_hilliard():
    mu_sym = lambda u: u**3 - u
    D_sym = lambda u: 1 + u**2
    dx, errors = check_convergence(
        CahnHilliard2DPeriodic,
        SymbolicCahnHilliard2DPeriodic,
        {"kappa": 1e-2, "mu": mu_sym, "D": D_sym, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_sym, "D_sym": D_sym, "u_star": U_STAR},
        NS, L, dtype=torch.float64, **CPU,
    )
    np.testing.assert_allclose(fit_order(dx, errors), 2.0, rtol=0.1)


def test_rhs_convergence_advection_diffusion():
    def v_torch(t, Xm, Ym):
        return (torch.sin(Xm) * torch.cos(Ym), -torch.cos(Xm) * torch.sin(Ym))

    def v_sym(t, x, y):
        return (sp.sin(x) * sp.cos(y), -sp.cos(x) * sp.sin(y))

    dx, errors = check_convergence(
        AdvectionDiffusion2D,
        SymbolicAdvectionDiffusion2D,
        {"velocity": v_torch, "diffusion_coeff": 0.1, "derivs": "fd"},
        {"diffusion_coeff": 0.1, "v_sym": v_sym, "u_star": U_STAR},
        NS, L, dtype=torch.float64, **CPU,
    )
    np.testing.assert_allclose(fit_order(dx, errors), 2.0, rtol=0.1)


def test_rhs_spectral_cahn_hilliard_superconvergent():
    """The pseudo-spectral RHS should beat 4th order on smooth data."""
    mu_sym = lambda u: u**3 - u
    D_sym = lambda u: 1 + u**2
    dx, errors = check_convergence(
        CahnHilliard2DPeriodic,
        SymbolicCahnHilliard2DPeriodic,
        {"kappa": 1e-2, "mu": mu_sym, "D": D_sym, "derivs": "fourier"},
        {"kappa": 1e-2, "mu_sym": mu_sym, "D_sym": D_sym, "u_star": U_STAR},
        [16, 32, 64], L, dtype=torch.float64, **CPU,
    )
    # Nonlinear terms alias at N=16 but errors must crash toward roundoff.
    assert errors[-1] < 1e-8


# ---- tests/test_mms_fuzz.py --------------------------------------------------

U_FUZZ = sp.sin(2 * X) * sp.cos(3 * Y) * sp.exp(-sp.Rational(1, 2) * T)
NS_FUZZ = [64, 128]


def _poly(coeffs):
    """Coefficient function usable on tensors AND sympy expressions."""
    def f(u):
        out = coeffs[0]
        for c in coeffs[1:]:
            out = out * u + c
        return out + 0 * u   # keep sympy type; no-op for tensors
    return f


def _ratio(res):
    return res.errors[0] / res.errors[1]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cahn_hilliard_mms_random_coeffs(seed):
    rng = np.random.default_rng(seed)
    mu_c = rng.uniform(-1.0, 1.0, size=3)
    # D must stay positive on the manufactured solution's range [-1, 1].
    D_c = np.array([rng.uniform(0.1, 0.5), 0.0, rng.uniform(0.5, 1.5)])
    mu_f, D_f = _poly(mu_c), _poly(D_c)
    res = check_convergence(
        CahnHilliard2DPeriodic,
        SymbolicCahnHilliard2DPeriodic,
        {"kappa": 1e-2, "mu": mu_f, "D": D_f, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_f, "D_sym": D_f, "u_star": U_FUZZ},
        NS_FUZZ, L, dtype=torch.float64, **CPU,
    )
    assert 3.0 < _ratio(res) < 5.0, res


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_allen_cahn_mms_random_coeffs(seed):
    rng = np.random.default_rng(seed)
    mu_c = rng.uniform(-1.0, 1.0, size=4)
    R_c = np.array([rng.uniform(0.1, 0.5), 0.0, rng.uniform(0.5, 1.5)])
    mu_f, R_f = _poly(mu_c), _poly(R_c)
    res = check_convergence(
        AllenCahn2DPeriodic,
        SymbolicAllenCahn2DPeriodic,
        {"kappa": 1e-2, "mu": mu_f, "R": R_f, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_f, "R_sym": R_f, "u_star": U_FUZZ},
        NS_FUZZ, L, dtype=torch.float64, **CPU,
    )
    assert 3.0 < _ratio(res) < 5.0, res


# ---- the engine against JAX's --------------------------------------------------

def _twins(ndim):
    """The CH operator for each package's MMS on the same box (f64); in 3D
    with a linear mu and unit mobility (sympy simplifies the cubic's 3D
    flux for about a minute)."""
    box = ((-1.0, 2.0),) * ndim
    pts = (12, 10, 8)[:ndim]
    mu = (lambda u: u**3 - u) if ndim == 2 else (lambda u: 2 * u)
    D = (lambda u: 1 + u**2) if ndim == 2 else (lambda u: 1)
    syms = sp.symbols("x y z"[: 2 * ndim - 1].split(), real=True)
    u_star = sp.exp(-T) * sp.Mul(*(sp.sin((k + 1) * s) for k, s in enumerate(syms)))
    t_mms = tsym.MMS(tgrid.Domain(pts, box, dtype=torch.float64), u_star,
                     tsym.cahn_hilliard_operator(0.02, mu, D), device="cpu")
    j_mms = jsym.MMS(jgrid.Domain(pts, box, dtype=jnp.float64), u_star,
                     jsym.cahn_hilliard_operator(0.02, mu, D))
    return t_mms, j_mms


@pytest.mark.parametrize("ndim", [2, 3])
def test_mms_samples_match_jax(ndim):
    t_mms, j_mms = _twins(ndim)
    for t in (0.0, 0.3):
        for name in ("u_exact", "rhs_exact"):
            got, want = getattr(t_mms, name)(t), np.asarray(getattr(j_mms, name)(t))
            assert got.dtype == torch.float64 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())


def test_operators_and_harness_match_jax():
    """The operator factories give JAX's expressions; the harness's helpers
    give JAX's numbers; the 3D twin orders CH3D at 2."""
    x, y = sp.symbols("x y", real=True)
    u = sp.sin(x) * sp.cos(2 * y)
    for name in ("sym_lap", "sym_div", "sym_grad"):
        arg = (u, u) if name == "sym_div" else u
        assert getattr(tsym, name)(arg, (x, y)) == getattr(jsym, name)(arg, (x, y))
    v = lambda t, a, b: (sp.cos(b), sp.sin(a))
    for t_op, j_op in ((tsym.advection_diffusion_operator(0.1, v),
                        jsym.advection_diffusion_operator(0.1, v)),
                       (tsym.allen_cahn_operator(0.01, lambda c: c**3, lambda c: 1 + c),
                        jsym.allen_cahn_operator(0.01, lambda c: c**3, lambda c: 1 + c))):
        assert sp.simplify(t_op(u, (x, y), T) - j_op(u, (x, y), T)) == 0
    from pde_opt_tpu.utils import testing as jtesting

    a, b = np.random.default_rng(4).normal(size=(2, 9))
    assert l2_rel_err(torch.from_numpy(a), b) == jtesting.l2_rel_err(a, b)
    assert fit_order([0.1, 0.05, 0.025], [1e-2, 2.6e-3, 6e-4]) == jtesting.fit_order(
        [0.1, 0.05, 0.025], [1e-2, 2.6e-3, 6e-4])
    z = sp.Symbol("z", real=True)
    res = check_convergence(
        CahnHilliard3DPeriodic, tsym.SymbolicCahnHilliard3DPeriodic,
        {"kappa": 1e-2, "mu": lambda c: c**3 - c, "D": lambda c: 1 + 0 * c, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": lambda c: c**3 - c, "D_sym": lambda c: 1 + 0 * c,
         "u_star": sp.sin(X) * sp.cos(Y) * sp.sin(z)},
        [16, 32], L, dtype=torch.float64, ndim=3, **CPU)
    assert isinstance(res, ConvergenceResult) and 1.8 < res.order() < 2.2
