"""The port's Levenberg-Marquardt (``optim/lm.py``), ``ravel_params`` and
``PDEModel.train(method="least_squares" | "least_squares_jit")`` held
against the JAX package on the same numpy inputs (f64, conftest's x64).

Tolerances: on an analytic fit both port variants give JAX's parameters
to 1e-10 with the same ``steps`` and ``converged``; each model fit (the
LM cases of ``tests/test_model.py`` and ``tests/test_3d.py``, their data
made by the JAX package) gives JAX's fitted values to 1e-6 and the truth
within the JAX tests' own bounds.
"""

import numpy as np
import pytest
import torch
from torch.func import jvp

from pde_opt_tpu_torch.grid import Domain
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic, CahnHilliard3DPeriodic
from pde_opt_tpu_torch.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    PeriodicCNN,
)
from pde_opt_tpu_torch.models.pde_model import PDEModel
from pde_opt_tpu_torch.ops.steppers import SemiImplicitFourierSpectral
from pde_opt_tpu_torch.optim.lm import LMResult, least_squares_lm, least_squares_lm_jitted
from pde_opt_tpu_torch.utils import ptree

torch.set_num_threads(1)

KAPPA_TRUE = 0.002
DT0 = 0.00025


def _jax():
    import jax
    import jax.numpy as jnp

    import pde_opt_tpu as jp

    return jax, jnp, jp


def MU_T(c):
    return c**3 - c


# ---- least_squares_lm on an analytic fit -------------------------------------

X_FIT = np.linspace(0.0, 2.0, 25)
Y_FIT = 1.7 * np.exp(-0.8 * X_FIT) + 0.3 + 0.01 * np.sin(7.0 * X_FIT)


def _jax_residual(jnp):
    def residual(theta, x, y):
        return (y - theta[0] * jnp.exp(theta[1] * x) - theta[2], theta[0] * 0.0)
    return residual


def _residual(theta, x, y):
    """The model's misfit and a scalar leaf (as the model's ``reg``)."""
    return (y - theta[0] * torch.exp(theta[1] * x) - theta[2], theta[0] * 0.0)


@pytest.mark.parametrize("variant", ["host", "jitted"])
@pytest.mark.parametrize("max_steps", [3, 100])
def test_lm_matches_jax_on_an_analytic_fit(variant, max_steps):
    """Three parameters of y = a·exp(b·x) + c: the same parameters to 1e-10
    and the same steps and convergence as the JAX function of the same
    name, cut off after 3 steps and run to convergence."""
    jax, jnp, _ = _jax()
    from pde_opt_tpu.optim import lm as jlm

    theta0 = np.array([1.0, -0.2, 0.0])
    jfn = jlm.least_squares_lm if variant == "host" else jlm.least_squares_lm_jitted
    tfn = least_squares_lm if variant == "host" else least_squares_lm_jitted
    want = jfn(_jax_residual(jnp), jnp.asarray(theta0), args=(jnp.asarray(X_FIT), jnp.asarray(Y_FIT)),
               max_steps=max_steps)
    got = tfn(_residual, torch.from_numpy(theta0), args=(torch.from_numpy(X_FIT),
                                                         torch.from_numpy(Y_FIT)),
              max_steps=max_steps)
    assert isinstance(got, LMResult)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-9, atol=1e-14)
    assert (got.steps, got.converged) == (int(want.steps), bool(want.converged))
    assert got.converged == (max_steps == 100) and got.steps <= max_steps


def test_lm_reports_stall_as_not_converged():
    """``tests/test_model.py:178``: a residual with a floor at theta0 and a
    cliff to NaN for any step away from it: no damping improves, a stall."""
    def residual(theta):
        return torch.where(torch.all(theta == 1.0), torch.ones(3, dtype=theta.dtype),
                           torch.full((3,), float("nan"), dtype=theta.dtype))

    for solver in (least_squares_lm, least_squares_lm_jitted):
        out = solver(residual, torch.ones(2, dtype=torch.float64), max_steps=5)
        assert not out.converged and out.steps == 1
        assert torch.equal(out.params, torch.ones(2, dtype=torch.float64))


def test_lm_verbose_prints_each_iteration(capsys):
    least_squares_lm(_residual, torch.tensor([1.0, -0.2, 0.0], dtype=torch.float64),
                     args=(torch.from_numpy(X_FIT), torch.from_numpy(Y_FIT)), max_steps=2,
                     verbose=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[LM] step=")]
    assert len(lines) == 2 and "accepted=True" in lines[0]
    least_squares_lm_jitted(_residual, torch.tensor([1.0, -0.2, 0.0], dtype=torch.float64),
                            args=(torch.from_numpy(X_FIT), torch.from_numpy(Y_FIT)), max_steps=2)
    assert capsys.readouterr().out == ""


# ---- ravel_params --------------------------------------------------------------

def test_ravel_params_round_trip_through_modules():
    """Inexact leaves flatten in ``tree_leaves`` order (a python float as a
    weak scalar, a module through its parameters); ``unravel`` rebuilds the
    tree with the static leaves, modules as copies of the caller's class
    whose coefficients are slices of the vector, so a forward-mode tangent
    on the vector reaches a Legendre coefficient; the caller's tree is
    unchanged.  ``tree_size`` counts as the JAX package's does."""
    jax, jnp, _ = _jax()
    from pde_opt_tpu.models.functions import DiffusionLegendrePolynomials as JD
    from pde_opt_tpu.utils import ptree as jptree

    d_mod = DiffusionLegendrePolynomials(torch.tensor([0.3, 0.2], dtype=torch.float64))
    tree = {"D": d_mod, "kappa": 0.004, "mu": MU_T, "c": torch.tensor([[1.0, 2.0]]),
            "n": 3, "off": None}
    flat, unravel = ptree.ravel_params(tree)
    assert flat.dtype == torch.float64 and not flat.requires_grad
    np.testing.assert_array_equal(flat.numpy(), [0.3, 0.2, 0.004, 1.0, 2.0])
    back = unravel(flat)
    assert back["mu"] is MU_T and back["n"] == 3 and back["off"] is None
    assert back["c"].dtype == torch.float32 and back["c"].shape == (1, 2)
    assert back["kappa"].dtype == torch.float64 and back["kappa"].shape == ()
    assert type(back["D"]) is DiffusionLegendrePolynomials and back["D"] is not d_mod
    assert not isinstance(back["D"].expansion.params, torch.nn.Parameter)
    assert isinstance(d_mod.expansion.params, torch.nn.Parameter)

    u = torch.linspace(0.1, 0.9, 9, dtype=torch.float64)
    tangent = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    val, dval = jvp(lambda v: unravel(v)["D"](u), (flat,), (tangent,))
    torch.testing.assert_close(val, d_mod(u).detach())
    torch.testing.assert_close(dval, d_mod(u).detach() * (2.0 * u - 1.0))  # d/dp1 of exp(Σ p P)

    jtree = {"D": JD(jnp.array([0.3, 0.2])), "kappa": 0.004, "c": np.array([[1.0, 2.0]]), "n": 3}
    assert ptree.tree_size(tree) == jptree.tree_size(jtree) == 6
    cnn = PeriodicCNN(1, (3,), 1, 3, generator=torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.float64)
    flat_c, unravel_c = ptree.ravel_params({"mu": cnn})
    assert flat_c.numel() == sum(p.numel() for p in cnn.parameters()) == ptree.tree_size(cnn)
    x = torch.rand(2, 8, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(unravel_c(flat_c)["mu"](x), cnn(x).detach())


# ---- PDEModel.train by LM --------------------------------------------------------

def _domain(n, dim, jp=None, jnp=None):
    ln = 0.01 * n
    box = ((-ln / 2, ln / 2),) * dim
    if jp is not None:
        return jp.Domain((n,) * dim, box, dtype=jnp.float64)
    return Domain((n,) * dim, box, dtype=torch.float64)


def _models(n, dim):
    jax, jnp, jp = _jax()
    if dim == 2:
        jeq, teq = jp.CahnHilliard2DPeriodic, CahnHilliard2DPeriodic
    else:
        from pde_opt_tpu.models.cahn_hilliard import CahnHilliard3DPeriodic as jeq
        teq = CahnHilliard3DPeriodic
    jm = jp.PDEModel(jeq, _domain(n, dim, jp, jnp), jp.SemiImplicitFourierSpectral)
    tm = PDEModel(teq, _domain(n, dim), SemiImplicitFourierSpectral)
    return jm, tm


# name: (grid, dim, seed, ts, inds, truth, start, method, max_steps, JAX test's bound)
FITS = {
    "kappa_2d": (32, 2, 0, np.linspace(0.0, 0.004, 9), [[0, 2, 4], [4, 6, 8]], "kappa",
                 "least_squares", 30, 2e-5),                       # test_model.py:49
    "legendre_D_2d": (32, 2, 0, np.linspace(0.0, 0.004, 9), [[0, 2, 4, 6]], "D",
                      "least_squares", 25, 2e-2),                  # test_model.py:88
    "kappa_2d_jit": (32, 2, 0, np.linspace(0.0, 0.004, 9), [[0, 2, 4], [4, 6, 8]], "kappa",
                     "least_squares_jit", 30, 2e-5),               # test_model.py:158
    "kappa_3d_32": (32, 3, 1, np.linspace(0.0, 0.002, 5), [[0, 2, 4]], "kappa",
                    "least_squares", 20, 2e-5),                    # test_3d.py:81
    "legendre_D_3d_16": (16, 3, 2, np.linspace(0.0, 0.002, 5), [[0, 1, 2, 3, 4]], "D",
                         "least_squares", 25, 2e-2),               # test_3d.py:110
}


@pytest.mark.parametrize("name", list(FITS))
def test_train_least_squares_matches_jax(name):
    """The fits of the JAX tests, each with the data of the JAX package's
    rollout: the port's fitted values within 1e-6 of JAX's, and the truth
    within the JAX test's bound; the fixed parameters carried through."""
    jax, jnp, jp = _jax()
    from pde_opt_tpu.models.functions import DiffusionLegendrePolynomials as JD

    n, dim, seed, ts, inds, what, method, max_steps, bound = FITS[name]
    jm, tm = _models(n, dim)
    y0 = np.clip(0.01 * np.random.default_rng(seed).standard_normal((n,) * dim) + 0.5, 0.0, 1.0)
    if what == "kappa":
        truth, jtrue = KAPPA_TRUE, {"kappa": KAPPA_TRUE, "D": jnp.ones_like}
        jopt, topt = {"kappa": 0.004}, {"kappa": torch.tensor(0.004, dtype=torch.float64)}
        jother = {"mu": lambda c: c**3 - c, "D": jnp.ones_like, "derivs": "fd"}
        tother = {"mu": MU_T, "D": torch.ones_like, "derivs": "fd", "device": "cpu"}
    else:
        truth, jtrue = np.array([0.3, 0.2]), {"kappa": KAPPA_TRUE, "D": JD(jnp.array([0.3, 0.2]))}
        jopt = {"D": JD(jnp.array([0.0, 0.0]))}
        topt = {"D": DiffusionLegendrePolynomials(torch.zeros(2, dtype=torch.float64))}
        jother = {"mu": lambda c: c**3 - c, "kappa": KAPPA_TRUE, "derivs": "fd"}
        tother = {"mu": MU_T, "kappa": KAPPA_TRUE, "derivs": "fd", "device": "cpu"}
    sol = np.array(jm.solve({"mu": lambda c: c**3 - c, "derivs": "fd", **jtrue},
                            jnp.asarray(y0), ts, {"A": 0.5}, dt0=DT0))
    common = dict(solver_parameters={"A": 0.5}, weights={what: None}, lambda_reg=0.0,
                  method=method, max_steps=max_steps, dt0=DT0)
    jres = jm.train({"ys": list(sol), "ts": list(ts)}, inds, opt_parameters=jopt,
                    other_parameters=jother, **common)
    tres = tm.train({"ys": [torch.from_numpy(y) for y in sol], "ts": list(ts)}, inds,
                    opt_parameters=topt, other_parameters=tother, **common)
    if what == "kappa":
        got, want = float(tres["kappa"]), float(jres["kappa"])
    else:
        assert type(tres["D"]) is DiffusionLegendrePolynomials
        got, want = tres["D"].expansion.params.numpy(), np.asarray(jres["D"].expansion.params)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, truth, rtol=0, atol=bound)
    assert tres["mu"] is MU_T and tres["derivs"] == "fd"


def test_train_least_squares_legendre_mu_and_D():
    """``examples/optimize_3d.py``'s fit (Legendre μ from zeros(3) and D
    from zeros(2), A = 0.5, two windows) at CI scale: 16³ over
    ``tests/test_3d.py:110``'s horizon.  Both modules are recovered; the
    coefficients that enter the dynamics agree with JAX's to 1e-6.  μ's
    constant coefficient does not (the rhs takes ∇μ): its Jacobian column
    is exactly zero, so the port keeps it at 0, where the JAX package's
    damping matrix, which also fills its off-diagonal zeros with the
    1e-12 floor, moves it by minus the sum of the other steps."""
    jax, jnp, jp = _jax()
    from pde_opt_tpu.models.functions import ChemicalPotentialLegendrePolynomials as JMu
    from pde_opt_tpu.models.functions import DiffusionLegendrePolynomials as JD

    jm, tm = _models(16, 3)
    y0 = np.clip(0.01 * np.random.default_rng(0).standard_normal((16,) * 3) + 0.5, 0.0, 1.0)
    ts = np.linspace(0.0, 0.002, 5)
    inds = [[0, 1, 2], [2, 3, 4]]
    sol = np.array(jm.solve({"kappa": KAPPA_TRUE, "mu": JMu(jnp.array([0.0, 1.0, 0.5])),
                             "D": JD(jnp.array([0.3, 0.2])), "derivs": "fd"},
                            jnp.asarray(y0), ts, {"A": 0.5}, dt0=DT0))
    common = dict(solver_parameters={"A": 0.5}, weights={"mu": None, "D": None},
                  lambda_reg=0.0, max_steps=60, dt0=DT0)
    jres = jm.train({"ys": list(sol), "ts": list(ts)}, inds,
                    opt_parameters={"mu": JMu(jnp.zeros(3)), "D": JD(jnp.zeros(2))},
                    other_parameters={"kappa": KAPPA_TRUE, "derivs": "fd"}, **common)
    tres = tm.train({"ys": [torch.from_numpy(y) for y in sol], "ts": list(ts)}, inds,
                    opt_parameters={
                        "mu": ChemicalPotentialLegendrePolynomials(torch.zeros(3, dtype=torch.float64)),
                        "D": DiffusionLegendrePolynomials(torch.zeros(2, dtype=torch.float64))},
                    other_parameters={"kappa": KAPPA_TRUE, "derivs": "fd", "device": "cpu"},
                    **common)
    mu, d = tres["mu"].expansion.params.numpy(), tres["D"].expansion.params.numpy()
    assert mu[0] == 0.0 and abs(float(jres["mu"].expansion.params[0])) > 0.1
    np.testing.assert_allclose(mu[1:], np.asarray(jres["mu"].expansion.params)[1:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(d, np.asarray(jres["D"].expansion.params), rtol=0, atol=1e-6)
    np.testing.assert_allclose(mu, [0.0, 1.0, 0.5], rtol=0, atol=2e-2)
    np.testing.assert_allclose(d, [0.3, 0.2], rtol=0, atol=2e-2)


def test_lm_leaves_an_unobservable_parameter_in_place():
    """A parameter the residual does not depend on has a zero Jacobian
    column: the floored diagonal keeps the solve regular and its step is
    exactly 0, while the others converge."""
    def residual(theta, x):
        return theta[1] * x + theta[2] - (2.0 * x - 1.0)

    out = least_squares_lm(residual, torch.tensor([5.0, 0.0, 0.0], dtype=torch.float64),
                           args=(torch.linspace(0.0, 1.0, 6, dtype=torch.float64),))
    assert out.converged and out.params[0] == 5.0
    np.testing.assert_allclose(out.params[1:].numpy(), [2.0, -1.0], rtol=0, atol=1e-6)


def test_fit_jacobian_on_a_fresh_domain_matches_differences():
    """``bench/inverse.py``'s 3D Legendre fit at 6³ (f64) on observations
    given up front, so its first equation is built inside ``jacfwd``: the
    Jacobian at theta0 matches central differences of the residual."""
    from pde_opt_tpu_torch.bench.inverse import legendre_fit_3d

    rng = np.random.default_rng(5)
    ys = [torch.from_numpy(0.5 + 0.02 * rng.standard_normal((6, 6, 6))) for _ in range(9)]
    fit = legendre_fit_3d("cpu", torch.float64, grid=6, ys=ys)
    jac = fit.jacobian()
    flat0, unravel = ptree.ravel_params(fit.start())
    assert jac.shape == (2 * 2 * 6**3, 5)

    def res(th):
        return fit.residuals(unravel(th))[0].reshape(-1)

    eps = 1e-6
    fd = torch.stack([(res(flat0 + eps * e) - res(flat0 - eps * e)) / (2 * eps)
                      for e in torch.eye(5, dtype=torch.float64)], dim=1)
    torch.testing.assert_close(jac, fd, rtol=1e-6, atol=1e-9)
    assert not jac[:, 0].any()                  # μ's constant never enters the rhs
