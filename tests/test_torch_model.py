"""The port's training path held against the JAX package: ``integrate``,
the optimizers, ``ptree`` and ``PDEModel`` (solve, regularization,
train, optimize), on the same numpy inputs.

Tolerances: f64 rollouts of the FFT stepper agree to 1e-10 (the same
arithmetic in two FFT libraries); Adam trajectories in f64 to 1e-10; the
recovery tests keep the JAX tests' own bounds (``tests/test_model.py``).
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.grid import Domain
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic
from pde_opt_tpu_torch.models.pde_model import PDEModel
from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
from pde_opt_tpu_torch.ops.integrate import PIDController, integrate
from pde_opt_tpu_torch.ops.steppers import (
    FusedSemiImplicitSpectral,
    SemiImplicitFourierSpectral,
)
from pde_opt_tpu_torch.optim.minimize import minimize_adam, minimize_lbfgs
from pde_opt_tpu_torch.utils import ptree
from pde_opt_tpu_torch.utils.compat import prepare_solver_params

torch.set_num_threads(1)

N = 32
L = 0.01 * N
KAPPA_TRUE = 0.002
DT0 = 0.00025
MU_T = PolynomialMu((0.0, -1.0, 0.0, 1.0))


def MU_J(c):
    return c**3 - c


def _jax():
    import jax
    import jax.numpy as jnp

    import pde_opt_tpu as jp

    return jax, jnp, jp


def _y0(n=N, seed=0, batch=(), amp=0.01):
    rng = np.random.default_rng(seed)
    return np.clip(amp * rng.standard_normal(batch + (n, n)) + 0.5, 0.0, 1.0)


def _domain(n=N, dtype=torch.float64):
    ln = 0.01 * n
    return Domain((n, n), ((-ln / 2, ln / 2), (-ln / 2, ln / 2)), dtype=dtype)


def _jmodel(jp, jnp, n=N):
    ln = 0.01 * n
    dom = jp.Domain((n, n), ((-ln / 2, ln / 2), (-ln / 2, ln / 2)), dtype=jnp.float64)
    return jp.PDEModel(jp.CahnHilliard2DPeriodic, dom, jp.SemiImplicitFourierSpectral)


def _sif(kappa, n=16):
    eq = CahnHilliard2DPeriodic(_domain(n), kappa, MU_T, torch.ones_like, derivs="fd",
                                device="cpu")
    st = SemiImplicitFourierSpectral(
        **prepare_solver_params(SemiImplicitFourierSpectral, {"A": 0.5}, eq))
    return st, eq.rhs


# ---- integrate --------------------------------------------------------------

@pytest.mark.parametrize("ts", [np.linspace(0.0, 0.002, 5), [0.0, 0.0005, 0.0012, 0.002]],
                         ids=["uniform", "nonuniform"])
def test_integrate_matches_jax(ts):
    jax, jnp, jp = _jax()
    from pde_opt_tpu.ops.integrate import integrate as jintegrate
    from pde_opt_tpu.utils.compat import prepare_solver_params as jprep

    y0 = _y0(16, seed=1)
    jdom = jp.Domain((16, 16), ((-0.08, 0.08), (-0.08, 0.08)), dtype=jnp.float64)
    jeq = jp.CahnHilliard2DPeriodic(jdom, 0.002, MU_J, jnp.ones_like, derivs="fd")
    jst = jp.SemiImplicitFourierSpectral(
        **jprep(jp.SemiImplicitFourierSpectral, {"A": 0.5}, jeq))
    want = jintegrate(jst, jeq.rhs, jnp.asarray(y0), ts, DT0)
    st, rhs = _sif(0.002)
    for adjoint in ("forward", "checkpoint"):
        got = integrate(st, rhs, torch.from_numpy(y0), ts, DT0, adjoint=adjoint)
        assert got.shape == (len(ts), 16, 16)
        np.testing.assert_array_equal(got[0].numpy(), y0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("stepper", ["sif", "fused"])
def test_integrate_adjoints_agree(stepper):
    """``"forward"`` and ``"checkpoint"`` give the same values and the same
    gradients with respect to kappa."""
    ts = [0.0, 0.002, 0.004, 0.005]
    kap0 = np.array([0.003, 0.005, 0.008])
    y0 = torch.from_numpy(_y0(16, seed=2, batch=(3,)))
    results = {}
    for adjoint in ("forward", "checkpoint"):
        k = torch.from_numpy(kap0).requires_grad_()
        if stepper == "sif":
            st, rhs = _sif(k[:, None, None])
        else:
            st, rhs = FusedSemiImplicitSpectral(
                kappa=k, mu=MU_T, D=torch.ones_like, domain=_domain(16),
                mats_dtype=torch.float32), None
        sol = integrate(st, rhs, y0, ts, 1e-3, adjoint=adjoint)
        (sol[1:] ** 2).sum().backward()
        results[adjoint] = (sol.detach(), k.grad)
    (vf, gf), (vc, gc) = results["forward"], results["checkpoint"]
    torch.testing.assert_close(vc, vf, rtol=0, atol=0)
    torch.testing.assert_close(gc, gf, rtol=1e-12, atol=0)
    assert bool((gf != 0).all())


@pytest.mark.parametrize("adjoint,fwd_per_segment", [("forward", 1), ("checkpoint", 2)])
def test_fused_segments_run_the_macro_as_designed(monkeypatch, adjoint, fwd_per_segment):
    """One value+grad through a fused rollout runs the macro forward once per
    segment (twice with ``"checkpoint"``: the backward re-runs each segment)
    and its backward once per segment.  On CUDA these are the launch counts
    of kernels K2 and K3."""
    from pde_opt_tpu_torch.ops import cas_spectral

    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("ch_cas_macro_plain", "fwd"), ("ch_cas_macro_bwd_plain", "bwd")):
        real = getattr(cas_spectral, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(cas_spectral, name, counted)
    k = torch.full((3,), 0.004, requires_grad=True)
    st = FusedSemiImplicitSpectral(kappa=k, mu=MU_T, D=torch.ones_like,
                                   domain=_domain(16, torch.float32))
    y0 = torch.from_numpy(_y0(16, seed=3, batch=(3,)).astype(np.float32))
    sol = integrate(st, None, y0, [0.0, 0.01, 0.02], 1e-3, adjoint=adjoint)
    sol[-1].var(dim=(-2, -1), correction=0).sum().backward()
    assert calls == {"fwd": 2 * fwd_per_segment, "bwd": 2}


def test_integrate_rejects_bad_arguments():
    st, rhs = _sif(0.002)
    y0 = torch.zeros(16, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="strictly increasing"):
        integrate(st, rhs, y0, [0.0, 0.002, 0.001], DT0)
    with pytest.raises(ValueError, match="at least two"):
        integrate(st, rhs, y0, [0.0], DT0)
    with pytest.raises(ValueError, match="adjoint"):
        integrate(st, rhs, y0, [0.0, 0.001], DT0, adjoint="backsolve")


# ---- optimizers and ptree ---------------------------------------------------

def test_minimize_adam_matches_optax():
    jax, jnp, _ = _jax()
    from pde_opt_tpu.optim.minimize import minimize_adam as jadam

    target = np.array([0.3, -1.2, 2.0])
    w = np.array([1.0, 10.0, 0.1])

    def jfn(p, t):
        return jnp.sum(jnp.asarray(w) * (p["x"] - t) ** 2) + jnp.sin(3.0 * p["y"]) ** 2

    def tfn(p, t):
        return (torch.from_numpy(w) * (p["x"] - t) ** 2).sum() + torch.sin(3.0 * p["y"]) ** 2

    for steps in (1, 2, 5):
        jres = jadam(jfn, {"x": jnp.zeros(3), "y": jnp.asarray(0.7)},
                     args=(jnp.asarray(target),), max_steps=steps, learning_rate=0.05)
        tres = minimize_adam(tfn, {"x": torch.zeros(3, dtype=torch.float64),
                                   "y": torch.tensor(0.7, dtype=torch.float64)},
                             args=(torch.from_numpy(target),), max_steps=steps,
                             learning_rate=0.05)
        assert tres.steps == jres.steps == steps and not tres.params["x"].requires_grad
        np.testing.assert_allclose(tres.params["x"].numpy(), np.asarray(jres.params["x"]),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(tres.params["y"]), float(jres.params["y"]),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-10)


def test_minimize_lbfgs_converges_and_stops():
    """Rosenbrock from (-1.2, 1): the minimum, and the JAX stop rule."""

    def rosen(p):
        x, y = p["z"][0], p["z"][1]
        return (1 - x) ** 2 + 100 * (y - x * x) ** 2

    res = minimize_lbfgs(rosen, {"z": torch.tensor([-1.2, 1.0], dtype=torch.float64)},
                         max_steps=200)
    assert res.converged and res.steps < 200
    np.testing.assert_allclose(res.params["z"].numpy(), [1.0, 1.0], atol=1e-4)
    nan = minimize_lbfgs(lambda p: p["z"].sum() * float("nan"),
                         {"z": torch.ones(2, dtype=torch.float64)}, max_steps=5)
    assert nan.steps == 1 and not nan.converged


def test_ptree_carries_jax_parameters():
    """``from_numpy`` turns a JAX parameter tree (arrays, floats, callables)
    into the port's; partition/combine split and rebuild it."""
    jax, jnp, _ = _jax()
    jparams = {"kappa": jnp.asarray(0.004, jnp.float32), "mu": MU_J,
               "coeffs": np.array([0.3, 0.2]), "layers": [jnp.ones((2, 2)), 3],
               "lr": 0.1, "off": None}
    host = jax.tree_util.tree_map(np.asarray, {k: v for k, v in jparams.items()
                                               if k in ("kappa", "layers")})
    tp = ptree.from_numpy({**jparams, **host}, device="cpu")
    assert tp["kappa"].dtype == torch.float32 and float(tp["kappa"]) == np.float32(0.004)
    assert tp["coeffs"].dtype == torch.float64
    np.testing.assert_array_equal(tp["coeffs"].numpy(), [0.3, 0.2])
    assert tp["layers"][0].shape == (2, 2) and tp["layers"][1] == 3
    assert tp["mu"] is MU_J and tp["lr"] == 0.1 and tp["off"] is None

    dyn, static = ptree.partition(tp)
    assert dyn["mu"] is None and static["mu"] is MU_J and dyn["layers"][1] is None
    assert static["kappa"] is None and dyn["lr"] == 0.1
    back = ptree.combine(ptree.as_arrays(dyn), static)
    assert back["mu"] is MU_J and torch.is_tensor(back["lr"]) and back["layers"][1] == 3
    # The same split as the JAX package's.
    from pde_opt_tpu.utils import ptree as jptree

    jdyn, _ = jptree.partition(jparams)
    assert {k for k, v in jdyn.items() if v is not None} == {
        k for k, v in dyn.items() if v is not None and not isinstance(v, list)
    } | {"layers"}


# ---- PDEModel ---------------------------------------------------------------

def _model():
    return PDEModel(CahnHilliard2DPeriodic, _domain(), SemiImplicitFourierSpectral)


def _jax_data():
    """The JAX package's rollout at kappa = KAPPA_TRUE (``test_model.py``'s data)."""
    jax, jnp, jp = _jax()
    y0 = _y0()
    ts = np.linspace(0.0, 0.004, 9)
    sol = _jmodel(jp, jnp).solve({"kappa": KAPPA_TRUE, "mu": MU_J, "D": jnp.ones_like,
                                  "derivs": "fd"}, jnp.asarray(y0), ts, {"A": 0.5}, dt0=DT0)
    return y0, ts, np.array(sol)


def test_train_mse_lbfgs_recovers_kappa():
    y0, ts, sol = _jax_data()
    model = _model()
    mine = model.solve({"kappa": KAPPA_TRUE, "mu": MU_T, "D": torch.ones_like,
                        "derivs": "fd", "device": "cpu"}, torch.from_numpy(y0), ts,
                       {"A": 0.5}, dt0=DT0)
    np.testing.assert_allclose(mine.numpy(), sol, rtol=0, atol=1e-10)
    data = {"ys": list(sol), "ts": list(ts)}
    res = model.train(
        data, [[0, 2, 4]],
        opt_parameters={"kappa": torch.tensor(0.003, dtype=torch.float64)},
        other_parameters={"mu": MU_T, "D": torch.ones_like, "derivs": "fd"},
        solver_parameters={"A": 0.5}, weights={"kappa": None}, lambda_reg=0.0,
        method="mse", max_steps=40, dt0=DT0,
    )
    assert abs(float(res["kappa"]) - KAPPA_TRUE) < 5e-4
    assert res["mu"] is MU_T


def test_train_adam_and_unported_methods():
    y0, ts, sol = _jax_data()
    model = _model()
    data = {"ys": list(sol), "ts": list(ts)}
    kw = dict(opt_parameters={"kappa": torch.tensor(0.003, dtype=torch.float64)},
              other_parameters={"mu": MU_T, "D": torch.ones_like, "derivs": "fd"},
              solver_parameters={"A": 0.5}, weights={"kappa": None}, lambda_reg=0.0,
              dt0=DT0)
    res = model.train(data, [[0, 2, 4], [4, 6, 8]], method="adam", max_steps=5,
                      learning_rate=1e-4, **kw)
    assert abs(float(res["kappa"]) - 0.003) > 1e-9
    assert float(res["kappa"]) < 0.003          # toward KAPPA_TRUE
    # The JAX package's default method, Levenberg-Marquardt, runs (its fits
    # are held against JAX's in tests/test_torch_lm.py).
    lm = model.train(data, [[0, 2, 4]], max_steps=2, **kw)
    assert abs(float(lm["kappa"]) - KAPPA_TRUE) < abs(0.003 - KAPPA_TRUE)
    ctl = PIDController()
    assert (ctl.rtol, ctl.atol) == (1e-4, 1e-6)


def test_regularization_matches_jax():
    """The scalar and tensor leaves of ``test_model.py``'s regularization
    case (module leaves wait for ``models/functions``)."""
    jax, jnp, jp = _jax()
    jm = _jmodel(jp, jnp)
    w = np.array([0.5, 1.0])
    v = np.array([1.0, 2.0])
    cases = [
        ({"kappa": 2.0, "mu": MU_J}, {"kappa": 1.0, "mu": None}, 0.5, 2.0),
        ({"kappa": 2.0, "c": v}, {"kappa": None, "c": w}, 1.0, 4.5),
        ({"kappa": 2.0, "c": [v, 3]}, {"kappa": 0.25, "c": [w, None]}, 2.0, 11.0),
    ]
    model = _model()
    for params, weights, lam, want in cases:
        got = model.regularization(ptree.from_numpy(params, device="cpu"),
                                   ptree.from_numpy(weights, device="cpu"), lam)
        jwant = jm.regularization(params, weights, lam)
        np.testing.assert_allclose(float(got), want)
        np.testing.assert_allclose(float(got), float(jwant))


def test_optimize_objective_control():
    """``optimize`` (L-BFGS) drives kappa toward the value whose final
    field the objective matches (``test_model.py``'s control case)."""
    model = _model()
    y0 = torch.from_numpy(_y0())
    ts = np.linspace(0.0, 0.002, 4)
    target = 0.0025
    base = {"mu": MU_T, "D": torch.ones_like, "derivs": "fd", "device": "cpu"}
    ref_sol = model.solve({"kappa": target, **base}, y0, ts, {"A": 0.5}, dt0=DT0)
    res = model.optimize(
        lambda sol: ((sol[-1] - ref_sol[-1]) ** 2).sum(), y0, ts,
        opt_parameters={"kappa": torch.tensor(0.004, dtype=torch.float64)},
        other_parameters=base, solver_parameters={"A": 0.5}, weights={"kappa": None},
        lambda_reg=0.0, max_steps=25, dt0=DT0,
    )
    assert abs(float(res["kappa"]) - target) < 5e-4


def test_optimize_on_fused_path_matches_jax():
    """``PDEModel.optimize`` (Adam) end to end on the fused stepper, against
    the JAX package's on the same field (``test_fused_grad.py``'s case)."""
    jax, jnp, jp = _jax()
    from pde_opt_tpu.models.pde_model import PDEModel as JModel
    from pde_opt_tpu.ops.steppers import FusedSemiImplicitSpectral as JFused

    n = 16
    y0 = (0.5 + 0.05 * np.random.default_rng(7).standard_normal((n, n))).astype(np.float32)
    ts = np.linspace(0.0, 3e-3, 4)
    common = dict(weights={"kappa": None}, lambda_reg=0.0, max_steps=3, dt0=1e-3,
                  method="adam", learning_rate=1e-4)
    jdom = jp.Domain((n, n), ((0.0, 0.16), (0.0, 0.16)), "dimensionless")
    jres = JModel(jp.CahnHilliard2DPeriodic, jdom, JFused).optimize(
        objective_function=lambda sol: jnp.var(sol[-1]), y0=jnp.asarray(y0), ts=ts,
        opt_parameters={"kappa": jnp.asarray(0.004, jnp.float32)},
        other_parameters={"mu": MU_J, "D": jnp.ones_like},
        solver_parameters={"A": 1.0, "interpret": True, "mats_dtype": jnp.float32},
        **common)
    dom = Domain((n, n), ((0.0, 0.16), (0.0, 0.16)), "dimensionless")
    res = PDEModel(CahnHilliard2DPeriodic, dom, FusedSemiImplicitSpectral).optimize(
        objective_function=lambda sol: sol[-1].var(correction=0), y0=torch.from_numpy(y0),
        ts=ts, opt_parameters={"kappa": torch.tensor(0.004)},
        other_parameters={"mu": MU_T, "D": torch.ones_like},
        solver_parameters={"A": 1.0, "mats_dtype": torch.float32}, **common)
    k = float(res["kappa"])
    assert np.isfinite(k) and abs(k - 0.004) > 1e-9
    np.testing.assert_allclose(k, float(jres["kappa"]), rtol=0, atol=1e-8)


# ---- module parameters (the Legendre coefficient modules) -------------------

LEG_N, LEG_MU0, LEG_TRUE = 16, [0.0, 1.0, 0.5], [0.0, 1.2, 0.3]
# ROADMAP's case: optimize(mean(u_T²)) over κ and μ from a field of
# amplitude 0.05, 3 Adam steps from [0, 1, 0.5].  There (f32) JAX moved μ to
# [-1.75e-4, 1.0250, 0.4774]; in f64 the constant coefficient, which does not
# enter the dynamics (the rhs takes ∇²μ), stays at 0 in both packages, and
# the others agree with those to their printed digits.
LEG_ROADMAP = dict(amp=0.05, ts=[0.0, 1e-5, 2e-5], steps=3, jax=[0.0, 1.0250, 0.4774])
# Fits to a rollout at μ = LEG_TRUE over 2e-4 from a field of amplitude 0.1:
# ``train`` (the MSE to the saved fields) and, for L-BFGS, ``optimize`` (the
# squared distance to the saved fields, summed: the stop rule's absolute
# 1e-8 would end a mean's descent early).  L-BFGS runs to the same minimizer in both
# packages; 3 steps would not agree, as their first step and line search
# differ (optax scales the first step by 1/|g|_2, torch by 1/|g|_1).
LEG_FIT = dict(amp=0.1, ts=[0.0, 1e-4, 2e-4], steps={"adam": 3, "lbfgs": 20})


def _legendre_models(jp, jnp):
    """The two packages' CH models on 16², f64, FFT stepper."""
    ln = 0.01 * LEG_N
    box = ((-ln / 2, ln / 2), (-ln / 2, ln / 2))
    jm = jp.PDEModel(jp.CahnHilliard2DPeriodic,
                     jp.Domain((LEG_N, LEG_N), box, dtype=jnp.float64),
                     jp.SemiImplicitFourierSpectral)
    tm = PDEModel(CahnHilliard2DPeriodic, Domain((LEG_N, LEG_N), box, dtype=torch.float64),
                  SemiImplicitFourierSpectral)
    return jm, tm


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
@pytest.mark.parametrize("entry", ["optimize", "train"])
def test_module_coefficients_train_as_in_jax(entry, method):
    """A Legendre μ in ``opt_parameters`` trains, as the JAX package's pytree
    module does (SemiImplicitFourierSpectral, A = 0.5, κ = 0.002, 16², f64):
    ``optimize`` with Adam on the ROADMAP's case (``LEG_ROADMAP``, κ trained
    too), the other three on the fits of ``LEG_FIT``.  The coefficients
    agree with JAX's to 1e-4 and moved as far (rtol 1e-3 of the
    displacement); the result is a module of the caller's class, and the
    caller's module is unchanged."""
    jax, jnp, jp = _jax()
    from pde_opt_tpu.models.functions import ChemicalPotentialLegendrePolynomials as JMu
    from pde_opt_tpu_torch.models.functions import ChemicalPotentialLegendrePolynomials as TMu

    jm, tm = _legendre_models(jp, jnp)
    mu0 = TMu(torch.tensor(LEG_MU0, dtype=torch.float64))
    jparams = {"D": jnp.ones_like, "derivs": "fd"}
    tparams = {"D": torch.ones_like, "derivs": "fd", "device": "cpu"}
    common = dict(solver_parameters={"A": 0.5}, lambda_reg=0.0, dt0=1e-6, learning_rate=1e-2)
    roadmap = entry == "optimize" and method == "adam"
    case = LEG_ROADMAP if roadmap else LEG_FIT
    y0, ts = _y0(LEG_N, amp=case["amp"]), case["ts"]
    if roadmap:
        jres = jm.optimize(lambda s: jnp.mean(s[-1] ** 2), jnp.asarray(y0), ts,
                           opt_parameters={"kappa": 0.002, "mu": JMu(jnp.array(LEG_MU0))},
                           other_parameters=jparams, weights={"kappa": None, "mu": None},
                           method="adam", max_steps=case["steps"], **common)
        tres = tm.optimize(lambda s: (s[-1] ** 2).mean(), torch.from_numpy(y0), ts,
                           opt_parameters={"kappa": 0.002, "mu": mu0},
                           other_parameters=tparams, weights={"kappa": None, "mu": None},
                           method="adam", max_steps=case["steps"], **common)
        np.testing.assert_allclose(float(tres["kappa"]), float(jres["kappa"]), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(jres["mu"].expansion.params), case["jax"],
                                   rtol=0, atol=5e-5)
    else:
        ys = np.array(jm.solve({"kappa": 0.002, "mu": JMu(jnp.array(LEG_TRUE)), **jparams},
                                jnp.asarray(y0), ts, {"A": 0.5}, dt0=1e-6))
        common.update(max_steps=case["steps"][method], weights={"mu": None})
        jother, tother = {"kappa": 0.002, **jparams}, {"kappa": 0.002, **tparams}
        if entry == "train":
            kw = dict(method="mse" if method == "lbfgs" else "adam", **common)
            jres = jm.train({"ys": list(ys), "ts": ts}, [[0, 1, 2]],
                            opt_parameters={"mu": JMu(jnp.array(LEG_MU0))},
                            other_parameters=jother, **kw)
            tres = tm.train({"ys": [torch.from_numpy(y) for y in ys], "ts": ts}, [[0, 1, 2]],
                            opt_parameters={"mu": mu0}, other_parameters=tother, **kw)
        else:
            target = ys[1:]
            jres = jm.optimize(lambda s: 1e6 * jnp.sum((s[1:] - target) ** 2), jnp.asarray(y0), ts,
                               opt_parameters={"mu": JMu(jnp.array(LEG_MU0))},
                               other_parameters=jother, method=method, **common)
            tres = tm.optimize(lambda s: 1e6 * ((s[1:] - torch.from_numpy(target)) ** 2).sum(),
                               torch.from_numpy(y0), ts, opt_parameters={"mu": mu0},
                               other_parameters=tother, method=method, **common)
    want = np.asarray(jres["mu"].expansion.params)
    got = tres["mu"].expansion.params
    assert type(tres["mu"]) is TMu and tres["mu"] is not mu0 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy() - LEG_MU0, want - LEG_MU0, rtol=1e-3, atol=1e-9)
    assert np.abs(want - LEG_MU0).max() > 1e-3              # JAX moved them
    assert isinstance(mu0.expansion.params, torch.nn.Parameter)
    assert mu0.expansion.params.requires_grad
    np.testing.assert_array_equal(mu0.expansion.params.detach().numpy(), LEG_MU0)


def test_regularization_of_module_leaves_matches_jax():
    """``tests/test_model.py``'s module case: a ``None`` weight scores a
    module 0, a module weight pairs its parameters with the module's."""
    jax, jnp, jp = _jax()
    from pde_opt_tpu.models.functions import DiffusionLegendrePolynomials as JD
    from pde_opt_tpu_torch.models.functions import DiffusionLegendrePolynomials as TD

    jm, tm = _legendre_models(jp, jnp)
    cases = [
        ({"kappa": 2.0, "D": ([1.0, 2.0],)}, {"kappa": 1.0, "D": None}, 0.5, 2.0),
        ({"D": ([1.0, 2.0],)}, {"D": ([1.0, 1.0],)}, 1.0, 5.0),
    ]

    def build(tree, mod):
        return {k: mod(*v) if isinstance(v, tuple) else v for k, v in tree.items()}

    for params, weights, lam, want in cases:
        jreg = jm.regularization(build(params, lambda c: JD(jnp.array(c))),
                                 build(weights, lambda c: JD(jnp.array(c))), lam)
        treg = tm.regularization(build(params, lambda c: TD(torch.tensor(c))),
                                 build(weights, lambda c: TD(torch.tensor(c))), lam)
        np.testing.assert_allclose(float(jreg), want)
        np.testing.assert_allclose(float(torch.as_tensor(treg).detach()), want)


def test_ptree_descends_into_modules():
    """partition keeps a module's structure static and its parameters
    dynamic; combine rebuilds the caller's class around the dynamic tensors,
    which carry gradients; the caller's module is untouched."""
    from pde_opt_tpu_torch.models.functions import DiffusionLegendrePolynomials as TD

    mod = TD(torch.tensor([0.3, 0.2]))
    dyn, static = ptree.partition({"D": mod, "kappa": 0.1})
    assert [t.data_ptr() for t in ptree.tree_leaves(dyn["D"])] == [mod.expansion.params.data_ptr()]
    assert ptree.tree_leaves(static["D"]) == [] and static["kappa"] is None
    leaf = torch.tensor([0.5, -0.1], requires_grad=True)
    back = ptree.combine({"D": ptree.tree_map(lambda _: leaf, dyn["D"]), "kappa": 0.1}, static)
    c = torch.linspace(0.1, 0.9, 5)
    back["D"](c).sum().backward()
    assert type(back["D"]) is TD and back["D"].expansion.params is leaf
    ref = TD(torch.tensor([0.5, -0.1]))
    ref(c).sum().backward()
    torch.testing.assert_close(leaf.grad, ref.expansion.params.grad)
    assert isinstance(mod.expansion.params, torch.nn.Parameter) and mod.expansion.params.grad is None
    torch.testing.assert_close(mod.expansion.params.detach(), torch.tensor([0.3, 0.2]))
