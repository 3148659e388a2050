"""The port's backward Euler by Newton-GMRES (``ImplicitEuler``) and its
GMRES: ``tests/test_solvers.py``'s implicit-Euler checks mirrored, and
``solve_step`` held against the JAX package's on the same float64 inputs.

Tolerances: the mirrored checks keep JAX's (rtol 1e-5 against the exact
factor, 1e-6 and 1e-10 between variants); ``solve_step`` against JAX's
rtol 1e-10 (both converge to the Newton tolerance), gradients through the
differentiable variant against ``jax.grad`` rtol 1e-8 (JAX differentiates
GMRES implicitly, the port through its iterations; both converge).
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import ImplicitEuler
from pde_opt_tpu_torch.ops import stencils as tst
from pde_opt_tpu_torch.ops.steppers import gmres

torch.set_num_threads(1)
F64 = torch.float64


def test_implicit_euler_dahlquist():
    """Backward Euler on y' = -50y: stable at dt where explicit Euler blows up."""
    stepper = ImplicitEuler()
    y = torch.tensor([1.0], dtype=F64)
    dt = 0.1  # explicit Euler factor |1-5| = 4 -> divergent
    for i in range(10):
        y, _ = stepper.step(lambda y, t: -50.0 * y, y, i * dt, dt)
    np.testing.assert_allclose(float(y[0]), 1.0 / (1 + 50 * dt) ** 10, rtol=1e-5)
    assert float(y[0]) < 1.0


@pytest.mark.slow
def test_implicit_euler_stiff_diffusion():
    """Implicit Euler integrates 1D diffusion far beyond the explicit limit."""
    from pde_opt_tpu_torch import grid as tgrid

    N = 64
    domain = tgrid.Domain((N, 1), ((-1, 1), (-0.01, 0.01)), dtype=F64)
    hx = domain.dx[0]
    x = domain.axes()[0]
    y0 = torch.from_numpy(np.sin(np.pi * np.asarray(x))[:, None])
    dt = 10 * hx**2  # ~40x the explicit stability limit
    stepper = ImplicitEuler(newton_iters=3, gmres_iters=40)
    y = y0
    for i in range(20):
        y, _ = stepper.step(lambda y, t: tst.grad2_c(y, hx, -2), y, i * dt, dt)
    assert bool(torch.isfinite(y).all())
    assert float(y.abs().max()) < float(y0.abs().max())


def test_implicit_euler_convergence_diagnostics():
    """A well-posed stiff solve reports converged=True in few iterations; an
    absurd dt reports converged=False; the masked differentiable variant
    matches the host loop and is reverse-differentiable."""
    lam = 50.0

    def rhs(y, t):
        return -lam * y

    y0 = torch.ones((8, 8), dtype=F64)
    st = ImplicitEuler()
    y1, stats = st.solve_step(rhs, y0, 0.0, 0.1)
    np.testing.assert_allclose(y1.numpy(), (y0 / (1.0 + lam * 0.1)).numpy(), rtol=1e-6)
    assert bool(stats["converged"]) and int(stats["iterations"]) <= 3

    def hard_rhs(y, t):
        return -torch.exp(5.0 * y) * y + 10.0 * torch.sin(y)

    _, stats_bad = ImplicitEuler(newton_iters=2, gmres_iters=2).solve_step(
        hard_rhs, 3.0 * y0, 0.0, 50.0)
    assert not bool(stats_bad["converged"])

    st_diff = ImplicitEuler(differentiable=True)
    y1d, stats_d = st_diff.solve_step(rhs, y0, 0.0, 0.1)
    np.testing.assert_allclose(y1d.numpy(), y1.numpy(), rtol=1e-10)
    assert bool(stats_d["converged"])
    z = y0.clone().requires_grad_()
    (st_diff.solve_step(rhs, z, 0.0, 0.1)[0] ** 2).sum().backward()
    assert bool(torch.isfinite(z.grad).all())
    np.testing.assert_allclose(z.grad.numpy(), 2.0 / (1.0 + lam * 0.1) ** 2, rtol=1e-8)


# ---- parity with the JAX package ---------------------------------------------

def _nonlinear(pkg):
    """A stiff nonlinear rhs on a (2, 6, 6) f64 field: periodic diffusion
    plus a cubic reaction, in JAX or torch."""
    if pkg == "j":
        import jax.numpy as jnp

        def lap(y):
            return (jnp.roll(y, 1, -1) + jnp.roll(y, -1, -1) + jnp.roll(y, 1, -2)
                    + jnp.roll(y, -1, -2) - 4.0 * y)
    else:
        def lap(y):
            return (torch.roll(y, 1, -1) + torch.roll(y, -1, -1) + torch.roll(y, 1, -2)
                    + torch.roll(y, -1, -2) - 4.0 * y)

    def rhs(y, t):
        return 40.0 * lap(y) + y - y**3 + 0.5 * t

    return rhs


@pytest.mark.parametrize("kw", [{}, {"differentiable": True},
                                {"newton_iters": 3, "gmres_iters": 1, "tol": 1e-6}],
                         ids=["default", "differentiable", "loose"])
def test_solve_step_matches_jax(kw):
    """``solve_step`` and ``step`` on a stiff nonlinear rhs from the same
    f64 field: y1, the error estimate and the diagnostics equal JAX's."""
    import jax.numpy as jnp

    from pde_opt_tpu.ops.steppers import ImplicitEuler as JIE

    y0 = np.random.default_rng(0).uniform(-1, 1, (2, 6, 6))
    j, t = JIE(**kw), ImplicitEuler(**kw)
    assert t == ImplicitEuler(**kw) and hash(t) == hash(ImplicitEuler(**kw))
    jy, js = j.solve_step(_nonlinear("j"), jnp.asarray(y0), 0.3, 0.05)
    ty, ts = t.solve_step(_nonlinear("t"), torch.from_numpy(y0), 0.3, 0.05)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-12)
    assert int(ts["iterations"]) == int(js["iterations"])
    assert bool(ts["converged"]) == bool(js["converged"])
    np.testing.assert_allclose(float(ts["residual_norm"]), float(js["residual_norm"]),
                               rtol=1e-3, atol=1e-11)
    je = j.step(_nonlinear("j"), jnp.asarray(y0), 0.3, 0.05)[1]
    te = t.step(_nonlinear("t"), torch.from_numpy(y0), 0.3, 0.05)[1]
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-10, atol=1e-12)


def test_differentiable_gradient_matches_jax():
    """The gradient of sum(y1²) with respect to y0 through the masked loop
    against ``jax.grad`` of JAX's differentiable variant."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.ops.steppers import ImplicitEuler as JIE

    y0 = np.random.default_rng(1).uniform(-1, 1, (2, 6, 6))
    j = JIE(differentiable=True)
    want = jax.grad(lambda z: jnp.sum(j.solve_step(_nonlinear("j"), z, 0.3, 0.05)[0] ** 2))(
        jnp.asarray(y0))
    z = torch.from_numpy(y0).requires_grad_()
    (ImplicitEuler(differentiable=True).solve_step(_nonlinear("t"), z, 0.3, 0.05)[0] ** 2
     ).sum().backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("restart,maxiter", [(20, None), (3, 2), (5, 1)])
def test_gmres_matches_jax(restart, maxiter):
    """``gmres`` on a nonsymmetric 12 x 12 system against
    ``jax.scipy.sparse.linalg.gmres(..., solve_method="batched")``:
    ``restart`` vectors a cycle, ``maxiter`` cycles, tol relative to |b|."""
    import jax.numpy as jnp
    from jax.scipy.sparse.linalg import gmres as jgmres

    rng = np.random.default_rng(restart)
    A = np.eye(12) * 3.0 + 0.5 * rng.standard_normal((12, 12))
    b = rng.standard_normal((3, 4))
    Aj = jnp.asarray(A)
    want, _ = jgmres(lambda v: (Aj @ v.reshape(-1)).reshape(3, 4), jnp.asarray(b), tol=1e-10,
                     restart=restart, maxiter=maxiter, solve_method="batched")
    At = torch.from_numpy(A)
    got = gmres(lambda v: (At @ v.reshape(-1)).reshape(3, 4), torch.from_numpy(b), tol=1e-10,
                restart=restart, maxiter=maxiter)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    if maxiter is None:
        np.testing.assert_allclose(got.numpy().reshape(-1), np.linalg.solve(A, b.reshape(-1)),
                                   rtol=1e-8)
