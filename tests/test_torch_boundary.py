"""The port's ghost-cell boundary operators (``ops/boundary.py``):
``tests/test_boundary.py``'s seven checks mirrored, and the Laplacian on
mixed boundary conditions held against the JAX package's on the same
float64 inputs (rtol 1e-12), with its gradient."""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.ops.boundary import get_neighbor_indices, laplacian, pad_ghost

torch.set_num_threads(1)


def test_periodic_1d_matches_circulant():
    lap = laplacian(dx=0.1, boundary_conditions={0: ("periodic", None)})
    test = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    mat = torch.tensor([[-2, 1, 1], [1, -2, 1], [1, 1, -2]], dtype=torch.float64) / 0.1**2
    np.testing.assert_allclose(lap(test).numpy(), (mat @ test).numpy(), rtol=1e-6, atol=1e-9)


def test_dirichlet_zero_1d():
    lap = laplacian(dx=1.0, boundary_conditions={0: ("dirichlet", 0.0)})
    got = lap(torch.tensor([1.0, 1.0, 1.0]))
    # ghost = 2*0 - u_edge = -1 -> lap at edges = (-1 - 2*1 + 1)/1 = -2
    np.testing.assert_allclose(got.numpy(), [-2.0, 0.0, -2.0])


def test_neumann_zero_flux_constant_field():
    """Zero Neumann: a constant field has exactly zero Laplacian."""
    lap = laplacian(dx=(0.5, 0.5),
                    boundary_conditions={0: ("neumann", 0.0), 1: ("neumann", 0.0)})
    u = 3.0 * torch.ones((5, 7), dtype=torch.float64)
    np.testing.assert_allclose(lap(u).numpy(), np.zeros((5, 7)), atol=1e-12)


def test_mixed_2d_and_time_arg():
    lap = laplacian(dx=(0.1, 0.1),
                    boundary_conditions={0: ("dirichlet", 0.0), 1: ("periodic", None)})
    out = lap(torch.ones((3, 3)), 0.0)  # accepts an (ignored) time argument
    assert out.shape == (3, 3)
    assert bool(torch.isfinite(out).all())


def test_dirichlet_array_boundary_values():
    g = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    lap = laplacian(dx=(0.1, 0.1),
                    boundary_conditions={0: ("dirichlet", g), 1: ("periodic", None)})
    out = lap(torch.zeros((4, 3), dtype=torch.float64))
    # Top ghost row = 2g; contribution to row 0: 2g/h^2
    np.testing.assert_allclose(out[0].numpy(), 2 * g.numpy() / 0.01, rtol=1e-6)


def test_batch_transparency():
    lap = laplacian(dx=(0.2, 0.3),
                    boundary_conditions={0: ("neumann", 0.0), 1: ("dirichlet", 1.0)})
    u = torch.arange(2 * 4 * 5, dtype=torch.float64).reshape(2, 4, 5)
    np.testing.assert_allclose(lap(u)[1].numpy(), lap(u[1]).numpy(), rtol=1e-12)


def test_get_neighbor_indices():
    nb = get_neighbor_indices((4, 4), (0, 2))
    assert (3, 2) in nb  # periodic wrap on axis 0
    nb2 = get_neighbor_indices((4, 4), (0, 2), boundary_conditions={0: ("dirichlet", 0.0)})
    assert None in nb2  # outside a Dirichlet wall
    assert (1, 2) in nb2


# ---- parity with the JAX package ---------------------------------------------

MIXED = [
    ({0: ("dirichlet", 0.3), 1: ("neumann", -0.7)}, (0.1, 0.2)),
    ({0: ("periodic", None), 1: ("dirichlet", "array")}, (0.05, 0.1)),
    ({0: ("neumann", 0.0), 1: ("periodic", None)}, (0.2, 0.05)),
]


@pytest.mark.parametrize("bcs,dx", MIXED, ids=["dir-neu", "per-dirarray", "neu-per"])
def test_laplacian_matches_jax_on_mixed_bcs(bcs, dx):
    """A batch (3, 6, 9) of f64 fields through the port's and JAX's
    Laplacian, with Dirichlet values as scalars and as a per-row array."""
    import jax.numpy as jnp

    from pde_opt_tpu.ops.boundary import laplacian as jlap

    rng = np.random.default_rng(sum(map(ord, str(bcs))))
    u = rng.standard_normal((3, 6, 9))
    g = rng.standard_normal((6, 1))           # broadcasts to the (6, 1) boundary slice

    def resolve(pkg):
        conv = torch.from_numpy if pkg == "t" else jnp.asarray
        return {k: (kind, conv(g) if v == "array" else v) for k, (kind, v) in bcs.items()}

    want = np.asarray(jlap(dx, resolve("j"))(jnp.asarray(u)))
    got = laplacian(dx, resolve("t"))(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)


def test_pad_ghost_and_laplacian_are_differentiable():
    """The gradient of sum(lap(u)²) with respect to u and to a tensor
    Dirichlet value, against JAX's ``jax.grad`` of the same function."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.ops.boundary import laplacian as jlap

    rng = np.random.default_rng(11)
    u, gv = rng.standard_normal((5, 7)), rng.standard_normal((1, 7))

    def jloss(uu, gg):
        return jnp.sum(jlap((0.1, 0.2), {0: ("dirichlet", gg), 1: ("neumann", 0.5)})(uu) ** 2)

    ju, jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(gv))
    ut = torch.from_numpy(u).requires_grad_()
    gt = torch.from_numpy(gv).requires_grad_()
    (laplacian((0.1, 0.2), {0: ("dirichlet", gt), 1: ("neumann", 0.5)})(ut) ** 2).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(ju), rtol=1e-10)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(jg), rtol=1e-10)
    with pytest.raises(ValueError, match="unknown boundary condition"):
        pad_ghost(ut, -1, 0.1, ("robin", 1.0))
    with pytest.raises(ValueError, match="every axis"):
        laplacian((0.1, 0.1), {0: ("periodic", None)})
