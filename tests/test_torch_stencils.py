"""The port's stencils and spectral transforms: tests/test_stencils.py on
the port, and every name of the JAX modules' ``__all__`` against JAX's on
one numpy field (f64, 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_opt_tpu.ops import spectral as jsp
from pde_opt_tpu.ops import stencils as jst
from pde_opt_tpu_torch.ops import spectral as tsp
from pde_opt_tpu_torch.ops import stencils as st

torch.set_num_threads(1)


@pytest.fixture
def field():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.normal(size=(16, 24)))


def np_roll_lap(u, hx, hy):
    u = np.asarray(u)
    return (np.roll(u, -1, 0) - 2 * u + np.roll(u, 1, 0)) / hx**2 + (
        np.roll(u, -1, 1) - 2 * u + np.roll(u, 1, 1)
    ) / hy**2


def test_laplacian_2d_matches_numpy(field):
    got = st.lap_2nd_2d(field, 0.1, 0.2)
    np.testing.assert_allclose(got, np_roll_lap(field, 0.1, 0.2), rtol=1e-12)


def test_laplacian_generic_matches_2d(field):
    got = st.laplacian(field, (0.1, 0.2))
    np.testing.assert_allclose(got, st.lap_2nd_2d(field, 0.1, 0.2), rtol=1e-12)


def test_3d_laplacian():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(6, 7, 8))
    got = st.lap_2nd_3d(torch.from_numpy(u), 0.1, 0.2, 0.3)
    want = (
        (np.roll(u, -1, 0) - 2 * u + np.roll(u, 1, 0)) / 0.1**2
        + (np.roll(u, -1, 1) - 2 * u + np.roll(u, 1, 1)) / 0.2**2
        + (np.roll(u, -1, 2) - 2 * u + np.roll(u, 1, 2)) / 0.3**2
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_face_grad_avg_div_adjointness(field):
    """div_f2c is the (negative transpose) adjoint of grad_c2f on the torus."""
    hx = 0.1
    g = st.grad_c2f(field, hx, -2)
    d = st.div_f2c(g, hx, -2)
    # On a periodic grid, sum of divergence of any flux is 0.
    np.testing.assert_allclose(float(torch.sum(d)), 0.0, atol=1e-10)


def test_centered_gradient(field):
    got = st.grad_c(field, 0.1, -2)
    u = field.numpy()
    want = 0.5 * (np.roll(u, -1, 0) - np.roll(u, 1, 0)) / 0.1
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_mixed_second_derivative(field):
    got = st.grad2_cross_c(field, 0.1, 0.2, -2, -1)
    u = field.numpy()
    want = (
        np.roll(np.roll(u, -1, 0), -1, 1)
        + np.roll(np.roll(u, 1, 0), 1, 1)
        - np.roll(np.roll(u, -1, 0), 1, 1)
        - np.roll(np.roll(u, 1, 0), -1, 1)
    ) / (4.0 * 0.1 * 0.2)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_batch_transparency(field):
    """A leading batch axis must not change per-sample results."""
    batch = torch.stack([field, 2 * field, field**2])
    for fn in [
        lambda u: st.lap_2nd_2d(u, 0.1, 0.2),
        lambda u: st.grad_c2f(u, 0.1, -2),
        lambda u: st.avg_c2f(u, -1),
        lambda u: st.div_f2c(u, 0.1, -1),
        lambda u: st.grad_c(u, 0.3, -1),
    ]:
        got = fn(batch)
        for i in range(3):
            np.testing.assert_allclose(got[i], fn(batch[i]), rtol=1e-12)


def test_spatial_accuracy_second_order():
    """Stencils converge at 2nd order on a smooth periodic function."""
    errs = []
    for n in (32, 64, 128):
        x = (torch.arange(n, dtype=torch.float64) + 0.5) / n * 2 * np.pi
        X, Y = torch.meshgrid(x, x, indexing="ij")
        u = torch.sin(X) * torch.cos(2 * Y)
        h = float(2 * np.pi / n)
        lap = st.lap_2nd_2d(u, h, h)
        exact = -5 * u
        errs.append(float(torch.max(torch.abs(lap - exact))))
    order = np.log2(errs[0] / errs[1])
    assert 1.9 < order < 2.1
    order = np.log2(errs[1] / errs[2])
    assert 1.9 < order < 2.1


H3 = (0.1, 0.2, 0.3)
# Each stencil of the JAX module's __all__ on a (2, 6, 7, 8) field: its
# arguments after the field, for a 2D (trailing (7, 8)) or 3D call.
STENCILS = {
    "shift": [(1, -1), (-2, -3)],
    "grad_c2f": [(0.1, -2)], "avg_c2f": [(-1,)], "div_f2c": [(0.2, -3)],
    "grad_c": [(0.3, -1)], "grad2_c": [(0.1, -2)], "grad2_cross_c": [(0.1, 0.2, -3, -1)],
    "laplacian": [((0.1, 0.2),), (H3,), ((0.1, 0.2, 0.3), 2)],
    "lap_2nd_2d": [(0.1, 0.2)], "lap_2nd_3d": [H3],
    "gradx_c2f": [(0.1,), (0.1, 3)], "grady_c2f": [(0.2,), (0.2, 3)], "gradz_c2f": [(0.3,)],
    "avgx_c2f": [(), (3,)], "avgy_c2f": [(), (3,)], "avgz_c2f": [()],
    "divx_f2c": [(0.1,), (0.1, 3)], "divy_f2c": [(0.2,), (0.2, 3)], "divz_f2c": [(0.3,)],
    "gradx_c": [(0.1,), (0.1, 3)], "grady_c": [(0.2,), (0.2, 3)], "gradz_c": [(0.3,)],
    "grad2x_c": [(0.1,), (0.1, 3)], "grad2y_c": [(0.2,), (0.2, 3)], "grad2z_c": [(0.3,)],
    "grad2xy_c": [(0.1, 0.2), (0.1, 0.2, 3)],
}


def test_stencil_table_covers_the_jax_names():
    assert set(STENCILS) == set(jst.__all__) == set(st.__all__)


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_stencil_matches_jax(name):
    u = np.random.default_rng(2).normal(size=(2, 6, 7, 8))
    for args in STENCILS[name]:
        got = getattr(st, name)(torch.from_numpy(u), *args)
        want = np.asarray(getattr(jst, name)(jnp.asarray(u), *args))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name", ["fftn", "ifftn", "rfftn", "irfftn"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_spectral_matches_jax(name, ndim):
    u = np.random.default_rng(3).normal(size=(2, 6, 7, 8))
    if name == "irfftn":
        x = np.fft.rfftn(u, axes=tuple(range(-ndim, 0)))
        shape = u.shape[-ndim:]
        got = tsp.irfftn(torch.from_numpy(x), shape, ndim)
        want = jsp.irfftn(jnp.asarray(x), shape, ndim)
    else:
        got = getattr(tsp, name)(torch.from_numpy(u), ndim)
        want = getattr(jsp, name)(jnp.asarray(u), ndim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
