"""The port's smoothed-boundary geometry (``Shape``, the smoothed-boundary
Allen-Cahn, Cahn-Hilliard and Butler-Volmer equations,
``AdvectionDiffusion2D``, the SBM preset's ``smooth_geometry=True``) and the
mixed-derivative stencil they read, held against the JAX package on the same numpy inputs;
``tests/test_geometry.py`` mirrored.

Tolerances:

    grad2_cross_c (f64)                                  rtol 1e-12
    Shape.smooth at test_geometry.py's settings (f64)    atol 1e-10
    Shape.smooth in f32 against f64                      atol 5e-4
    laplacian_from_mask                                  equal CSR arrays
    get_shape_modes: eigenvalues                         atol 1e-10
        eigenvectors, through the projector onto each group of equal
        eigenvalues (the disk's modes come in degenerate pairs)      atol 1e-6
    smoothed-boundary rhs (f64)                          1e-12 of max |rhs|
    weighted-mass conservation (the JAX tests' bound)    atol 1e-10
    Shape from smooth_dt 0.1 (an overflowing first step) atol 1e-3 of JAX's
        at the SBM preset's 64^2 and ε, to t = 0.05    Shape(..., smooth_dt=1e-5),
                                                         whose error norms stay finite

The JAX ``Shape`` at its default ``smooth_dt = 0.1`` (the SBM preset's)
never accepts a step: its first Tsit5 step overflows, the error norm is
NaN and so is every later step size.  The port rejects such a step
(``integrate_adaptive``), so its run from ``smooth_dt = 0.1`` is compared
with JAX's from ``smooth_dt = 1e-5``, and the JAX failure is shown with
``max_steps`` capped through ``monkeypatch``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_opt_tpu as jp
import pde_opt_tpu.geometry as jgeometry
from pde_opt_tpu.envs import make_sbm_butler_volmer_control_env as jsbm
from pde_opt_tpu.ops import stencils as jst
from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.envs import make_sbm_butler_volmer_control_env as tsbm
from pde_opt_tpu_torch.envs.presets import BV_J0, BV_MU
from pde_opt_tpu_torch.geometry import Shape
from pde_opt_tpu_torch.models import (
    AdvectionDiffusion2D,
    AllenCahn2DSmoothedBoundary,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
    CahnHilliard2DSmoothedBoundary,
)
from pde_opt_tpu_torch.ops import stencils as tst

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 32
L = 1.0


@pytest.fixture
def f64():
    """The port's Shape integrates in the default dtype: f64 here, as the
    JAX package's does under x64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _disk_mask(radius_frac=1 / 3, n=N):
    yy, xx = np.mgrid[0:n, 0:n]
    return ((yy - n / 2) ** 2 + (xx - n / 2) ** 2 < (radius_frac * n) ** 2).astype(np.float64)


_SHAPE_KW = dict(dx=(L / N, L / N), smooth_epsilon=2 * L / N, smooth_dt=0.001, smooth_tf=0.02)
_SHAPES = {}


def _shapes():
    """(port Shape, JAX Shape) at tests/test_geometry.py's settings, built
    once (f64 both)."""
    if not _SHAPES:
        old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            _SHAPES["t"] = Shape(_disk_mask(), device=CPU, **_SHAPE_KW)
        finally:
            torch.set_default_dtype(old)
        _SHAPES["j"] = jgeometry.Shape(jnp.asarray(_disk_mask()), **_SHAPE_KW)
    return _SHAPES["t"], _SHAPES["j"]


def _domains(geometry=True):
    """Both packages' domains on one level set: the port's Shape, and for
    JAX the same psi (its equations read only ``geometry.smooth``)."""
    ts, _ = _shapes()
    box = ((-L / 2, L / 2), (-L / 2, L / 2))
    jgeom = types.SimpleNamespace(smooth=jnp.asarray(_np(ts.smooth))) if geometry else None
    return (tgrid.Domain((N, N), box, geometry=ts if geometry else None, dtype=torch.float64),
            jp.Domain((N, N), box, geometry=jgeom, dtype=jnp.float64))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel_close(got, want, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rel * np.abs(want).max())


def _preset_mask(n):
    dom = jp.Domain((n, n), ((-0.5, 0.5), (-0.5, 0.5)), dtype=jnp.float32)
    X, Y = (np.asarray(m) for m in dom.mesh())
    return (np.sqrt(X**2 + Y**2) < 0.35).astype(np.float32), dom.dx


_PRESETS = {}


def _smooth_preset(method):
    """The SBM preset at 24² with smooth_geometry=True (its Shape in f64),
    built once per method."""
    if method not in _PRESETS:
        old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            _PRESETS[method] = tsbm(num_envs=3, grid_size=24, substeps=2, smooth_geometry=True,
                                    method=method, device=CPU)
        finally:
            torch.set_default_dtype(old)
    return _PRESETS[method]


# ---- the mixed-derivative stencil ---------------------------------------------

@pytest.mark.parametrize("args", [(0.1, 0.07, -2, -1), (0.05, 0.2, -3, -1), (0.3, 0.1, -1, -2)])
def test_grad2_cross_c_matches_jax(args):
    x = np.random.default_rng(1).standard_normal((3, 8, 16, 24))
    np.testing.assert_allclose(_np(tst.grad2_cross_c(torch.from_numpy(x), *args)),
                               np.asarray(jst.grad2_cross_c(jnp.asarray(x), *args)),
                               rtol=1e-12, atol=1e-12)


# ---- Shape ------------------------------------------------------------------

def test_shape_smooth_matches_jax():
    ts, js = _shapes()
    assert ts.smooth.dtype == torch.float64 and ts.smooth.device == CPU
    np.testing.assert_allclose(_np(ts.smooth), np.asarray(js.smooth), rtol=0, atol=1e-10)
    assert ts.smooth_stats["accepted_steps"] > 0


def test_shape_smoothing_bounds_and_interior():
    """Mirror of test_geometry.py::test_shape_smoothing_bounds_and_interior."""
    psi = _np(_shapes()[0].smooth)
    assert psi.min() >= 0.001 and psi.max() <= 1.0
    assert psi[N // 2, N // 2] > 0.9
    assert psi[1, 1] < 0.05
    assert ((psi > 0.2) & (psi < 0.8)).sum() > 0


def test_shape_smooth_in_f32_by_default():
    shape = Shape(torch.from_numpy(_disk_mask()), device=CPU, **_SHAPE_KW)
    assert shape.smooth.dtype == torch.float32
    np.testing.assert_allclose(_np(shape.smooth), _np(_shapes()[0].smooth), rtol=0, atol=5e-4)


def test_shape_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Shape(_disk_mask(), **_SHAPE_KW)


@pytest.mark.parametrize("periodic", [False, True])
def test_laplacian_from_mask_matches_jax(periodic):
    ts, js = _shapes()
    (tl, tids), (jl, jids) = ts.laplacian_from_mask(periodic), js.laplacian_from_mask(periodic)
    np.testing.assert_array_equal(tids, jids)
    for a in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(tl, a), getattr(jl, a))
    assert tl.shape == jl.shape


def _projectors(evals, vecs, tol=1e-8):
    """The projector onto each group of equal eigenvalues, leaving out the
    last group (the subset may cut it)."""
    groups, start = [], 0
    for i in range(1, len(evals) + 1):
        if i == len(evals) or evals[i] - evals[start] > tol:
            groups.append((start, i))
            start = i
    return [vecs[:, a:b] @ vecs[:, a:b].T for a, b in groups[:-1]]


@pytest.mark.parametrize("dense", [True, False])
def test_shape_modes_match_jax(dense, monkeypatch):
    ts, js = _shapes()
    if not dense:
        # The LOBPCG branch, both packages.
        monkeypatch.setattr(Shape, "_DENSE_EIG_LIMIT", 16)
        monkeypatch.setattr(jgeometry.Shape, "_DENSE_EIG_LIMIT", 16)
    tb, tev = ts.get_shape_modes(10)
    jb, jev = js.get_shape_modes(10)
    assert tb.shape == (N, N, 10) and tb.dtype == torch.get_default_dtype()
    np.testing.assert_allclose(tev, np.asarray(jev), rtol=0, atol=1e-10)
    tv, jv = _np(tb).reshape(N * N, 10), np.asarray(jb).reshape(N * N, 10)
    pt, pj = _projectors(tev, tv / np.linalg.norm(tv, axis=0)), \
        _projectors(np.asarray(jev), jv / np.linalg.norm(jv, axis=0))
    assert len(pt) == len(pj) >= 3
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_shape_modes_graph_laplacian():
    """Mirror of test_geometry.py::test_shape_modes_graph_laplacian."""
    basis, evals = _shapes()[0].get_shape_modes(4)
    assert basis.shape == (N, N, 4)
    assert abs(evals[0]) < 1e-8
    mask = _disk_mask() > 0
    v0 = _np(basis[..., 0])[mask]
    np.testing.assert_allclose(v0, v0[0], atol=1e-6)
    assert np.all(_np(basis)[~mask] == 0)


# ---- the smoothed-boundary equations ---------------------------------------

def _u(seed, shape=(N, N), lo=0.05, hi=0.95):
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.05 * rng.standard_normal(shape), lo, hi)


def _f(c):
    return 0.25 * (c**2) * (1 - c) ** 2 + 1e-8


def test_sbm_cahn_hilliard_matches_jax_and_conserves_weighted_mass():
    td, jd = _domains()
    kw = dict(kappa=1e-3, f=_f, mu=lambda c: c**3 - c, theta=lambda t: np.pi / 3,
              flux=lambda t: 0.0)
    teq = CahnHilliard2DSmoothedBoundary(td, D=torch.ones_like, **kw)
    jeq = jp.CahnHilliard2DSmoothedBoundary(jd, D=jnp.ones_like, **kw)
    u = _u(0, (2, N, N))
    got = teq.rhs(torch.from_numpy(u), 0.0)
    _rel_close(got, jeq.rhs(jnp.asarray(u), 0.0))
    # Zero normal flux: the flux form telescopes, ∫ψ·rhs = 0 (each env).
    rate = (got * teq.psi).sum((-2, -1)) * td.dx[0] ** 2
    np.testing.assert_allclose(_np(rate), 0.0, atol=1e-10)
    # A contact mask and a normal flux of its own, and the 50-row default.
    mask = np.zeros((N, N))
    mask[:, :7] = 1.0
    kw.update(theta=lambda t: 0.4, flux=lambda t: 0.2)
    _rel_close(CahnHilliard2DSmoothedBoundary(td, D=lambda c: 1 + c, contact_mask=torch.from_numpy(mask),
                                              **kw).rhs(torch.from_numpy(u), 0.0),
               jp.CahnHilliard2DSmoothedBoundary(jd, D=lambda c: 1 + c, contact_mask=jnp.asarray(mask),
                                                 **kw).rhs(jnp.asarray(u), 0.0))
    assert float(teq.left_half[:50].min()) == 1.0 and teq.left_half.shape == (N, N)


def test_sbm_allen_cahn_matches_jax_finite_and_batched():
    td, jd = _domains()
    kw = dict(kappa=1e-3, f=_f, mu=lambda c: c**3 - c, theta=lambda t: np.pi / 3)
    teq = AllenCahn2DSmoothedBoundary(td, R=torch.ones_like, **kw)
    jeq = jp.AllenCahn2DSmoothedBoundary(jd, R=jnp.ones_like, **kw)
    u = _u(1, (3, N, N))
    r = teq.rhs(torch.from_numpy(u), 0.0)
    _rel_close(r, jeq.rhs(jnp.asarray(u), 0.0))
    assert r.shape == (3, N, N) and bool(torch.isfinite(r).all())
    np.testing.assert_allclose(_np(r[1]), _np(teq.rhs(torch.from_numpy(u[1]), 0.0)), rtol=1e-12)
    _rel_close(AllenCahn2DSmoothedBoundary(td, R=lambda c: 1 + c, contact_cols=5, **kw)
               .rhs(torch.from_numpy(u), 0.0),
               jp.AllenCahn2DSmoothedBoundary(jd, R=lambda c: 1 + c, contact_cols=5, **kw)
               .rhs(jnp.asarray(u), 0.0))


@pytest.mark.parametrize("smooth,derivs,use_rfft", [
    (True, "fd", True), (False, "fd", True), (False, "fourier", True), (False, "fourier", False),
])
def test_advection_diffusion_matches_jax(smooth, derivs, use_rfft):
    td, jd = _domains()

    def vel(xp):
        return lambda t, X, Y: (0.3 * xp.ones_like(X) + 0.1 * xp.sin(6.0 * Y), -0.2 * xp.cos(4.0 * X))

    kw = dict(diffusion_coeff=0.05, smooth=smooth, derivs=derivs, use_rfft=use_rfft)
    teq = AdvectionDiffusion2D(td, vel(torch), device=CPU, **kw)
    jeq = jp.AdvectionDiffusion2D(jd, vel(jnp), **kw)
    u = _u(2, lo=0.0, hi=1.0)
    _rel_close(teq.rhs(torch.from_numpy(u), 0.0), jeq.rhs(jnp.asarray(u), 0.0))
    _rel_close(teq.fourier_symbol, jeq.fourier_symbol)


def test_smoothed_advection_diffusion_conserves_weighted_mass():
    """Mirror of test_geometry.py::test_smoothed_advection_diffusion_conserves_weighted_mass."""
    td, _ = _domains()
    eq = AdvectionDiffusion2D(td, lambda t, X, Y: (0.3 * torch.ones_like(X), -0.2 * torch.ones_like(Y)),
                              diffusion_coeff=0.05, smooth=True)
    assert eq.device == CPU
    u = torch.from_numpy(_u(2, lo=0.0, hi=1.0))
    rate = float((eq.rhs(u, 0.0) * eq.psi).sum()) * td.dx[0] ** 2
    np.testing.assert_allclose(rate, 0.0, atol=1e-10)
    with pytest.raises(ValueError, match="smoothed-boundary requires"):
        AdvectionDiffusion2D(td, lambda t, X, Y: (X, Y), 0.1, smooth=True, derivs="fourier")


def test_sbm_butler_volmer_default_psi_is_the_geometry():
    td, jd = _domains()
    kw = dict(kappa=5e-4, f=lambda c: 3.0 * c * (1.0 - c), alpha=0.5, Crate=1.3)
    teq = AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(td, mu=BV_MU, j0=BV_J0, **kw)
    assert teq.psi is td.geometry.smooth and teq.device == CPU
    jeq = jp.AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(
        jd, mu=lambda c: (jnp.log(jnp.clip(c, 1e-4, 1 - 1e-4) / (1 - jnp.clip(c, 1e-4, 1 - 1e-4)))
                          + 3.0 * (1 - 2 * c)),
        j0=lambda c: jnp.sqrt(jnp.maximum(c * (1 - c), 1e-6)), **kw)
    u = _u(3, (2, N, N), 0.01, 0.99) * 0.2
    _rel_close(teq.rhs(torch.from_numpy(u), 0.0), jeq.rhs(jnp.asarray(u), 0.0))
    with pytest.raises(ValueError, match="geometry is None"):
        AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(_domains(False)[0], mu=BV_MU,
                                                               j0=BV_J0, **kw)


# ---- the SBM preset's smooth_geometry=True ------------------------------------

def test_jax_smooth_geometry_at_its_default_step_accepts_nothing(monkeypatch):
    """The JAX Shape at the SBM preset's settings (24², ε = 4 dx, default
    smooth_dt 0.1): capped at 50 attempts, it accepts no step and returns
    the clamped mask.  (The port's preset converges from the same start:
    ``test_sbm_preset_smooth_geometry``.)"""
    stats = []
    orig = jgeometry.integrate_adaptive

    def capped(*args, **kw):
        ys, st = orig(*args, max_steps=50, return_stats=True, **kw)
        stats.append({k: int(v) for k, v in st.items()})
        return ys

    monkeypatch.setattr(jgeometry, "integrate_adaptive", capped)
    mask, dx = _preset_mask(24)
    shape = jgeometry.Shape(jnp.asarray(mask), dx=dx, smooth_epsilon=4.0 * dx[0])
    assert stats == [{"accepted_steps": 0, "rejected_steps": 50}]
    np.testing.assert_array_equal(np.asarray(shape.smooth), np.where(mask > 0, 1.0, 0.001))


def test_shape_from_an_overflowing_first_step_matches_jax(f64):
    """At the SBM preset's grid (64²) and ε (4 dx), from its smooth_dt 0.1
    (a first step that overflows, rejected), over the first 0.02 of the
    flow: within 1e-3 of JAX's Shape run from smooth_dt 1e-5, whose error
    norms stay finite.  From 1e-5 the port's run stays within 1e-5 of
    JAX's (roundings move the step placement over the run's few hundred
    steps)."""
    mask, dx = _preset_mask(64)
    kw = dict(dx=dx, smooth_epsilon=4.0 * dx[0], smooth_tf=0.02)
    want = np.asarray(jgeometry.Shape(jnp.asarray(mask), smooth_dt=1e-5, **kw).smooth)
    got = Shape(mask, smooth_dt=0.1, device=CPU, **kw)
    assert got.smooth_stats["rejected_steps"] >= 4 and got.smooth_stats["accepted_steps"] > 100
    np.testing.assert_allclose(_np(got.smooth), want, rtol=0, atol=1e-3)
    same = Shape(mask, smooth_dt=1e-5, device=CPU, **kw)
    np.testing.assert_allclose(_np(same.smooth), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["fused", "rk4"])
def test_sbm_preset_smooth_geometry(method):
    """The preset's psi is the Shape of its binary disk at the Shape's
    defaults (ε = 4 dx, smooth_dt 0.1, whose first step overflows and is
    rejected), in the fleet's dtype, and the fleet steps on it.  (The full
    flow to t = 1 at 24² is not compared with JAX: there it breaks the
    disk's symmetry, and two runs a rounding apart, JAX's and the port's
    from the same smooth_dt in f64, end 8.6e-3 apart; at 64², where it is
    stable, they agree to 5e-5, a run of over a minute on the CPU that
    chip_smoke.py makes on the card.)"""
    env = _smooth_preset(method)
    psi = env.static_equation_parameters["psi"]
    mask, dx = _preset_mask(24)
    shape = env.shape
    assert torch.equal(shape.binary, torch.from_numpy(mask))
    assert (shape.dx, shape.smooth_epsilon, shape.smooth_curvature, shape.smooth_dt,
            shape.smooth_tf) == (dx, 4.0 * dx[0], 0.0, 0.1, 1.0)
    assert shape.smooth.dtype == torch.float64 and shape.smooth_stats["rejected_steps"] >= 4
    assert psi.dtype == torch.float32 and torch.equal(psi, shape.smooth.float())
    other = _smooth_preset("rk4" if method == "fused" else "fused")
    assert torch.equal(other.static_equation_parameters["psi"], psi)
    assert float(psi.max()) == 1.0 and float(psi.min()) >= 0.001
    assert int(((psi > 0.2) & (psi < 0.8)).sum()) > 0
    state, _ = env.reset(torch.Generator().manual_seed(4))
    state, rewards, _ = env.rollout(state, lambda o, g: torch.zeros((3, 1)), 3)
    assert bool(torch.isfinite(rewards).all()) and bool(torch.isfinite(state.y).all())
    assert tsbm(num_envs=2, grid_size=24, method=method, device=CPU).shape is None


def test_sbm_preset_smooth_geometry_steps_like_jax_on_its_psi():
    """From one shared state, one step of the port's smooth-psi fleet against
    the JAX RK4 path on the same psi (the JAX preset's analytic psi swapped
    for the port's): rewards and fields."""
    from pde_opt_tpu.envs.vector_env import VectorPDEEnv as JEnv
    from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy

    te = _smooth_preset("rk4")
    psi = _np(te.static_equation_parameters["psi"])
    je = jsbm(num_envs=3, grid_size=24, substeps=2, method="rk4")
    je_args = {k: getattr(je, k) for k in (
        "equation_type", "domain", "solver_type", "end_time", "step_dt", "numeric_dt",
        "reset_func", "reset_control_value", "update_control_value", "update_control_parameter",
        "control_equation_parameter_name", "solver_parameters", "num_envs", "auto_reset")}
    jpsi = jnp.asarray(psi)
    je2 = JEnv(**je_args, state_to_observation_func=lambda y: jnp.clip(y * jpsi * 255.0, 0, 255)
               .astype(jnp.uint8)[..., None, :, :],
               reward_function=lambda y: jnp.sum(jpsi * y) / jnp.sum(jpsi),
               action_space_config=je.action_space_config,
               static_equation_parameters={**je.static_equation_parameters, "psi": jpsi},
               vectorized_control=True)
    js, _ = je2.reset(jax.random.PRNGKey(1))
    te.reset(torch.Generator().manual_seed(0))
    ts = env_state_from_numpy(js, device=CPU)
    a = np.array([[0.5], [-1.0], [0.0]], np.float32)
    js, jo, *_ = je2.step(js, jnp.asarray(a))
    ts, to, *_ = te.step(ts, torch.from_numpy(a))
    np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), rtol=0, atol=2e-5)
    assert np.abs(_np(to).astype(int) - np.asarray(jo).astype(int)).max() <= 1
