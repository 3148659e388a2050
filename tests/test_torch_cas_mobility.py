"""The port's general-mobility CH macros (``pde_opt_tpu_torch/ops/cas_mobility.py``),
``FusedMobilitySpectral`` and the Legendre coefficient modules, held against
the JAX package: every test of ``tests/test_cas_mobility.py`` and the
Legendre half of ``tests/test_functions.py``, on the same seeded numpy
inputs.

On the CPU the ``"pallas"`` macros run the fused rhs's plain version (the
JAX macros run their kernel in interpret mode) and ``"auto"`` runs the roll
chain (``"xla"``).  The JAX macros run under ``jax.jit``: XLA's CPU runtime
dispatches no eager bf16 x bf16 -> f32 product.  Tolerances:

    macro vs its FFT oracle, f32 matrices        atol 1e-6 (the JAX tests')
    macro vs the JAX macro, f32 matrices         atol 1e-6 (f32 rounding)
    solve vs the JAX solve, bf16 matrices        atol 4e-3 (the bf16 bound of
                                                 ROADMAP.md's North star; the
                                                 same rounding sites, but the
                                                 cas matrices' few-bit entries
                                                 put many f32 sums on bf16
                                                 ties, which two summation
                                                 orders round apart: measured
                                                 8.0e-4 at 2 x 5 substeps)
    "pallas" vs "xla"                            atol 2e-5 (the JAX tests')
    gradients vs the oracle's (port)             the JAX tests' bounds
    gradients vs jax.grad of the JAX macro, f32  du atol 1e-5, dκ rtol 1e-4
    gradients vs jax.grad, bf16 matrices         max err <= 1e-2 of max|grad|
                                                 (bf16 rounds the cotangent
                                                 in both; two correct orders
                                                 flip roundings)
    Legendre modules vs numpy legval             rtol 1e-5, atol 1e-7 (the
                                                 JAX tests')

Tests marked ``cuda`` run the 3D macro on the card (K8 forward, roll-chain
backward) against the same call on the CPU and skip without one; JAX is
imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch
from numpy.polynomial.legendre import legval as np_legval

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.models.cahn_hilliard import (
    CahnHilliard2DPeriodic as TCH2,
    CahnHilliard3DPeriodic as TCH3,
)
from pde_opt_tpu_torch.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomials,
    legendre_from_numpy,
    legval,
)
from pde_opt_tpu_torch.models.pde_model import PDEModel
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.cas_mobility import (
    ch3d_mobility_macro_reference,
    ch_mobility_macro_reference,
    make_ch3d_mobility_cas_macro,
    make_ch_mobility_cas_macro,
)
from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
from pde_opt_tpu_torch.ops.fused import make_ch3d_rhs_fd_fused
from pde_opt_tpu_torch.ops.fused_spectral import ch_sif_macro_reference
from pde_opt_tpu_torch.ops.integrate import evolve
from pde_opt_tpu_torch.ops.steppers import FusedMobilitySpectral
from pde_opt_tpu_torch.utils.compat import prepare_solver_params

torch.set_num_threads(1)

MU = PolynomialMu((0.0, -1.0, 0.0, 1.0))          # c**3 - c
D = PolynomialMu((1.0, 0.0, 0.5))                 # 1 + 0.5 c**2, smooth non-unit mobility
F32, BF16 = torch.float32, torch.bfloat16


def _jfns():
    import jax.numpy as jnp

    return (lambda c: c**3 - c), (lambda c: 1.0 + 0.5 * c**2), jnp


def _u(shape, seed):
    rng = np.random.default_rng(seed)
    return (0.5 + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def _t(*arrs):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrs)


def _jit(fn):
    import jax

    return jax.jit(fn)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---- tests/test_cas_mobility.py ---------------------------------------------------

def test_2d_matches_fft_oracle_per_env_kappa():
    from pde_opt_tpu.ops.cas_mobility import make_ch_mobility_cas_macro as jmake

    jmu, jd, jnp = _jfns()
    u = _u((4, 16, 16), 0)
    h = 1.0 / 16
    kap = np.linspace(2e-3, 8e-3, 4).astype(np.float32)
    macro = make_ch_mobility_cas_macro(MU, D, 16, 16, h, h, 1.0, 1e-5, 5, mats_dtype=F32)
    ref = ch_mobility_macro_reference(MU, D, h, h, 1.0, 1e-5, 5)
    got = macro(*_t(u, kap))
    _close(got, ref(*_t(u, kap)), 1e-6)
    want = _jit(jmake(jmu, jd, 16, 16, h, h, 1.0, 1e-5, 5, mats_dtype=jnp.float32))(
        jnp.asarray(u), jnp.asarray(kap))
    _close(got, want, 1e-6)


def test_2d_unit_mobility_matches_sif_scheme():
    """With D ≡ 1 the roll-rhs + cas-solve update is the unit-mobility SIF
    scheme (C[lap_roll z] = λ·C[z] exactly)."""
    from pde_opt_tpu.ops.cas_mobility import make_ch_mobility_cas_macro as jmake

    jmu, _, jnp = _jfns()
    u = _u((3, 16, 16), 1)
    h = 1.0 / 16
    kap = np.full((3,), 4e-3, np.float32)
    macro = make_ch_mobility_cas_macro(MU, PolynomialMu((1.0,)), 16, 16, h, h, 0.5, 1e-5, 4,
                                       mats_dtype=F32)
    sif = ch_sif_macro_reference(MU, h, h, 0.5, 1e-5, 4)
    got = macro(*_t(u, kap))
    _close(got, sif(*_t(u, kap)), 1e-6)
    want = _jit(jmake(jmu, lambda c: jnp.ones_like(c), 16, 16, h, h, 0.5, 1e-5, 4,
                      mats_dtype=jnp.float32))(jnp.asarray(u), jnp.asarray(kap))
    _close(got, want, 1e-6)


def test_2d_conserves_mass():
    """The conservative face-flux form telescopes: per-env mean is exact."""
    u = torch.from_numpy(_u((2, 24, 24), 2))
    h = 1.0 / 24
    macro = make_ch_mobility_cas_macro(MU, D, 24, 24, h, h, 1.0, 1e-5, 20, mats_dtype=F32)
    u1 = macro(u, 4e-3)
    _close(u1.mean(dim=(-2, -1)), u.mean(dim=(-2, -1)), 1e-6)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_2d_grads_match_oracle_native_diff(mats):
    import jax

    from pde_opt_tpu.ops.cas_mobility import make_ch_mobility_cas_macro as jmake

    jmu, jd, jnp = _jfns()
    u = _u((2, 16, 16), 3)
    h = 1.0 / 16
    kap = np.array([3e-3, 5e-3], np.float32)
    tdt, jdt = (F32, jnp.float32) if mats == "f32" else (BF16, jnp.bfloat16)
    macro = make_ch_mobility_cas_macro(MU, D, 16, 16, h, h, 1.0, 1e-5, 3, mats_dtype=tdt)
    x, k = (t.clone().requires_grad_() for t in _t(u, kap))
    (macro(x, k) ** 2).sum().backward()
    jm = jmake(jmu, jd, 16, 16, h, h, 1.0, 1e-5, 3, mats_dtype=jdt)
    gu_j, gk_j = _jit(jax.grad(lambda a, kk: jnp.sum(jm(a, kk) ** 2), argnums=(0, 1)))(
        jnp.asarray(u), jnp.asarray(kap))
    if mats == "f32":
        ref = ch_mobility_macro_reference(MU, D, h, h, 1.0, 1e-5, 3)
        xr, kr = (t.clone().requires_grad_() for t in _t(u, kap))
        (ref(xr, kr) ** 2).sum().backward()
        _close(x.grad, xr.grad, 1e-5)
        _close(k.grad, kr.grad, 1e-8, rtol=1e-4)
        _close(x.grad, gu_j, 1e-5)
        _close(k.grad, gk_j, 1e-8, rtol=1e-4)
    else:
        for got, want in ((x.grad, gu_j), (k.grad, gk_j)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()


def test_2d_grads_flow_to_learnable_mobility_params():
    """Parameters closed over by D_fn get native gradients, as jax.grad
    gives them (the training path of Legendre D)."""
    import jax

    from pde_opt_tpu.ops.cas_mobility import make_ch_mobility_cas_macro as jmake

    jmu, _, jnp = _jfns()
    u = _u((2, 16, 16), 4)
    h = 1.0 / 16
    theta = torch.tensor([0.3, 0.2], requires_grad=True)
    Dp = lambda c: 1.0 + theta[0] * c + theta[1] * c**2  # noqa: E731
    macro = make_ch_mobility_cas_macro(MU, Dp, 16, 16, h, h, 1.0, 1e-5, 3, mats_dtype=F32)
    (macro(torch.from_numpy(u), 4e-3) ** 2).sum().backward()
    g = theta.grad
    assert g.shape == (2,) and bool(torch.isfinite(g).all()) and float(g.abs().min()) > 0.0

    def loss(th):
        m = jmake(jmu, lambda c: 1.0 + th[0] * c + th[1] * c**2, 16, 16, h, h, 1.0, 1e-5, 3,
                  mats_dtype=jnp.float32)
        return jnp.sum(m(jnp.asarray(u), 4e-3) ** 2)

    _close(g, _jit(jax.grad(loss))(jnp.asarray([0.3, 0.2], jnp.float32)), 0.0, rtol=1e-4)


def test_3d_matches_fft_oracle():
    from pde_opt_tpu.ops.cas_mobility import make_ch3d_mobility_cas_macro as jmake

    jmu, jd, jnp = _jfns()
    u = _u((2, 8, 8, 8), 5)
    h = 1.0 / 8
    kap = np.array([2e-3, 6e-3], np.float32)
    macro = make_ch3d_mobility_cas_macro(MU, D, 8, 8, 8, h, h, h, 1.0, 1e-6, 4, mats_dtype=F32)
    ref = ch3d_mobility_macro_reference(MU, D, h, h, h, 1.0, 1e-6, 4)
    got = macro(*_t(u, kap))
    _close(got, ref(*_t(u, kap)), 1e-6)
    want = _jit(jmake(jmu, jd, 8, 8, 8, h, h, h, 1.0, 1e-6, 4, mats_dtype=jnp.float32))(
        jnp.asarray(u), jnp.asarray(kap))
    _close(got, want, 1e-6)


def test_3d_stab_scale_stabilizes_large_mobility():
    """D ~ 25: stab_scale = Dmax keeps the update stable at the same dt, in
    the port as in JAX."""
    from pde_opt_tpu.ops.cas_mobility import make_ch3d_mobility_cas_macro as jmake

    jmu, _, jnp = _jfns()
    u = _u((2, 16, 16, 16), 6)
    h = 1.0 / 16
    macro = make_ch3d_mobility_cas_macro(MU, PolynomialMu((25.0,)), 16, 16, 16, h, h, h, 1.0,
                                         2e-7, 200, stab_scale=25.0, mats_dtype=F32)
    out = macro(torch.from_numpy(u), 4e-3)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) < 10.0
    want = _jit(jmake(jmu, lambda c: 25.0 * jnp.ones_like(c), 16, 16, 16, h, h, h, 1.0, 2e-7,
                      200, stab_scale=25.0, mats_dtype=jnp.float32))(jnp.asarray(u), 4e-3)
    _close(out, want, 1e-5)


def test_stepper_dispatches_rank_and_matches_macro():
    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.cahn_hilliard import CahnHilliard2DPeriodic as JCH2
    from pde_opt_tpu.ops.integrate import evolve as jevolve
    from pde_opt_tpu.ops.steppers import FusedMobilitySpectral as JFMS
    from pde_opt_tpu.utils.compat import prepare_solver_params as jprep

    jmu, jd, jnp = _jfns()
    u = _u((3, 16, 16), 7)
    box = ((-0.5, 0.5), (-0.5, 0.5))
    kap = np.linspace(2e-3, 6e-3, 3).astype(np.float32)
    eq = TCH2(tgrid.Domain((16, 16), box), torch.from_numpy(kap)[:, None, None], MU, D)
    solver = FusedMobilitySpectral(**prepare_solver_params(FusedMobilitySpectral, {"A": 1.0}, eq),
                                   mats_dtype=F32)
    out = evolve(solver, eq.rhs, torch.from_numpy(u), 0.0, 1e-5, 4)
    ref = ch_mobility_macro_reference(MU, D, 1 / 16, 1 / 16, 1.0, 1e-5, 4)
    _close(out, ref(*_t(u, kap)), 1e-6)
    jeq = JCH2(JDomain((16, 16), box, dtype=jnp.float32), jnp.asarray(kap)[:, None, None],
               jmu, jd)
    jsolver = JFMS(**jprep(JFMS, {"A": 1.0}, jeq), mats_dtype=jnp.float32)
    want = _jit(lambda y: jevolve(jsolver, jeq.rhs, y, 0.0, 1e-5, 4))(jnp.asarray(u))
    _close(out, want, 1e-6)
    with pytest.raises(ValueError, match="2D/3D"):
        FusedMobilitySpectral(1e-3, MU, D, tgrid.Domain((16,), ((0, 1),))).evolve(
            None, torch.zeros(2, 16), 0.0, 1e-5, 1)


def test_2d_pallas_rhs_matches_xla_macro():
    """rhs_impl='pallas' (the fused rhs, its plain version on the CPU) matches
    the roll-chain macro, and state/κ gradients flow through its oracle
    VJP; the JAX pallas macro agrees."""
    import jax

    from pde_opt_tpu.ops.cas_mobility import make_ch_mobility_cas_macro as jmake

    jmu, jd, jnp = _jfns()
    u = _u((3, 16, 16), 8)
    h = 1.0 / 16
    kap = np.linspace(2e-3, 6e-3, 3).astype(np.float32)
    fast = make_ch_mobility_cas_macro(MU, D, 16, 16, h, h, 1.0, 1e-5, 4, mats_dtype=F32,
                                      rhs_impl="pallas")
    ref = make_ch_mobility_cas_macro(MU, D, 16, 16, h, h, 1.0, 1e-5, 4, mats_dtype=F32,
                                     rhs_impl="xla")
    _close(fast(*_t(u, kap)), ref(*_t(u, kap)), 2e-5)
    grads = []
    for m in (fast, ref):
        x, k = (t.clone().requires_grad_() for t in _t(u, kap))
        (m(x, k) ** 2).sum().backward()
        grads.append((x.grad, k.grad))
    _close(grads[0][0], grads[1][0], 1e-5)
    _close(grads[0][1], grads[1][1], 1e-8, rtol=1e-4)
    jm = jmake(jmu, jd, 16, 16, h, h, 1.0, 1e-5, 4, mats_dtype=jnp.float32, rhs_impl="pallas")
    gu_j, gk_j = jax.grad(lambda a, kk: jnp.sum(jm(a, kk) ** 2), argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(kap))
    _close(grads[0][0], gu_j, 1e-5)
    _close(grads[0][1], gk_j, 1e-8, rtol=1e-4)


def test_3d_pallas_rhs_matches_xla_macro():
    u = _u((2, 8, 8, 8), 9)
    h = 1.0 / 8
    kap = np.array([2e-3, 6e-3], np.float32)
    fast = make_ch3d_mobility_cas_macro(MU, D, 8, 8, 8, h, h, h, 1.0, 1e-6, 4, mats_dtype=F32,
                                        rhs_impl="pallas")
    ref = make_ch3d_mobility_cas_macro(MU, D, 8, 8, 8, h, h, h, 1.0, 1e-6, 4, mats_dtype=F32,
                                       rhs_impl="xla")
    _close(fast(*_t(u, kap)), ref(*_t(u, kap)), 2e-5)
    grads = []
    for m in (fast, ref):
        x, k = (t.clone().requires_grad_() for t in _t(u, kap))
        (m(x, k) ** 2).sum().backward()
        grads.append((x.grad, k.grad))
    _close(grads[0][0], grads[1][0], 1e-5)
    _close(grads[0][1], grads[1][1], 1e-8, rtol=1e-4)
    with pytest.raises(ValueError, match="rhs_impl"):
        make_ch3d_mobility_cas_macro(MU, D, 8, 8, 8, h, h, h, 1.0, 1e-6, 4, rhs_impl="nope")


def test_3d_fused_rhs_kernel_matches_model_rhs():
    """The raw 3D fused rhs against CahnHilliard3DPeriodic.rhs_fd, in the
    port and against the JAX model's rhs."""
    import jax.numpy as jnp

    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.cahn_hilliard import CahnHilliard3DPeriodic as JCH3

    jmu, jd, _ = _jfns()
    u = _u((3, 8, 8, 8), 10)
    L = 0.08
    h = L / 8
    box = ((-L / 2, L / 2),) * 3
    eq = TCH3(tgrid.Domain((8, 8, 8), box), 3e-3, MU, D, derivs="fd", device="cpu")
    ref = eq.rhs(torch.from_numpy(u), 0.0).double().numpy()
    got = make_ch3d_rhs_fd_fused(MU, D, h, h, h)(torch.from_numpy(u), 3e-3).double().numpy()
    _close(got, ref, 1e-5 * np.abs(ref).max())
    jref = np.asarray(JCH3(JDomain((8, 8, 8), box, dtype=jnp.float32), 3e-3, jmu, jd,
                           derivs="fd").rhs(jnp.asarray(u), 0.0), np.float64)
    _close(ref, jref, 1e-6 * np.abs(jref).max())


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_mobility_stepper_through_model_solve_matches_jax(mats):
    """The slice's path at test size: FusedMobilitySpectral through
    PDEModel.solve on 2 x 16^3 with the JAX bench's Legendre mu and D, against
    the JAX PDEModel.solve on the same field and coefficients."""
    import jax.numpy as jnp

    import pde_opt_tpu as jp
    from pde_opt_tpu.models.cahn_hilliard import CahnHilliard3DPeriodic as JCH3
    from pde_opt_tpu.models.functions import (
        ChemicalPotentialLegendrePolynomials as JCP,
        DiffusionLegendrePolynomials as JDL,
    )
    from pde_opt_tpu.ops.steppers import FusedMobilitySpectral as JFMS

    N, L = 16, 0.16
    box = ((-L / 2, L / 2),) * 3
    jmu = JCP(jnp.array([0.0, 1.0, 0.5], jnp.float32))
    jd = JDL(jnp.array([0.3, 0.2], jnp.float32))
    tmu = legendre_from_numpy("chemical_potential", np.asarray(jmu.expansion.params), "cpu")
    td = legendre_from_numpy("diffusion", np.asarray(jd.expansion.params), "cpu")
    y0 = np.clip(_u((2, N, N, N), 11) * 0.2 + 0.4, 0.0, 1.0)
    ts = np.linspace(0.0, 2 * 5 * 2.5e-4, 3)
    tdt, jdt = (F32, jnp.float32) if mats == "f32" else (BF16, jnp.bfloat16)
    jsol = jp.PDEModel(JCH3, jp.Domain((N,) * 3, box, dtype=jnp.float32), JFMS).solve(
        {"kappa": 0.002, "mu": jmu, "D": jd, "derivs": "fd"}, jnp.asarray(y0), ts,
        {"A": 1.0, "stab_scale": 2.0, "mats_dtype": jdt}, dt0=2.5e-4)
    model = PDEModel(TCH3, tgrid.Domain((N,) * 3, box), FusedMobilitySpectral)
    with torch.no_grad():
        sol = model.solve({"kappa": 0.002, "mu": tmu, "D": td, "derivs": "fd", "device": "cpu"},
                          torch.from_numpy(y0), ts,
                          {"A": 1.0, "stab_scale": 2.0, "mats_dtype": tdt}, dt0=2.5e-4)
    assert sol.shape == (3, 2, N, N, N) and bool(torch.isfinite(sol).all())
    _close(sol, jsol, 1e-6 if mats == "f32" else 4e-3)
    # The flux form telescopes; with bf16 matrices the k = 0 mode carries
    # rounding noise, in JAX too (1.6e-3 here), so the port may drift at most
    # twice as far as the JAX solve.
    def drift(s):
        s = np.asarray(s, np.float64)
        return np.abs(s[-1].mean(axis=(-3, -2, -1)) - s[0].mean(axis=(-3, -2, -1))).max()

    assert drift(sol) < (1e-6 if mats == "f32" else 2 * drift(jsol) + 1e-6)
    assert float((sol[-1] - sol[0]).abs().max()) > 1e-3


# ---- tests/test_functions.py, the Legendre modules -------------------------------

def test_legendre_polynomial_expansion_matches_numpy():
    params = np.array([1.0, 0.5, 0.2, 0.1, -0.05, -0.02, 0.01], np.float32)
    x = torch.linspace(-1, 1, 20)
    got = LegendrePolynomialExpansion(params)(x).detach()
    _close(got, np_legval(x.numpy(), params), 1e-7, rtol=1e-5)


def test_diffusion_legendre_positive_and_matches_exp():
    params = np.array([0.2, -0.1, 0.05, -0.02, 0.01, -0.005, 0.002], np.float32)
    x = torch.linspace(0, 1, 20)
    got = DiffusionLegendrePolynomials(params)(x).detach()
    assert bool((got > 0).all())
    _close(got, np.exp(np_legval(2 * x.numpy() - 1, params)), 1e-7, rtol=1e-5)


def test_chemical_potential_matches_legendre():
    params = np.array([0.3, 0.1, -0.2, -0.1, 0.45, -2.02, 0.01], np.float32)
    x = torch.linspace(0, 1, 20)
    got = ChemicalPotentialLegendrePolynomials(params)(x).detach()
    _close(got, np_legval(2 * x.numpy() - 1, params), 1e-7, rtol=1e-5)


def test_chemical_potential_with_prior():
    params = np.array([0.3, 0.1, -0.2], np.float32)
    x = torch.linspace(0, 1, 20)
    got = ChemicalPotentialLegendrePolynomials(params, prior_fn=lambda v: 2.0 * v)(x).detach()
    _close(got, np_legval(2 * x.numpy() - 1, params) + 2.0 * x.numpy(), 1e-7, rtol=1e-5)


def test_legendre_polynomials_hardcoded_equivalent():
    params = torch.tensor([0.3, 0.1, -0.2, -0.1, 0.45, -2.02, 0.01])
    x = torch.linspace(-1, 1, 15)
    _close(LegendrePolynomials(max_degree=6)(params, x), np_legval(x.numpy(), params.numpy()),
           1e-7, rtol=1e-5)


def test_legval_rejects_short_params():
    with pytest.raises(ValueError, match="at least max_degree"):
        legval(torch.tensor([1.0, 2.0]), torch.linspace(-1, 1, 8), max_degree=4)


def test_modules_are_optimizable():
    mod = ChemicalPotentialLegendrePolynomials(np.array([0.3, 0.1, -0.2], np.float32))
    params = list(mod.parameters())
    assert len(params) == 1 and params[0].shape == (3,)
    (mod(torch.linspace(0, 1, 8)) ** 2).sum().backward()
    assert params[0].grad.shape == (3,) and bool((params[0].grad != 0).all())


@pytest.mark.parametrize("kind", ["expansion", "diffusion", "chemical_potential"])
def test_legendre_from_numpy_matches_jax_modules(kind):
    """The port's modules built from a JAX module's parameters compute what
    the JAX module computes."""
    import jax.numpy as jnp

    from pde_opt_tpu.models.functions import (
        ChemicalPotentialLegendrePolynomials as JCP,
        DiffusionLegendrePolynomials as JDL,
        LegendrePolynomialExpansion as JLE,
    )

    p = jnp.array([0.3, 0.1, -0.2, 0.05])
    jmod = {"expansion": JLE, "diffusion": JDL, "chemical_potential": JCP}[kind](p)
    params = jmod.params if kind == "expansion" else jmod.expansion.params
    tmod = legendre_from_numpy(kind, np.asarray(params), "cpu")
    x = np.linspace(0, 1, 33).astype(np.float32)
    got = tmod(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32
    _close(got, jmod(jnp.asarray(x)), 1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="kind"):
        legendre_from_numpy("cnn", params, "cpu")


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_3d_macro_value_and_grad_on_card_match_cpu(cuda_device):
    """K8 forward and the roll-chain backward on the card against the same
    call on the CPU (the roll chain both ways), Legendre pair, f32 matrices.
    The loss is sum(w * u1) for a zero-mean random w, so each κ gradient is
    a sum that cancels: the CPU's f32 gradient is off by 2.2e-4 of max|dκ|
    from the f64 FFT oracle here (5.8 % for sum(u1**2) at 32^3), and the
    card rounds differently (cuBLAS sums, expf), hence the bound 5e-3."""
    rng = np.random.default_rng(13)
    u = np.clip(_u((4, 16, 16, 16), 12), 0.0, 1.0)
    w = rng.standard_normal(u.shape).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        mu = ChemicalPotentialLegendrePolynomials([0.0, 1.0, 0.5]).to(dev).requires_grad_(False)
        Dl = DiffusionLegendrePolynomials([0.3, 0.2]).to(dev).requires_grad_(False)
        macro = make_ch3d_mobility_cas_macro(mu, Dl, 16, 16, 16, 0.01, 0.01, 0.01, 1.0, 2.5e-4,
                                             2, stab_scale=2.0, mats_dtype=F32)
        k = torch.full((4,), 2e-3, device=dev, requires_grad=True)
        before = kernels.launch_counts()["ch3d_rhs_fd"]
        v = (torch.from_numpy(w).to(dev) * macro(torch.from_numpy(u).to(dev), k)).sum()
        v.backward()
        launched = kernels.launch_counts()["ch3d_rhs_fd"] - before
        assert launched == (2 if str(dev) == "cuda" else 0)
        out[str(dev)] = (v.item(), k.grad.cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    g, gc = out["cuda"][1], out["cpu"][1]
    assert float((g - gc).abs().max()) <= 5e-3 * float(gc.abs().max())
