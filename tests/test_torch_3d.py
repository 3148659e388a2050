"""The port's 3D Cahn-Hilliard path held against the JAX package: the
periodic 3D equation (``rhs_fd``, ``rhs_fourier``, the rfft/fft pairs), the
SIF rollout, the 3D cas macro (``pde_opt_tpu_torch/ops/cas3d.py``) and
``FusedSemiImplicitSpectral3D`` through ``PDEModel.solve`` — the parts of
``tests/test_3d.py`` that need no Levenberg-Marquardt.

Same seeded numpy inputs on both sides.  Tolerances:

    stencil, equation rhs, SIF rollout (f64)      atol 1e-10 x max|ref|
                                                  (same formulas, rounding only)
    3D cas macro vs its FFT oracle (f32)          atol 5e-5 (the JAX test's)
    3D cas macro vs the JAX macro, f32 matrices   atol 1e-6 (f32 rounding)
    3D cas macro vs the JAX macro, bf16 matrices  atol 4e-3 (ROADMAP.md's bf16
                                                  bound; measured 6e-8)
    dκ vs the oracle's (port)                     rtol 1e-3, atol 1e-7 (the
                                                  JAX test's)
    dκ vs jax.grad of the JAX macro, f32          rtol 1e-4
    fused 3D stepper solve vs JAX (f64 matrices)  atol 1e-6 (the field is f32
                                                  in both macros)
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard3DPeriodic as TCH3
from pde_opt_tpu_torch.models.pde_model import PDEModel
from pde_opt_tpu_torch.ops import stencils as tst
from pde_opt_tpu_torch.ops.cas3d import ch3d_sif_macro_reference, make_ch3d_cas_macro
from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
from pde_opt_tpu_torch.ops.steppers import (
    FusedSemiImplicitSpectral3D,
    SemiImplicitFourierSpectral,
)

torch.set_num_threads(1)

MU = PolynomialMu((0.0, -1.0, 0.0, 1.0))          # c**3 - c
ONE = PolynomialMu((1.0,))


def _jmu(c):
    return c**3 - c


def _box(N):
    L = 0.01 * N
    return ((-L / 2, L / 2),) * 3


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _field(shape, seed, amp=0.05):
    return 0.5 + amp * np.random.default_rng(seed).standard_normal(shape)


def test_lap_2nd_3d_matches_jax():
    import jax.numpy as jnp

    from pde_opt_tpu.ops import stencils as jst

    x = _field((2, 8, 12, 16), 0)
    want = jst.lap_2nd_3d(jnp.asarray(x), 0.1, 0.07, 0.05)
    _close(tst.lap_2nd_3d(torch.from_numpy(x), 0.1, 0.07, 0.05), want,
           1e-10 * float(jnp.abs(want).max()))


@pytest.mark.parametrize("derivs", ["fd", "fourier"])
@pytest.mark.parametrize("use_rfft", [True, False])
def test_ch3d_rhs_matches_jax(derivs, use_rfft):
    import jax.numpy as jnp

    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.models.cahn_hilliard import CahnHilliard3DPeriodic as JCH3

    N = (8, 12, 16)
    box = ((-0.04, 0.04), (-0.06, 0.06), (-0.08, 0.08))
    kap = np.linspace(2e-3, 8e-3, 2).reshape(2, 1, 1, 1)
    jeq = JCH3(JDomain(N, box, dtype=jnp.float64), jnp.asarray(kap), _jmu,
               lambda c: 1.0 + 0.1 * c**2, derivs=derivs, use_rfft=use_rfft)
    teq = TCH3(tgrid.Domain(N, box, dtype=torch.float64), torch.from_numpy(kap), MU,
               PolynomialMu((1.0, 0.0, 0.1)), derivs=derivs, use_rfft=use_rfft)
    u = _field((2, *N), 1)
    want = jeq.rhs(jnp.asarray(u), 0.0)
    _close(teq.rhs(torch.from_numpy(u), 0.0), want, 1e-10 * float(jnp.abs(want).max()))
    _close(teq.fourier_symbol, jeq.fourier_symbol, 1e-10 * float(jnp.abs(jeq.fourier_symbol).max()))
    x = teq.fft(torch.from_numpy(u))
    _close(teq.ifft(x).real, u, 1e-12)
    with pytest.raises(ValueError, match="Invalid"):
        TCH3(tgrid.Domain(N, box), 1e-3, MU, ONE, derivs="pallas", device="cpu")


def test_3d_spectral_rollout_finite_and_conservative():
    """Batched rfft SIF rollout at 16³ (f64): finite, mass-conserving and
    equal to the JAX rollout."""
    import jax.numpy as jnp

    import pde_opt_tpu as jp
    from pde_opt_tpu.models.cahn_hilliard import CahnHilliard3DPeriodic as JCH3

    N = 16
    y0 = np.clip(_field((3, N, N, N), 2), 0.0, 1.0)
    ts = np.linspace(0.0, 2e-4, 3)
    params = {"kappa": 0.002, "derivs": "fourier"}
    jsol = jp.PDEModel(JCH3, jp.Domain((N,) * 3, _box(N), dtype=jnp.float64),
                       jp.SemiImplicitFourierSpectral).solve(
        {**params, "mu": _jmu, "D": lambda c: jnp.ones_like(c)}, jnp.asarray(y0), ts,
        {"A": 0.5}, dt0=5e-5)
    model = PDEModel(TCH3, tgrid.Domain((N,) * 3, _box(N), dtype=torch.float64),
                     SemiImplicitFourierSpectral)
    sol = model.solve({**params, "mu": MU, "D": ONE, "device": "cpu"}, torch.from_numpy(y0), ts,
                      {"A": 0.5}, dt0=5e-5)
    assert sol.shape == (3, 3, N, N, N) and bool(torch.isfinite(sol).all())
    drift = (sol[-1].mean(dim=(-3, -2, -1)) - sol[0].mean(dim=(-3, -2, -1))).abs().max()
    assert float(drift) < 1e-10
    assert float((sol[-1] - sol[0]).abs().max()) > 1e-6
    _close(sol, jsol, 1e-10)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_ch3d_cas_macro_matches_fft_oracle(mats):
    """3D cas macro == torch.fft oracle (f32) and == the JAX macro; the κ
    gradient is native (autograd through the loop) and equals jax.grad's."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.ops.cas3d import make_ch3d_cas_macro as jmake

    B, N, h = 3, 16, 0.01
    u = _field((B, N, N, N), 5).astype(np.float32)
    kap = np.linspace(0.002, 0.006, B).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if mats == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    fused = make_ch3d_cas_macro(MU, N, N, N, h, h, h, 1.0, 1e-4, 3, mats_dtype=tdt)
    k = torch.from_numpy(kap).requires_grad_()
    out = fused(torch.from_numpy(u), k)
    (out**2).sum().backward()
    jm = jmake(_jmu, N, N, N, h, h, h, 1.0, 1e-4, 3, mats_dtype=jdt)
    want = jax.jit(jm)(jnp.asarray(u), jnp.asarray(kap))
    gk_j = jax.jit(jax.grad(lambda kk: jnp.sum(jm(jnp.asarray(u), kk) ** 2)))(jnp.asarray(kap))
    if mats == "bf16":
        _close(out.detach(), want, 4e-3)
        return
    _close(out.detach(), want, 1e-6)
    ref = ch3d_sif_macro_reference(MU, h, h, h, 1.0, 1e-4, 3)
    kr = torch.from_numpy(kap).requires_grad_()
    ro = ref(torch.from_numpy(u), kr)
    _close(out.detach(), ro.detach(), 5e-5)
    (ro**2).sum().backward()
    _close(k.grad, kr.grad, 1e-7, rtol=1e-3)
    _close(k.grad, gk_j, 0.0, rtol=1e-4)


def test_ch3d_cas_stepper_through_model_solve():
    """FusedSemiImplicitSpectral3D through PDEModel.solve with f64 matrices:
    finite, mass conserved to the transforms' roundoff, equal to the JAX
    solve (the field is f32 inside both macros)."""
    import jax.numpy as jnp

    import pde_opt_tpu as jp
    from pde_opt_tpu.models.cahn_hilliard import CahnHilliard3DPeriodic as JCH3
    from pde_opt_tpu.ops.steppers import FusedSemiImplicitSpectral3D as JF3

    N = 16
    y0 = np.clip(_field((N, N, N), 6), 0.0, 1.0)
    ts = np.linspace(0.0, 3e-4, 4)
    params = {"kappa": 0.002, "derivs": "fd"}
    jsol = jp.PDEModel(JCH3, jp.Domain((N,) * 3, _box(N), dtype=jnp.float64), JF3).solve(
        {**params, "mu": _jmu, "D": lambda c: jnp.ones_like(c)}, jnp.asarray(y0), ts,
        {"A": 1.0, "mats_dtype": jnp.float64}, dt0=1e-4)
    model = PDEModel(TCH3, tgrid.Domain((N,) * 3, _box(N), dtype=torch.float64),
                     FusedSemiImplicitSpectral3D)
    sol = model.solve({**params, "mu": MU, "D": ONE, "device": "cpu"}, torch.from_numpy(y0), ts,
                      {"A": 1.0, "mats_dtype": torch.float64}, dt0=1e-4)
    assert sol.dtype == torch.float64 and bool(torch.isfinite(sol).all())
    assert abs(float(sol[-1].mean() - sol[0].mean())) < 1e-8
    assert float((sol[-1] - sol[0]).abs().max()) > 1e-7
    _close(sol, jsol, 1e-6)


def test_fused_3d_stepper_requires_unit_mobility():
    domain = tgrid.Domain((8, 8, 8), _box(8))
    with pytest.raises(ValueError, match="unit mobility"):
        FusedSemiImplicitSpectral3D(0.002, MU, PolynomialMu((1.0, 1.0)), domain)
    FusedSemiImplicitSpectral3D(0.002, MU, ONE, domain)
    FusedSemiImplicitSpectral3D(0.002, MU, torch.ones_like, domain)


def test_ch3d_equation_defaults_to_the_card():
    """Like the 2D equation: a float κ and no device means CUDA, which
    raises where there is none; a tensor κ keeps its device."""
    domain = tgrid.Domain((8, 8, 8), _box(8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TCH3(domain, 0.002, MU, ONE)
    assert TCH3(domain, torch.tensor(0.002), MU, ONE).device == torch.device("cpu")
