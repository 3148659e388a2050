"""The port's fused conservative CH FD rhs (kernel K8's module,
``pde_opt_tpu_torch/ops/fused.py``) held against the JAX package.

On the CPU the port runs the plain-torch version; the JAX functions run
their Pallas kernels in interpret mode.  Same seeded numpy inputs on both
sides, f32.  Tolerances, as a fraction of the reference's largest value (the
rhs is a difference of flux terms ~1/h^4 larger than the field):

    plain rhs vs the JAX kernel, Legendre mu/D   1e-6 (same formulas;
                                                 measured 1e-7, 16^2 and 8^3)
    plain rhs vs the JAX kernel, polynomial mu/D 1e-6 (Horner vs c**3 - c)
    fused rhs vs the models' rhs_fd              1e-5 (the JAX test's bound:
                                                 /h against *(1/h))
    kernel vs plain on the card                  1e-5 (chip_smoke's bound)

Tests marked ``cuda`` hold the kernel against the plain version on the card
and skip without one; JAX is imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.models.cahn_hilliard import (
    CahnHilliard2DPeriodic as TCH2,
    CahnHilliard3DPeriodic as TCH3,
)
from pde_opt_tpu_torch.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    legendre_from_numpy,
)
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
from pde_opt_tpu_torch.ops.fused import (
    ch3d_rhs_fd_cuda,
    ch3d_rhs_fd_plain,
    ch_rhs_fd_cuda,
    ch_rhs_fd_plain,
    kernel_form,
    make_ch3d_rhs_fd_fused,
    make_ch_rhs_fd_fused,
)

torch.set_num_threads(1)

MU_P = np.array([0.0, 1.0, 0.5], np.float32)     # the JAX bench's Legendre mu
D_P = np.array([0.3, 0.2], np.float32)           # and D
TOL = 1e-6


def _field(shape, seed):
    return (0.5 + 0.05 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _kappa(B):
    return np.linspace(2e-3, 6e-3, B).astype(np.float32)


def _pairs(kind, device="cpu"):
    """``(port mu, port D, jax mu, jax D)`` of one coefficient kind."""
    import jax.numpy as jnp

    from pde_opt_tpu.models.functions import (
        ChemicalPotentialLegendrePolynomials as JCP,
        DiffusionLegendrePolynomials as JDL,
    )

    if kind == "poly":
        return (PolynomialMu((0.0, -1.0, 0.0, 1.0)), PolynomialMu((1.0, 0.0, 0.5)),
                lambda c: c**3 - c, lambda c: 1.0 + 0.5 * c**2)
    jmu, jd = JCP(jnp.asarray(MU_P)), JDL(jnp.asarray(D_P))
    return (legendre_from_numpy("chemical_potential", np.asarray(jmu.expansion.params), device),
            legendre_from_numpy("diffusion", np.asarray(jd.expansion.params), device), jmu, jd)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("kind", ["poly", "legendre"])
@pytest.mark.parametrize("dims,h", [((16, 16), (0.01, 0.01)), ((16, 24), (0.01, 0.02)),
                                    ((8, 8, 8), (0.01, 0.01, 0.01))])
def test_rhs_matches_jax(kind, dims, h):
    import jax.numpy as jnp

    from pde_opt_tpu.ops.fused import make_ch3d_rhs_fd_fused as j3, make_ch_rhs_fd_fused as j2

    B = 3 if len(dims) == 2 else 2
    u, kap = _field((B, *dims), seed=len(dims) + dims[-1]), _kappa(B)
    tmu, td, jmu, jd = _pairs(kind)
    jmake, tmake = (j2, make_ch_rhs_fd_fused) if len(dims) == 2 else (j3, make_ch3d_rhs_fd_fused)
    want = jmake(jmu, jd, *h, interpret=True)(jnp.asarray(u), jnp.asarray(kap))
    with torch.no_grad():
        got = tmake(tmu, td, *h)(torch.from_numpy(u), torch.from_numpy(kap))
    _close(got.numpy(), want, TOL)


@pytest.mark.parametrize("nd", [2, 3])
def test_rhs_matches_model_rhs_fd(nd):
    """The fused rhs against the port's ``rhs_fd`` (``/h`` stencils)."""
    N, B, L = (16, 3, 0.16) if nd == 2 else (8, 3, 0.08)
    domain = tgrid.Domain((N,) * nd, ((-L / 2, L / 2),) * nd)
    tmu, td, _, _ = _pairs("poly")
    eq = (TCH2 if nd == 2 else TCH3)(domain, 3e-3, tmu, td, derivs="fd", device="cpu")
    u = torch.from_numpy(_field((B,) + (N,) * nd, seed=10 + nd))
    make = make_ch_rhs_fd_fused if nd == 2 else make_ch3d_rhs_fd_fused
    got = make(tmu, td, *domain.dx)(u, 3e-3)
    _close(got.numpy(), eq.rhs(u, 0.0).numpy(), 1e-5)


def test_kappa_forms_agree():
    """A number, a scalar tensor, ``(B,)`` and ``(B, 1, 1)`` κ give one rhs;
    leading batch axes are flattened and restored."""
    u = torch.from_numpy(_field((2, 3, 16, 16), seed=3))
    rhs = make_ch_rhs_fd_fused(PolynomialMu((0.0, -1.0, 0.0, 1.0)), PolynomialMu((1.0,)),
                               0.01, 0.01)
    want = rhs(u, 4e-3)
    assert want.shape == u.shape
    for k in (torch.tensor(4e-3), torch.full((2, 3), 4e-3), torch.full((2, 3, 1, 1), 4e-3)):
        assert torch.equal(rhs(u, k), want)
    per_env = torch.linspace(2e-3, 6e-3, 6)
    got = rhs(u, per_env.reshape(2, 3))
    flat = rhs(u.reshape(6, 16, 16), per_env).reshape(2, 3, 16, 16)
    assert torch.equal(got, flat)


def test_unsupported_callables_raise_on_the_card_path():
    """The kernel reads mu and D from coefficients; anything else raises
    before a launch."""
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match="PolynomialMu"):
        kernel_form(lambda c: c**3 - c, dev)
    with pytest.raises(ValueError, match="prior_fn"):
        kernel_form(ChemicalPotentialLegendrePolynomials(MU_P, prior_fn=torch.log), dev)
    with pytest.raises(ValueError, match="coefficients"):
        kernel_form(LegendrePolynomialExpansion(np.zeros(17, np.float32)), dev)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_form(DiffusionLegendrePolynomials(D_P), dev)   # parameters on the CPU
    u, k = torch.zeros(2, 16, 16), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        ch_rhs_fd_cuda(u, k, mu_fn=PolynomialMu((1.0,)), D_fn=PolynomialMu((1.0,)),
                       hx=0.1, hy=0.1)
    with pytest.raises(ValueError, match="too large"):
        ch3d_rhs_fd_cuda(torch.zeros(1, 4, 96, 96), torch.zeros(1), mu_fn=PolynomialMu((1.0,)),
                         D_fn=PolynomialMu((1.0,)), h1=0.1, h2=0.1, h3=0.1)


def test_raw_rhs_has_no_derivative():
    """JAX cannot differentiate its kernel (no rule for the TPU roll); the
    port's fused rhs raises on backward, and a learnable coefficient raises
    at the call while grad mode is on."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.ops.fused import make_ch_rhs_fd_fused as j2

    u = _field((2, 16, 16), seed=4)
    jrhs = j2(lambda c: c**3 - c, lambda c: jnp.ones_like(c), 0.01, 0.01, interpret=True)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda x: jnp.sum(jrhs(x, 4e-3)))(jnp.asarray(u))

    trhs = make_ch_rhs_fd_fused(PolynomialMu((0.0, -1.0, 0.0, 1.0)), PolynomialMu((1.0,)),
                                0.01, 0.01)
    x = torch.from_numpy(u).requires_grad_()
    out = trhs(x, 4e-3)
    with pytest.raises(NotImplementedError, match="no derivative"):
        out.sum().backward()

    mu, D = _pairs("legendre")[:2]
    rhs = make_ch_rhs_fd_fused(mu, D, 0.01, 0.01)
    with pytest.raises(ValueError, match="rhs_impl='xla'"):
        rhs(torch.from_numpy(u), 4e-3)
    with torch.no_grad():
        a = rhs(torch.from_numpy(u), 4e-3)
    D.requires_grad_(False)
    mu.requires_grad_(False)
    assert torch.equal(rhs(torch.from_numpy(u), 4e-3), a)


def test_plain_versions_follow_the_kernel_order():
    """The plain versions are what the kernel is held against: on D ≡ 1 and
    mu ≡ 0 they reduce to -κ∇⁴u with the Laplacian applied twice."""
    u = torch.from_numpy(_field((2, 8, 8, 8), seed=5)).double()
    k = torch.tensor([2e-3, 5e-3], dtype=torch.float64)
    zero, one = PolynomialMu((0.0,)), PolynomialMu((1.0,))
    h = (0.01, 0.02, 0.03)
    got = ch3d_rhs_fd_plain(u, k, mu_fn=zero, D_fn=one, h1=h[0], h2=h[1], h3=h[2])

    def lap(a):
        return sum((torch.roll(a, -1, ax) - 2 * a + torch.roll(a, 1, ax)) / hh**2
                   for ax, hh in zip((-3, -2, -1), h))

    np.testing.assert_allclose(got.numpy(), (-k.reshape(2, 1, 1, 1) * lap(lap(u))).numpy(),
                               rtol=0, atol=1e-9 * float(got.abs().max()))
    u2 = u[:, 0]
    got2 = ch_rhs_fd_plain(u2, k, mu_fn=zero, D_fn=one, hx=0.01, hy=0.02)

    def lap2(a):
        return sum((torch.roll(a, -1, ax) - 2 * a + torch.roll(a, 1, ax)) / hh**2
                   for ax, hh in zip((-2, -1), (0.01, 0.02)))

    np.testing.assert_allclose(got2.numpy(), (-k.reshape(2, 1, 1) * lap2(lap2(u2))).numpy(),
                               rtol=0, atol=1e-9 * float(got2.abs().max()))


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_pairs(kind, dev):
    if kind == "poly":
        return PolynomialMu((0.0, -1.0, 0.0, 1.0)), PolynomialMu((1.0, 0.0, 0.5))
    return (ChemicalPotentialLegendrePolynomials(MU_P).to(dev).requires_grad_(False),
            DiffusionLegendrePolynomials(D_P).to(dev).requires_grad_(False))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["poly", "legendre"])
@pytest.mark.parametrize("B,dims,h", [(7, (16, 24), (0.01, 0.02)), (64, (64, 64), (0.01, 0.01)),
                                      (3, (8, 8, 8), (0.01, 0.01, 0.01)),
                                      (5, (32, 32, 32), (0.01, 0.01, 0.01)),
                                      (2, (6, 16, 8), (0.01, 0.02, 0.03))])
def test_kernel_matches_plain_on_card(cuda_device, kind, B, dims, h):
    u = torch.from_numpy(_field((B, *dims), seed=B)).to(cuda_device)
    # Beyond [0, 1] too, where exp-Legendre D grows.
    u[0] = u[0] * 3.0 - 1.0
    kap = torch.from_numpy(_kappa(B)).to(cuda_device)
    mu, D = _card_pairs(kind, cuda_device)
    if len(dims) == 2:
        kw = dict(mu_fn=mu, D_fn=D, hx=h[0], hy=h[1])
        cuda, plain, name = ch_rhs_fd_cuda, ch_rhs_fd_plain, "ch_rhs_fd"
    else:
        kw = dict(mu_fn=mu, D_fn=D, h1=h[0], h2=h[1], h3=h[2])
        cuda, plain, name = ch3d_rhs_fd_cuda, ch3d_rhs_fd_plain, "ch3d_rhs_fd"
    before = kernels.launch_counts()[name]
    got = cuda(u, kap, **kw)
    want = plain(u, kap, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    _close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)


@pytest.mark.cuda
def test_fused_rhs_on_card_matches_cpu(cuda_device):
    """The whole fused rhs (kernel on the card) against the same call on the
    CPU (plain), 3D, Legendre pair."""
    u = _field((4, 16, 16, 16), seed=9)
    out = {}
    for dev in ("cpu", cuda_device):
        mu, D = _card_pairs("legendre", dev)
        out[str(dev)] = make_ch3d_rhs_fd_fused(mu, D, 0.01, 0.01, 0.01)(
            torch.from_numpy(u).to(dev), 2e-3).cpu().numpy()
    _close(out["cuda"], out["cpu"], 1e-5)
    with pytest.raises(ValueError, match="PolynomialMu"):
        make_ch_rhs_fd_fused(lambda c: c, PolynomialMu((1.0,)), 0.01, 0.01)(
            torch.zeros(2, 16, 16, device=cuda_device), 1e-3)
