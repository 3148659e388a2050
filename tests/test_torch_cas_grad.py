"""Gradients through the port's fused cas macro held against the JAX package.

The port's macros are ``torch.autograd.Function``s whose backward is the
JAX macro's custom VJP (``bwd_kernel``): on CPU tensors the plain-torch
:func:`ch_cas_macro_bwd_plain`, on CUDA tensors kernel K3.  The JAX macro
runs in interpret mode, as ``tests/test_fused_grad.py`` runs it.  Same
numpy inputs on both sides.  Tolerances:

    gradient    f32 matrices                       bf16 matrices
    du          atol 2e-6 (test_fused_grad's own)  atol 2e-3
    dkappa      rtol 2e-4, atol 1e-6 (the same)    max error <= 1e-2 of max|dkappa|

The bf16 bounds hold the port to the JAX VJP's rounding: a backward that
rounds its cotangents elsewhere (plain autograd through the forward's bf16
casts) is off by 1.9e-2 in du and 3.8e-2 in dkappa on the first case.

Tests marked ``cuda`` hold K3 against the plain backward on the card and
skip without one; they import no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_cas_grad.py``).
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.cas_spectral import (
    PolynomialMu,
    cas_constants,
    ch_cas_macro_bwd_cuda,
    ch_cas_macro_bwd_plain,
    make_ch_cas_fused_macro as tmake,
    make_ch_cas_fused_macro_ep as tmake_ep,
)
from pde_opt_tpu_torch.ops.fused_spectral import ch_sif_macro_reference as tref

torch.set_num_threads(1)

MU_T = PolynomialMu((0.0, -1.0, 0.0, 1.0))
A, DT = 1.0, 1e-3
MATS = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def MU_J(c):
    return c**3 - c


def _jax():
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.ops.cas_spectral import make_ch_cas_fused_macro

    return jax, jnp, make_ch_cas_fused_macro


def _inputs(B, H, seed):
    """Fields around 0.5, kappa across the env's control range, and a
    random cotangent ``w``."""
    rng = np.random.default_rng(seed)
    u = (0.5 + 0.05 * rng.standard_normal((B, H, H))).astype(np.float32)
    kap = np.linspace(0.002, 0.01, B).astype(np.float32)
    w = rng.standard_normal((B, H, H)).astype(np.float32)
    return u, kap, w


def _assert_grads(mats, du, dk, jdu, jdk):
    jdu, jdk = np.asarray(jdu), np.asarray(jdk)
    if mats == "f32":
        np.testing.assert_allclose(du, jdu, rtol=0, atol=2e-6)
        np.testing.assert_allclose(dk, jdk, rtol=2e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(du, jdu, rtol=0, atol=2e-3)
        assert np.abs(dk - jdk).max() <= 1e-2 * np.abs(jdk).max()


def _torch_grads(macro, u, kap, loss):
    ut = torch.from_numpy(u).requires_grad_()
    kt = torch.from_numpy(kap).requires_grad_()
    loss(macro(ut, kt)).backward()
    return ut.grad.numpy(), kt.grad.numpy()


@pytest.mark.parametrize("B,H,n_steps,hy,mats", [
    (8, 16, 3, 0.02, "f32"), (8, 16, 3, 0.02, "bf16"), (4, 64, 10, 0.01, "bf16"),
])
def test_macro_grad_matches_jax(B, H, n_steps, hy, mats):
    """du and dkappa of ``sum(w * macro(u, kappa))``: the port against
    ``jax.grad`` of the JAX macro (its custom VJP)."""
    hx = 0.01
    u, kap, w = _inputs(B, H, seed=H + n_steps)
    jax, jnp, jmake = _jax()
    jm = jmake(MU_J, H, H, hx, hy, A, DT, n_steps,
               mats_dtype=getattr(jnp, MATS[mats][0]), interpret=True)
    jdu, jdk = jax.grad(lambda a, b: jnp.sum(jnp.asarray(w) * jm(a, b)),
                        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(kap))
    tm = tmake(MU_T, H, H, hx, hy, A, DT, n_steps, mats_dtype=MATS[mats][1])
    du, dk = _torch_grads(tm, u, kap, lambda y: (torch.from_numpy(w) * y).sum())
    _assert_grads(mats, du, dk, jdu, jdk)


def test_macro_grad_matches_fft_oracle():
    """The port's fused gradient against autograd through the port's FFT
    oracle (``test_fused_grad.py``'s reference semantics), f32 matrices."""
    B, H, n, hx, hy = 8, 16, 3, 0.01, 0.02
    u, kap, w = _inputs(B, H, seed=1)
    loss = lambda y: (torch.from_numpy(w) * y).sum()  # noqa: E731
    du, dk = _torch_grads(tmake(MU_T, H, H, hx, hy, A, DT, n, mats_dtype=torch.float32),
                          u, kap, loss)
    rdu, rdk = _torch_grads(tref(MU_T, hx, hy, A, DT, n), u, kap, loss)
    np.testing.assert_allclose(du, rdu, rtol=0, atol=2e-6)
    np.testing.assert_allclose(dk, rdk, rtol=2e-4, atol=1e-6)


def test_kappa_grad_finite_difference():
    """f64 central differences confirm the oracle's kappa gradient, which
    the test above pins the fused backward to."""
    B, H, n, h = 4, 16, 2, 0.01
    rng = np.random.default_rng(2)
    u = torch.from_numpy(0.5 + 0.05 * rng.standard_normal((B, H, H)))
    kap = torch.linspace(0.002, 0.01, B, dtype=torch.float64)
    ref = tref(MU_T, h, h, A, DT, n)

    def loss(kk):
        return (ref(u, kk) ** 2).sum()       # not the mass: CH conserves it

    kt = kap.clone().requires_grad_()
    loss(kt).backward()
    eps = 1e-6
    for i in range(B):
        e = torch.zeros_like(kap)
        e[i] = eps
        fd = (loss(kap + e) - loss(kap - e)) / (2 * eps)
        np.testing.assert_allclose(float(kt.grad[i]), float(fd), rtol=1e-3, atol=1e-9)


def test_kappa_cotangent_shapes():
    """kappa's cotangent comes back in the caller's shape: scalar, (B,),
    batch-shaped."""
    B, H = 4, 16
    u, _, _ = _inputs(B, H, seed=3)
    ut = torch.from_numpy(u)
    m = tmake(MU_T, H, H, 0.01, 0.01, A, DT, 2, mats_dtype=torch.float32)

    def grad(kk, state=ut):
        kk = kk.clone().requires_grad_()
        (m(state, kk) ** 2).sum().backward()
        return kk.grad

    g_scalar = grad(torch.tensor(0.005))
    g_vec = grad(torch.full((B,), 0.005))
    g_batch = grad(torch.full((2, 2, 1, 1), 0.005), ut.reshape(2, 2, H, H))
    assert g_scalar.shape == () and g_vec.shape == (B,) and g_batch.shape == (2, 2, 1, 1)
    np.testing.assert_allclose(float(g_scalar), float(g_vec.sum()), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(g_batch.reshape(B).numpy(), g_vec.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_epilogue_grad_matches_jax(mats):
    """A loss on ``u1`` and on the stats: the port's fold of the stats
    cotangent plus the backward against the JAX ``_core_ep`` VJP."""
    B, H, n, h = 6, 16, 3, 0.01
    u, kap, w = _inputs(B, H, seed=4)
    a = np.linspace(-1.0, 1.0, B).astype(np.float32)
    b = np.linspace(2.0, 0.5, B).astype(np.float32)
    jax, jnp, jmake = _jax()
    jm = jmake(MU_J, H, H, h, h, A, DT, n, mats_dtype=getattr(jnp, MATS[mats][0]),
               interpret=True, epilogue={"stats_center": 0.5, "obs_downsample": 2})

    def jloss(uu, kk):
        u1, st, _ = jm(uu, kk)
        return (jnp.sum(jnp.asarray(w) * u1) + jnp.sum(jnp.asarray(a) * st[:, 0])
                + jnp.sum(jnp.asarray(b) * st[:, 1]) + jnp.sum(st[:, 2]))

    jdu, jdk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(kap))
    tm = tmake_ep(MU_T, H, H, h, h, A, DT, n, stats_center=0.5, obs_downsample=2,
                  mats_dtype=MATS[mats][1])

    def tloss(out):
        u1, st, obs = out
        assert not obs.requires_grad
        return ((torch.from_numpy(w) * u1).sum() + (torch.from_numpy(a) * st[:, 0]).sum()
                + (torch.from_numpy(b) * st[:, 1]).sum() + st[:, 2].sum())

    du, dk = _torch_grads(tm, u, kap, tloss)
    _assert_grads(mats, du, dk, jdu, jdk)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_bwd_plain_matches_jax_vjp(mats):
    """:func:`ch_cas_macro_bwd_plain` on its own against the JAX macro's
    VJP (``_run_bwd``) at the main path's grid: 64² x 10 substeps."""
    B, H, n, h = 2, 64, 10, 0.01
    u, kap, w = _inputs(B, H, seed=5)
    jax, jnp, jmake = _jax()
    jm = jmake(MU_J, H, H, h, h, A, DT, n, mats_dtype=getattr(jnp, MATS[mats][0]),
               interpret=True)
    _, vjp = jax.vjp(jm, jnp.asarray(u), jnp.asarray(kap))
    jdu, jdk = vjp(jnp.asarray(w))
    tm = MATS[mats][1]
    consts = cas_constants(H, H, h, h, tm, torch.device("cpu"))
    du, dk = ch_cas_macro_bwd_plain(
        torch.from_numpy(u), torch.from_numpy(kap), torch.from_numpy(w), consts,
        mu_fn=MU_T, dt=DT, A=A, n_steps=n, round_bf16=tm == torch.bfloat16)
    assert du.shape == (B, H, H) and dk.shape == (B,)
    _assert_grads(mats, du.numpy(), dk.numpy(), jdu, jdk)


@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_bwd_plain_128_matches_jax_grad(mats):
    """The plain VJP at 128² (the grid of the NN-control rollout, where the
    card runs the tiled K3) against ``jax.grad`` of the interpret macro."""
    B, H, n, h = 2, 128, 2, 0.01
    u, kap, w = _inputs(B, H, seed=13)
    jax, jnp, jmake = _jax()
    jm = jmake(MU_J, H, H, h, h, A, DT, n, mats_dtype=getattr(jnp, MATS[mats][0]),
               interpret=True)
    jdu, jdk = jax.grad(lambda a, b: jnp.sum(jnp.asarray(w) * jm(a, b)),
                        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(kap))
    tm = MATS[mats][1]
    consts = cas_constants(H, H, h, h, tm, torch.device("cpu"))
    du, dk = ch_cas_macro_bwd_plain(
        torch.from_numpy(u), torch.from_numpy(kap), torch.from_numpy(w), consts,
        mu_fn=MU_T, dt=DT, A=A, n_steps=n, round_bf16=tm == torch.bfloat16)
    assert du.shape == (B, H, H) and dk.shape == (B,)
    _assert_grads(mats, du.numpy(), dk.numpy(), jdu, jdk)


def test_grad_through_fused_stepper_evolve():
    """Autograd through ``FusedSemiImplicitSpectral`` + ``evolve`` with a
    kappa that requires grad: the stepper hands kappa's graph to the macro
    unchanged, and the gradient matches the oracle (``test_fused_grad.py``'s
    tolerance) and the JAX stepper's."""
    from pde_opt_tpu_torch.grid import Domain
    from pde_opt_tpu_torch.ops.integrate import evolve
    from pde_opt_tpu_torch.ops.steppers import FusedSemiImplicitSpectral

    B, N, n = 4, 16, 3
    domain = Domain((N, N), ((0.0, 0.16), (0.0, 0.16)), "dimensionless")
    u, kap, _ = _inputs(B, N, seed=6)
    hx, hy = domain.dx

    kt = torch.from_numpy(kap).requires_grad_()
    stepper = FusedSemiImplicitSpectral(kappa=kt, mu=MU_T, D=torch.ones_like,
                                        domain=domain, A=A, mats_dtype=torch.float32)
    (evolve(stepper, None, torch.from_numpy(u), 0.0, DT, n) ** 2).sum().backward()
    g_fused = kt.grad.numpy()

    kr = torch.from_numpy(kap).requires_grad_()
    (tref(MU_T, hx, hy, A, DT, n)(torch.from_numpy(u), kr) ** 2).sum().backward()
    np.testing.assert_allclose(g_fused, kr.grad.numpy(), rtol=2e-3, atol=1e-6)

    jax, jnp, _ = _jax()
    from pde_opt_tpu.grid import Domain as JDomain
    from pde_opt_tpu.ops.integrate import evolve as jevolve
    from pde_opt_tpu.ops.steppers import FusedSemiImplicitSpectral as JFused

    jdomain = JDomain((N, N), ((0.0, 0.16), (0.0, 0.16)), "dimensionless")

    def jloss(kk):
        st = JFused(kappa=kk, mu=MU_J, D=jnp.ones_like, domain=jdomain, A=A,
                    interpret=True, mats_dtype=jnp.float32)
        return jnp.sum(jevolve(st, None, jnp.asarray(u), 0.0, DT, n) ** 2)

    np.testing.assert_allclose(g_fused, np.asarray(jax.grad(jloss)(jnp.asarray(kap))),
                               rtol=2e-4, atol=1e-6)


def test_polynomial_mu_derivative():
    c = torch.linspace(-2, 2, 9, dtype=torch.float64)
    torch.testing.assert_close(MU_T.derivative()(c), 3 * c**2 - 1)
    assert MU_T.derivative() == PolynomialMu((-1.0, 0.0, 3.0))
    assert PolynomialMu((2.5,)).derivative() == PolynomialMu((0.0,))
    jvp = torch.func.jvp(MU_T, (c,), (torch.ones_like(c),))[1]
    torch.testing.assert_close(MU_T.derivative()(c), jvp)


def test_bwd_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    u, kap, w = (torch.from_numpy(a) for a in _inputs(2, 16, seed=7))
    consts = cas_constants(16, 16, 0.01, 0.01, torch.float32, torch.device("cpu"))
    kw = dict(mu_fn=MU_T, dt=DT, A=A, n_steps=2, round_bf16=False)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ch_cas_macro_bwd_cuda(u, kap, w, consts, **kw)
    with pytest.raises(ValueError, match="PolynomialMu"):
        ch_cas_macro_bwd_cuda(u, kap, w, consts, **{**kw, "mu_fn": MU_J})
    assert kernels.launch_counts() == before


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# K3 against the plain backward on the card, each relative to its maximum:
# f32 arithmetic is the same (FMA contraction aside); with bf16 matrices a
# flipped bf16 rounding of an intermediate moves one element by an ulp.
TOL_REL = {"f32": (1e-5, 1e-4), "bf16": (1e-2, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,n_steps", [(3, 16, 3), (5, 40, 4), (300, 64, 10), (7, 64, 0),
                                         (300, 128, 3), (7, 128, 0), (300, 256, 3),
                                         (7, 256, 0)])
@pytest.mark.parametrize("mats", ["f32", "bf16"])
def test_k3_matches_plain_on_card(cuda_device, B, H, n_steps, mats):
    u, kap, w = (torch.from_numpy(a).to(cuda_device) for a in _inputs(B, H, seed=B))
    tm = MATS[mats][1]
    consts = cas_constants(H, H, 0.01, 0.01, tm, cuda_device)
    kw = dict(mu_fn=MU_T, dt=DT, A=A, n_steps=n_steps, round_bf16=tm == torch.bfloat16)
    before = kernels.launch_counts()["ch_cas_macro_bwd"]
    du, dk = ch_cas_macro_bwd_cuda(u, kap, w, consts, **kw)
    pdu, pdk = ch_cas_macro_bwd_plain(u, kap, w, consts, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ch_cas_macro_bwd"] == before + 1
    tol_u, tol_k = TOL_REL[mats]
    assert ((du - pdu).abs().max() / pdu.abs().max()).item() <= tol_u
    assert ((dk - pdk).abs().max() / pdk.abs().max().clamp_min(1e-30)).item() <= tol_k


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [False, True])
def test_grad_on_card_runs_k3(cuda_device, epilogue):
    """A gradient through the macro on CUDA tensors launches K3 once and
    agrees with the same gradient on the CPU (plain backward)."""
    B, H, n = 64, 64, 10
    u, kap, w = _inputs(B, H, seed=8)
    make = tmake_ep if epilogue else tmake
    m = make(MU_T, H, H, 0.01, 0.01, A, DT, n, mats_dtype=torch.float32)

    def grads(dev):
        ut = torch.from_numpy(u).to(dev).requires_grad_()
        kt = torch.from_numpy(kap).to(dev).requires_grad_()
        out = m(ut, kt)
        y = out[0] if epilogue else out
        loss = (torch.from_numpy(w).to(dev) * y).sum()
        if epilogue:
            loss = loss + out[1][:, 1].sum()
        loss.backward()
        return ut.grad.cpu(), kt.grad.cpu()

    before = kernels.launch_counts()["ch_cas_macro_bwd"]
    du, dk = grads(cuda_device)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ch_cas_macro_bwd"] == before + 1
    cdu, cdk = grads("cpu")
    assert ((du - cdu).abs().max() / cdu.abs().max()).item() <= 1e-5
    assert ((dk - cdk).abs().max() / cdk.abs().max()).item() <= 1e-4
