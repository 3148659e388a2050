"""The port's coefficient nets (``models/functions``: ``PeriodicCNN``,
``Mixer2d``, ``LegendrePolynomialExpansion2D``) held against the JAX
package, and the cases of ``tests/test_functions.py`` that cover them
mirrored (``:58``, ``:96``, ``:110``, ``:118``, ``:128``).

JAX modules carried across by the loaders give the same outputs and the
same input gradients to 1e-10 (f64, conftest's x64); the mirrored cases
keep the JAX tests' bounds.  Two cases pin the traps of the translation:
``jax.nn.gelu`` is the tanh approximation and ``jnp.var`` the biased
variance.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from numpy.polynomial.legendre import legval as np_legval

from pde_opt_tpu_torch.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion2D,
    Mixer2d,
    PeriodicCNN,
    cnn_from_numpy,
    function_from_numpy,
    gelu_tanh,
    legendre_from_numpy,
    mixer_from_numpy,
)
from pde_opt_tpu_torch.models.functions.mixer import _LayerNorm
from pde_opt_tpu_torch.utils import ptree

torch.set_num_threads(1)


def _jax():
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.models import functions as jf

    return jax, jnp, jf


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape)


# ---- tests/test_functions.py ------------------------------------------------

def test_legendre_2d_tensor_product():
    params = torch.tensor([[1.0, 0.3], [0.5, -0.2], [0.1, 0.0]], dtype=torch.float64)
    x = torch.linspace(-1, 1, 7, dtype=torch.float64)
    y = torch.linspace(-1, 1, 7, dtype=torch.float64)
    got = LegendrePolynomialExpansion2D(params)(x, y)
    want = np.zeros(7)
    for m in range(3):
        for n in range(2):
            cm = np.zeros(m + 1)
            cm[m] = 1
            cn = np.zeros(n + 1)
            cn[n] = 1
            want += float(params[m, n]) * np_legval(x.numpy(), cm) * np_legval(y.numpy(), cn)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-7)


def test_modules_are_parameter_trees_and_optimizable():
    mod = ChemicalPotentialLegendrePolynomials(torch.tensor([0.3, 0.1, -0.2]))
    leaves = ptree.tree_leaves(ptree.partition(mod)[0])
    assert len(leaves) == 1 and leaves[0].shape == (3,)
    loss = (mod(torch.linspace(0, 1, 8)) ** 2).sum()
    (g,) = torch.autograd.grad(loss, [mod.expansion.params])
    assert g.shape == (3,)


def test_periodic_cnn_shapes_and_batching():
    cnn = PeriodicCNN(1, (4, 4), 1, 3, generator=_gen(0), device="cpu")
    x = torch.from_numpy(_x((5, 16, 16))).float()
    y = cnn(x)
    assert y.shape == (5, 16, 16)
    np.testing.assert_allclose(y[2].detach().numpy(), cnn(x[2]).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_periodic_cnn_translation_equivariance():
    cnn = PeriodicCNN(1, (4,), 1, 3, generator=_gen(0), device="cpu")
    x = torch.from_numpy(_x((12, 12))).float()
    shifted = torch.roll(x, (3, 5), (0, 1))
    np.testing.assert_allclose(cnn(shifted).detach().numpy(),
                               torch.roll(cnn(x), (3, 5), (0, 1)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_mixer2d_shapes_and_batching():
    mx = Mixer2d((1, 16, 16), 4, 8, 16, 16, 2, generator=_gen(0), device="cpu")
    x = torch.from_numpy(_x((3, 16, 16))).float()
    y = mx(x)
    assert y.shape == (3, 16, 16)
    np.testing.assert_allclose(y[1].detach().numpy(), mx(x[1]).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


# ---- the port's construction ------------------------------------------------

def test_nets_are_seeded_and_shaped_like_jax():
    """Uniform init on ±1/√fan_in from the given generator (the same seed,
    the same numbers, on any device), the JAX modules' parameter shapes,
    field-in/field-out only for one channel, and the card as the default
    device."""
    jax, jnp, jf = _jax()
    a = PeriodicCNN(1, (4, 6), 1, 3, generator=_gen(7), device="cpu")
    b = PeriodicCNN(1, (4, 6), 1, 3, generator=_gen(7), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    jcnn = jf.PeriodicCNN(1, (4, 6), 1, 3, key=jax.random.PRNGKey(0))
    assert [tuple(w.shape) for w in a.weights] == [w.shape for w in jcnn.weights]
    for w, c_in in zip(a.weights, (1, 4, 6)):
        lim = 1.0 / math.sqrt(c_in * 9)
        top = float(w.detach().abs().max())
        assert 0.5 * lim < top <= lim
    multi = PeriodicCNN(2, (4,), 3, 5, generator=_gen(1), device="cpu")
    assert multi(torch.zeros(7, 2, 10, 10)).shape == (7, 3, 10, 10)
    with pytest.raises(ValueError, match="odd"):
        PeriodicCNN(1, (4,), 1, 4, generator=_gen(0), device="cpu")
    jmx = jf.Mixer2d((1, 16, 16), 4, 8, 16, 12, 2, key=jax.random.PRNGKey(0))
    mx = Mixer2d((1, 16, 16), 4, 8, 16, 12, 2, generator=_gen(2), device="cpu")
    jshapes = {".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(jmx)[0]}
    assert {n: tuple(p.shape) for n, p in mx.named_parameters()} == jshapes
    with pytest.raises(ValueError, match="patch_size"):
        Mixer2d((1, 16, 16), 5, 8, 16, 12, 2, generator=_gen(2), device="cpu")
    if not torch.cuda.is_available():           # the nets build on the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            PeriodicCNN(1, (4,), 1, 3, generator=_gen(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            Mixer2d((1, 16, 16), 4, 8, 16, 12, 2, generator=_gen(2))


def _jax_pair(jax, jnp, fn, x, w):
    """JAX's output and the gradient of sum(w * out) with respect to x."""
    out = fn(jnp.asarray(x))
    g = jax.grad(lambda z: jnp.sum(jnp.asarray(w) * fn(z)))(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def _port_pair(module, x, w, *extra):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt, *extra)
    (g,) = torch.autograd.grad((torch.from_numpy(w) * out).sum(), [xt])
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("net", ["cnn", "cnn_multichannel", "mixer", "legendre_2d"])
def test_carried_nets_match_jax(net):
    """A JAX net carried across by its loader (and by ``ptree.from_numpy``,
    which recognises the JAX module) computes the same output and the same
    input gradient to 1e-10, on batched fields."""
    jax, jnp, jf = _jax()
    if net == "cnn":
        jnet = jf.PeriodicCNN(1, (5, 4), 1, 3, key=jax.random.PRNGKey(3))
        tnet = cnn_from_numpy(jnet.weights, jnet.biases, "cpu")
        x = _x((2, 12, 12))
    elif net == "cnn_multichannel":
        jnet = jf.PeriodicCNN(2, (3,), 2, 5, key=jax.random.PRNGKey(4))
        tnet = cnn_from_numpy(jnet.weights, jnet.biases, "cpu")
        x = _x((3, 2, 10, 10))
    elif net == "mixer":
        jnet = jf.Mixer2d((1, 16, 16), 4, 8, 16, 12, 2, key=jax.random.PRNGKey(5))
        # Non-trivial norms, so the affine parameters are carried too.
        for blk in jnet.blocks:
            blk.norm1.weight = blk.norm1.weight + 0.1 * jnp.arange(blk.norm1.weight.size).reshape(
                blk.norm1.weight.shape) / blk.norm1.weight.size
            blk.norm2.bias = blk.norm2.bias + 0.05
        jnet.norm.bias = jnet.norm.bias - 0.02
        tnet = mixer_from_numpy(jnet, "cpu")
        x = _x((3, 16, 16))
    else:
        params = _x((4, 3), seed=9)
        jnet = jf.LegendrePolynomialExpansion2D(jnp.asarray(params))
        tnet = legendre_from_numpy("expansion_2d", jnet.params, "cpu")
        x = np.tanh(_x((5, 6)))
        yv = np.tanh(_x((5, 6), seed=2))
    assert all(p.dtype == torch.float64 for p in tnet.parameters())
    w = _x(np.shape(jnet(jnp.asarray(x), jnp.asarray(yv)) if net == "legendre_2d"
                    else jnet(jnp.asarray(x))), seed=8)
    if net == "legendre_2d":
        want = _jax_pair(jax, jnp, lambda z: jnet(z, jnp.asarray(yv)), x, w)
        got = _port_pair(tnet, x, w, torch.from_numpy(yv))
    else:
        want = _jax_pair(jax, jnp, jnet, x, w)
        got = _port_pair(tnet, x, w)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g, wv, rtol=0, atol=1e-10)
    carried = ptree.from_numpy({"mu": jnet, "kappa": 0.002}, device="cpu")
    assert type(carried["mu"]) is type(tnet) and carried["kappa"] == 0.002
    for p, q in zip(carried["mu"].parameters(), tnet.parameters()):
        assert torch.equal(p, q)


def test_function_from_numpy_recognises_the_jax_modules():
    jax, jnp, jf = _jax()
    cases = [
        (jf.DiffusionLegendrePolynomials(jnp.array([0.3, 0.2])), DiffusionLegendrePolynomials),
        (jf.ChemicalPotentialLegendrePolynomials(jnp.array([0.0, 1.0, 0.5])),
         ChemicalPotentialLegendrePolynomials),
    ]
    u = torch.linspace(0.05, 0.95, 11, dtype=torch.float64)
    for jmod, cls in cases:
        tmod = function_from_numpy(jmod, "cpu")
        assert type(tmod) is cls
        np.testing.assert_allclose(tmod(u).detach().numpy(), np.asarray(jmod(jnp.asarray(u.numpy()))),
                                   rtol=0, atol=1e-14)
    assert function_from_numpy(lambda c: c, "cpu") is None
    with pytest.raises(ValueError, match="prior_fn"):
        function_from_numpy(jf.ChemicalPotentialLegendrePolynomials(jnp.zeros(2), lambda c: c),
                            "cpu")
    with pytest.raises(ValueError, match="gelu"):
        function_from_numpy(jf.PeriodicCNN(1, (2,), 1, 3, act=jax.nn.relu,
                                           key=jax.random.PRNGKey(0)), "cpu")


@pytest.mark.parametrize("act,matches", [("default", True), ("exact_erf", False)])
def test_cnn_gelu_is_the_tanh_approximation(act, matches):
    """The default activation is ``jax.nn.gelu``'s tanh form: a CNN with
    torch's exact-erf GELU instead leaves the JAX output by far more than
    the parity bound."""
    jax, jnp, jf = _jax()
    jnet = jf.PeriodicCNN(1, (6,), 1, 3, key=jax.random.PRNGKey(11))
    tnet = cnn_from_numpy(jnet.weights, jnet.biases, "cpu",
                          **({} if act == "default" else {"act": F.gelu}))
    x = 3.0 * _x((10, 10), seed=4)
    err = np.abs(tnet(torch.from_numpy(x)).detach().numpy() - np.asarray(jnet(jnp.asarray(x)))).max()
    assert (err <= 1e-10) == matches and (matches or err > 1e-5)
    z = torch.linspace(-4, 4, 81, dtype=torch.float64)
    tanh_form = 0.5 * z * (1 + torch.tanh(math.sqrt(2 / math.pi) * (z + 0.044715 * z**3)))
    torch.testing.assert_close(gelu_tanh(z), tanh_form, rtol=0, atol=1e-14)


@pytest.mark.parametrize("correction,matches", [(0, True), (1, False)])
def test_layer_norm_variance_is_biased(correction, matches):
    """``_LayerNorm`` divides by the biased variance (``jnp.var``) with ε =
    1e-5; the unbiased one, over 6 elements, differs by ~10 %."""
    norm = _LayerNorm((2, 3), device="cpu", dtype=torch.float64)
    x = torch.from_numpy(_x((4, 2, 3), seed=6))
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, correction=correction)
    want = (x - mean) / torch.sqrt(var + 1e-5)
    err = float((norm(x) - want).detach().abs().max())
    assert (err <= 1e-12) == matches and (matches or err > 1e-2)


def test_cnn_mu_trains_as_in_jax():
    """``examples/optimize_nn.py`` at 16² (f64): a JAX ``PeriodicCNN`` μ,
    carried across, takes the same two Adam steps of ``train`` as in the
    JAX package, on the JAX package's trajectory; its weights agree to
    1e-9."""
    jax, jnp, jf = _jax()
    import pde_opt_tpu as jp

    from pde_opt_tpu_torch.bench.inverse import flory_huggins_mu, nn_mu_fit_2d

    n = 16
    jdom = jp.Domain((n, n), ((-0.08, 0.08),) * 2, dtype=jnp.float64)
    jm = jp.PDEModel(jp.CahnHilliard2DPeriodic, jdom, jp.SemiImplicitFourierSpectral)
    ts = np.linspace(0.0, 0.004, 9)
    y0 = np.clip(0.01 * np.random.default_rng(0).standard_normal((n, n)) + 0.5, 0.0, 1.0)

    def jmu(c):
        cc = jnp.clip(c, 1e-3, 1 - 1e-3)
        return jnp.log(cc / (1.0 - cc)) + 3.0 * (1.0 - 2.0 * c)

    jother = {"kappa": 0.002, "D": jnp.ones_like, "derivs": "fd"}
    sol = np.array(jm.solve({"mu": jmu, **jother}, jnp.asarray(y0), ts, {"A": 0.5}, dt0=2.5e-4))
    jcnn = jf.PeriodicCNN(1, (4, 4), 1, 3, key=jax.random.PRNGKey(1))
    jres = jm.train({"ys": list(sol), "ts": list(ts)}, [[0, 2, 4], [4, 6, 8]],
                    opt_parameters={"mu": jcnn}, other_parameters=jother,
                    solver_parameters={"A": 0.5}, weights={"mu": None}, lambda_reg=0.0,
                    method="adam", max_steps=2, dt0=2.5e-4, learning_rate=1e-2)
    fit = nn_mu_fit_2d("cpu", torch.float64, grid=n, ys=[torch.from_numpy(y) for y in sol],
                       cnn=cnn_from_numpy(jcnn.weights, jcnn.biases, "cpu"))
    np.testing.assert_allclose(
        flory_huggins_mu(torch.linspace(0.0, 1.0, 11, dtype=torch.float64)).numpy(),
        np.asarray(jmu(jnp.linspace(0.0, 1.0, 11))), rtol=0, atol=1e-14)
    tres = fit.model.train({"ys": fit.ys, "ts": list(ts)}, [[0, 2, 4], [4, 6, 8]],
                           opt_parameters=fit.start(), other_parameters=fit.other,
                           solver_parameters={"A": 0.5}, weights={"mu": None}, lambda_reg=0.0,
                           method="adam", max_steps=2, dt0=2.5e-4, learning_rate=1e-2)
    assert type(tres["mu"]) is PeriodicCNN
    moved = 0.0
    for got, want, start in zip([*tres["mu"].weights, *tres["mu"].biases],
                                [*jres["mu"].weights, *jres["mu"].biases],
                                [*jcnn.weights, *jcnn.biases]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)
        moved = max(moved, float(np.abs(np.asarray(want) - np.asarray(start)).max()))
    assert moved > 1e-3
