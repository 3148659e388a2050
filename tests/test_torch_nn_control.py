"""The differentiable NN control of the CH macro (BASELINE config 3, the
JAX bench's ``run_train_grad_128``) held against the JAX bench's loss.

The bench's loss is copied here as the JAX reference (``bench.py:567-574``:
features mean - 0.5 and variance, a 2 -> 32 -> 1 tanh/sigmoid net to kappa
in [0.002, 0.010], ``sum((macro(u, kappa) - 0.5)**2)``), run through the JAX
macro in interpret mode; the port runs :mod:`pde_opt_tpu_torch.bench.nn_control`
with its plain macro on the CPU.  The same numpy parameters (keyed ``w1``,
``b1``, ``w2``, ``b2``, loaded with ``params_from_numpy``) and fields go to
both, at 128² x 10 substeps, dt 1e-3, on a small batch.  Tolerances, from
the measured gaps (value 1.7e-7 relative and gradients 1.6e-6 of their
largest entry with f32 matrices, 5.0e-7 and 3.5e-4 with bf16) plus
headroom: the value to rtol 1e-6 (f32) and 1e-5 (bf16); each parameter's
gradient within 2e-5 (f32) and 3e-3 (bf16) of its largest entry.
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu, make_ch_cas_fused_macro as tmake
from pde_opt_tpu_torch.bench.nn_control import KappaControlNet, field_features, nn_control_loss
from pde_opt_tpu_torch.rl.nets import params_from_numpy

torch.set_num_threads(1)

B, N, N_SUB, DT = 4, 128, 10, 1e-3
MU_T = PolynomialMu((0.0, -1.0, 0.0, 1.0))
TOL = {"f32": (1e-6, 2e-5), "bf16": (1e-5, 3e-3)}        # value rtol, grad / max|grad|


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w1": (0.5 * rng.standard_normal((2, 32))).astype(np.float32),
            "b1": (0.1 * rng.standard_normal(32)).astype(np.float32),
            "w2": (0.5 * rng.standard_normal((32, 1))).astype(np.float32),
            "b2": (0.1 * rng.standard_normal(1)).astype(np.float32)}


def _fields(seed):
    """The bench's 0.5 + 0.01 N(0, 1) fields, each env shifted and scaled so
    that the features, and kappa, differ between envs."""
    rng = np.random.default_rng(seed)
    off = np.linspace(-0.05, 0.05, B)[:, None, None]
    amp = np.linspace(0.01, 0.08, B)[:, None, None]
    return (0.5 + off + amp * rng.standard_normal((B, N, N))).astype(np.float32)


def _jax_value_and_grad(params, u, mats):
    """The bench's loss and its gradient with respect to the parameters."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.ops.cas_spectral import make_ch_cas_fused_macro

    macro = make_ch_cas_fused_macro(lambda c: c**3 - c, N, N, 0.01, 0.01, 1.0, DT, N_SUB,
                                    mats_dtype=getattr(jnp, mats), interpret=True)

    def loss(p, uu):
        feats = jnp.stack([uu.mean(axis=(-2, -1)) - 0.5, uu.var(axis=(-2, -1))], axis=-1)
        h = jnp.tanh(feats @ p["w1"] + p["b1"])
        kap = 0.002 + 0.008 * jax.nn.sigmoid(h @ p["w2"] + p["b2"])[:, 0]
        return jnp.sum((macro(uu, kap) - 0.5) ** 2)

    v, g = jax.value_and_grad(loss)({k: jnp.asarray(a) for k, a in params.items()},
                                    jnp.asarray(u))
    return float(v), {k: np.asarray(a) for k, a in g.items()}


@pytest.mark.parametrize("mats", ["float32", "bfloat16"])
def test_nn_control_value_and_grad_match_jax(mats):
    params, u = _params(0), _fields(1)
    jv, jg = _jax_value_and_grad(params, u, mats)
    net = params_from_numpy(KappaControlNet(device="cpu"), params)
    macro = tmake(MU_T, N, N, 0.01, 0.01, 1.0, DT, N_SUB, mats_dtype=getattr(torch, mats))
    v = nn_control_loss(net, macro, torch.from_numpy(u))
    v.backward()
    tol_v, tol_g = TOL["f32" if mats == "float32" else "bf16"]
    np.testing.assert_allclose(float(v.detach()), jv, rtol=tol_v)
    for name, p in net.named_parameters():
        g, want = p.grad.numpy(), jg[name]
        assert g.shape == want.shape
        assert np.abs(g - want).max() <= tol_g * np.abs(want).max(), name


def test_net_and_features():
    """The net's parameters carry the JAX dict's names and shapes, the init
    draws 0.5 N(0, 1) weights and zero biases, kappa stays in [0.002,
    0.010], and the features are each env's mean - 0.5 and variance."""
    net = KappaControlNet(device="cpu", generator=torch.Generator().manual_seed(3))
    assert {n: tuple(p.shape) for n, p in net.named_parameters()} == {
        "w1": (2, 32), "b1": (32,), "w2": (32, 1), "b2": (1,)}
    assert not net.b1.any() and not net.b2.any() and 0.3 < float(net.w1.detach().std()) < 0.7
    u = torch.from_numpy(_fields(2))
    f = field_features(u).numpy()
    np.testing.assert_allclose(f[:, 0], u.numpy().mean(axis=(1, 2)) - 0.5, rtol=0, atol=1e-6)
    np.testing.assert_allclose(f[:, 1], u.numpy().var(axis=(1, 2)), rtol=1e-5)
    kap = net(u)
    assert kap.shape == (B,) and bool(((kap >= 0.002) & (kap <= 0.010)).all())
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy(net, {"w1": np.zeros((2, 32), np.float32)})
