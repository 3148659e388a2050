"""The port's packed-DFT macros (kernels K9a and K9b), the fused steppers'
``algo="dft"`` and their per-env control shapes, held against the JAX
package on the same numpy inputs.

On the CPU the port runs its plain-torch macros; the JAX macros run their
Pallas kernels in interpret mode, with f32 tables unless stated.
Tolerances:

    plain macro vs JAX macro, f32, 3 substeps        atol 1e-5
    macro vs FFT oracle, f32                         atol 5e-5 (tests/test_fused_spectral.py)
    bf16 tables, one substep from a shared field     every pixel within 2^-8, at most
                                                     0.1 % of pixels off by more than
                                                     1e-6, RMS below 1e-4
    gradients vs jax.grad                            tests/test_fused_grad.py:109-154
    steppers (evolve, PDEModel.solve) vs JAX         atol 1e-5
    control shapes: the port against itself          exact; against JAX atol 1e-5

Tests marked ``cuda`` hold the kernels against the plain versions on the
card and skip without one.  JAX is imported inside the tests that use it,
so the ``cuda`` tests also run where JAX is not installed
(``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.ops import kernels
from pde_opt_tpu_torch.ops.cas_spectral import PolynomialMu
from pde_opt_tpu_torch.ops.fused_spectral import (
    ac_sif_macro_cuda,
    ac_sif_macro_plain,
    ac_sif_macro_reference,
    ch_sif_macro_cuda,
    ch_sif_macro_plain,
    ch_sif_macro_reference,
    make_ac_sif_fused_macro,
    make_ch_sif_fused_macro,
    sif_constants,
)
from pde_opt_tpu_torch.ops.steppers import FusedAllenCahnSpectral, FusedSemiImplicitSpectral

torch.set_num_threads(1)

MU_T = PolynomialMu((0.0, -1.0, 0.0, 1.0))
R_T = PolynomialMu((1.0, 0.0, 0.5))          # 1 + 0.5 c**2
ONES_T = PolynomialMu((1.0,))
HX, HY = 0.01, 0.02
BOX = ((0.0, 0.16), (0.0, 0.16))
# (dt, kappa range, field) of each macro: tests/test_fused_spectral.py's.
CASE = {"ch": (1e-3, (0.002, 0.01), (0.5, 0.05)), "ac": (1e-4, (1e-4, 1e-3), (0.0, 0.1))}


def MU_J(c):
    return c**3 - c


def R_J(c):
    return 1.0 + 0.5 * c**2


def ONES_J(c):
    import jax.numpy as jnp

    return jnp.ones_like(c)


def _jfs():
    import pde_opt_tpu.ops.fused_spectral as jfs

    return jfs


def _inputs(kind, B, H=16, W=16, seed=0):
    """A field and a per-env κ spread over the control range, numpy f32."""
    _, (k0, k1), (mean, amp) = CASE[kind]
    rng = np.random.default_rng(seed)
    u = (mean + amp * rng.standard_normal((B, H, W))).astype(np.float32)
    return u, np.linspace(k0, k1, B).astype(np.float32)


def _macros(kind, general, n, mats="f32", half=None, H=16, W=16):
    """The JAX macro (interpret mode, jitted) and the port's, same arguments."""
    import jax
    import jax.numpy as jnp

    jfs = _jfs()
    dt = CASE[kind][0]
    jm, tm = (jnp.float32, torch.float32) if mats == "f32" else (jnp.bfloat16, torch.bfloat16)
    common = (H, W, HX, HY, 1.0, dt, n)
    if kind == "ch":
        j = jfs.make_ch_sif_fused_macro(MU_J, *common, mats_dtype=jm, interpret=True,
                                        half_spectrum=half)
        t = make_ch_sif_fused_macro(MU_T, *common, mats_dtype=tm, half_spectrum=half)
    else:
        j = jfs.make_ac_sif_fused_macro(MU_J, R_J if general else ONES_J, *common, mats_dtype=jm,
                                        interpret=True, half_spectrum=half)
        t = make_ac_sif_fused_macro(MU_T, R_T if general else None, *common, mats_dtype=tm,
                                    half_spectrum=half)
    return jax.jit(j), t


def _oracle(kind, general, n):
    dt = CASE[kind][0]
    if kind == "ch":
        return ch_sif_macro_reference(MU_T, HX, HY, 1.0, dt, n)
    return ac_sif_macro_reference(MU_T, R_T if general else torch.ones_like, HX, HY, 1.0, dt, n)


MACROS = [("ch", False), ("ac", False), ("ac", True)]
MACRO_IDS = ["ch", "ac-R1", "ac-R"]


# ---- the macros against JAX and the oracles ---------------------------------

@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_plain_macro_matches_jax(kind, general, half):
    """K9a/K9b's plain versions against the JAX kernels, f32 tables, 3
    substeps, per-env κ."""
    u, kap = _inputs(kind, 6, seed=1)
    j, t = _macros(kind, general, 3, half=half)
    want = np.asarray(j(u, kap))
    got = t(torch.from_numpy(u), torch.from_numpy(kap))
    assert got.shape == u.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float(np.abs(want - u).max()) > 1e-6


@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_macro_matches_fft_reference(kind, general):
    """``test_fused_spectral.py``'s oracle checks: the macro with f32 tables
    against the port's FFT oracle (the carried spectrum, the half-spectrum
    inverse and the roll Laplacian equal the oracle's in exact arithmetic)."""
    u, kap = _inputs(kind, 8, seed=2)
    _, t = _macros(kind, general, 3)
    ut, kt = torch.from_numpy(u), torch.from_numpy(kap)
    out = t(ut, kt)
    np.testing.assert_allclose(out.numpy(), _oracle(kind, general, 3)(ut, kt).numpy(),
                               rtol=0, atol=5e-5)
    assert float((out - ut).abs().max()) > 1e-7


@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_macro_per_env_kappa_and_batch_shapes(kind, general):
    """Each env's κ acts on its own env (the denominators' signs show only
    when κ varies), and a scalar κ on a (2, 3, H, W) batch matches the
    oracle."""
    u, _ = _inputs(kind, 4, seed=3)
    _, t = _macros(kind, general, 2)
    k0, k1 = CASE[kind][1]
    ut = torch.from_numpy(u)
    lo, hi = t(ut, torch.full((4,), k0)), t(ut, torch.full((4,), k1))
    assert float((lo - hi).abs().max()) > 1e-7
    mixed = t(ut, torch.tensor([k0, k1, k0, k1]))
    torch.testing.assert_close(mixed[::2], lo[::2], rtol=0, atol=0)
    torch.testing.assert_close(mixed[1::2], hi[1::2], rtol=0, atol=0)
    u6, _ = _inputs(kind, 6, seed=4)
    u6 = torch.from_numpy(u6).reshape(2, 3, 16, 16)
    out = t(u6, 0.5 * (k0 + k1))
    assert out.shape == u6.shape
    np.testing.assert_allclose(out.numpy(), _oracle(kind, general, 2)(u6, 0.5 * (k0 + k1)).numpy(),
                               rtol=0, atol=5e-5)


@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_bf16_substep_from_shared_field_matches_jax(kind, general):
    """bf16 tables, one substep from the same field: the rounding sites are
    JAX's (a misplaced one moves every pixel; a one-ulp f32 flip moves
    isolated pixels by a bf16 ulp)."""
    u, kap = _inputs(kind, 8, seed=5)
    j, t = _macros(kind, general, 1, mats="bf16")
    d = np.abs(t(torch.from_numpy(u), torch.from_numpy(kap)).numpy() - np.asarray(j(u, kap)))
    assert d.max() <= 2.0**-8
    assert (d > 1e-6).mean() <= 1e-3
    assert float(np.sqrt((d.astype(np.float64) ** 2).mean())) < 1e-4


BIG = [(128, 128, True), (128, 128, False), (96, 136, True), (96, 136, False)]
BIG_IDS = ["128-half", "128-full", "96x136-half", "96x136-full"]


@pytest.mark.parametrize("H,W,half", BIG, ids=BIG_IDS)
@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_plain_macro_above_64_matches_jax(kind, general, H, W, half):
    """K9a/K9b's plain versions against the JAX kernels past 64² (what the
    tiled kernels run on the card): 128² and 96 x 136 with the half and the
    full spectrum, f32 tables, 2 envs, 2 substeps, per-env κ."""
    u, kap = _inputs(kind, 2, H, W, seed=H + W)
    j, t = _macros(kind, general, 2, half=half, H=H, W=W)
    want = np.asarray(j(u, kap))
    got = t(torch.from_numpy(u), torch.from_numpy(kap))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float(np.abs(want - u).max()) > 1e-6


@pytest.mark.parametrize("H,W", [(128, 128), (96, 136)], ids=["128", "96x136"])
@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_bf16_substep_above_64_matches_jax(kind, general, H, W):
    """bf16 tables past 64², one substep from the same field: every pixel
    within 2^-8 and the RMS below 1e-4, as at 16².  The AC macros also keep
    16²'s 0.1 % of pixels off by more than 1e-6.  The CH macro's sums of
    128 terms round apart from the JAX kernel's at bf16 ties on 7.7 % of
    pixels at 128² (by at most 3.1e-5); it is held by its RMS against the
    unrounded plain version's (the control, 1.2e-3 from JAX, where the
    port sits at 3.0e-6): a misplaced rounding site moves every pixel."""
    u, kap = _inputs(kind, 2, H, W, seed=H + 2 * W)
    j, t = _macros(kind, general, 1, mats="bf16", H=H, W=W)
    _, ctl = _macros(kind, general, 1, H=H, W=W)
    ut, kt = torch.from_numpy(u), torch.from_numpy(kap)
    want = np.asarray(j(u, kap))
    d = np.abs(t(ut, kt).numpy() - want)

    def rms(x):
        return float(np.sqrt((x.astype(np.float64) ** 2).mean()))

    assert d.max() <= 2.0**-8 and rms(d) < 1e-4
    if kind == "ac":
        assert (d > 1e-6).mean() <= 1e-3
    else:
        assert rms(d) <= 0.01 * rms(ctl(ut, kt).numpy() - want)


def test_half_spectrum_tables():
    """The half spectrum keeps kw in [0, W/2] and weighs the interior
    columns of the inverse twice; with f32 tables both spectra invert what
    the forward takes (a real field, Nyquist column included); the half
    spectrum is the default for even W."""
    from pde_opt_tpu_torch.ops.fused_spectral import _dft_transforms

    half = sif_constants(16, 24, HX, HY, torch.float32, True, torch.device("cpu"))
    full = sif_constants(16, 24, HX, HY, torch.float32, False, torch.device("cpu"))
    assert half.wr_w.shape == (24, 13) and half.vr_w.shape == (13, 24)
    assert half.lam.shape == (16, 13) and full.lam.shape == (16, 24)
    torch.testing.assert_close(half.vr_w[1:12], 2.0 * full.vr_w[1:12])
    torch.testing.assert_close(half.vr_w[[0, 12]], full.vr_w[[0, 12]])
    u = torch.from_numpy(_inputs("ch", 2, 16, 24, seed=6)[0])
    for consts in (half, full):
        fwd, inv = _dft_transforms(consts, False)
        torch.testing.assert_close(inv(*fwd(u)), u, rtol=0, atol=1e-5)
    dflt = make_ch_sif_fused_macro(MU_T, 16, 24, HX, HY, 1.0, 1e-3, 2, mats_dtype=torch.float32)
    h = make_ch_sif_fused_macro(MU_T, 16, 24, HX, HY, 1.0, 1e-3, 2, mats_dtype=torch.float32,
                                half_spectrum=True)
    torch.testing.assert_close(dflt(u, 0.004), h(u, 0.004), rtol=0, atol=0)


# ---- gradients ----------------------------------------------------------------

@pytest.mark.parametrize("kind,general", [("ch", False), ("ac", True)], ids=["ch", "ac-R"])
def test_macro_grads_match_jax(kind, general):
    """``jax.grad`` of ``sum(macro(u, κ)²)`` through the JAX macro (the VJP of
    its checkpointed oracle) against the port's (the same VJP in torch), at
    ``test_fused_grad.py``'s tolerances for the fused macro against its
    oracle."""
    import jax
    import jax.numpy as jnp

    B = 6 if kind == "ch" else 4
    u, kap = _inputs(kind, B, seed=7)
    j, t = _macros(kind, general, 3)
    gu_j, gk_j = jax.grad(lambda uu, kk: jnp.sum(j(uu, kk) ** 2), argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(kap))
    ut, kt = torch.from_numpy(u).requires_grad_(), torch.from_numpy(kap).requires_grad_()
    (t(ut, kt) ** 2).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_j), rtol=1e-3,
                               atol=1e-6 if kind == "ch" else 1e-7)
    assert float(kt.grad.abs().max()) > 0.0


def test_scalar_kappa_gradient_is_the_sum():
    """A scalar κ's cotangent comes back as a scalar, the sum of the
    per-env ones (``test_fused_grad.py``'s shape case)."""
    u, _ = _inputs("ch", 4, seed=8)
    _, t = _macros("ch", False, 2)
    ut = torch.from_numpy(u)
    ks = torch.tensor(0.005, requires_grad=True)
    (t(ut, ks) ** 2).sum().backward()
    kv = torch.full((4,), 0.005, requires_grad=True)
    (t(ut, kv) ** 2).sum().backward()
    assert ks.grad.shape == ()
    np.testing.assert_allclose(float(ks.grad), float(kv.grad.sum()), rtol=1e-4, atol=1e-7)


# ---- the steppers' algo="dft" ---------------------------------------------------

def _steppers(kind, kappa_np, algo):
    """The JAX stepper and the port's, f32 tables, on 16² over BOX."""
    import jax.numpy as jnp

    from pde_opt_tpu import grid as jgrid
    from pde_opt_tpu.ops import steppers as js

    jdom = jgrid.Domain((16, 16), BOX, "dimensionless")
    tdom = tgrid.Domain((16, 16), BOX, "dimensionless")
    jk, tk = jnp.asarray(kappa_np), torch.from_numpy(kappa_np)
    if kind == "ch":
        j = js.FusedSemiImplicitSpectral(kappa=jk, mu=MU_J, D=ONES_J, domain=jdom, A=1.0,
                                         mats_dtype=jnp.float32, interpret=True, algo=algo)
        t = FusedSemiImplicitSpectral(kappa=tk, mu=MU_T, D=torch.ones_like, domain=tdom, A=1.0,
                                      mats_dtype=torch.float32, algo=algo)
    else:
        j = js.FusedAllenCahnSpectral(kappa=jk, mu=MU_J, R=ONES_J, domain=jdom, A=1.0,
                                      mats_dtype=jnp.float32, interpret=True, algo=algo)
        t = FusedAllenCahnSpectral(kappa=tk, mu=MU_T, R=None, domain=tdom, A=1.0,
                                   mats_dtype=torch.float32, algo=algo)
    return j, t


@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_stepper_dft_through_evolve_matches_jax(kind):
    import jax.numpy as jnp

    from pde_opt_tpu.ops.integrate import evolve as jevolve
    from pde_opt_tpu_torch.ops.integrate import evolve

    u, kap = _inputs(kind, 4, seed=9)
    dt = CASE[kind][0]
    j, t = _steppers(kind, kap[:, None, None], "dft")
    got = evolve(t, None, torch.from_numpy(u), 0.0, dt, 3)
    want = np.asarray(jevolve(j, None, jnp.asarray(u), 0.0, dt, 3))
    assert got.shape == u.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    cas = evolve(_steppers(kind, kap[:, None, None], "cas")[1], None, torch.from_numpy(u), 0.0,
                 dt, 3)
    np.testing.assert_allclose(got.numpy(), cas.numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_pde_model_solve_on_dft_stepper_matches_jax(kind):
    import jax.numpy as jnp

    import pde_opt_tpu as jp
    from pde_opt_tpu.ops import steppers as js
    from pde_opt_tpu_torch.models import AllenCahn2DPeriodic, CahnHilliard2DPeriodic, PDEModel

    u, kap = _inputs(kind, 3, seed=10)
    dt = CASE[kind][0]
    ts = [0.0, 2 * dt, 4 * dt]
    jdom = jp.Domain((16, 16), BOX, "dimensionless")
    tdom = tgrid.Domain((16, 16), BOX, "dimensionless")
    if kind == "ch":
        jm = jp.PDEModel(jp.CahnHilliard2DPeriodic, jdom, js.FusedSemiImplicitSpectral)
        tm = PDEModel(CahnHilliard2DPeriodic, tdom, FusedSemiImplicitSpectral)
        jparams = {"mu": MU_J, "D": ONES_J}
        tparams = {"mu": MU_T, "D": torch.ones_like}
    else:
        jm = jp.PDEModel(jp.AllenCahn2DPeriodic, jdom, js.FusedAllenCahnSpectral)
        tm = PDEModel(AllenCahn2DPeriodic, tdom, FusedAllenCahnSpectral)
        jparams = {"mu": MU_J, "R": ONES_J}
        tparams = {"mu": MU_T, "R": ONES_T}
    want = jm.solve({**jparams, "kappa": jnp.asarray(kap[:, None, None])}, jnp.asarray(u), ts,
                    {"A": 1.0, "algo": "dft", "mats_dtype": jnp.float32, "interpret": True},
                    dt0=dt)
    got = tm.solve({**tparams, "kappa": torch.from_numpy(kap[:, None, None])}, torch.from_numpy(u),
                   ts, {"A": 1.0, "algo": "dft", "mats_dtype": torch.float32}, dt0=dt)
    assert got.shape == (3, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_dft_stepper_refuses_the_epilogue_and_unknown_algos(kind):
    _, kap = _inputs(kind, 2)
    _, t = _steppers(kind, kap, "dft")
    y0 = torch.zeros((2, 16, 16))
    with pytest.raises(NotImplementedError, match="requires algo='cas'"):
        t.evolve_with_epilogue(None, y0, 0.0, 1e-4, 2, {"obs_scale": 255.0})
    cls = FusedSemiImplicitSpectral if kind == "ch" else FusedAllenCahnSpectral
    other = {"D": torch.ones_like} if kind == "ch" else {"R": None}
    with pytest.raises(ValueError, match="algo must be 'cas' or 'dft'"):
        cls(kappa=0.004, mu=MU_T, domain=t.domain, algo="fft", **other)


# ---- control shapes (tests/test_control_shapes.py:82-121) ------------------------

CTRL = {"ch": 0.004, "ac": 4e-4}


def _ctrl_field(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.4, 0.6, (3, 16, 16)).astype(np.float32)


@pytest.mark.parametrize("algo", ["cas", "dft"])
@pytest.mark.parametrize("kind", ["ch", "ac"])
@pytest.mark.parametrize("shape", [(), (3,), (3, 1), (3, 1, 1)], ids=["scalar", "B", "B1", "B11"])
def test_fused_stepper_accepts_all_control_shapes(kind, algo, shape):
    """Every accepted κ shape gives the (B,) control's result exactly, and
    JAX's stepper's for the same shape."""
    import jax.numpy as jnp

    y0 = _ctrl_field(0)
    ctrl = np.full(shape, CTRL[kind], np.float32)
    jb, tb = _steppers(kind, np.full((3,), CTRL[kind], np.float32), algo)
    j, t = _steppers(kind, ctrl, algo)
    base = tb.evolve(None, torch.from_numpy(y0), 0.0, 1e-4, 2)
    out = t.evolve(None, torch.from_numpy(y0), 0.0, 1e-4, 2)
    assert out.shape == y0.shape
    torch.testing.assert_close(out, base, rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j.evolve(None, jnp.asarray(y0), 0.0, 1e-4, 2)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("algo", ["cas", "dft"])
@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_fused_stepper_per_env_control_stays_per_env(kind, algo):
    y0 = torch.from_numpy(_ctrl_field(1))
    vals = np.asarray([0.5, 1.0, 1.5], np.float32) * CTRL[kind]
    outs = [_steppers(kind, v, algo)[1].evolve(None, y0, 0.0, 1e-4, 2)
            for v in (vals, vals[:, None], vals[:, None, None])]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    assert float((outs[0][0] - outs[0][1]).abs().max()) > 0.0


@pytest.mark.parametrize("algo", ["cas", "dft"])
@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_fused_stepper_rejects_nonsingleton_trailing_axis(kind, algo):
    import jax.numpy as jnp

    y0 = _ctrl_field(2)
    bad = np.full((3, 2), CTRL[kind], np.float32)
    j, t = _steppers(kind, bad, algo)
    with pytest.raises(ValueError, match="does not broadcast"):
        t.evolve(None, torch.from_numpy(y0), 0.0, 1e-4, 2)
    with pytest.raises((ValueError, TypeError)):
        j.evolve(None, jnp.asarray(y0), 0.0, 1e-4, 2)


@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_preset_dft_step_at_128_matches_jax(kind):
    """One step of the CH and AC presets at 128² on the packed-DFT macro
    (``"algo": "dft"`` in the solver parameters, no fused epilogue, bf16
    tables: the tiled K9a/K9b on the card) from the same state, against the
    JAX env on the CPU: field atol 1e-3, obs within 1 LSB, reward rtol
    1e-3 (``test_torch_env.py``'s bounds)."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs import presets as jp
    from pde_opt_tpu.envs.vector_env import EnvState as JState
    from pde_opt_tpu_torch.envs import presets as tp
    from pde_opt_tpu_torch.envs.vector_env import env_state_to_numpy

    name = "make_cahn_hilliard_control_env" if kind == "ch" else "make_allen_cahn_control_env"
    kw = dict(num_envs=2, grid_size=128, substeps=10, spectral_solve="fused",
              fused_epilogue=False)
    jenv, tenv = getattr(jp, name)(**kw), getattr(tp, name)(device="cpu", **kw)
    jenv.solver_parameters = {**jenv.solver_parameters, "algo": "dft", "interpret": True}
    tenv.solver_parameters = {**tenv.solver_parameters, "algo": "dft"}
    gen = torch.Generator().manual_seed(3)
    ts, _ = tenv.reset(gen)
    arrs = env_state_to_numpy(ts)
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), 2),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    a = np.random.default_rng(4).uniform(-1, 1, (2, 1))
    js, jo, jr, *_ = jenv.step(js, jnp.asarray(a))
    ts, to, tr, *_ = tenv.step(ts, torch.from_numpy(a))
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=1e-3)
    assert float(np.abs(np.asarray(js.y) - arrs["y"]).max()) > 1e-6
    d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert d.max() <= 1
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
    np.testing.assert_array_equal(ts.control_value.numpy(), np.asarray(js.control_value))


# ---- the CUDA wrappers -------------------------------------------------------------

def _cpu_args(kind):
    u, kap = _inputs(kind, 2)
    consts = sif_constants(16, 16, HX, HY, torch.float32, True, torch.device("cpu"))
    kw = dict(mu_fn=MU_T, dt=CASE[kind][0], A=1.0, n_steps=2, round_bf16=False)
    if kind == "ac":
        kw.update(R_fn=None, r_identity=True, hx=HX, hy=HY)
    return torch.from_numpy(u), torch.from_numpy(kap), consts, kw


@pytest.mark.parametrize("kind", ["ch", "ac"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(kind):
    u, kap, consts, kw = _cpu_args(kind)
    cuda = ch_sif_macro_cuda if kind == "ch" else ac_sif_macro_cuda
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda(u, kap, consts, **kw)
    with pytest.raises(ValueError, match="PolynomialMu"):
        cuda(u, kap, consts, **{**kw, "mu_fn": MU_J})
    if kind == "ac":
        with pytest.raises(ValueError, match="non-identity R"):
            cuda(u, kap, consts, **{**kw, "R_fn": R_J, "r_identity": False})
    # The plain path and the oracle's gradient launch nothing.
    _, t = _macros(kind, False, 2)
    ut, kt = u.clone().requires_grad_(), kap.clone().requires_grad_()
    t(ut, kt).sum().backward()
    assert ut.grad is not None and kt.grad is not None
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="multiples of 8"):
        make_ch_sif_fused_macro(MU_T, 12, 16, HX, HY, 1.0, 1e-3, 2)
    # K9a/K9b take grids up to 256² (tiled above 64²), checked before the
    # device: a 264² state raises and launches nothing.
    big = torch.zeros((2, 264, 264))
    with pytest.raises(ValueError, match=r"up to 256;"):
        cuda(big, kap, consts, **kw)
    assert kernels.launch_counts() == before


# ---- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_run(kind, dev, H, W, mats, half, n, general=False):
    """Kernel and plain version on the same card inputs; returns both and
    the plain version with the rounding off (the control)."""
    B = 300
    u, kap = _inputs(kind, B, H, W, seed=H + W)
    u, kap = torch.from_numpy(u).to(dev), torch.from_numpy(kap).to(dev)
    consts = sif_constants(H, W, HX, HY, mats, half, dev)
    kw = dict(mu_fn=MU_T, dt=CASE[kind][0], A=1.0, n_steps=n)
    if kind == "ac":
        kw.update(R_fn=R_T if general else ONES_T, r_identity=not general, hx=HX, hy=HY)
    cuda, plain = ((ch_sif_macro_cuda, ch_sif_macro_plain) if kind == "ch"
                   else (ac_sif_macro_cuda, ac_sif_macro_plain))
    name = f"{kind}_sif_macro"
    before = kernels.launch_counts()[name]
    rb = mats == torch.bfloat16
    got = cuda(u, kap, consts, round_bf16=rb, **kw)
    want = plain(u, kap, consts, round_bf16=rb, **kw)
    control = plain(u, kap, consts, round_bf16=False, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    return got, want, control, (u, kap)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16), (64, 64), (24, 40), (128, 128), (96, 136),
                                   (256, 256)],
                         ids=["16", "64", "24x40", "128", "96x136", "256"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_kernel_matches_plain_on_card(cuda_device, kind, general, half, shape):
    """f32 tables, 10 substeps: the same arithmetic in another order (above
    64² the tiled FMA kernels)."""
    got, want, _, _ = _card_run(kind, cuda_device, *shape, torch.float32, half, 10, general)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _rms(d):
    return float(d.double().pow(2).mean().sqrt())


# One substep, bf16 tables, 300 envs at 64²: the RMS of kernel - plain must
# sit below a bound that the unrounded control exceeds (a kernel that rounds
# in the wrong places moves every pixel).  Measured on an H100 with the
# tensor-core kernels: K9a 2.2e-6 against a control of 1.2e-3, K9b 1.3e-8
# (R == 1) and 1.1e-8 against controls of 5.6e-7 at these inputs' dt.
TOL_SITE = {"ch": 2e-5, "ac": 5e-8}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_kernel_rounds_where_plain_rounds_on_card(cuda_device, kind, general):
    got, want, control, _ = _card_run(kind, cuda_device, 64, 64, torch.bfloat16, True, 1, general)
    assert _rms(got - want) <= TOL_SITE[kind] < _rms(control - want), (
        _rms(got - want), _rms(control - want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,general", MACROS, ids=MACRO_IDS)
def test_kernel_matches_oracle_on_card(cuda_device, kind, general):
    got, _, _, (u, kap) = _card_run(kind, cuda_device, 64, 64, torch.float32, True, 10, general)
    torch.testing.assert_close(got, _oracle(kind, general, 10)(u, kap), rtol=0, atol=5e-5)
