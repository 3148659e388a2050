"""The port's dense and separable spectral solves (``ops/dft.py``) and the
dense-solve stepper (``SemiImplicitDenseSolve``), held against the JAX
package on the same numpy inputs, and ``tests/test_dense_solve.py``'s four
checks mirrored at its N = 32.

Tolerances: the dense matrix and the f32 solve against JAX rtol 1e-5 /
atol 1e-6 (two f32 products summed in other orders); the bf16 solves
against JAX within 1e-5 of the output's maximum (bf16-exact operands, f32
sums in another order; the sqrt form also rounds the half-solved field to
bf16, where a sum near a tie can round apart); the separable solve atol
1e-5; one step of the dense CH preset with f32 products field atol 1e-5.
"""

import numpy as np
import pytest
import torch

from pde_opt_tpu_torch import grid as tgrid
from pde_opt_tpu_torch.models.cahn_hilliard import CahnHilliard2DPeriodic as TCH
from pde_opt_tpu_torch.ops import dft as tdft
from pde_opt_tpu_torch.ops.steppers import SemiImplicitDenseSolve, SemiImplicitFourierSpectral

torch.set_num_threads(1)

N = 32
L = 0.01 * N
BOX = ((-L / 2, L / 2), (-L / 2, L / 2))


def _symbol(mesh):
    kx, ky = mesh
    return 0.01 * ((2 * np.pi * kx) ** 2 + (2 * np.pi * ky) ** 2) ** 2


def _setup():
    domain = tgrid.Domain((N, N), BOX)
    eq = TCH(domain, 0.004, lambda c: c**3 - c, torch.ones_like, device="cpu")
    rng = np.random.default_rng(0)
    u0 = np.clip(0.5 + 0.01 * rng.standard_normal((4, N, N)), 0, 1).astype(np.float32)
    return domain, eq, _symbol(domain.fft_mesh()), torch.from_numpy(u0)


# ---- tests/test_dense_solve.py, mirrored ----------------------------------------

def test_dense_f32_matches_fft_fixed_symbol():
    domain, eq, symbol, u0 = _setup()
    dense = SemiImplicitDenseSolve(0.5, symbol, domain.points, dtype="f32")
    symbol_r = torch.from_numpy(_symbol(domain.rfft_mesh()))
    fft = SemiImplicitFourierSpectral(0.5, symbol_r, eq.fft, eq.ifft)
    y_d, y_f = u0, u0
    for _ in range(5):
        y_d, _ = dense.step(eq.rhs, y_d, 0.0, 1e-3)
        y_f, _ = fft.step(eq.rhs, y_f, 0.0, 1e-3)
        y_f = y_f.to(u0.dtype)
    np.testing.assert_allclose(y_d.numpy(), y_f.numpy(), rtol=1e-4, atol=1e-6)


def test_dense_solve_matrix_matches_fft_solve():
    domain, _, symbol, _ = _setup()
    denom = 1.0 / (1.0 + 0.5 * 1e-3 * symbol)
    solve = tdft.make_dense_spectral_solve(domain.points, denom, dtype="f32", device="cpu")
    x = np.random.default_rng(1).standard_normal((N, N))
    ref = np.real(np.fft.ifftn(np.fft.fftn(x) * denom))
    got = solve(torch.from_numpy(x.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_bf16_sqrt_long_rollout_stable():
    """The sqrt-factored bf16 solve stays bounded in the stiff loop over
    300 substeps (the flat bf16 solve is the unstable one)."""
    domain, eq, symbol, u0 = _setup()
    dense = SemiImplicitDenseSolve(0.5, symbol, domain.points, dtype="bf16_sqrt")
    y = u0
    for _ in range(300):
        y, _ = dense.step(eq.rhs, y, 0.0, 1e-3)
    assert bool(torch.isfinite(y).all())
    assert float(y.abs().max()) < 2.0


def test_dense_requires_concrete_dt():
    """A tensor dt raises TypeError, as a traced dt does in JAX."""
    domain, eq, symbol, u0 = _setup()
    dense = SemiImplicitDenseSolve(0.5, symbol, domain.points)
    with pytest.raises(TypeError, match="Python-number dt"):
        dense.step(eq.rhs, u0, 0.0, torch.tensor(1e-3))


def test_dense_solves_are_shared_by_equal_configurations():
    """An env builds a stepper every step: equal configurations share one
    solve per dt and device, and another symbol or dt gets its own."""
    _, _, symbol, _ = _setup()
    cpu = torch.device("cpu")
    first = SemiImplicitDenseSolve(0.5, symbol, (N, N))._solve_for_dt(1e-3, cpu)
    assert SemiImplicitDenseSolve(0.5, symbol.copy(), (N, N))._solve_for_dt(1e-3, cpu) is first
    assert SemiImplicitDenseSolve(0.5, 2 * symbol, (N, N))._solve_for_dt(1e-3, cpu) is not first
    assert SemiImplicitDenseSolve(0.5, symbol, (N, N))._solve_for_dt(2e-3, cpu) is not first


# ---- parity with the JAX package ---------------------------------------------

def test_dense_solve_matrix_matches_jax():
    from pde_opt_tpu.ops import dft as jdft

    denom = np.random.default_rng(2).uniform(0.1, 1.0, (8, 12))
    np.testing.assert_array_equal(tdft.dense_solve_matrix((8, 12), denom),
                                  jdft.dense_solve_matrix((8, 12), denom))


@pytest.mark.parametrize("dtype", ["bf16_sqrt", "bf16", "f32"])
def test_dense_spectral_solve_matches_jax(dtype):
    """The three dtypes of ``make_dense_spectral_solve`` against JAX's on a
    (2, 3, N, N) batch; the CPU product route keeps JAX's f32 output."""
    import jax.numpy as jnp

    from pde_opt_tpu.ops import dft as jdft

    domain, _, symbol, _ = _setup()
    denom = 1.0 / (1.0 + 0.5 * 1e-3 * symbol)
    x = np.random.default_rng(3).standard_normal((2, 3, N, N)).astype(np.float32)
    want = np.asarray(jdft.make_dense_spectral_solve(domain.points, denom, dtype=dtype)(
        jnp.asarray(x)))
    got = tdft.make_dense_spectral_solve(domain.points, denom, dtype=dtype, device="cpu")(
        torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # The bf16 forms differ from the exact solve by their roundings.
    exact = tdft.make_dense_spectral_solve(domain.points, denom, dtype="f32", device="cpu")(
        torch.from_numpy(x))
    assert (dtype == "f32") == bool(torch.allclose(got, exact, rtol=0, atol=1e-5))


def test_dense_sqrt_refuses_a_negative_denominator():
    with pytest.raises(ValueError, match="nonnegative"):
        tdft.make_dense_spectral_solve((4, 4), -np.ones((4, 4)), dtype="bf16_sqrt",
                                       device="cpu")
    with pytest.raises(ValueError, match="unknown dtype"):
        tdft.make_dense_spectral_solve((4, 4), np.ones((4, 4)), dtype="f16", device="cpu")


def test_solves_default_to_the_card():
    """Both builders put their tables on the card unless the caller names
    another device; without CUDA, naming none raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdft.make_dense_spectral_solve((4, 4), np.ones((4, 4)), dtype="f32")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdft.make_separable_spectral_solve((4, 4))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_separable_spectral_solve_matches_jax(dtype):
    """``make_separable_spectral_solve`` with a per-env full-spectrum
    denominator on a (3, 16, 24) batch, against JAX's."""
    import jax.numpy as jnp

    from pde_opt_tpu.ops import dft as jdft

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16, 24)).astype(np.float32)
    denom = rng.uniform(0.2, 1.0, (3, 16, 24)).astype(np.float32)
    want = np.asarray(jdft.make_separable_spectral_solve((16, 24), dtype=dtype)(
        jnp.asarray(x), jnp.asarray(denom)))
    got = tdft.make_separable_spectral_solve((16, 24), dtype=dtype, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(denom))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = np.real(np.fft.ifftn(np.fft.fftn(x, axes=(-2, -1)) * denom, axes=(-2, -1)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 if dtype == "f32" else 5e-2)


def test_dense_stepper_matches_jax():
    """Five substeps of ``SemiImplicitDenseSolve`` (bf16 sqrt) on the CH rhs
    against JAX's stepper, each from JAX's field: the increment within
    1e-2 of its maximum (a bf16 ulp is 3.9e-3 of a value: the half-solved
    field rounds apart near ties), and its RMS distance a tenth of the f32
    solve's (the control, which skips the rounding sites); the error
    estimate likewise."""
    import jax.numpy as jnp

    from pde_opt_tpu import grid as jgrid
    from pde_opt_tpu.models.cahn_hilliard import CahnHilliard2DPeriodic as JCH
    from pde_opt_tpu.ops.steppers import SemiImplicitDenseSolve as JDense

    domain, eq, symbol, u0 = _setup()
    jdom = jgrid.Domain((N, N), BOX)
    jeq = JCH(jdom, 0.004, lambda c: c**3 - c, lambda c: jnp.ones_like(c))
    j = JDense(0.5, symbol, (N, N))
    t = SemiImplicitDenseSolve(0.5, symbol, (N, N))
    ctl = SemiImplicitDenseSolve(0.5, symbol, (N, N), dtype="f32")
    assert t == SemiImplicitDenseSolve(0.5, symbol, (N, N)) and hash(t) == hash(
        SemiImplicitDenseSolve(0.5, symbol, (N, N)))
    assert t != ctl

    def rms(x):
        return float(np.sqrt((x.astype(np.float64) ** 2).mean()))

    yj = jnp.asarray(u0.numpy())
    for _ in range(5):
        y = torch.from_numpy(np.asarray(yj))
        yj1, ej = j.step(jeq.rhs, yj, 0.0, 1e-3)
        yt, et = t.step(eq.rhs, y, 0.0, 1e-3)
        yc, _ = ctl.step(eq.rhs, y, 0.0, 1e-3)
        dj, dt_, dc = (np.asarray(yj1) - np.asarray(yj)), (yt - y).numpy(), (yc - y).numpy()
        assert np.abs(dt_ - dj).max() <= 1e-2 * np.abs(dj).max()
        assert rms(dt_ - dj) <= 0.1 * rms(dc - dj)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0,
                                   atol=1e-2 * np.abs(np.asarray(ej)).max())
        yj = yj1


@pytest.mark.parametrize("solve", ["dense", "dense_bf16"])
def test_dense_preset_step_matches_jax(solve):
    """One step of the CH preset with ``spectral_solve="dense"`` (A = 0.5,
    the fixed symbol κ_max (2π|k|)⁴, bf16 sqrt) and ``"dense_bf16"`` (flat
    bf16) at 32²: the preset's configuration equals JAX's, its bf16 fleet
    steps from its own reset state to finite fields, and, with both
    steppers' products switched to f32, a step from the same rough field
    (0.5 ± 0.05) matches the JAX env: field atol 1e-5, reward rtol 1e-3,
    obs within 1 LSB.  With bf16 products from that field the solve rounds
    the rhs (up to 3.2e6 at this κ and spacing) to bf16, whose low-k error
    moves an env's mean by up to 0.066 within a step (f32: 3e-6), in JAX and
    the port alike, a rounding apart: ``test_dense_stepper_matches_jax``
    holds those roundings one substep at a time."""
    import jax
    import jax.numpy as jnp

    from pde_opt_tpu.envs.presets import make_cahn_hilliard_control_env as jpreset
    from pde_opt_tpu.envs.vector_env import EnvState as JState
    from pde_opt_tpu_torch.envs.presets import make_cahn_hilliard_control_env as tpreset
    from pde_opt_tpu_torch.envs.vector_env import env_state_from_numpy

    n = 4
    kw = dict(num_envs=n, grid_size=N, substeps=10, spectral_solve=solve)
    jenv, tenv = jpreset(**kw), tpreset(device="cpu", **kw)
    assert tenv.solver_parameters["dtype"] == jenv.solver_parameters["dtype"] == (
        "bf16_sqrt" if solve == "dense" else "bf16")
    assert tenv.solver_parameters["A"] == jenv.solver_parameters["A"] == 0.5
    np.testing.assert_array_equal(tenv.solver_parameters["dense_symbol"],
                                  jenv.solver_parameters["dense_symbol"])
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (n, 1))
    ts, _ = tenv.reset(gen)
    ts, _, tr, *_ = tenv.step(ts, torch.from_numpy(a))
    assert bool(torch.isfinite(ts.y).all()) and bool(torch.isfinite(tr).all())
    jenv.solver_parameters = {**jenv.solver_parameters, "dtype": "f32"}
    tenv.solver_parameters = {**tenv.solver_parameters, "dtype": "f32"}
    arrs = {"y": (0.5 + 0.05 * rng.standard_normal((n, N, N))).astype(np.float32),
            "t": np.zeros(n, np.float32),
            "control_value": rng.uniform(2e-3, 1e-2, n).astype(np.float32),
            "step_count": np.zeros(n, np.int32), "done": np.zeros(n, bool)}
    js = JState(y=jnp.asarray(arrs["y"]), t=jnp.asarray(arrs["t"]),
                control_value=jnp.asarray(arrs["control_value"]),
                key=jax.random.split(jax.random.PRNGKey(0), n),
                step_count=jnp.asarray(arrs["step_count"]), done=jnp.asarray(arrs["done"]))
    ts = env_state_from_numpy(arrs, "cpu")
    js, jo, jr, *_ = jenv.step(js, jnp.asarray(a))
    ts, to, tr, *_ = tenv.step(ts, torch.from_numpy(a))
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(js.y) - arrs["y"]).max()) > 1e-2
    d = np.abs(to.numpy().astype(np.int32) - np.asarray(jo).astype(np.int32))
    assert d.max() <= 1
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-3)
