"""The port's halo exchange, distributed FFT and sharded SIF macros held
against the JAX package, on four gloo processes.

The counterparts of every test of ``tests/test_halo.py``, by name.  One
group of four ranks (``torch_dist_ranks.halo_program``, torch only) runs
every case once for the whole file.  The same numpy fields go to the ranks
and to the JAX functions under ``shard_map`` on a 4-device sub-mesh of
conftest's 8 virtual devices, and each rank's block is compared with the
JAX block of the same rank, in the JAX layouts (row blocks in, column blocks
out of the forward transforms), at the JAX tests' f64 tolerances.  The
groups of two ranks (a ring whose next and previous rank are one peer) and
of one rank (the local wrap) are the port's own cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from pde_opt_tpu.ops import stencils as st
from pde_opt_tpu.ops.fused_spectral import ch_sif_macro_reference
from pde_opt_tpu.parallel import halo as jhalo
from pde_opt_tpu.parallel.mesh import shard_map
from torch_dist_ranks import halo_program, spawn_group, value

WORLD = 4


def _inputs():
    rng = np.random.default_rng(0)
    N = 4 * WORLD
    k = np.fft.fftfreq(N)
    KX, KY = np.meshgrid(k, k, indexing="ij")
    return {
        "lap2d": rng.standard_normal((N, 16)),
        "pad2": np.arange(N * 8, dtype=np.float32).reshape(N, 8),
        "fft2": rng.standard_normal((N, N)),
        "fft_rt": rng.standard_normal((N, N)),
        "symbol": -(2 * np.pi) ** 2 * (KX**2 + KY**2),
        "sif2": 0.5 + 0.05 * rng.standard_normal((8 * WORLD, 8 * WORLD)),
        "lap3d": rng.standard_normal((2 * WORLD, 12, 8)),
        "fft3": rng.standard_normal((2 * WORLD, 2 * WORLD, 4)),
        "sif3": 0.5 + 0.05 * rng.standard_normal((2 * WORLD, 2 * WORLD, 8)),
        "small": rng.standard_normal((8, 6)),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(1)
    inputs = _inputs()
    results = spawn_group(halo_program, WORLD, tmp_path_factory.mktemp("halo"), inputs)
    return inputs, results


def _case(run, name):
    return [value(r, name) for r in run[1]()]


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("space",))


def _blocks(x, axis=0):
    return np.split(np.asarray(x), WORLD, axis=axis)


def test_sharded_laplacian_matches_global(run):
    u = run[0]["lap2d"]
    f = jax.jit(shard_map(lambda ul: jhalo.sharded_lap_2nd_2d(ul, 0.1, 0.2, "space"),
                          mesh=_mesh(), in_specs=P("space"), out_specs=P("space")))
    want = _blocks(f(jnp.asarray(u)))
    glob = _blocks(st.lap_2nd_2d(jnp.asarray(u), 0.1, 0.2))
    for rank, got in enumerate(_case(run, "lap2d")):
        np.testing.assert_allclose(got, want[rank], rtol=1e-12)
        np.testing.assert_allclose(got, glob[rank], rtol=1e-12)


def test_halo_pad_width2(run):
    u = run[0]["pad2"]
    N, M = u.shape
    f = jax.jit(shard_map(lambda ul: jhalo.halo_pad_rows(ul, "space", halo=2),
                          mesh=_mesh(), in_specs=P("space"), out_specs=P("space")))
    want = _blocks(f(jnp.asarray(u)))
    rows_local = N // WORLD
    for d, got in enumerate(_case(run, "pad2")):
        assert got.shape == (rows_local + 4, M)
        np.testing.assert_array_equal(got, want[d])
        lo = (d * rows_local - 2) % N
        np.testing.assert_array_equal(got[:2], np.stack([u[(lo + i) % N] for i in range(2)]))
        np.testing.assert_array_equal(got[2:-2], u[d * rows_local:(d + 1) * rows_local])
        np.testing.assert_array_equal(
            got[-2:], np.stack([u[((d + 1) * rows_local + i) % N] for i in range(2)]))


def test_distributed_fft2_matches_global(run):
    u = run[0]["fft2"]
    f = jax.jit(shard_map(lambda ul: jhalo.distributed_fft2(ul.astype(jnp.complex128), "space"),
                          mesh=_mesh(), in_specs=P("space"), out_specs=P(None, "space")))
    want = _blocks(f(jnp.asarray(u)), axis=1)         # JAX's column blocks
    glob = _blocks(np.fft.fftn(u), axis=1)
    for rank, got in enumerate(_case(run, "fft2")):
        got = got[..., 0] + 1j * got[..., 1]
        assert got.shape == (u.shape[0], u.shape[1] // WORLD)
        np.testing.assert_allclose(got, want[rank], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got, glob[rank], rtol=1e-9, atol=1e-9)


def test_distributed_fft_roundtrip_and_spectral_multiply(run):
    """fft -> spectral Laplacian multiply -> ifft, sharded vs global."""
    u, symbol = run[0]["fft_rt"], run[0]["symbol"]

    def shard_fn(ul, sym_cols):
        fhat = jhalo.distributed_fft2(ul.astype(jnp.complex128), "space") * sym_cols
        return jhalo.distributed_ifft2(fhat, "space").real

    f = jax.jit(shard_map(shard_fn, mesh=_mesh(), in_specs=(P("space"), P(None, "space")),
                          out_specs=P("space")))
    want = _blocks(f(jnp.asarray(u), jnp.asarray(symbol)))
    glob = _blocks(np.real(np.fft.ifftn(symbol * np.fft.fftn(u))))
    for rank, got in enumerate(_case(run, "fft_roundtrip")):
        np.testing.assert_allclose(got, want[rank], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got, glob[rank], rtol=1e-9, atol=1e-9)


def test_sharded_sif_ch_macro_matches_single_device(run):
    """f64 against JAX's sharded macro and its single-device reference; a
    per-instance κ on a batch of two fields; an f32 field keeps f32 (the
    f64 symbols cast to the field's dtype) at the f32 bound."""
    u = run[0]["sif2"]
    N, M = u.shape
    hx, hy, A, dt, n = 0.01, 0.015, 1.0, 1e-3, 3
    mu = lambda c: c**3 - c
    macro = jhalo.make_sharded_sif_ch_macro(mu, N, M, hx, hy, A, dt, n)
    f = jax.jit(shard_map(lambda ul: macro(ul, 0.004), mesh=_mesh(),
                          in_specs=P("space", None), out_specs=P("space", None)))
    want = _blocks(f(jnp.asarray(u)))
    ref = ch_sif_macro_reference(mu, hx, hy, A, dt, n)
    glob = _blocks(ref(jnp.asarray(u), 0.004))
    pair = np.stack([u, 1.0 - u])
    glob_pair = np.asarray(ref(jnp.asarray(pair), jnp.asarray([0.004, 0.006])[:, None, None]))
    for rank, got in enumerate(_case(run, "sif2")):
        np.testing.assert_allclose(got["u"], want[rank], rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got["u"], glob[rank], rtol=1e-10, atol=1e-10)
        rows = slice(rank * N // WORLD, (rank + 1) * N // WORLD)
        np.testing.assert_allclose(got["batch"], glob_pair[:, rows], rtol=1e-10, atol=1e-10)
        assert got["f32"].dtype == np.float32
        np.testing.assert_allclose(got["f32"], glob[rank], rtol=0, atol=1e-5)


def test_sharded_laplacian_3d_matches_global(run):
    u = run[0]["lap3d"]
    f = jax.jit(shard_map(lambda ul: jhalo.sharded_lap_2nd_3d(ul, 0.1, 0.2, 0.3, "space"),
                          mesh=_mesh(), in_specs=P("space"), out_specs=P("space")))
    want = _blocks(f(jnp.asarray(u)))
    glob = _blocks(st.lap_2nd_3d(jnp.asarray(u), 0.1, 0.2, 0.3))
    for rank, got in enumerate(_case(run, "lap3d")):
        np.testing.assert_allclose(got, want[rank], rtol=1e-12)
        np.testing.assert_allclose(got, glob[rank], rtol=1e-12)


def test_distributed_fft3_roundtrip_and_matches_global(run):
    u = run[0]["fft3"]
    fwd = jax.jit(shard_map(lambda ul: jhalo.distributed_fft3(ul.astype(jnp.complex128), "space"),
                            mesh=_mesh(), in_specs=P("space"), out_specs=P(None, "space", None)))
    want = _blocks(fwd(jnp.asarray(u)), axis=1)        # (N, M/P, K) blocks
    glob = _blocks(np.fft.fftn(u), axis=1)
    for rank, got in enumerate(_case(run, "fft3")):
        f = got["fwd"][..., 0] + 1j * got["fwd"][..., 1]
        assert f.shape == (u.shape[0], u.shape[1] // WORLD, u.shape[2])
        np.testing.assert_allclose(f, want[rank], rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(f, glob[rank], rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got["roundtrip"], _blocks(u)[rank], rtol=1e-12, atol=1e-12)


def test_sharded_sif_ch3d_macro_matches_single_device(run):
    """The sharded 3D macro against JAX's and the single-device FD-symbol
    update with numpy's FFT."""
    u0 = run[0]["sif3"]
    N, M, K = u0.shape
    mu = lambda c: c**3 - c
    hx = hy = hz = 0.01
    kappa, A, dt, n = 2e-3, 0.5, 1e-5, 6
    macro = jhalo.make_sharded_sif_ch3d_macro(mu, N, M, K, hx, hy, hz, A, dt, n)
    want = _blocks(jax.jit(shard_map(lambda ul: macro(ul, kappa), mesh=_mesh(),
                                     in_specs=P("space"), out_specs=P("space")))(jnp.asarray(u0)))
    lam = ((2 * np.cos(2 * np.pi * np.arange(N) / N) - 2)[:, None, None] / hx**2
           + (2 * np.cos(2 * np.pi * np.arange(M) / M) - 2)[None, :, None] / hy**2
           + (2 * np.cos(2 * np.pi * np.arange(K) / K) - 2)[None, None, :] / hz**2)
    denom = 1.0 / (1.0 + A * dt * kappa * lam**2)
    u = u0
    for _ in range(n):
        incr = denom * (lam * np.fft.fftn(mu(u)) - kappa * lam**2 * np.fft.fftn(u))
        u = u + dt * np.fft.ifftn(incr).real
    glob = _blocks(u)
    for rank, got in enumerate(_case(run, "sif3")):
        np.testing.assert_allclose(got, want[rank], rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, glob[rank], rtol=0, atol=1e-10)


def test_ring_of_two_ranks_pads_and_transposes(run):
    """Groups [0, 1] and [2, 3]: next and previous rank are one peer, the
    messages match in the order they were posted; halo widths 1 and 3."""
    u = run[0]["small"]
    n = u.shape[0]
    half = n // 2
    f = np.fft.fftn(u)
    for rank, got in enumerate(_case(run, "small_groups")):
        r = rank % 2
        rows = np.arange(r * half, (r + 1) * half)
        for h, key in ((1, "pair_pad"), (3, "pair_pad3")):
            want = u[np.arange(r * half - h, (r + 1) * half + h) % n]
            np.testing.assert_array_equal(got[key], want)
        got_f = got["pair_fft"][..., 0] + 1j * got["pair_fft"][..., 1]
        np.testing.assert_allclose(got_f, np.split(f, 2, axis=1)[r], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got["pair_back"], u[rows], rtol=1e-12, atol=1e-12)


def test_ring_of_one_rank_is_the_local_wrap(run):
    u = run[0]["small"]
    for got in _case(run, "small_groups"):
        np.testing.assert_array_equal(got["single_pad"], np.concatenate([u[-2:], u, u[:2]]))
        np.testing.assert_allclose(got["single_lap"], got["lap"], rtol=1e-12)
        assert got["single_fft_err"] < 1e-12
