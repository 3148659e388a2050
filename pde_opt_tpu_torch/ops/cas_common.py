"""What the cas-transform macro families share (PyTorch port): the
polynomial coefficient functions, the cas (Hartley) matrices and the FD
Laplacian symbol, the transforms with the JAX kernels' bf16 rounding, the
field epilogue, the batch flattening, the shape rules of the CUDA kernels
and the autograd function whose VJP is an FFT oracle's.

The CH and AC macros (:mod:`.cas_spectral`), the BV macro (:mod:`.bv_cas`),
the GPE macro (:mod:`.gpe_cas`), the SBM-BV macro (:mod:`.sbm_bv`) and the
packed-DFT macros (:mod:`.fused_spectral`) import these names from here and
from no other family; how a kernel is called lives in :mod:`.kernels`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .fold import fold_vmap
from .kernels import check_cuda

__all__ = [
    "MAX_MU_DEGREE",
    "MAX_GRID_TILED",
    "PolynomialMu",
    "c_coeffs",
    "cas_mat",
    "cas_mats",
    "fd_lap_symbols",
    "planes_fold",
    "CasConstants",
    "cas_constants",
    "ch_multipliers",
    "transforms",
    "Epilogue",
    "NO_EPILOGUE",
    "epilogue_plain",
    "fold_stats_cotangent",
    "flatten_batch",
    "r_is_identity",
    "OracleMacro",
    "check_config",
    "check_polynomials",
    "check_grid",
    "check_state",
    "check_mats",
    "mats_ptrs",
    "macro_outputs",
]

MAX_MU_DEGREE = 7
# The largest H, W each CUDA macro takes: every family (K1-K7, K9a/K9b) runs
# tiled kernels above 64^2, up to MAX_GRID_TILED.
MAX_GRID_TILED = 256


class PolynomialMu:
    """``mu(c) = sum_i coeffs[i] * c**i``, evaluated by Horner's rule.

    The CUDA kernel cannot trace a Python callable the way the Pallas kernel
    traces ``mu_fn``; it reads these coefficients instead.  Degree ≤ 7.
    ``PolynomialMu((0.0, -1.0, 0.0, 1.0))`` is the CH preset's ``c**3 - c``.
    """

    def __init__(self, coeffs: Sequence[float]):
        coeffs = tuple(float(c) for c in coeffs)
        if not 1 <= len(coeffs) <= MAX_MU_DEGREE + 1:
            raise ValueError(
                f"PolynomialMu takes 1 to {MAX_MU_DEGREE + 1} coefficients, "
                f"got {len(coeffs)}"
            )
        self.coeffs = coeffs

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        p = torch.full_like(c, self.coeffs[-1])
        for a in reversed(self.coeffs[:-1]):
            p = p * c + a
        return p

    def derivative(self) -> "PolynomialMu":
        """``mu'`` as a polynomial: what the backward kernel evaluates where
        the JAX kernel takes ``jax.jvp`` of ``mu_fn``."""
        d = tuple(i * c for i, c in enumerate(self.coeffs) if i)
        return PolynomialMu(d or (0.0,))

    def __eq__(self, other):
        return isinstance(other, PolynomialMu) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash((PolynomialMu, self.coeffs))

    def __repr__(self):
        return f"PolynomialMu({self.coeffs})"


def c_coeffs(mu: PolynomialMu):
    """``(float[n], n)``: a polynomial's coefficients as a C entry takes them."""
    return (ctypes.c_float * len(mu.coeffs))(*mu.coeffs), len(mu.coeffs)


def cas_mat(N: int) -> np.ndarray:
    """Symmetric cas (Hartley) matrix: C @ C = N * I."""
    x = np.arange(N)
    ang = 2.0 * np.pi * np.outer(x, x) / N
    return np.cos(ang) + np.sin(ang)


def cas_mats(H: int, W: int, mats_dtype: torch.dtype, device: torch.device) -> dict:
    """``ch``, ``cw`` and the inverses ``ich``, ``icw`` (``C/N``), f32 and
    rounded to ``mats_dtype``, and with bf16 matrices their exact bf16
    copies ``ch16`` .. ``icw16``: the matrix fields of :class:`CasConstants`
    (and of the GPE macro's constants)."""

    def mat(m):
        return torch.from_numpy(m).to(mats_dtype).to(device, torch.float32).contiguous()

    mats = {"ch": mat(cas_mat(H)), "cw": mat(cas_mat(W)),
            "ich": mat(cas_mat(H) / H), "icw": mat(cas_mat(W) / W)}
    if mats_dtype == torch.bfloat16:
        mats.update({f"{n}16": m.to(torch.bfloat16) for n, m in list(mats.items())})
    return mats


def fd_lap_symbols(H: int, W: int, hx: float, hy: float):
    """FD Laplacian eigenvalues per axis (roll-stencil spectrum)."""
    lam_h = (2.0 * np.cos(2.0 * np.pi * np.arange(H) / H) - 2.0) / (hx * hx)
    lam_w = (2.0 * np.cos(2.0 * np.pi * np.arange(W) / W) - 2.0) / (hy * hy)
    return lam_h, lam_w


class CasConstants(NamedTuple):
    """The macro's constant operands, contiguous on one device.

    ``ch``/``cw`` are the cas matrices and ``ich``/``icw`` the inverse pair
    ``C/N``, f32, each already rounded to ``mats_dtype``; ``lam``/``lam2``
    are the FD Laplacian symbol and its square on the (H, W) grid (f32).
    With bf16 matrices, ``ch16`` .. ``icw16`` are the same four as bf16
    tensors (exact copies), which the tiled tensor-core CH kernels read;
    ``None`` with f32 matrices, where those kernels refuse the launch.
    ``lam_h`` (H,) and ``lam_w`` (W,) are the f64 axis symbols that ``lam =
    f32(lam_h + lam_w)`` and ``lam2 = f32((lam_h + lam_w)**2)`` are built
    from; the on-chip CH forward rebuilds the two planes from them.
    ``fold`` says that both planes equal their folded entries bit for bit
    (:func:`planes_fold`), so that the on-chip CH forward may compute each
    env's multipliers once, at the folded pixels alone.
    """

    ch: torch.Tensor
    cw: torch.Tensor
    ich: torch.Tensor
    icw: torch.Tensor
    lam: torch.Tensor
    lam2: torch.Tensor
    ch16: Optional[torch.Tensor] = None
    cw16: Optional[torch.Tensor] = None
    ich16: Optional[torch.Tensor] = None
    icw16: Optional[torch.Tensor] = None
    lam_h: Optional[torch.Tensor] = None
    lam_w: Optional[torch.Tensor] = None
    fold: bool = False


def planes_fold(*planes: np.ndarray) -> bool:
    """Whether every (H, W) plane equals its folded entries bit for bit:
    ``p[i, j] == p[min(i, H - i), min(j, W - j)]`` for all ``i``, ``j``."""
    H, W = planes[0].shape
    fi = np.minimum(np.arange(H), H - np.arange(H))
    fj = np.minimum(np.arange(W), W - np.arange(W))
    return all(np.array_equal(p, p[np.ix_(fi, fj)]) for p in planes)


@functools.lru_cache(maxsize=32)
def cas_constants(H: int, W: int, hx: float, hy: float,
                  mats_dtype: torch.dtype, device: torch.device) -> CasConstants:
    """Build (once per configuration and device) the macro's constants."""
    lam_h, lam_w = fd_lap_symbols(H, W, hx, hy)
    lam = lam_h[:, None] + lam_w[None, :]                          # (H, W) f64
    lam32, lam2_32 = lam.astype(np.float32), (lam**2).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device).contiguous()

    return CasConstants(**cas_mats(H, W, mats_dtype, device), lam=dev(lam32), lam2=dev(lam2_32),
                        lam_h=dev(lam_h), lam_w=dev(lam_w), fold=planes_fold(lam32, lam2_32))


def ch_multipliers(kappa, lam, lam2, A, dt):
    """Per-env ``(denom, cm, cu)`` of the semi-implicit CH update, f32, in
    the JAX kernel's order."""
    k = kappa.reshape(-1, 1, 1)
    denom = 1.0 / (1.0 + float(A) * float(dt) * (k * lam2))
    cm = (float(dt) * lam) * denom
    cu = (float(dt) * k) * lam2 * denom
    return denom, cm, cu


def transforms(consts, round_bf16: bool):
    """``(fwd, inv)`` of the JAX kernel's ``make_transforms`` on the cas
    matrices of ``consts``: with bf16 matrices each transform rounds its
    operand and its intermediate."""
    if round_bf16:
        def rnd(z):
            return z.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(z):
            return z

    def transform(z, mh, mw):
        t = rnd(torch.matmul(rnd(z).transpose(-1, -2), mh))          # [b, w, k]
        return torch.matmul(t.transpose(-1, -2), mw)                  # [b, k, l]

    return (lambda z: transform(z, consts.ch, consts.cw),
            lambda z: transform(z, consts.ich, consts.icw))


class Epilogue(NamedTuple):
    """Env-epilogue configuration (the kernel's ``_ep_parse``)."""

    obs_scale: float = 255.0
    obs_offset: float = 0.0
    center: float = 0.0
    ds: int = 1

    @classmethod
    def from_dict(cls, cfg: dict, H: int, W: int) -> "Epilogue":
        return cls(float(cfg.get("obs_scale", 255.0)),
                   float(cfg.get("obs_offset", 0.0)),
                   float(cfg.get("stats_center", 0.0)),
                   int(cfg.get("obs_downsample", 1))).checked(H, W)

    def checked(self, H: int, W: int) -> "Epilogue":
        """``self``, or ``ValueError`` where ``ds`` does not divide the grid."""
        if self.ds < 1 or H % self.ds or W % self.ds:
            raise ValueError(f"obs_downsample={self.ds} must divide {(H, W)}")
        return self


# What a launch passes for the epilogue's constants where it has none.
NO_EPILOGUE = Epilogue(0.0, 0.0, 0.0, 1)


def epilogue_plain(u: torch.Tensor, epilogue: Epilogue):
    """The field epilogue of the CH and AC macros on the final field ``u``
    (B, H, W): ``(stats (B, 3), obs uint8)``."""
    fin = torch.isfinite(u)
    uz = torch.where(fin, u - epilogue.center, torch.zeros_like(u))
    stats = torch.stack(
        [uz.sum((-2, -1)), (uz * uz).sum((-2, -1)),
         fin.sum((-2, -1)).to(torch.float32)], dim=-1,
    )
    ds = epilogue.ds
    if ds > 1:
        B, H, W = u.shape
        inv = 1.0 / ds
        pooled = (uz.reshape(B, H // ds, ds, W // ds, ds) * inv).sum(2)
        pooled = (pooled * inv).sum(-1)                               # (B, Hd, Wd)
        x = (pooled + epilogue.center) * epilogue.obs_scale + epilogue.obs_offset
    else:
        x = torch.where(fin, u, torch.zeros_like(u)) * epilogue.obs_scale + epilogue.obs_offset
    return stats, torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def fold_stats_cotangent(u1, gu, gstats, center):
    """Fold the stats cotangent into the field cotangent at the final field
    (``s1 = sum(uz)``, ``s2 = sum(uz²)`` over the NaN-masked centered field
    ``uz``; the finite count has zero gradient almost everywhere)."""
    fin = torch.isfinite(u1)
    uz = torch.where(fin, u1 - center, torch.zeros_like(u1))
    return gu + torch.where(
        fin, gstats[..., 0, None, None] + 2.0 * uz * gstats[..., 1, None, None],
        torch.zeros_like(u1),
    )


def flatten_batch(state: torch.Tensor, kappa, H: int, W: int):
    """``(batch, x (B, H, W) f32, kapf (B,) f32)`` from a ``(*batch, H, W)``
    state and a scalar, ``(B,)`` or batch-shaped κ.  The broadcast to a flat
    ``(B,)`` vector is plain torch, so every κ shape gets its cotangent from
    autograd."""
    *batch, h, w = state.shape
    if (h, w) != (H, W):
        raise ValueError(f"state trailing shape {(h, w)} != {(H, W)}")
    B = math.prod(batch) if batch else 1
    x = state.reshape(B, H, W).to(torch.float32).contiguous()
    kap = torch.as_tensor(kappa, dtype=torch.float32, device=state.device)
    kapf = (torch.broadcast_to(kap, (B,)) if kap.ndim <= 1
            else kap.reshape(B)).contiguous()
    return batch, x, kapf


# The JAX AC macro's identity-R probe points: dense on the physical [-2, 2]
# band, geometric out to +-64.
_R_PROBE = np.concatenate([
    np.linspace(-2.0, 2.0, 257),
    np.geomspace(2.0, 64.0, 32),
    -np.geomspace(2.0, 64.0, 32),
])


def _probe_r_identity(R_fn) -> bool:
    if R_fn is None:
        return True
    try:
        out = R_fn(torch.as_tensor(_R_PROBE, dtype=torch.float32))
        out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        return bool(np.array_equal(out, np.ones_like(_R_PROBE)))
    except Exception:
        return False


_probe_r_identity_cached = functools.lru_cache(maxsize=64)(_probe_r_identity)


def r_is_identity(R_fn) -> bool:
    """The JAX AC macro's verdict on ``R ≡ 1`` (``R_fn=None`` counts as 1).

    Same probe points and exact equality as the JAX package, evaluated in
    float32 on the CPU (the JAX package's default precision): an R that is
    1 at every probe point is treated as identity, and the macro takes the
    3-transform path.  The verdict is cached per ``R_fn``, so rebuilding the
    macro every env step runs the probe once.
    """
    try:
        return _probe_r_identity_cached(R_fn)
    except TypeError:                      # an unhashable callable
        return _probe_r_identity(R_fn)


def _oracle_vjp(oracle: Callable, g, *inputs):
    """Cotangents of ``inputs`` under ``oracle(*inputs)`` for the output
    cotangent ``g``: reverse mode through the (checkpointed) FFT oracle,
    re-run here from the saved inputs."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs]
        out = oracle(*xs)
        return torch.autograd.grad(out, xs, g)


class OracleMacro(torch.autograd.Function):
    """A macro whose VJP is the checkpointed FFT oracle's (the JAX package's
    ``_attach_oracle_vjp``): the AC, GPE, BV, SBM-BV and packed-DFT macros,
    epilogue on or off.

    ``run(x, c)`` is the forward (the kernel or its plain version) and
    returns ``out``, or ``(out, stats, obs)`` when ``fold`` is given;
    ``obs`` is not differentiable, and ``fold(out, g_out, g_stats)`` folds
    the stats cotangent into the output cotangent before the oracle VJP.
    Under :func:`torch.func.vmap` the vmapped axis folds into the env axis:
    ``run`` sees the whole fleet at once."""

    @staticmethod
    def forward(x, c, run, oracle, fold):
        return run(x, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, c, _, ctx.oracle, ctx.fold = inputs
        if ctx.fold is None:
            ctx.save_for_backward(x, c)
            return
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(x, c, output[0])

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(OracleMacro.apply, info, in_dims, 2, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, *g_ep):
        x, c, *out = ctx.saved_tensors
        if ctx.fold is not None:
            g = ctx.fold(out[0], g, g_ep[0])
        dx, dc = _oracle_vjp(ctx.oracle, g, x, c)
        return dx, dc, None, None, None


def check_config(H: int, W: int, mats_dtype: torch.dtype = torch.float32):
    """Raise unless a macro can be built for an (H, W) grid (multiples of
    8) with ``mats_dtype`` (bf16 or f32)."""
    if H % 8 or W % 8:
        raise ValueError(f"H, W must be multiples of 8, got {(H, W)}")
    if mats_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mats_dtype must be bf16 or f32, got {mats_dtype}")


def check_polynomials(mu_fn, R_fn=None, r_identity: bool = True):
    """Raise unless a CUDA macro can read ``mu`` (and ``R``, unless
    ``r_identity``) as :class:`PolynomialMu` coefficients."""
    if not r_identity and not isinstance(R_fn, PolynomialMu):
        raise ValueError(
            "the CUDA AC macro evaluates a non-identity R from polynomial "
            f"coefficients: pass a PolynomialMu, got {R_fn!r}"
        )
    if not isinstance(mu_fn, PolynomialMu):
        raise ValueError(
            "the CUDA macro evaluates mu from polynomial coefficients: pass a "
            f"PolynomialMu, got {mu_fn!r}"
        )


def check_grid(u, ndim: int = 3):
    """Raise on a state the CUDA kernels do not take: ``(B, H, W)`` (with
    ``ndim=4`` ``(B, H, W, 2)``), B >= 1, H and W multiples of 8 up to
    :data:`MAX_GRID_TILED`.  Returns ``(B, H, W)``."""
    if u.ndim != ndim or (ndim == 4 and u.shape[-1] != 2):
        want = "(B, H, W)" if ndim == 3 else "(B, H, W, 2)"
        raise ValueError(f"the state must be {want}, got shape {tuple(u.shape)}")
    B, H, W = u.shape[:3]
    cap = MAX_GRID_TILED
    if B < 1 or H % 8 or W % 8 or not (8 <= H <= cap and 8 <= W <= cap):
        raise ValueError(
            f"the CUDA macro takes B >= 1 envs and H, W multiples of 8 up to "
            f"{cap}; got {(B, H, W)}"
        )
    return B, H, W


def check_state(u, control, control_name: str):
    """Raise unless ``u`` is a ``(B, H, W)`` f32 state the CUDA kernels take
    and ``control`` its ``(B,)`` f32 per-env control (κ or the C-rate), both
    on ``u``'s device; returns ``(B, H, W)``."""
    B, H, W = check_grid(u)
    check_cuda("u", u, (B, H, W), torch.float32, u.device)
    check_cuda(control_name, control, (B,), torch.float32, u.device)
    return B, H, W


def check_mats(consts, H: int, W: int, dev):
    """Raise unless ``consts`` holds the cas matrices ``ch, cw, ich, icw``
    (f32) on ``dev`` for an (H, W) grid, and their bf16 copies ``ch16`` ..
    ``icw16`` where it has them."""
    for name, shape in (("ch", (H, H)), ("cw", (W, W)), ("ich", (H, H)), ("icw", (W, W))):
        check_cuda(name, getattr(consts, name), shape, torch.float32, dev)
        if getattr(consts, name + "16") is not None:
            check_cuda(name + "16", getattr(consts, name + "16"), shape, torch.bfloat16, dev)


def mats_ptrs(consts):
    """The pointers of ``ch, cw, ich, icw, ch16 .. icw16`` as the launches
    take them, null where there is no bf16 copy (f32 matrices: a launch
    refuses a grid whose kernel reads one)."""
    return tuple(None if m is None else m.data_ptr()
                 for m in (consts.ch, consts.cw, consts.ich, consts.icw, consts.ch16,
                           consts.cw16, consts.ich16, consts.icw16))


def macro_outputs(x: torch.Tensor, epilogue, ds: int = 1):
    """``(out, stats, obs)`` as a macro kernel writes them: ``out`` shaped
    as ``x`` (``(B, H, W)``, or ``(B, H, W, 2)`` for the GPE state); with an
    ``epilogue``, the per-env stats ``(B, 3)`` f32 and the uint8 observation
    ``(B, H/ds, W/ds)``, else None for both."""
    out = torch.empty_like(x)
    if epilogue is None:
        return out, None, None
    B, H, W = x.shape[:3]
    return (out, torch.empty((B, 3), dtype=torch.float32, device=x.device),
            torch.empty((B, H // ds, W // ds), dtype=torch.uint8, device=x.device))
