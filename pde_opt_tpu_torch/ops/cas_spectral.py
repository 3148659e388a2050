"""Hartley-transform fused semi-implicit CH and AC macro-steps (PyTorch port).

Counterpart of :func:`pde_opt_tpu.ops.cas_spectral.make_ch_cas_fused_macro`
and :func:`~pde_opt_tpu.ops.cas_spectral.make_ch_cas_fused_macro_ep`.  Every
multiplier of the semi-implicit CH update is even in each frequency axis,
so the real, symmetric cas transform ``C[x,k] = cos(2πxk/N) + sin(2πxk/N)``
diagonalises it; the spectrum ``u~`` is carried across substeps:

    u~ = fwd(u)                                     fwd(z) = C_H^T z C_W
    n_steps times:
        incr = cm * fwd(mu(u)) - cu * u~            inv(z) = fwd(z) / (H W)
        u~  += incr
        u   += inv(incr)

with ``cm = dt lam / (1 + A dt κ lam²)`` and ``cu = dt κ lam² / (1 + A dt κ
lam²)`` for the FD Laplacian symbol ``lam`` and each env's own κ.  With
``mats_dtype=torch.bfloat16`` (the default, as in the JAX package) the cas
matrices, each transform's operand and its intermediate are rounded to bf16
where the JAX kernel rounds them; products accumulate in f32.

The optional env epilogue emits, from the same pass over the final field,
per-env ``[sum(u-c), sum((u-c)^2), n_finite]`` over finite pixels and the
uint8 observation ``clip(u*scale + offset, 0, 255)`` (mean-pooled by
``obs_downsample``), so the env step never re-reads the field.

Each macro has two implementations of the same function:
:func:`ch_cas_macro_plain` (plain torch; what CPU tensors run) and
:func:`ch_cas_macro_cuda` (the hand-written Hopper kernel
``csrc/ch_cas_macro.cu``; what CUDA tensors run).  So has its backward:
:func:`ch_cas_macro_bwd_plain` and :func:`ch_cas_macro_bwd_cuda` (kernel
K3, in the same source).  Both take grids up to 256²: above 64² they run
the tiled kernels (``csrc/cas_tiled.cuh``), whose per-block scratch the
wrappers allocate, except the forward with bf16 matrices on a square grid
up to 128², which keeps each env on chip (``csrc/cas_onchip.cuh``).  The
macros are ``torch.autograd.Function``s whose backward is the JAX package's
custom VJP: re-run the forward, then sweep back through the same
transforms, rounding where the forward rounds.
There is no fallback from one implementation to the other.

The Allen-Cahn macro (:func:`make_ac_cas_fused_macro`, kernel K4 in
``csrc/ac_cas_macro.cu``, tiled above 64² as well) runs on the same
transforms and epilogue; its backward is the VJP of the checkpointed FFT
oracle, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable

from .cas_common import (
    MAX_MU_DEGREE,
    CasConstants,
    Epilogue,
    NO_EPILOGUE,
    OracleMacro,
    PolynomialMu,
    c_coeffs,
    cas_constants,
    ch_multipliers,
    check_config,
    check_mats,
    check_polynomials,
    check_state,
    epilogue_plain,
    flatten_batch,
    fold_stats_cotangent,
    macro_outputs,
    mats_ptrs,
    r_is_identity,
    transforms,
)
from .fold import fold_vmap
from .fused_spectral import ac_sif_macro_reference, ch_sif_macro_reference
from .kernels import (
    SCRATCH_OUT,
    alloc_scratch,
    bind,
    check,
    check_cuda,
    count_launch,
    data_ptr,
    device_stream,
    library,
    register_launches,
)

__all__ = [
    "PolynomialMu",
    "MAX_MU_DEGREE",
    "CasConstants",
    "Epilogue",
    "cas_constants",
    "ch_cas_macro_plain",
    "ch_cas_macro_cuda",
    "ch_cas_macro_bwd_plain",
    "ch_cas_macro_bwd_cuda",
    "make_ch_cas_fused_macro",
    "make_ch_cas_fused_macro_ep",
    "ch_cas_macro_reference",
    "r_is_identity",
    "ac_cas_macro_plain",
    "ac_cas_macro_cuda",
    "make_ac_cas_fused_macro",
]

# Same semantics as the fused DFT kernel -> same oracle.
ch_cas_macro_reference = ch_sif_macro_reference


def ch_cas_macro_plain(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                       *, mu_fn: Callable, dt: float, A: float, n_steps: int,
                       round_bf16: bool, epilogue: Optional[Epilogue] = None):
    """Plain-torch macro: ``u`` (B, H, W) f32, ``kappa`` (B,) f32.

    Returns ``u1`` or, with ``epilogue``, ``(u1, stats (B, 3), obs uint8)``.
    Runs on any device; it is what the macro runs on CPU tensors and what
    the CUDA kernel is held against on the card.
    """
    fwd, inv = transforms(consts, round_bf16)
    _, cm, cu = ch_multipliers(kappa, consts.lam, consts.lam2, A, dt)
    u_t = fwd(u)
    for _ in range(n_steps):
        incr = cm * fwd(mu_fn(u)) - cu * u_t
        u_t = u_t + incr
        u = u + inv(incr)
    if epilogue is None:
        return u
    return (u, *epilogue_plain(u, epilogue))


def ch_cas_macro_bwd_plain(u: torch.Tensor, kappa: torch.Tensor, g: torch.Tensor,
                           consts: CasConstants, *, mu_fn: Callable, dt: float,
                           A: float, n_steps: int, round_bf16: bool):
    """Plain-torch VJP of the macro (the JAX kernel's ``bwd_kernel``).

    ``u`` (B, H, W) and ``kappa`` (B,) are the macro's inputs and ``g``
    (B, H, W) the cotangent of ``u1``; returns ``(du (B, H, W), dkappa
    (B,))``.  The forward substeps are re-run into a list, then swept in
    reverse; the cas matrices are symmetric and the multipliers diagonal, so
    each transposed operator is again transform-multiply-transform:

        gbar_k = gbar_{k+1} + mu'(u_k) * inv(cm * ghat) - inv(cu * ghat)
        kacc  += ghat/(H W) * (dcm * fwd(mu(u_k)) - dcu * fwd(u_k))

    with ``ghat = fwd(gbar_{k+1})``, ``dcm = d cm/d kappa = -A dt² lam³
    denom²`` and ``dcu = d cu/d kappa = dt lam² denom²``; ``dkappa`` is the
    per-env sum of ``kacc``.
    """
    fwd, inv = transforms(consts, round_bf16)
    lam, lam2 = consts.lam, consts.lam2
    denom, cm, cu = ch_multipliers(kappa, lam, lam2, A, dt)
    dcm = -(float(A) * float(dt) * float(dt)) * (lam * lam2) * denom * denom
    dcu = float(dt) * lam2 * denom * denom

    traj = []
    u_t = fwd(u)
    for _ in range(n_steps):
        traj.append(u)
        incr = cm * fwd(mu_fn(u)) - cu * u_t
        u_t = u_t + incr
        u = u + inv(incr)

    inv_hw = 1.0 / float(u.shape[-2] * u.shape[-1])
    gbar = g
    kacc = torch.zeros_like(g)
    for u_k in reversed(traj):
        ghat = fwd(gbar)
        mu_p = torch.func.jvp(mu_fn, (u_k,), (torch.ones_like(u_k),))[1]
        kacc = kacc + (inv_hw * ghat) * (dcm * fwd(mu_fn(u_k)) - dcu * fwd(u_k))
        gbar = gbar + mu_p * inv(cm * ghat) - inv(cu * ghat)
    return gbar, kacc.sum((-2, -1))


# ---- the C interface of K1-K3 and K4 ---------------------------------------------

def _bind_library(lib, name: str):
    """Declare the C interface of ``name`` on ``lib``: ``ch_cas_macro``
    (K1-K3) or ``ac_cas_macro`` (K4), built for the card or for the CPU by
    the tests' stub build."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "ch_cas_macro":
        return bind(lib, {
            "ch_cas_macro_launch": [
                p, p, p, p, p, p, p, p, p, p,    # u, kappa, ch, cw, ich, icw, ch16 .. icw16
                p, p, p, p, i,                   # lam, lam2, lam_h, lam_w, fold
                p, p, p, p, i,                   # out, stats, obs, scratch, n_slots
                i, i, i, i, f, f,                # B, H, W, n_steps, dt, A*dt
                p, i, i,                         # mu coeffs, n_coeffs, round_bf16
                i, f, f, f,                      # ds, obs_scale, obs_offset, center
                p,                               # stream
            ],
            "ch_cas_macro_onchip": [i, i, i],    # H, W, round_bf16
            "ch_cas_macro_scratch": [i, i, i, i, i, *SCRATCH_OUT],   # bwd, bf16, H, W, n
            "ch_cas_macro_bwd_launch": [
                p, p, p,                         # u, kappa, g
                p, p, p, p, p, p, p, p, p, p,    # ch, cw, ich, icw, ch16 .. icw16, lam, lam2
                p, p, p, i,                      # du, dkappa, scratch, n_slots
                i, i, i, i, f, f, f,             # B, H, W, n_steps, dt, A*dt, -A*dt*dt
                p, i, p, i, i,                   # mu, n, mu', n, round_bf16
                p,                               # stream
            ],
        })
    return bind(lib, {
        "ac_cas_macro_launch": [
            p, p, p, p, p, p,                    # u, kappa, ch, cw, ich, icw
            p, p, p, p, p,                       # ch16 .. icw16, lam
            p, p, p, p, i,                       # out, stats, obs, scratch, n_slots
            i, i, i, i, f, f,                    # B, H, W, n_steps, dt, A*dt
            p, i, p, i,                          # mu coeffs, n, R coeffs, n (0: R == 1)
            i, i, f, f, f,                       # round_bf16, ds, obs_scale, obs_offset, center
            p,                                   # stream
        ],
        "ac_cas_macro_scratch": [i, i, i, *SCRATCH_OUT],             # bf16, H, W
    })


register_launches("ch_cas_macro", "ch_cas_macro_ep", "ch_cas_macro_bwd",
                  # Of the two above, the launches that ran the on-chip kernel (128^2),
                  # and of those the ones that built each env's multipliers once
                  # (CasConstants.fold).
                  "ch_cas_macro.onchip", "ch_cas_macro.onchip_fold", "ac_cas_macro",
                  "ac_cas_macro_ep")


def _ch_cas_macro_launch(lib, u, kappa, consts: CasConstants, *, mu_fn, dt, A, n_steps,
                         round_bf16, epilogue=None, stream):
    """K1 (with ``epilogue``) or K2 of ``lib`` on ``stream``, with its
    outputs and its scratch allocated here: ``u1`` or ``(u1, stats, obs)``."""
    B, H, W = u.shape
    ep = NO_EPILOGUE if epilogue is None else epilogue
    out, stats, obs = macro_outputs(u, epilogue, ep.ds)
    scratch, slots = alloc_scratch(lib, "ch_cas_macro_scratch", u.device, B, 0,
                                   int(round_bf16), H, W, int(n_steps))
    coeffs, n_coeffs = c_coeffs(mu_fn)
    check(lib, lib.ch_cas_macro_launch(
        u.data_ptr(), kappa.data_ptr(), *mats_ptrs(consts), consts.lam.data_ptr(),
        consts.lam2.data_ptr(), consts.lam_h.data_ptr(), consts.lam_w.data_ptr(),
        int(bool(consts.fold)), out.data_ptr(), data_ptr(stats), data_ptr(obs),
        data_ptr(scratch), slots, B, H, W, int(n_steps), float(dt), float(A) * float(dt),
        coeffs, n_coeffs, int(bool(round_bf16)), ep.ds, ep.obs_scale, ep.obs_offset, ep.center,
        stream,
    ), "ch_cas_macro launch")
    return out if epilogue is None else (out, stats, obs)


def _ch_cas_macro_bwd_launch(lib, u, kappa, g, consts: CasConstants, *, mu_fn, dt, A,
                             n_steps, round_bf16, stream):
    """K3 of ``lib`` on ``stream``, with its outputs and its scratch
    allocated here: ``(du, dkappa)``."""
    B, H, W = u.shape
    du = torch.empty_like(u)
    dkappa = torch.empty((B,), dtype=torch.float32, device=u.device)
    scratch, slots = alloc_scratch(lib, "ch_cas_macro_scratch", u.device, B, 1,
                                   int(round_bf16), H, W, int(n_steps))
    coeffs, n_coeffs = c_coeffs(mu_fn)
    dcoeffs, n_dcoeffs = c_coeffs(mu_fn.derivative())
    check(lib, lib.ch_cas_macro_bwd_launch(
        u.data_ptr(), kappa.data_ptr(), g.data_ptr(), *mats_ptrs(consts),
        consts.lam.data_ptr(), consts.lam2.data_ptr(), du.data_ptr(), dkappa.data_ptr(),
        data_ptr(scratch), slots, B, H, W, int(n_steps), float(dt), float(A) * float(dt),
        -(float(A) * float(dt) * float(dt)), coeffs, n_coeffs, dcoeffs, n_dcoeffs,
        int(bool(round_bf16)), stream,
    ), "ch_cas_macro_bwd launch")
    return du, dkappa


def _ac_cas_macro_launch(lib, u, kappa, consts: CasConstants, *, mu_fn, R_fn, r_identity,
                         dt, A, n_steps, round_bf16, epilogue=None, stream):
    """K4 of ``lib`` on ``stream``, with its outputs and its scratch
    allocated here: ``u1`` or, with ``epilogue``, ``(u1, stats, obs)``."""
    B, H, W = u.shape
    ep = NO_EPILOGUE if epilogue is None else epilogue
    out, stats, obs = macro_outputs(u, epilogue, ep.ds)
    scratch, slots = alloc_scratch(lib, "ac_cas_macro_scratch", u.device, B,
                                   int(round_bf16), H, W)
    mu_c, n_mu = c_coeffs(mu_fn)
    r_c, n_r = (None, 0) if r_identity else c_coeffs(R_fn)
    check(lib, lib.ac_cas_macro_launch(
        u.data_ptr(), kappa.data_ptr(), *mats_ptrs(consts), consts.lam.data_ptr(),
        out.data_ptr(), data_ptr(stats), data_ptr(obs), data_ptr(scratch), slots,
        B, H, W, int(n_steps), float(dt), float(A) * float(dt), mu_c, n_mu, r_c, n_r,
        int(bool(round_bf16)), ep.ds, ep.obs_scale, ep.obs_offset, ep.center, stream,
    ), "ac_cas_macro launch")
    return out if epilogue is None else (out, stats, obs)


# ---- the CUDA wrappers ----------------------------------------------------------------

def _check_macro_args(u, kappa, consts, mu_fn, R_fn=None, r_identity=True):
    """Raise on what the CUDA kernels K1-K4 do not take; return ``(B, H, W)``."""
    check_polynomials(mu_fn, R_fn, r_identity)
    B, H, W = check_state(u, kappa, "kappa")
    for name in ("lam", "lam2"):
        check_cuda(name, getattr(consts, name), (H, W), torch.float32, u.device)
    check_mats(consts, H, W, u.device)
    return B, H, W


@functools.lru_cache(maxsize=None)
def _ch_onchip(H: int, W: int, round_bf16: bool) -> bool:
    """Whether the CH forward of an (H, W) grid runs the on-chip kernel
    (``ch_cas_macro_onchip_kernel``; the rule is the library's
    ``ch_cas_macro_onchip``): bf16 matrices on a square grid above 64² up to
    128²."""
    lib = library("ch_cas_macro", _bind_library)
    return bool(lib.ch_cas_macro_onchip(int(H), int(W), int(bool(round_bf16))))


def ch_cas_macro_cuda(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                      *, mu_fn: Callable, dt: float, A: float, n_steps: int,
                      round_bf16: bool, epilogue: Optional[Epilogue] = None):
    """The Hopper kernel: same contract as :func:`ch_cas_macro_plain`.

    Launches ``csrc/ch_cas_macro.cu`` on the current stream (K1 with an
    epilogue, K2 without; with ``round_bf16`` on the tensor cores, else f32
    FMA) and counts the launch.  H and W up to :data:`MAX_GRID_TILED`:
    above 64² with bf16 matrices on a square grid up to 128² the on-chip
    kernel runs (also counted as ``ch_cas_macro.onchip``, :func:`_ch_onchip`;
    where ``consts.fold`` holds, it computes each env's multipliers once into
    a folded table, counted as ``ch_cas_macro.onchip_fold`` too),
    otherwise above 64² the tiled kernel, with a scratch of three H x W planes
    for each resident block, allocated here.  Raises on anything the kernel
    does not take.
    """
    B, H, W = _check_macro_args(u, kappa, consts, mu_fn)
    check_cuda("lam_h", consts.lam_h, (H,), torch.float64, u.device)
    check_cuda("lam_w", consts.lam_w, (W,), torch.float64, u.device)
    if epilogue is not None:
        epilogue.checked(H, W)
    with device_stream(u.device) as stream:
        res = _ch_cas_macro_launch(library("ch_cas_macro", _bind_library), u, kappa, consts,
                                   mu_fn=mu_fn, dt=dt, A=A, n_steps=n_steps,
                                   round_bf16=round_bf16, epilogue=epilogue, stream=stream)
    if _ch_onchip(H, W, round_bf16):
        count_launch("ch_cas_macro.onchip")
        if consts.fold:
            count_launch("ch_cas_macro.onchip_fold")
    count_launch("ch_cas_macro" if epilogue is None else "ch_cas_macro_ep")
    return res


def ch_cas_macro_bwd_cuda(u: torch.Tensor, kappa: torch.Tensor, g: torch.Tensor,
                          consts: CasConstants, *, mu_fn: Callable, dt: float,
                          A: float, n_steps: int, round_bf16: bool):
    """The Hopper backward kernel K3 (with ``round_bf16`` on the tensor
    cores, else f32 FMA): same contract as :func:`ch_cas_macro_bwd_plain`.

    ``mu'`` reaches the kernel as :meth:`PolynomialMu.derivative`.  Each
    resident block re-runs its envs' forward into its own slot of a
    device-memory scratch, allocated here: ``n_steps`` H x W f32 planes a
    slot at 64² and below (43 MB at 64², 10 substeps on an H100: 264
    slots), ``n_steps + 5`` above (the tiled kernel's planes: 3.8 MB a slot
    at 256², 10 substeps), H and W up to :data:`MAX_GRID_TILED`.  Launches
    on the current stream and counts the launch; raises on anything the
    kernel does not take.
    """
    B, H, W = _check_macro_args(u, kappa, consts, mu_fn)
    check_cuda("g", g, (B, H, W), torch.float32, u.device)
    with device_stream(u.device) as stream:
        res = _ch_cas_macro_bwd_launch(library("ch_cas_macro", _bind_library), u, kappa, g,
                                       consts, mu_fn=mu_fn, dt=dt, A=A, n_steps=n_steps,
                                       round_bf16=round_bf16, stream=stream)
    count_launch("ch_cas_macro_bwd")
    return res


def _run_fwd(x, kapf, consts, kw, epilogue):
    run = ch_cas_macro_plain if x.device.type == "cpu" else ch_cas_macro_cuda
    return run(x, kapf, consts, epilogue=epilogue, **kw)


def _run_bwd(x, kapf, g, consts, kw):
    run = ch_cas_macro_bwd_plain if x.device.type == "cpu" else ch_cas_macro_bwd_cuda
    return run(x, kapf, g.contiguous(), consts, **kw)


class _CasMacro(torch.autograd.Function):
    """The JAX macro's ``_core``: ``x`` (B, H, W), ``kapf`` (B,) f32 ->
    ``u1``, with the backward kernel as its VJP (``_core_bwd``).  Under
    :func:`torch.func.vmap` the vmapped axis folds into the env axis: one
    launch for the whole fleet (:func:`~pde_opt_tpu_torch.ops.fold.fold_vmap`)."""

    @staticmethod
    def forward(x, kapf, consts, kw):
        return _run_fwd(x, kapf, consts, kw, None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, kapf, ctx.consts, ctx.kw = inputs
        ctx.save_for_backward(x, kapf)

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(_CasMacro.apply, info, in_dims, 2, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, kapf = ctx.saved_tensors
        du, dkappa = _run_bwd(x, kapf, g, ctx.consts, ctx.kw)
        return du, dkappa, None, None


class _CasMacroEp(torch.autograd.Function):
    """The JAX macro's ``_core_ep``: ``(u1, stats, obs)``.  ``obs`` is not
    differentiable; the stats cotangent folds into the field cotangent at
    ``u1`` before the backward kernel runs (``_core_ep_bwd``).  Under
    :func:`torch.func.vmap` it folds as :class:`_CasMacro` does."""

    @staticmethod
    def forward(x, kapf, consts, kw, epilogue):
        return _run_fwd(x, kapf, consts, kw, epilogue)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, kapf, ctx.consts, ctx.kw, epilogue = inputs
        ctx.center = epilogue.center
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(x, kapf, output[0])

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(_CasMacroEp.apply, info, in_dims, 2, *args)

    @staticmethod
    @once_differentiable
    def backward(ctx, gu, gstats, _gobs):
        x, kapf, u1 = ctx.saved_tensors
        g = fold_stats_cotangent(u1, gu, gstats, ctx.center)
        du, dkappa = _run_bwd(x, kapf, g, ctx.consts, ctx.kw)
        return du, dkappa, None, None, None


def make_ch_cas_fused_macro(
    mu_fn: Callable,
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype: torch.dtype = torch.bfloat16,
    epilogue: Optional[dict] = None,
):
    """Build ``macro(u, kappa) -> u1`` advancing ``n_steps`` fused substeps.

    ``u`` has shape (..., H, W) (leading axes are the env batch) and
    ``kappa`` broadcasts to the batch (scalar, ``(B,)`` or batch-shaped).
    With ``epilogue`` (keys ``obs_scale``, ``obs_offset``,
    ``obs_downsample``, ``stats_center``) the macro returns
    ``(u1, stats, obs)`` as :func:`make_ch_cas_fused_macro_ep` documents.
    CPU tensors run :func:`ch_cas_macro_plain`; CUDA tensors run the Hopper
    kernel through :func:`ch_cas_macro_cuda`.  Gradients with respect to
    ``u`` and ``kappa`` run the backward of the same kind (plain on CPU,
    kernel K3 on CUDA); ``kappa``'s comes back in the caller's shape.
    ``mats_dtype`` is bf16 (the JAX default) or f32 (no rounding).
    """
    check_config(H, W, mats_dtype)
    ep = Epilogue.from_dict(epilogue, H, W) if epilogue is not None else None
    kw = dict(mu_fn=mu_fn, dt=dt, A=A, n_steps=n_steps,
              round_bf16=mats_dtype == torch.bfloat16)

    def macro(state: torch.Tensor, kappa):
        batch, x, kapf = flatten_batch(state, kappa, H, W)
        consts = cas_constants(H, W, float(hx), float(hy), mats_dtype, state.device)
        if ep is None:
            u1 = _CasMacro.apply(x, kapf, consts, kw)
            return u1.to(state.dtype).reshape(*batch, H, W)
        u1, stats, obs = _CasMacroEp.apply(x, kapf, consts, kw, ep)
        return (u1.to(state.dtype).reshape(*batch, H, W),
                stats.reshape(*batch, 3),
                obs.reshape(*batch, H // ep.ds, W // ep.ds))

    return macro


def make_ch_cas_fused_macro_ep(
    mu_fn: Callable,
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    obs_scale: float = 255.0,
    obs_offset: float = 0.0,
    obs_downsample: int = 1,
    stats_center: float = 0.0,
    mats_dtype: torch.dtype = torch.bfloat16,
):
    """Fused CH macro WITH the env epilogue: ``macro(u, kappa) -> (u1, stats, obs)``.

    * ``stats``: (..., 3) f32 per env — ``[sum(u-c), sum((u-c)**2),
      n_finite]`` over the finite pixels, ``c = stats_center``.
    * ``obs``: (..., H/ds, W/ds) uint8 — ``clip(u*obs_scale + obs_offset,
      0, 255)`` on the NaN-masked field, mean-pooled first when
      ``ds = obs_downsample > 1``.
    """
    return make_ch_cas_fused_macro(
        mu_fn, H, W, hx, hy, A, dt, n_steps, mats_dtype=mats_dtype,
        epilogue={"obs_scale": obs_scale, "obs_offset": obs_offset,
                  "obs_downsample": obs_downsample,
                  "stats_center": stats_center},
    )


# ---- Allen-Cahn: kernel K4 -------------------------------------------------

def ac_cas_macro_plain(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                       *, mu_fn: Callable, R_fn: Optional[Callable], r_identity: bool,
                       dt: float, A: float, n_steps: int, round_bf16: bool,
                       epilogue: Optional[Epilogue] = None):
    """Plain-torch AC macro: ``u`` (B, H, W) f32, ``kappa`` (B,) f32.

    Returns ``u1`` or, with ``epilogue``, ``(u1, stats (B, 3), obs uint8)``
    (the CH macro's epilogue).  Per substep, with ``dd = dt/(1 + A dt κ
    (-lam))``: ``u += inv(dd (κ lam fwd(u) - fwd(mu(u))))`` when
    ``r_identity``, else ``lap = inv(lam fwd(u))``, ``g = -R(u) (mu(u) - κ
    lap)``, ``u += inv(dd fwd(g))``.  What CPU tensors run and what kernel K4
    is held against on the card.
    """
    fwd, inv = transforms(consts, round_bf16)
    lam = consts.lam
    k = kappa.reshape(-1, 1, 1)
    denom_dt = float(dt) / (1.0 + float(A) * float(dt) * (k * (-lam)))
    for _ in range(n_steps):
        if r_identity:
            u = u + inv(denom_dt * (k * lam * fwd(u) - fwd(mu_fn(u))))
        else:
            lap = inv(lam * fwd(u))
            g = -R_fn(u) * (mu_fn(u) - k * lap)
            u = u + inv(denom_dt * fwd(g))
    if epilogue is None:
        return u
    return (u, *epilogue_plain(u, epilogue))


def ac_cas_macro_cuda(u: torch.Tensor, kappa: torch.Tensor, consts: CasConstants,
                      *, mu_fn: Callable, R_fn: Optional[Callable], r_identity: bool,
                      dt: float, A: float, n_steps: int, round_bf16: bool,
                      epilogue: Optional[Epilogue] = None):
    """Kernel K4: same contract as :func:`ac_cas_macro_plain`.

    Launches ``csrc/ac_cas_macro.cu`` on the current stream and counts the
    launch (``ac_cas_macro_ep`` with an epilogue, ``ac_cas_macro``
    without).  H and W up to :data:`MAX_GRID_TILED`: above 64² the tiled
    kernel runs, with a scratch of three H x W planes for each resident
    block, allocated here.  ``mu`` must be a :class:`PolynomialMu`, and so
    must ``R`` unless ``r_identity``; raises on anything the kernel does not
    take.
    """
    B, H, W = _check_macro_args(u, kappa, consts, mu_fn, R_fn, r_identity)
    if epilogue is not None:
        epilogue.checked(H, W)
    with device_stream(u.device) as stream:
        res = _ac_cas_macro_launch(library("ac_cas_macro", _bind_library), u, kappa, consts,
                                   mu_fn=mu_fn, R_fn=R_fn, r_identity=r_identity, dt=dt, A=A,
                                   n_steps=n_steps, round_bf16=round_bf16, epilogue=epilogue,
                                   stream=stream)
    count_launch("ac_cas_macro" if epilogue is None else "ac_cas_macro_ep")
    return res


def make_ac_cas_fused_macro(
    mu_fn: Callable,
    R_fn: Optional[Callable],
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype: torch.dtype = torch.bfloat16,
    epilogue: Optional[dict] = None,
):
    """Build ``macro(u, kappa) -> u1``: the fused Allen-Cahn semi-implicit
    macro (``∂u/∂t = -R(u) (mu(u) - κ ∇²u)``, FD Laplacian symbol, each env's
    own κ in the implicit denominator ``1/(1 + A dt κ (-lam))``).

    ``R_fn=None``, or an R the JAX package's probe finds equal to 1
    (:func:`r_is_identity`), takes the 3-transform path; any other R the
    4-transform path.  ``u`` is ``(..., H, W)`` and ``kappa`` broadcasts to
    the batch.  With ``epilogue`` (keys ``obs_scale``, ``obs_offset``,
    ``obs_downsample``, ``stats_center``) the macro returns ``(u1, stats,
    obs)`` as :func:`make_ch_cas_fused_macro_ep` documents.  CPU tensors run
    :func:`ac_cas_macro_plain`, CUDA tensors kernel K4; on CUDA ``mu`` (and a
    non-identity ``R``) must be :class:`PolynomialMu`.  Gradients with
    respect to ``u`` and ``kappa`` come from the checkpointed FFT oracle
    (:func:`~pde_opt_tpu_torch.ops.fused_spectral.ac_sif_macro_reference`)
    through the true ``mu_fn`` and ``R_fn``, as in the JAX package.  The JAX
    macro's ``block_envs``/``interpret`` (TPU tiling) have no counterpart.
    """
    check_config(H, W, mats_dtype)
    ep = Epilogue.from_dict(epilogue, H, W) if epilogue is not None else None
    kw = dict(mu_fn=mu_fn, R_fn=R_fn, r_identity=r_is_identity(R_fn), dt=dt, A=A,
              n_steps=n_steps, round_bf16=mats_dtype == torch.bfloat16)
    oracle = ac_sif_macro_reference(
        mu_fn, torch.ones_like if R_fn is None else R_fn, hx, hy, A, dt, n_steps,
        remat=True)

    fold = (None if ep is None
            else functools.partial(fold_stats_cotangent, center=ep.center))

    def macro(state: torch.Tensor, kappa):
        batch, x, kapf = flatten_batch(state, kappa, H, W)
        consts = cas_constants(H, W, float(hx), float(hy), mats_dtype, state.device)
        impl = ac_cas_macro_plain if state.device.type == "cpu" else ac_cas_macro_cuda

        def run(u, k):
            return impl(u, k, consts, epilogue=ep, **kw)

        if ep is None:
            u1 = OracleMacro.apply(x, kapf, run, oracle, None)
            return u1.to(state.dtype).reshape(*batch, H, W)
        u1, stats, obs = OracleMacro.apply(x, kapf, run, oracle, fold)
        return (u1.to(state.dtype).reshape(*batch, H, W),
                stats.reshape(*batch, 3),
                obs.reshape(*batch, H // ep.ds, W // ep.ds))

    return macro
