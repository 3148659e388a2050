"""General-mobility Cahn-Hilliard semi-implicit macro on cas transforms,
2D and 3D (PyTorch port of :mod:`pde_opt_tpu.ops.cas_mobility`).

The fast path for concentration-dependent mobility ``D(c) != 1``: every
other fused CH macro requires unit mobility.  Per substep, with each env's
own κ:

    rhs   = div( D_face(c) · grad(mu(c) − κ ∇²c) )     (conservative
            face-flux stencils, the CH models' ``rhs_fd``)
    u    += C⁻¹[ C[rhs] · dt / (1 + A·dt·κ·s·λ²) ]     (cas transforms)

where λ is the FD Laplacian symbol and ``s`` (``stab_scale``) optionally
over-relaxes the implicit shift for stiff mobilities (D ≫ 1).  One forward
and one inverse separable cas transform a substep (4 matrix products in 2D,
6 in 3D), ``torch.matmul`` as in :mod:`.cas3d`.

``rhs_impl`` picks the rhs:

* ``"xla"``: the ``torch.roll`` chain of :func:`_flux_div_rhs`; the macro is
  natively differentiable with respect to the field, κ and any parameters
  of ``mu_fn``/``D_fn`` (the learnable-function training path).
* ``"pallas"``: the fused rhs of :mod:`.fused` (kernel K8 on CUDA tensors,
  its plain version on CPU tensors, as the JAX kernel runs in interpret mode
  there).  Gradients with respect to the field and κ come from reverse
  mode through the ``"xla"`` macro (the JAX package's oracle VJP);
  coefficient parameters that require a gradient raise while grad mode is
  on, as a traced parameter does in JAX.
* ``"auto"``: ``"pallas"`` on CUDA tensors, ``"xla"`` on CPU tensors (JAX
  resolves it by backend).

With ``D ≡ 1`` the update is algebraically the unit-mobility scheme
(``C[lap_roll z] = λ·C[z]``), which the tests use as a cross-oracle.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from . import stencils as st
from .cas3d import cas_nd_constants, cas_nd_transform, fd_lap_symbol, flatten_nd
from .cas_common import OracleMacro
from .fused import make_ch3d_rhs_fd_fused, make_ch_rhs_fd_fused, refuse_learnable

__all__ = [
    "make_ch_mobility_cas_macro",
    "make_ch3d_mobility_cas_macro",
    "ch_mobility_macro_reference",
    "ch3d_mobility_macro_reference",
]

_RHS_IMPLS = ("auto", "pallas", "xla")


def _flux_div_rhs(mu_fn, D_fn, kap, dxs, axes):
    """Conservative FD rhs ``div(D_face · grad(mu − κ·lap u))`` (batched),
    the CH models' ``rhs_fd`` with a per-env ``kap`` broadcast over the
    spatial axes."""

    def rhs(u):
        lap = 0.0
        for h, ax in zip(dxs, axes):
            lap = lap + st.grad2_c(u, h, ax)
        mu_tot = mu_fn(u) - kap * lap
        Du = D_fn(u)
        out = 0.0
        for h, ax in zip(dxs, axes):
            F = st.avg_c2f(Du, ax) * st.grad_c2f(mu_tot, h, ax)
            out = out + st.div_f2c(F, h, ax)
        return out

    return rhs


def _make_macro(mu_fn, D_fn, Ns: Tuple[int, ...], dxs: Tuple[float, ...], A, dt, n_steps,
                stab_scale, mats_dtype, rhs_impl):
    if rhs_impl not in _RHS_IMPLS:
        raise ValueError(f"rhs_impl must be auto/pallas/xla, got {rhs_impl!r}")
    nd = len(Ns)
    axes = tuple(range(-nd, 0))
    A_dt, dt_f = float(A) * float(dt) * float(stab_scale), float(dt)
    make_fused = make_ch_rhs_fd_fused if nd == 2 else make_ch3d_rhs_fd_fused
    fused = make_fused(mu_fn, D_fn, *dxs)

    def run(u, kap, use_fused):
        c = cas_nd_constants(Ns, dxs, mats_dtype, u.device)
        k = kap.reshape(-1, *(1,) * nd)
        denom_dt = torch.full_like(c.lam2, dt_f) / (1.0 + A_dt * (k * c.lam2))
        if use_fused:
            def rhs(uu):
                return fused(uu, kap)
        else:
            rhs = _flux_div_rhs(mu_fn, D_fn, k, dxs, axes)
        for _ in range(n_steps):
            spec = denom_dt * cas_nd_transform(rhs(u), c.fwd, mats_dtype)
            u = u + cas_nd_transform(spec, c.inv, mats_dtype)
        return u

    def macro(state: torch.Tensor, kappa) -> torch.Tensor:
        batch, x, kap = flatten_nd(state, kappa, Ns)
        use_fused = rhs_impl == "pallas" or (rhs_impl == "auto" and state.device.type == "cuda")
        if use_fused:
            refuse_learnable(mu_fn, D_fn)
            u1 = OracleMacro.apply(x.contiguous(), kap.contiguous(),
                                    lambda u, k: run(u, k, True),
                                    lambda u, k: run(u, k, False), None)
        else:
            u1 = run(x, kap, False)
        return u1.to(state.dtype).reshape(*batch, *Ns)

    return macro


def make_ch_mobility_cas_macro(
    mu_fn: Callable,
    D_fn: Callable,
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    stab_scale: float = 1.0,
    mats_dtype: torch.dtype = torch.bfloat16,
    rhs_impl: str = "auto",
):
    """Build ``macro(u, kappa) -> u1``: 2D general-mobility CH substeps.

    ``u``: ``(..., H, W)`` real field (leading axes batch); ``kappa`` a
    number or broadcastable to the batch; ``mu_fn``/``D_fn`` elementwise
    callables (on CUDA under ``"pallas"``/``"auto"``, forms kernel K8
    reads).  ``stab_scale`` multiplies the implicit κλ² shift (set ≈ max D
    for stiff mobilities); ``mats_dtype=torch.float32`` forces exact
    arithmetic for tests; ``rhs_impl`` as the module docstring says.
    """
    return _make_macro(mu_fn, D_fn, (H, W), (float(hx), float(hy)), A, dt, n_steps,
                       stab_scale, mats_dtype, rhs_impl)


def make_ch3d_mobility_cas_macro(
    mu_fn: Callable,
    D_fn: Callable,
    N1: int,
    N2: int,
    N3: int,
    h1: float,
    h2: float,
    h3: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    stab_scale: float = 1.0,
    mats_dtype: torch.dtype = torch.bfloat16,
    rhs_impl: str = "auto",
):
    """3D analog of :func:`make_ch_mobility_cas_macro` (6 matrix products a
    substep): on CUDA tensors under ``"auto"`` each substep's rhs is one
    launch of kernel K8 (3D)."""
    return _make_macro(mu_fn, D_fn, (N1, N2, N3), (float(h1), float(h2), float(h3)), A, dt,
                       n_steps, stab_scale, mats_dtype, rhs_impl)


def _fft_reference(mu_fn, D_fn, dxs: Sequence[float], A, dt, n_steps, stab_scale, ndim):
    """``torch.fft`` oracle with the macros' exact-arithmetic semantics, in
    the field's dtype (tests and on-card checks)."""
    axes = tuple(range(-ndim, 0))

    def macro(u: torch.Tensor, kappa) -> torch.Tensor:
        lam = torch.from_numpy(fd_lap_symbol(u.shape[-ndim:], dxs)).to(u.device, u.dtype)
        kap = torch.as_tensor(kappa, device=u.device)
        if kap.ndim <= 1:
            kap = torch.broadcast_to(kap, u.shape[:-ndim]).reshape(
                u.shape[:-ndim] + (1,) * ndim)
        denom = 1.0 / (1.0 + A * dt * stab_scale * kap * lam**2)
        rhs = _flux_div_rhs(mu_fn, D_fn, kap, dxs, axes)
        for _ in range(n_steps):
            incr = denom * torch.fft.fftn(rhs(u), dim=axes)
            u = u + dt * torch.fft.ifftn(incr, dim=axes).real.to(u.dtype)
        return u

    return macro


def ch_mobility_macro_reference(mu_fn, D_fn, hx, hy, A, dt, n_steps, stab_scale: float = 1.0):
    return _fft_reference(mu_fn, D_fn, (hx, hy), A, dt, n_steps, stab_scale, 2)


def ch3d_mobility_macro_reference(mu_fn, D_fn, h1, h2, h3, A, dt, n_steps,
                                  stab_scale: float = 1.0):
    return _fft_reference(mu_fn, D_fn, (h1, h2, h3), A, dt, n_steps, stab_scale, 3)
