"""The frozen work model of the BV charging macro (kernel K6): the least
time an H100 could take for it.

Copied from the port's own model (``chip_smoke.py`` ``_bounds``, its ``bv``
row; ``PERF.md`` section 6) and frozen here, as ``workmodel.py`` froze the
CH macro's, so that a later change of the program is measured against the
same work.  It depends only on a cell's shapes.

* Products: 8 n cas transforms an env (four a RK stage, four stages a
  substep: a forward and an inverse of two products each), each
  2 H W (H + W) operations, at the bf16 tensor-core peak.
* Pointwise work: 4 * 33 + 2 operations a pixel a substep (33 a stage,
  2 for the RK4 update) at the f32 peak, each ``log``, ``exp``, ``sqrt``
  and division counted as one operation.  Those run on the special-function
  units at a fraction of the f32 rate, so the bound is optimistic: the
  closure cannot reach it.
* Bytes: the field read once and written once (f32), the C-rate (f32),
  with the epilogue the observation (uint8) and a 12-byte stats row an env,
  the four cas matrices (f32 as stored) and ``lam``.
* The bound is the larger of the compute and the memory time.
"""

from __future__ import annotations

from .workmodel import bound_ms, cas_transform_ops

BV_EW_OPS_PER_PX_SUBSTEP = 4 * 33 + 2


def bv_macro_work(B: int, H: int, W: int, n: int, epilogue: bool = True):
    """``(product_ops, ew_ops, nbytes)`` of one BV macro call of ``n`` RK4
    substeps over ``B`` envs (the fleet's stepper call)."""
    px = H * W
    products = 8 * n * cas_transform_ops(H, W) * B
    ew = BV_EW_OPS_PER_PX_SUBSTEP * px * n * B
    mats = 4 * (H * H + W * W) * 4
    nbytes = B * px * 4 * 2 + B * 4 + mats + px * 4
    if epilogue:
        nbytes += B * (px + 12)
    return products, ew, nbytes


def bv_macro_bound_ms(B: int, H: int, W: int, n: int, epilogue: bool = True):
    """``(ms, what)`` of :func:`bv_macro_work`."""
    return bound_ms(*bv_macro_work(B, H, W, n, epilogue))
