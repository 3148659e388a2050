"""The frozen work model: the least time an H100 could take for a macro.

Copied from the port's own model (``PERF.md`` section 6, ``chip_smoke.py``
``_bound``/``_bound_ops``) and frozen here, so that a later change of the
program is measured against the same work.  It depends only on a cell's
shapes.

* A cas (Hartley) transform of one (H, W) env is two dense separable
  products, 2 H W (H + W) operations, at the bf16 tensor-core peak.
* A semi-implicit CH macro of n substeps runs 1 + 2 n transforms an env:
  the first forward, then a forward of mu(u) and an inverse of the
  increment each substep.
* Its pointwise work is 21 operations a pixel a substep, at the f32 peak.
* Bytes: the field read once and written once (f32), kappa (f32), the
  observation (uint8, pooled by ``ds``) and a 12-byte stats row an env,
  the four cas matrices (f32 as stored) and the two symbol planes.
* The bound is the larger of the compute and the memory time.

Not used, and why: the JAX bench's ``bench.py:106`` ``_cas_substep_flops``
counts the zeros of the TPU's block-diagonal operands, and ``bench.py:364``
counts 16 N^3 for the rotating ADI where the macro does 24 N^3.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet, dense): bf16 tensor
# cores, f32 outside the tensor cores, HBM bandwidth; all at 700 W.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

CH_EW_OPS_PER_PX_SUBSTEP = 21


def cas_transform_ops(H: int, W: int) -> float:
    """Operations of one cas transform of one (H, W) env."""
    return 2.0 * H * W * (H + W)


def bound_ms(product_ops: float, ew_ops: float, nbytes: float):
    """``(ms, what)``: products at the bf16 peak plus pointwise work at the
    f32 peak, against bytes at the memory rate; ``what`` names the larger."""
    ops_s = product_ops / PEAK_BF16 + ew_ops / PEAK_F32
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def ch_macro_work(B: int, H: int, W: int, n: int, ds: int = 1, epilogue: bool = True):
    """``(product_ops, ew_ops, nbytes)`` of one semi-implicit CH macro call
    of ``n`` substeps over ``B`` envs (the fleet's stepper call)."""
    px = H * W
    products = (1 + 2 * n) * cas_transform_ops(H, W) * B
    ew = CH_EW_OPS_PER_PX_SUBSTEP * px * n * B
    mats = 4 * (H * H + W * W) * 4
    nbytes = B * px * 4 * 2 + B * 4 + mats + 2 * px * 4
    if epilogue:
        nbytes += B * (px // (ds * ds) + 12)
    return products, ew, nbytes


def ch_macro_bound_ms(B: int, H: int, W: int, n: int, ds: int = 1, epilogue: bool = True):
    """``(ms, what)`` of :func:`ch_macro_work`."""
    return bound_ms(*ch_macro_work(B, H, W, n, ds, epilogue))
