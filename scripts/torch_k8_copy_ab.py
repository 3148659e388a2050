"""Time K8 3D (``pde_opt_tpu_torch/csrc/ch_rhs_fd.cu``) as built, its next
u plane brought into shared memory by ``cp.async``, against the same plane
march with synchronous copies, where each thread waits for its load before
the step's arithmetic instead of after it:

* "cp.async": the kernel as built;
* "synchronous": ``csrc/async_copy.cuh`` swapped for a header whose copies
  are a plain load and store (16 bytes where the plane allows, else 4);
* "plain loads": that header, and ``copy_plane`` a loop of 4-byte copies.

Each build (nvcc for sm_90a, into ``build/kernels/copy_ab/``) is held
against ``ch3d_rhs_fd_plain`` at the 3D mobility path's shape (256 x 32^3,
Legendre mu and D, the fields ``chip_smoke.py`` makes) and timed with CUDA
events, one launch straight through the C interface per repetition, in the
order A B C C B A: on one field (L2-warm) and on two in turn (L2-cold).
Prints ``ptxas -v``'s registers and spills and the card's name and power
limit.  Needs one CUDA card; from the repository root:

    python3 scripts/torch_k8_copy_ab.py
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pde_opt_tpu_torch.ops import fused, kernels  # noqa: E402

CSRC = ROOT / "pde_opt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernels" / "copy_ab"
SYNC_COPY = """// Synchronous stand-in for async_copy.cuh: a load and a store.
#pragma once
#include <cuda_runtime.h>
namespace {
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  *static_cast<float4*>(s) = *static_cast<const float4*>(g);
}
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  *static_cast<float*>(s) = *static_cast<const float*>(g);
}
__device__ __forceinline__ void cp_async_wait_all() {}
}  // namespace
"""
COPY_PLANE = "__device__ __forceinline__ void copy_plane("
PLAIN_COPY = """__device__ __forceinline__ void copy_plane(float* dst, const float* src, int n23, bool) {
  for (int c = static_cast<int>(threadIdx.x); c < n23; c += kThreads) dst[c] = src[c];
}
"""


def variants():
    """``{name: (ch_rhs_fd.cu source, async_copy.cuh source or None)}``."""
    src = (CSRC / "ch_rhs_fd.cu").read_text()
    start = src.index(COPY_PLANE)
    end = src.index("\n}\n", start) + 3
    plain = src[:start] + PLAIN_COPY + src[end:]
    return {"cp.async": (src, None), "synchronous": (src, SYNC_COPY),
            "plain loads": (plain, SYNC_COPY)}


def build():
    """Build each variant in parallel; return ``{name: bound library}``."""
    procs = {}
    for name, (src, header) in variants().items():
        d = OUT / name.replace(" ", "_").replace(".", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "ch_rhs_fd.cu").write_text(src)
        if header is not None:
            (d / "async_copy.cuh").write_text(header)
        lib = d / "libch_rhs_fd.so"
        procs[name] = lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(d / "ch_rhs_fd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
        for line in err.splitlines():
            if "ch_rhs_fd_3d" in line or "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
        libs[name] = fused._bind_library(ctypes.CDLL(str(lib)))
    return libs


def launcher(lib, shape, kappa, mu, D, h):
    """One K8 3D launch of ``lib`` on a field of ``shape``: ``run(u) -> out``."""
    out, coeffs = fused._launch_args(torch.empty(shape, device=kappa.device), kappa, mu, D,
                                     shape)
    resident = ctypes.c_int(0)
    if lib.ch_rhs_fd_3d_resident(shape[2], shape[3], ctypes.byref(resident)) != 0:
        raise RuntimeError("ch_rhs_fd_3d_resident failed")
    inv_c = (ctypes.c_float * 3)(*(1.0 / x for x in h))
    inv2_c = (ctypes.c_float * 3)(*(1.0 / (x * x) for x in h))
    stream = torch.cuda.current_stream().cuda_stream

    def run(u):
        rc = lib.ch_rhs_fd_3d_launch(u.data_ptr(), kappa.data_ptr(), out.data_ptr(), *shape,
                                     *coeffs, inv_c, inv2_c, resident.value, stream)
        if rc != 0:
            raise RuntimeError(f"ch_rhs_fd_3d_launch failed: {rc}")
        return out
    return run


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    libs = build()
    card = cs._card()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    mu, D = cs._m3_coeffs(torch, dev)
    shape = (cs.M3_ENVS, cs.M3_N, cs.M3_N, cs.M3_N)
    h = (0.01, 0.01, 0.01)
    u, u2 = (cs._m3_field(torch, dev, gen, cs.M3_ENVS) for _ in range(2))
    kappa = torch.full((cs.M3_ENVS,), cs.M3_KAPPA, device=dev)
    want = fused.ch3d_rhs_fd_plain(u, kappa, mu_fn=mu, D_fn=D, h1=h[0], h2=h[1], h3=h[2])
    runs = {name: launcher(lib, shape, kappa, mu, D, h) for name, lib in libs.items()}
    order = list(runs)
    for name in order + order[::-1]:
        run = runs[name]
        err = ((run(u) - want).abs().max() / want.abs().max()).item()
        if not err <= cs.TOL_K8:
            raise AssertionError(f"{name}: error {err:.3e} of max|plain| above {cs.TOL_K8}")
        warm = cs._time_ms(torch, lambda: run(u), reps=50, warmup=5)
        cold = cs._time_ms(torch, lambda: (run(u), run(u2)), reps=25, warmup=3) / 2
        print(f"K8 3D {name}: {warm:.4f} ms L2-warm, {cold:.4f} ms L2-cold a launch at "
              f"{'x'.join(map(str, shape))}, error {err:.1e} of max|plain| [{card}]", flush=True)


if __name__ == "__main__":
    main()
