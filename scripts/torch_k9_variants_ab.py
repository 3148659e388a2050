"""Time K9a and K9b's tensor-core kernels (bf16 tables) as built against
variants of their register budget and of K9b's Laplacian:

* K9a (``csrc/ch_sif_macro.cu``): "as built" (uncapped, one block an SM);
  "capped" (``__launch_bounds__(256, 2)``, two blocks an SM, 128 registers);
  "capped, recomputed" (capped, and cm and cu recomputed from lam every
  substep instead of held in registers for the env).
* K9b (``csrc/ac_sif_macro.cu``): "as built" (capped at 128 registers, the
  Laplacian reading pixel pairs from a swizzled copy of the field);
  "uncapped" (one block an SM); "unswizzled scalar" (the copy unswizzled,
  each neighbour read as a single float).

Each variant is an edited copy of the source, built with nvcc for sm_90a
into ``build/kernels/k9_ab/``, held against its plain version at the main
path's shape (4096 envs x 64^2 x 10 substeps, bf16 tables, the fields
``chip_smoke.py`` makes) and timed with CUDA events through the wrapper, in
the order A B C C B A.  Prints ``ptxas -v``'s registers and spills for the
64^2 instance (N = 40) and the card's name and power limit.  Needs one
CUDA card; from the repository root:

    python3 scripts/torch_k9_variants_ab.py
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pde_opt_tpu_torch.envs.presets import AC_MU, AC_R, CH_MU  # noqa: E402
from pde_opt_tpu_torch.ops import fused_spectral as fs  # noqa: E402
from pde_opt_tpu_torch.ops import kernels  # noqa: E402

CSRC = ROOT / "pde_opt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernels" / "k9_ab"
CH_HOLD = "    // cm and cu at this thread's spectrum entries"
CH_HOLD_END = "    // The previous env's last stage A finished"
CH_UPDATE = ("          const float z = __fsub_rn(__fmul_rn(cm[j][e], x[j][e]), "
             "__fmul_rn(cu[j][e], uh[j][e]));")
CH_RECOMPUTE = """          const int kh = f.row(e), kw = f.col(j, e);
          float cm = 0.f, cu = 0.f;
          if (kh < H && kw < W2) {
            const float l = __ldg(g.lam + kh * W2 + kw), l2 = __ldg(g.lam2 + kh * W2 + kw);
            const float den = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, l2))));
            cm = __fmul_rn(__fmul_rn(dt, l), den);
            cu = __fmul_rn(__fmul_rn(dtk, l2), den);
          }
          const float z = __fsub_rn(__fmul_rn(cm, x[j][e]), __fmul_rn(cu, uh[j][e]));"""
AC_LAP = "      // The Laplacian at the pixel pairs"
AC_LAP_END = "      store_field(s.xa, v, o, H, W);\n      sif_forward<N>(s, f, x);"
AC_SCALAR = """#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = 0.f;
          if (!o.valid(j, e >> 1, H, W)) continue;
          const int h = o.row(e), w = o.col(j, e);
          const float* up = s.uf + (h + 1 == H ? 0 : h + 1) * W;
          const float* dn = s.uf + (h == 0 ? H - 1 : h - 1) * W;
          const float* row = s.uf + h * W;
          const float c = u[j][e], c2 = __fmul_rn(2.f, c);
          const float lx = __fadd_rn(__fsub_rn(up[w], c2), dn[w]);
          const float ly = __fadd_rn(__fsub_rn(row[w + 1 == W ? 0 : w + 1], c2),
                                     row[w == 0 ? W - 1 : w - 1]);
          const float lap = __fadd_rn(__fmul_rn(lx, inv_hx2), __fmul_rn(ly, inv_hy2));
          const float m = __fsub_rn(mu_eval(mu, c), __fmul_rn(k, lap));
          v[j][e] = r_identity ? -m : __fmul_rn(-mu_eval(R, c), m);
        }
"""
AC_SWIZZLE = "  return h * W + (W % 32 == 0 ? w ^ ((h & 3) << 3) : w);"


def _bounds(src, kind, blocks):
    old = f"__global__ void __launch_bounds__(kThreads, {3 - blocks})\n{kind}_sif_macro_wg_kernel("
    new = f"__global__ void __launch_bounds__(kThreads, {blocks})\n{kind}_sif_macro_wg_kernel("
    assert old in src, f"{kind}: launch bounds not found"
    return src.replace(old, new)


def _cut(src, start, end, new):
    a, b = src.index(start), src.index(end)
    return src[:a] + new + src[b:]


def variants():
    """``{(kind, name): edited source}`` in the A B C order of each kind."""
    ch = (CSRC / "ch_sif_macro.cu").read_text()
    ac = (CSRC / "ac_sif_macro.cu").read_text()
    capped = _bounds(ch, "ch", 2)
    assert CH_UPDATE in capped
    recomputed = _cut(capped, CH_HOLD, CH_HOLD_END,
                      "    float uh[N / 8][4], x[N / 8][4], u[4][4], v[4][4];\n")
    recomputed = recomputed.replace(CH_UPDATE, CH_RECOMPUTE)
    assert AC_SWIZZLE in ac
    scalar = _cut(ac, AC_LAP, AC_LAP_END, AC_SCALAR).replace(AC_SWIZZLE, "  return h * W + w;")
    return {("ch", "as built"): ch, ("ch", "capped"): capped,
            ("ch", "capped, recomputed"): recomputed,
            ("ac", "as built"): ac, ("ac", "uncapped"): _bounds(ac, "ac", 1),
            ("ac", "unswizzled scalar"): scalar}


def build(srcs):
    """Build every variant in parallel; ``{key: (bound library, ptxas line)}``."""
    procs = {}
    for i, ((kind, name), src) in enumerate(srcs.items()):
        d = OUT / f"{kind}{i}"
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / f"{kind}_sif_macro.cu").write_text(src)
        procs[kind, name] = (d, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{kind}_sif_macro.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for (kind, name), (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {kind} {name}:\n{err}")
        # ptxas reports an entry's spills, then its registers, after its name.
        entry = err[re.search(r"Compiling entry function '\w*wg_kernelILi40E", err).start():]
        spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
        regs = re.search(r"Used (\d+) registers", entry).group(1)
        lib = fs._bind_library(ctypes.CDLL(str(d / "lib.so")), f"{kind}_sif_macro")
        out[kind, name] = (lib, f"{regs} registers, {spill} B of spill stores at N = 40")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k9_variants_ab.py needs a CUDA device")
    card = cs._card()
    print(card, flush=True)
    libs = build(variants())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    u = 0.45 + 0.05 * torch.randn((cs.NUM_ENVS, cs.GRID, cs.GRID), generator=gen, device=dev)
    kap = 2e-3 + 8e-3 * torch.rand((cs.NUM_ENVS,), generator=gen, device=dev)
    u_ac = 0.1 * torch.randn((cs.AC_ENVS, cs.GRID, cs.GRID), generator=gen, device=dev)
    kap_ac = 1e-4 + 9e-4 * torch.rand((cs.AC_ENVS,), generator=gen, device=dev)
    consts = fs.sif_constants(cs.GRID, cs.GRID, cs.HX, cs.HY, torch.bfloat16, True, dev)
    kw = dict(dt=cs.DT, A=cs.A, n_steps=cs.SUBSTEPS, round_bf16=True)
    kw_ac = dict(kw, mu_fn=AC_MU, R_fn=AC_R, r_identity=True, hx=cs.HX, hy=cs.HY)
    runs = {"ch": (fs.ch_sif_macro_cuda, fs.ch_sif_macro_plain, u, kap, dict(kw, mu_fn=CH_MU)),
            "ac": (fs.ac_sif_macro_cuda, fs.ac_sif_macro_plain, u_ac, kap_ac, kw_ac)}
    library = fs._library
    try:
        for kind, (cuda, plain, x, k, kwk) in runs.items():
            names = [name for (kd, name) in libs if kd == kind]
            want = plain(x, k, consts, **kwk)
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                fs._library = lambda _, lib=libs[kind, name][0]: lib
                times[name].append(cs._time_ms(torch, lambda: cuda(x, k, consts, **kwk)))
            for name in names:
                fs._library = lambda _, lib=libs[kind, name][0]: lib
                err = (cuda(x, k, consts, **kwk) - want).abs().max().item()
                print(f"K9{'a' if kind == 'ch' else 'b'} {name}: {times[name][0]:.4f} / "
                      f"{times[name][1]:.4f} ms, max_abs_err vs plain {err:.3e}, "
                      f"{libs[kind, name][1]} ({cs.NUM_ENVS} envs x {cs.GRID}^2 x "
                      f"{cs.SUBSTEPS} substeps, bf16) [{card}]", flush=True)
    finally:
        fs._library = library


if __name__ == "__main__":
    main()
