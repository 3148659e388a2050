#!/usr/bin/env python3
"""Where the time of the tiled CH macro (K2 above 64², ``csrc/cas_tiled.cuh``)
goes, on one CUDA card.

    python3 scripts/torch_tiled_ablate.py      # from the repository root

Builds variants of ``csrc/ch_cas_macro.cu`` from a copy of ``csrc`` under
``build/tiled_ablate/`` (one ``nvcc`` each, in parallel) and times K2 with
bf16 matrices at 1024 envs x 136² x 10 substeps (bench.py's run_ch128 shape
runs the on-chip kernel, which these variants leave alone) and run_ch256's
(256 x 256² x 10) with CUDA events:

- ``base``: the kernel as it is;
- ``no_copy``: no chunk is copied into shared memory (the products read
  whatever the ring holds);
- ``no_mma``: no warpgroup product is issued;
- ``no_done``: neither product 1's store of T nor product 2's epilogue runs;
- ``no_fence``: no proxy fence before the products;
- ``barriers``: all four off, so that the barriers, the walk and the env
  loop are left;
- ``stages2``, ``stages6``: a ring of 2 or 6 stages instead of 4;

each also with the scratch slots capped at one block per SM (132 on an
H100), where the planes of all resident blocks fit the 50 MB L2.  The
variants with a part switched off compute wrong fields: they are timed,
not checked.  The card's name and power limit head the output.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "pde_opt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "tiled_ablate"
# name -> what the copy of cas_tiled.cuh wraps in #ifndef NAME ... #endif
GUARDS = {
    "NO_COPY": ("      copy_chunk_wg(sa, a, lda, tw.m0(st), M, tw.k0(st), depth, tid);\n"
                "      copy_chunk_wg(sa + kTile, b, ldb, tw.n0(st), N, tw.k0(st), depth, tid);\n"),
    "NO_MMA": ("#pragma unroll\n    for (int s = 0; s < 4; ++s)\n"
               "      wgmma_m64nNk16_bf16<32>(d, wgmma_desc(sa + s * kStepElems, kLbo, kSbo),\n"
               "                              wgmma_desc(sb + s * kStepElems, kLbo, kSbo),"
               " (k0 | s) != 0);\n"),
    "NO_DONE": "    if (tw.last(st)) done(tw.m0(st), tw.n0(st), d);\n",
    "NO_FENCE": ("    fence_proxy_async();\n"
                 "    __syncthreads();                             // every thread's;"
                 " step st - 1 is done\n"),
}
VARIANTS = {
    "base": [], "no_copy": ["-DNO_COPY"], "no_mma": ["-DNO_MMA"], "no_done": ["-DNO_DONE"],
    "no_fence": ["-DNO_FENCE"], "barriers": [f"-D{g}" for g in GUARDS],
    "stages2": ["-DSTAGES=2"], "stages6": ["-DSTAGES=6"],
}
SHAPES = ((1024, 136), (256, 256))


def _sources():
    """A copy of csrc whose cas_tiled.cuh has the guards and a STAGES knob."""
    if OUT.exists():
        shutil.rmtree(OUT)
    shutil.copytree(CSRC, OUT)
    t = (OUT / "cas_tiled.cuh").read_text()
    for name, code in GUARDS.items():
        if t.count(code) != 1:
            raise SystemExit(f"cas_tiled.cuh changed: the {name} guard no longer fits")
        kept = ("    __syncthreads();                             // every thread's;"
                " step st - 1 is done\n") if name == "NO_FENCE" else ""
        t = t.replace(code, f"#ifndef {name}\n{code}#else\n{kept}#endif\n")
    stages = "constexpr int kStagesWg = 4, kStagesFma = 3;"
    if t.count(stages) != 1:
        raise SystemExit("cas_tiled.cuh changed: the ring depth no longer fits")
    t = t.replace(stages, "#ifndef STAGES\n#define STAGES 4\n#endif\n"
                          "constexpr int kStagesWg = STAGES, kStagesFma = 3;")
    (OUT / "cas_tiled.cuh").write_text(t)


def _build():
    from pde_opt_tpu_torch.ops.kernels import NVCC_FLAGS, _nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {name: subprocess.Popen([_nvcc(), *flags, *extra, "-o", str(OUT / f"lib_{name}.so"),
                                     str(OUT / "ch_cas_macro.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, extra in VARIANTS.items()}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")


def main():
    import torch

    from pde_opt_tpu_torch.envs.presets import CH_MU
    from pde_opt_tpu_torch.ops import cas_spectral as cs

    if not torch.cuda.is_available():
        raise SystemExit("torch_tiled_ablate.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _sources()
    _build()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, reps=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    alloc = cs.alloc_scratch
    stream = torch.cuda.current_stream(dev).cuda_stream
    try:
        for B, N in SHAPES:
            consts = cs.cas_constants(N, N, 0.01, 0.01, torch.bfloat16, dev)
            u = 0.5 + 0.01 * torch.randn((B, N, N), generator=gen, device=dev)
            kap = torch.full((B,), 4e-3, device=dev)
            kw = dict(mu_fn=CH_MU, dt=1e-3, A=1.0, n_steps=10, round_bf16=True)
            for name in VARIANTS:
                lib = cs._bind_library(ctypes.CDLL(str(OUT / f"lib_{name}.so")), "ch_cas_macro")
                for cap in (None, sms):
                    def capped(*args, cap=cap):
                        scratch, slots = alloc(*args)
                        return scratch, slots if cap is None else min(slots, cap)

                    cs.alloc_scratch = capped
                    ms = time_ms(lambda: cs._ch_cas_macro_launch(lib, u, kap, consts,
                                                                 stream=stream, **kw))
                    slots = "resident" if cap is None else f"<= {cap}"
                    print(f"{name}: K2 {B}x{N}^2x10 bf16, slots {slots}: {ms:.4f} ms", flush=True)
                    cs.alloc_scratch = alloc
    finally:
        cs.alloc_scratch = alloc

if __name__ == "__main__":
    main()
