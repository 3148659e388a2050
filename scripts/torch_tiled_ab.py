#!/usr/bin/env python3
"""An A/B of two builds of the CH macro library (``csrc/ch_cas_macro.cu``)
at the tiled kernels' path shapes on one CUDA card, and the tiled K3 at the
NN-control path's shape held against its plain backward.

    python3 scripts/torch_tiled_ab.py OTHER_CSRC    # from the repository root

``OTHER_CSRC`` is another copy of ``pde_opt_tpu_torch/csrc`` (a parent
commit's, unpacked with ``git archive`` into a git-ignored directory) with
the same C interface.  Both are built with one ``nvcc`` each, in parallel,
into ``build/tiled_ab/``.  Part 1 times, with bf16 matrices and CUDA events,
K1 at bench.py's run_ch128 shape (1024 envs x 128² x 10 substeps, ds 1), K2
at run_ch256's (256 x 256² x 10) and at run_train_grad_128's (4096 x 128² x
10), and K3 at the latter, in the order other, this, this, other.

Part 2 (this checkout's build): K3 at 4096 x 128² x 10 on the NN-control
loss's cotangent, bf16 and f32 matrices.

- Each env's du and dkappa from the 4096-env launch (each block walks
  several envs through one scratch slot) against the same kernel launched
  on each 256 envs alone (one env a block): bit for bit.
- The kernel's errors against the plain backward, and those of two other
  correct bf16 backwards at the same rounding sites: the plain backward with
  every product accumulated in f64 (chip_smoke.py's control), and with
  every product on the TF32 tensor cores (its operands are bf16 values, so
  TF32 holds them exactly: the products are exact and summed in the tensor
  cores' f32, as the kernel's wgmma sums them).

The card's name and power limit head the output.
"""

import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "tiled_ab"
N_SUB, DT_NN, DT_256, CHUNK = 10, 1e-3, 1e-4, 256


def _build(sources):
    from pde_opt_tpu_torch.ops.kernels import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {name: subprocess.Popen([_nvcc(), *flags, "-o", str(OUT / f"lib_{name}.so"),
                                     str(src / "ch_cas_macro.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, src in sources.items()}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")


def _errs(got, want):
    """(du, dkappa) max errors, each relative to want's largest entry."""
    return tuple(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))


def _control_bwd(torch, cs, u, kap, g, consts, kw, how):
    """The plain backward with its products accumulated in f64 or on the
    TF32 tensor cores, at the plain version's rounding sites."""
    def transforms(c, round_bf16):
        def rnd(z):
            return z.to(torch.bfloat16).to(torch.float32) if round_bf16 else z

        def mm(a, b):
            return torch.matmul(a.double(), b.double()).float() if how == "f64" else a @ b

        def tr(z, mh, mw):
            t = rnd(mm(rnd(z).transpose(-1, -2), mh))
            return mm(t.transpose(-1, -2), mw)

        return (lambda z: tr(z, c.ch, c.cw), lambda z: tr(z, c.ich, c.icw))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = how == "tf32"
    try:
        with mock.patch.object(cs, "_transforms", transforms):
            return cs.ch_cas_macro_bwd_plain(u, kap, g, consts, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def main():
    import torch

    from pde_opt_tpu_torch.bench.nn_control import KappaControlNet
    from pde_opt_tpu_torch.envs.presets import CH_MU
    from pde_opt_tpu_torch.ops import cas_spectral as cs

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch_tiled_ab.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sources = {"other": Path(sys.argv[1]).resolve(), "this": ROOT / "pde_opt_tpu_torch" / "csrc"}
    _build(sources)
    libs = {n: cs._bind_ch_library(ctypes.CDLL(str(OUT / f"lib_{n}.so"))) for n in sources}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def use(name):
        cs._library = lambda: libs[name]
        cs._scratch.cache_clear()

    def time_ms(fn, reps=3):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kw = dict(mu_fn=CH_MU, A=1.0, n_steps=N_SUB, round_bf16=True)
    c128 = cs.cas_constants(128, 128, 0.01, 0.01, torch.bfloat16, dev)
    c256 = cs.cas_constants(256, 256, 0.01, 0.01, torch.bfloat16, dev)
    u1k = 0.45 + 0.05 * torch.randn((1024, 128, 128), generator=gen, device=dev)
    k1k = 2e-3 + 8e-3 * torch.rand((1024,), generator=gen, device=dev)
    u256 = 0.5 + 0.01 * torch.randn((256, 256, 256), generator=gen, device=dev)
    k256 = torch.full((256,), 4e-3, device=dev)
    u_nn = 0.5 + 0.01 * torch.randn((4096, 128, 128), generator=gen, device=dev)
    net = KappaControlNet(generator=torch.Generator(device=dev).manual_seed(56), device=dev)
    k_nn = net(u_nn).detach()
    kw_nn = {**kw, "dt": DT_NN}
    use("this")
    g_nn = 2.0 * (cs.ch_cas_macro_cuda(u_nn, k_nn, c128, **kw_nn) - 0.5)
    ep = cs.Epilogue(255.0, 0.0, 0.5, 1)
    cases = {
        "K1 1024x128^2x10 ds 1": lambda: cs.ch_cas_macro_cuda(u1k, k1k, c128, epilogue=ep,
                                                               dt=1e-3, **kw),
        "K2 256x256^2x10": lambda: cs.ch_cas_macro_cuda(u256, k256, c256, dt=DT_256, **kw),
        "K2 4096x128^2x10": lambda: cs.ch_cas_macro_cuda(u_nn, k_nn, c128, **kw_nn),
        "K3 4096x128^2x10": lambda: cs.ch_cas_macro_bwd_cuda(u_nn, k_nn, g_nn, c128, **kw_nn),
    }
    library = cs._library
    try:
        for case, fn in cases.items():
            ms = []
            for name in ("other", "this", "this", "other"):
                use(name)
                ms.append(time_ms(fn))
            print(f"time {case} bf16: other {ms[0]:.4f} / {ms[3]:.4f} ms, this {ms[1]:.4f} / "
                  f"{ms[2]:.4f} ms", flush=True)

        use("this")
        for mats, mdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            consts = cs.cas_constants(128, 128, 0.01, 0.01, mdt, dev)
            kwm = {**kw_nn, "round_bf16": mats == "bf16"}
            full = cs.ch_cas_macro_bwd_cuda(u_nn, k_nn, g_nn, consts, **kwm)
            parts = [cs.ch_cas_macro_bwd_cuda(u_nn[i:i + CHUNK].contiguous(),
                                              k_nn[i:i + CHUNK].contiguous(),
                                              g_nn[i:i + CHUNK].contiguous(), consts, **kwm)
                     for i in range(0, len(u_nn), CHUNK)]
            alone = tuple(torch.cat([p[j] for p in parts]) for j in range(2))
            same = all(torch.equal(a, b) for a, b in zip(full, alone))
            print(f"K3 {mats} 4096x128^2x10: the 4096-env launch equals the 256-env launches "
                  f"bit for bit: {same}", flush=True)
            want = cs.ch_cas_macro_bwd_plain(u_nn, k_nn, g_nn, consts, **kwm)
            rows = {"kernel": full}
            if mats == "bf16":
                for how in ("f64", "tf32"):
                    rows[f"plain, {how} products"] = _control_bwd(torch, cs, u_nn, k_nn, g_nn,
                                                                  consts, kwm, how)
            for what, got in rows.items():
                e = _errs(got, want)
                e256 = _errs(tuple(x[:CHUNK] for x in got), tuple(x[:CHUNK] for x in want))
                print(f"K3 {mats} 4096x128^2x10 {what} against plain: du max_rel_err "
                      f"{e[0]:.3e}, dkappa max_rel_err {e[1]:.3e} (first 256 envs {e256[0]:.3e}, "
                      f"{e256[1]:.3e})", flush=True)
    finally:
        cs._library = library
        cs._scratch.cache_clear()


if __name__ == "__main__":
    main()
