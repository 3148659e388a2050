"""Time K7 (``csrc/sbm_bv_macro.cu``) and K8 2D (``csrc/ch_rhs_fd.cu``) as
built against an earlier commit's kernels and against design variants, in
one process on one card:

* K7 at the SBM fleet's shape (1024 envs x 64^2 x 10 RK4 substeps, the
  preset's disk psi, the charging fields ``chip_smoke.py`` makes), epilogue
  on and off: the earlier commit's kernel, the kernel as built, and the
  kernel as built with other tiles and register budgets (its ``kR``,
  ``kC`` and ``kMinBlocks`` edited).
* K8 2D at the ``derivs="pallas"`` fleet's shape (4096 envs x 64^2, the
  fleet's mu = c^3 - c and D = 1): the earlier commit's kernel, the row
  march as built, with other rows in flight (its ``kAhead`` edited) and
  with mu and D evaluated a row at a time, and the 3D kernel's plane march
  run on the field as
  (B, H, 1, W) with 64-thread blocks (one pixel a thread of each 64-pixel
  row; it also computes a null middle axis and associates the face flux
  in the 3D order), as a proxy for a 2D block march through a cp.async
  ring; and K8 3D (256 envs x 32^3, the Legendre pair), whose source file
  the row march shares, as built against the earlier commit's.
* K6 at the BV fleet's shape (2048 envs x 64^2 x 10, bf16 and f32
  matrices, epilogue on and off) from the earlier commit's sources and
  from these: their outputs must be bit-identical (``bv_common.cuh`` is
  shared with K7).

Every build is nvcc for sm_90a into ``build/kernels/k7_k8_ab/`` and is
held against its plain version before it is timed.  Times are CUDA events
over 10 launches after 2, in the order A B C ... C B A (each variant twice).
Prints each kernel's ``ptxas -v`` registers, stack and spills, the blocks
an SM they allow, the share of the bound ``chip_smoke.py`` computes, K7's
SASS count of one RK stage (``cuobjdump -sass``: the innermost loop that
holds a stage's barriers, over the pixels a thread owns) and the
issue-rate floor it implies, and the card's name, power limit and
maximum SM clock.  Needs one CUDA card and the earlier commit's
``pde_opt_tpu_torch/csrc`` unpacked in a directory; from the repository
root, for example:

    mkdir -p .scratch/parent && git archive <commit> pde_opt_tpu_torch/csrc \\
        | tar -x -C .scratch/parent
    python3 scripts/torch_k7_k8_ab.py .scratch/parent/pde_opt_tpu_torch/csrc
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
from pde_opt_tpu_torch.envs.presets import (  # noqa: E402
    BV_J0,
    BV_MU,
    CH_D,
    CH_MU,
    make_sbm_butler_volmer_control_env,
)
from pde_opt_tpu_torch.ops import bv_cas, fused, kernels, sbm_bv  # noqa: E402
from pde_opt_tpu_torch.ops.cas_spectral import Epilogue, cas_constants  # noqa: E402

CSRC = ROOT / "pde_opt_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernels" / "k7_k8_ab"
SMS, REGS_SM, SMEM_SM, MAX_WARPS_SM = 132, 65536, 233472, 64
# K7 variants: (rows, columns, minimum blocks an SM), the first as built.
K7_DEFAULT = (2, 2, 1)
K7_TILES = {"as built (2x2, 1024 threads, 64 regs)": None,
            "2x4, 512 threads, 1 block": (2, 4, 1),
            "2x4, 512 threads, 2 blocks (64 regs)": (2, 4, 2),
            "4x4, 256 threads, 2 blocks (128 regs)": (4, 4, 2),
            "4x4, 256 threads, 1 block": (4, 4, 1),
            "1x4, 1024 threads, 1 block (64 regs)": (1, 4, 1)}
# K8 2D row marches: source edits, the first as built.
K8_AHEAD = "constexpr int kAhead = 1;"
K8_MARCHES = {"row march as built (1 row ahead)": None,
              "row march, 2 rows ahead": lambda s: _sub(s, K8_AHEAD, "constexpr int kAhead = 2;"),
              "row march, 4 rows ahead": lambda s: _sub(s, K8_AHEAD, "constexpr int kAhead = 4;"),
              "row march, mu and D a row at a time": lambda s: _per_row(s)}
# The row march's m, d with mu and D evaluated for a lane's V pixels of a
# row at once (the form picked and each coefficient read once a row), not
# a pixel at a time.
PIXEL_COEFFS = """#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float ctr = b[v];
      const float lap = __fadd_rn(second_diff(c[v], ctr, a[v], inv.hx2),
                                  second_diff(right(b, v, br), ctr, left(b, v, bl), inv.hy2));
      m[v] = __fsub_rn(coeff_eval(mu, ctr), __fmul_rn(kap, lap));
      d[v] = coeff_eval(dd, ctr);
    }"""
ROW_COEFFS = """    row_eval(mu, b, m);
    row_eval(dd, b, d);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float ctr = b[v];
      const float lap = __fadd_rn(second_diff(c[v], ctr, a[v], inv.hx2),
                                  second_diff(right(b, v, br), ctr, left(b, v, bl), inv.hy2));
      m[v] = __fsub_rn(m[v], __fmul_rn(kap, lap));
    }"""
ROW_EVAL = """template <int N>
__device__ __forceinline__ void row_legval(const float* c, int n, const float (&x)[N],
                                           float (&acc)[N]) {
  float p_prev[N], p_cur[N];
#pragma unroll
  for (int v = 0; v < N; ++v) acc[v] = c[0];
  if (n >= 2) {
    const float c1 = c[1];
#pragma unroll
    for (int v = 0; v < N; ++v) {
      p_prev[v] = 1.0f;
      p_cur[v] = x[v];
      acc[v] = __fadd_rn(acc[v], __fmul_rn(c1, p_cur[v]));
    }
    for (int k = 1; k < n - 1; ++k) {
      const float ck = c[k + 1];
#pragma unroll
      for (int v = 0; v < N; ++v) {
        const float t = __fsub_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(2 * k + 1), x[v]), p_cur[v]),
            __fmul_rn(static_cast<float>(k), p_prev[v]));
        p_prev[v] = p_cur[v];
        p_cur[v] = k == 1 ? __fmul_rn(t, 0.5f) : __fdiv_rn(t, static_cast<float>(k + 1));
        acc[v] = __fadd_rn(acc[v], __fmul_rn(ck, p_cur[v]));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void row_eval(const CoeffSmem& f, const float (&x)[N],
                                         float (&y)[N]) {
  if (f.form == kPoly) {
    const float top = f.c[f.n - 1];
#pragma unroll
    for (int v = 0; v < N; ++v) y[v] = top;
    for (int k = f.n - 2; k >= 0; --k) {
      const float ck = f.c[k];
#pragma unroll
      for (int v = 0; v < N; ++v) y[v] = __fadd_rn(__fmul_rn(y[v], x[v]), ck);
    }
    return;
  }
  if (f.form == kLegendre) {
    row_legval(f.c, f.n, x, y);
    return;
  }
  float t[N];
#pragma unroll
  for (int v = 0; v < N; ++v) t[v] = __fsub_rn(__fmul_rn(2.0f, x[v]), 1.0f);
  row_legval(f.c, f.n, t, y);
  if (f.form == kExpLegendreScaled) {
#pragma unroll
    for (int v = 0; v < N; ++v) y[v] = expf(y[v]);
  }
}

"""
LOAD_COEFFS = "__device__ __forceinline__ void load_coeffs("


def _per_row(src):
    assert PIXEL_COEFFS in src and LOAD_COEFFS in src
    src = src.replace(PIXEL_COEFFS, ROW_COEFFS)
    return src.replace(LOAD_COEFFS, ROW_EVAL + LOAD_COEFFS, 1)


PLANE = "3D plane march, 64 threads"


def _sub(src, old, new):
    assert old in src, old
    return src.replace(old, new)


def _k7_tile(tile):
    """The K7 source edited to another tile and register budget."""
    def edit(src):
        src = _sub(src, "constexpr int kR = 2, kC = 2;",
                   f"constexpr int kR = {tile[0]}, kC = {tile[1]};")
        return _sub(src, "constexpr int kMinBlocks = 1;", f"constexpr int kMinBlocks = {tile[2]};")
    return edit


def _build(tag, src_dir, name, edit=None):
    """nvcc ``src_dir/name.cu`` (with its headers) into OUT/tag; returns
    ``(CDLL, ptxas log, library path)``."""
    d = OUT / tag.replace(" ", "_").replace(",", "").replace("(", "").replace(")", "")
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    for h in Path(src_dir).glob("*.cuh"):
        shutil.copy(h, d)
    src = (Path(src_dir) / f"{name}.cu").read_text()
    (d / f"{name}.cu").write_text(edit(src) if edit else src)
    return d, subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
         str(d / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(builds):
    out = {}
    for key, (d, proc) in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{err}")
        out[key] = (ctypes.CDLL(str(d / "lib.so")), err, d / "lib.so")
    return out


def _ptxas(log, entry):
    """(registers, stack bytes, spill store bytes) of the first entry whose
    mangled name contains ``entry``."""
    at = re.search(r"Compiling entry function '(\w*" + entry + r"\w*)'", log)
    rest = log[at.end():]
    stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", rest)
    regs = re.search(r"Used (\d+) registers", rest)
    return int(regs.group(1)), int(stack.group(1)), int(stack.group(2))


def _blocks_per_sm(regs, threads, smem):
    """Blocks an SM holds by registers (a warp's allocated in 256s),
    shared memory (1 KB reserved a block) and threads."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (REGS_SM // per_warp) // warps
    by_smem = SMEM_SM // (smem + 1024) if smem else 32
    return min(by_regs, by_smem, MAX_WARPS_SM // warps, 32)


def _stage_sass(path, first, barriers_per_stage):
    """SASS of the K7 kernel in ``path``: ``(instructions of one RK stage,
    their MUFU count, instructions of the kernel)``.  The stage is the
    innermost loop whose body holds the first stage's barriers (each
    stage-dependent branch counted, slow paths called out of line not),
    divided by the stages it holds; ``first`` is the index of the first
    stage's first barrier among the kernel's.  None where no such loop is
    found."""
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    ins, branches = [], []                   # (address, text); (index, target address)
    for ln in sass[sass.index("sbm_bv_macro_kernel"):].splitlines():
        at = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(\S.*)", ln)
        if not at:
            continue
        if "Function :" in ln:
            break
        tgt = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)\s*;", ln)
        if tgt:
            branches.append((len(ins), int(tgt.group(1), 16)))
        ins.append((int(at.group(1), 16), at.group(2)))
    index = {addr: i for i, (addr, _) in enumerate(ins)}
    bars = [i for i, (_, t) in enumerate(ins) if "BAR.SYNC" in t]
    lo, hi = bars[first], bars[first + barriers_per_stage - 1]
    loops = [(j - index[t], index[t], j) for j, t in branches
             if t in index and index[t] <= lo and j >= hi]
    if not loops:
        return None
    _, t, j = min(loops)
    body = [text for _, text in ins[t:j + 1]]
    stages = sum("BAR.SYNC" in x for x in body) // barriers_per_stage
    return (len(body) / stages, sum("MUFU" in x for x in body) / stages, len(ins))


def _max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def _abba(names, run):
    """Each name's two CUDA-event times, in the order A B ... B A."""
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(run(n))
    return times


def k7(parent, card, bounds, clock):
    builds = {"earlier commit": _build("k7_parent", parent, "sbm_bv_macro")}
    for name, tile in K7_TILES.items():
        builds[name] = _build(f"k7_{name}", CSRC, "sbm_bv_macro", tile and _k7_tile(tile))
    libs = _finish(builds)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    env = make_sbm_butler_volmer_control_env(num_envs=cs.SBM_ENVS, grid_size=cs.GRID,
                                             substeps=cs.SUBSTEPS, device=dev)
    h = 1.0 / cs.GRID
    consts = sbm_bv.sbm_bv_constants(env.static_equation_parameters["psi"], cs.BV_KAPPA, h, h,
                                     dev)
    u, cr = cs._bv_inputs(torch, dev, gen, cs.SBM_ENVS)
    kw = dict(mu_fn=BV_MU, j0_fn=BV_J0, dt=cs.BV_DT, n_steps=cs.SUBSTEPS)
    px_stages = cs.SBM_ENVS * cs.GRID * cs.GRID * cs.SUBSTEPS * 4
    library = sbm_bv._library
    names = list(libs)
    try:
        for ep in (sbm_bv.SbmEpilogue(255.0, cs.CENTER), None):
            want = sbm_bv.sbm_bv_macro_plain(u, cr, consts, epilogue=ep, **kw)
            want = want[0] if ep else want

            def run(name, ep=ep):
                sbm_bv._library = lambda lib=sbm_bv._bind_library(libs[name][0]): lib
                return cs._time_ms(torch, lambda: sbm_bv.sbm_bv_macro_cuda(
                    u, cr, consts, epilogue=ep, **kw))

            times = _abba(names, run)
            bound = bounds["sbm_bv_macro_ep" if ep else "sbm_bv_macro"][0]
            for name in names:
                sbm_bv._library = lambda lib=sbm_bv._bind_library(libs[name][0]): lib
                got = sbm_bv.sbm_bv_macro_cuda(u, cr, consts, epilogue=ep, **kw)
                got = got[0] if ep else got
                err = (got - want).abs().max().item()
                cs._check(err <= cs.TOL_BV["f32"], f"K7 {name}: {err} vs plain")
                log = libs[name][1]
                regs, stack, spill = _ptxas(log, "sbm_bv_macro_kernel")
                if name == "earlier commit":
                    tile, smem, first, bps = (4, 4, 2), 48 * 1024, 0, 3
                else:
                    tile = K7_TILES[name] or K7_DEFAULT
                    # The constants' barrier comes before the stages'.
                    smem, first, bps = 5 * cs.GRID * cs.GRID * 4, 1, 2
                threads = (64 // tile[0]) * (64 // tile[1])
                mean = sum(times[name]) / 2
                line = (f"K7 {name} (ep {'on' if ep else 'off'}): {times[name][0]:.4f} / "
                        f"{times[name][1]:.4f} ms, {bound / mean:.1%} of the {bound:.4f} ms "
                        f"bound; max_abs_err vs plain {err:.3e}; {regs} registers, {stack} B "
                        f"stack, {spill} B spill stores, {threads} threads, "
                        f"{_blocks_per_sm(regs, threads, smem)} blocks an SM")
                if ep:
                    stage = _stage_sass(libs[name][2], first, bps)
                    if stage:
                        n, mufu, total = stage
                        per_px = n / (tile[0] * tile[1])
                        floor = px_stages * per_px / 32 / (SMS * 4 * clock) * 1e3
                        line += (f"; SASS: {total} instructions, one stage {n:.0f} "
                                 f"({mufu:.0f} MUFU) "
                                 f"= {per_px:.1f} a pixel-stage, issue floor {floor:.4f} ms "
                                 f"at {clock / 1e6:.0f} MHz")
                print(f"{line} ({cs.SBM_ENVS} envs x {cs.GRID}^2 x {cs.SUBSTEPS}) [{card}]",
                      flush=True)
    finally:
        sbm_bv._library = library


def k8(parent, card, bounds):
    three = "constexpr int kThreads = 256;"
    builds = {"earlier commit": _build("k8_parent", parent, "ch_rhs_fd")}
    for name, edit in K8_MARCHES.items():
        builds[name] = _build(f"k8_{name}", CSRC, "ch_rhs_fd", edit)
    builds[PLANE] = _build("k8_plane", CSRC, "ch_rhs_fd",
                           lambda s: _sub(s, three, "constexpr int kThreads = 64;"))
    libs = _finish(builds)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, W = cs.NUM_ENVS, cs.GRID, cs.GRID
    u = torch.clamp(0.5 + 0.01 * torch.randn((B, H, W), generator=gen, device=dev), 0.0, 1.0)
    kap = 2e-3 + 8e-3 * torch.rand((B,), generator=gen, device=dev)
    out = torch.empty_like(u)
    (mf, mc), (df, dc) = fused.kernel_form(CH_MU, dev), fused.kernel_form(CH_D, dev)
    coeffs = (mc.data_ptr(), mc.numel(), mf, dc.data_ptr(), dc.numel(), df)
    inv = (1 / cs.HX, 1 / cs.HY, 1 / cs.HX**2, 1 / cs.HY**2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    args = (u.data_ptr(), kap.data_ptr(), out.data_ptr())
    old = libs["earlier commit"][0]
    old.ch_rhs_fd_2d_launch.argtypes = [p, p, p, i, i, i, p, i, i, p, i, i, f, f, f, f, p]
    launch = {"earlier commit": lambda: old.ch_rhs_fd_2d_launch(*args, B, H, W, *coeffs, *inv,
                                                                stream)}
    for name in K8_MARCHES:
        lib = fused._bind_library(libs[name][0])
        warps = ctypes.c_int(0)
        assert lib.ch_rhs_fd_2d_resident(W, ctypes.byref(warps)) == 0
        launch[name] = (lambda lib=lib, n=warps.value: lib.ch_rhs_fd_2d_launch(
            *args, B, H, W, *coeffs, *inv, n, stream))
    plane = fused._bind_library(libs[PLANE][0])
    blocks3 = ctypes.c_int(0)
    assert plane.ch_rhs_fd_3d_resident(1, W, ctypes.byref(blocks3)) == 0
    inv3 = (ctypes.c_float * 3)(1 / cs.HX, 1.0, 1 / cs.HY)
    inv3_2 = (ctypes.c_float * 3)(1 / cs.HX**2, 1.0, 1 / cs.HY**2)
    launch[PLANE] = lambda: plane.ch_rhs_fd_3d_launch(*args, B, H, 1, W, *coeffs, inv3, inv3_2,
                                                      blocks3.value, stream)
    want2 = fused.ch_rhs_fd_plain(u, kap, mu_fn=CH_MU, D_fn=CH_D, hx=cs.HX, hy=cs.HY)
    want3 = fused.ch3d_rhs_fd_plain(u.view(B, H, 1, W), kap, mu_fn=CH_MU, D_fn=CH_D, h1=cs.HX,
                                    h2=1.0, h3=cs.HY).view(B, H, W)
    names = list(launch)
    times = _abba(names, lambda n: cs._time_ms(torch, lambda: cs._check(
        launch[n]() == 0, f"K8 {n} launch"), reps=20, warmup=3))
    bound = bounds["ch_rhs_fd"][0]
    for name in names:
        out.fill_(float("nan"))
        launch[name]()
        want = want3 if name == PLANE else want2
        torch.cuda.synchronize()
        err = (out - want).abs().max().item() / want.abs().max().item()
        cs._check(err <= cs.TOL_K8, f"K8 {name}: {err} of max|plain|")
        if name == PLANE:
            entry, threads, smem = "ch_rhs_fd_3d_kernel", 64, (5 * W + 4 * W) * 4
        elif name == "earlier commit":
            entry, threads, smem = "ch_rhs_fd_2d_kernel", 256, 3 * H * W * 4
        else:
            entry, threads, smem = "ch_rhs_fd_2d_kernelILi2E", 128, 0
        regs, stack, spill = _ptxas(libs[name][1], entry)
        mean = sum(times[name]) / 2
        print(f"K8 2D {name}: {times[name][0]:.4f} / {times[name][1]:.4f} ms, "
              f"{bound / mean:.1%} of the {bound:.4f} ms bound; max_abs_err "
              f"{err:.3e} of max|plain|; {regs} registers, {stack} B stack, {spill} B spill "
              f"stores, {threads} threads, {_blocks_per_sm(regs, threads, smem)} blocks an SM "
              f"({B} envs x {H} x {W}) [{card}]", flush=True)
    k8_3d(libs, card, bounds)


def _bind_3d(lib):
    """K8 3D's C interface on ``lib`` (the same in both commits)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ch_rhs_fd_3d_resident.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.ch_rhs_fd_3d_resident.restype = i
    lib.ch_rhs_fd_3d_launch.argtypes = [p, p, p, i, i, i, i, p, i, i, p, i, i, p, p, i, p]
    lib.ch_rhs_fd_3d_launch.restype = i
    lib.ch_rhs_fd_error_string.argtypes = [i]
    lib.ch_rhs_fd_error_string.restype = ctypes.c_char_p
    return lib


def k8_3d(libs, card, bounds):
    """K8 3D, whose source file K8 2D's row march shares, as built against
    the earlier commit's at the 3D path's shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    mu, D = cs._m3_coeffs(torch, dev)
    u = cs._m3_field(torch, dev, gen, cs.M3_ENVS)
    kap = torch.full((cs.M3_ENVS,), cs.M3_KAPPA, device=dev)
    h = 0.01                                  # chip_smoke.py's 3D check
    want = fused.ch3d_rhs_fd_plain(u, kap, mu_fn=mu, D_fn=D, h1=h, h2=h, h3=h)
    library = fused._library
    names = ["earlier commit", next(iter(K8_MARCHES))]
    try:
        def run(name):
            fused._library = lambda lib=_bind_3d(libs[name][0]): lib
            fused._resident_3d.cache_clear()
            return cs._time_ms(torch, lambda: fused.ch3d_rhs_fd_cuda(
                u, kap, mu_fn=mu, D_fn=D, h1=h, h2=h, h3=h), reps=20, warmup=3)

        times = _abba(names, run)
        bound = bounds["ch3d_rhs_fd"][0]
        for name in names:
            run(name)
            got = fused.ch3d_rhs_fd_cuda(u, kap, mu_fn=mu, D_fn=D, h1=h, h2=h, h3=h)
            err = (got - want).abs().max().item() / want.abs().max().item()
            cs._check(err <= cs.TOL_K8, f"K8 3D {name}: {err} of max|plain|")
            regs, stack, spill = _ptxas(libs[name][1], "ch_rhs_fd_3d_kernel")
            mean = sum(times[name]) / 2
            label = name if name == "earlier commit" else "as built"
            print(f"K8 3D {label}: {times[name][0]:.4f} / {times[name][1]:.4f} ms, "
                  f"{bound / mean:.1%} of the {bound:.4f} ms bound; max_abs_err {err:.3e} of "
                  f"max|plain|; {regs} registers, {spill} B spill stores ({cs.M3_ENVS} envs x "
                  f"{cs.M3_N}^3, Legendre mu and D) [{card}]", flush=True)
    finally:
        fused._library = library
        fused._resident_3d.cache_clear()


def k6(parent, card):
    libs = _finish({"earlier commit": _build("k6_parent", parent, "bv_cc_macro"),
                    "as built": _build("k6_new", CSRC, "bv_cc_macro")})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    u, cr = cs._bv_inputs(torch, dev, gen, cs.BV_ENVS)
    h = 1.0 / cs.GRID
    library = bv_cas._library
    try:
        for mdt in (torch.bfloat16, torch.float32):
            consts = cas_constants(cs.GRID, cs.GRID, h, h, mdt, dev)
            for ep in (None, Epilogue(255.0, 0.0, cs.CENTER, 1)):
                outs = []
                for name in libs:
                    bv_cas._library = lambda lib=bv_cas._bind_library(libs[name][0]): lib
                    outs.append(bv_cas.bv_cc_macro_cuda(
                        u, cr, consts, mu_fn=BV_MU, j0_fn=BV_J0, kappa=cs.BV_KAPPA, cell=h * h,
                        dt=cs.BV_DT, n_steps=cs.SUBSTEPS, round_bf16=mdt == torch.bfloat16,
                        epilogue=ep))
                same = all(torch.equal(a, b) for a, b in zip(
                    *((o,) if ep is None else o for o in outs)))
                line = (f"K6 {str(mdt)[6:]} matrices, epilogue {'on' if ep else 'off'}: "
                        f"as built bit-identical to the earlier commit: {same} "
                        f"({cs.BV_ENVS} envs x {cs.GRID}^2 x {cs.SUBSTEPS}) [{card}]")
                cs._check(same, line)
                print(line, flush=True)
    finally:
        bv_cas._library = library


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k7_k8_ab.py needs a CUDA device")
    if len(sys.argv) != 2 or not (Path(sys.argv[1]) / "sbm_bv_macro.cu").exists():
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1])
    card = cs._card()
    clock = _max_sm_clock_hz()
    print(f"{card}; max SM clock {clock / 1e6:.0f} MHz", flush=True)
    bounds = cs._bounds()
    k7(parent, card, bounds, clock)
    k8(parent, card, bounds)
    k6(parent, card)


if __name__ == "__main__":
    main()
