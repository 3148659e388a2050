// Fused galvanostatic Butler-Volmer RK4 macro-step on the cas (Hartley)
// transform, hand-written for Hopper (sm_90a), with the optional RL env
// epilogue: K6.
//
// Replaces the TPU kernel of pde_opt_tpu/ops/bv_cas.py,
// make_bv_cc_fused_macro (`kernel`, launched at :265, and `kernel_ep` at
// :280, both over `_evolve_packed`, :143).  Per env with its own C-rate C,
// n_steps classical RK4 substeps; per stage, on the stage input z:
//
//   lap = inv(lam * fwd(z))                  fwd(z) = C_H^T z C_W, inv = fwd/(H W)
//   m   = mu(z) - kappa*lap,  j = j0(z),  em = exp(m/2)
//   I+  = sum(j*em)*cell,  I- = sum(j/em)*cell           (one block reduction)
//   y   = (-C + sqrt(C^2 + 4 I+ I-)) / (2 I+)             (alpha = 1/2)
//   k   = j*(1/(em*y) - em*y)
//
// mu and j0 are the presets' LogRatioMu and SqrtJ0 (bv_common.cuh).  With
// bf16 matrices each transform's operand and intermediate are rounded to
// bf16, as in the JAX kernel; products accumulate in f32.  The epilogue is
// K1's (cas_common.cuh; its fragment-layout twin in cas_wgmma.cuh on the
// bf16 path) at obs_downsample 1.
//
// Bound: 4 transforms = 16 products of 2*64^3 FLOPs per env-substep at 64^2
// (8.4 MFLOP), 172 GFLOP per macro at 2048 envs x 10 substeps (0.17 ms at the
// tensor cores' bf16 rate), plus the closure's ~40 operations a pixel-stage
// with a logf, an expf, a sqrtf and three divisions.  Field traffic is 32 KB
// per env and macro: arithmetic-bound.  Two kernels, picked by the matrices'
// type alone:
//
// - bf16 matrices (the preset's): bv_cc_macro_wg_kernel runs both products of
//   every transform on the tensor cores (cas_wgmma.cuh: warpgroup wgmma, bf16
//   operands, f32 accumulation, the JAX rounding sites); 48 KB of shared
//   memory, each thread the 16 pixels of its accumulator fragment.
// - f32 matrices: bv_cc_macro_kernel, f32 FMA on the CUDA cores (67 TFLOP/s
//   peak; TF32 would not hold the f32 path's bounds), the four matrices and
//   two f32 transform tiles in 96 KB of shared memory, a 4 x 4 tile a thread.
//
// Both: one block of 256 threads owns one env at a time (grid-stride).  RK4
// keeps u, the accumulator, the stage input and one work tile live in
// registers (64 a thread); lam is read through the read-only cache at each
// use rather than held, to stay within 128 registers (two blocks an SM).  The
// two per-env integrals are one block reduction (block_sum3) per stage.
//
// Grids above 64 x 64 (any H and W that are multiples of 8 up to 256) run
// bv_cc_macro_tiled_kernel at the end of this file, bf16 and f32 alike: an
// env's planes live in device memory and each transform streams 64-wide
// chunks through shared memory (cas_tiled.cuh, as the tiled K1-K5).  The
// launch picks the kernel by grid; the 64^2 kernels are unchanged.

#include "bv_common.cuh"
#include "cas_common.cuh"
#include "cas_tiled.cuh"
#include "cas_wgmma.cuh"
#include "kernel_error.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
bv_cc_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ crate,
                   const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                   const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                   const float* __restrict__ lam, float* __restrict__ u_out, int B, int H,
                   int W, int n_steps, Rk4 rk, float kappa, float cell, BvCoeffs bv,
                   Epilogue ep) {
  constexpr bool rnd = false;   // f32 matrices: bf16 runs bv_cc_macro_wg_kernel
  extern __shared__ float4 smem4[];
  const Tiles sm = carve_tiles(reinterpret_cast<float*>(smem4));
  const float *ch = sm.ch, *cw = sm.cw, *ich = sm.ich, *icw = sm.icw;
  float *zs = sm.zs, *ts = sm.ts;
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x;
  const int ty4 = (tid / 16) * 4;        // first row (H axis) this thread owns
  const int tx4 = (tid % 16) * 4;        // first column (W axis)
  const bool own = ty4 < H && tx4 < W;
  load_mats(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float C = crate[env];
    // u: the field; acc: the RK sum; z: the stage input, then j0(z); a: the
    // transform output, then exp(m/2), then the stage's k.
    float u[4][4], acc[4][4], z[4][4], a[4][4] = {};
    if (own) load_tile(u_in + off, W, ty4, tx4, u);

    for (int s = 0; s < n_steps; ++s) {
      for (int stage = 0; stage < 4; ++stage) {
        // The previous transform's barriers have finished every read of zs.
        if (own) {
          rk4_stage_input(z, u, a, stage, rk);
          store_tile(zs, ty4, tx4, z, rnd);
        }
        transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, a);          // fwd(z)
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 l = __ldg(reinterpret_cast<const float4*>(lam + (ty4 + i) * W + tx4));
            a[i][0] *= l.x;
            a[i][1] *= l.y;
            a[i][2] *= l.z;
            a[i][3] *= l.w;
          }
          store_tile(zs, ty4, tx4, a, rnd);
        }
        transform(zs, ts, ich, icw, H, W, ty4, tx4, rnd, a);        // lap
        float ip = 0.f, im = 0.f, unused = 0.f;
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float m = __fsub_rn(bv_mu(bv, z[i][j]), __fmul_rn(kappa, a[i][j]));
              const float jj = bv_j0(bv, z[i][j]);
              const float em = expf(0.5f * m);
              ip += __fmul_rn(jj, em);
              im += __fmul_rn(jj, __fdiv_rn(1.0f, em));
              z[i][j] = jj;
              a[i][j] = em;
            }
        }
        block_sum3(ip, im, unused, red, tid);
        const float y = bv_root(C, __fmul_rn(ip, cell), __fmul_rn(im, cell));
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = bv_reaction(z[i][j], a[i][j], y);
          rk4_accumulate(acc, a, stage);
        }
      }
      if (own) rk4_finish(u, acc, rk);
    }

    if (own) save_tile(u_out + off, W, ty4, tx4, u);
    // Every thread has read the last reduction's totals before the epilogue
    // (or the next env) writes red again.
    __syncthreads();
    if (ep.stats != nullptr) emit_field_epilogue(u, a, zs, red, ep, env, H, W, tid, ty4, tx4, own);
  }
}

// The bf16 path on the tensor cores: the same macro as bv_cc_macro_kernel
// with every transform a wg_transform (operand and intermediate rounded to
// bf16), the fields in the fragment layout of cas_wgmma.cuh.  Pixels off the
// grid (H or W below 64) are computed on and never stored or summed.
__global__ void __launch_bounds__(kThreads, 2)
bv_cc_macro_wg_kernel(const float* __restrict__ u_in, const float* __restrict__ crate,
                      const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                      const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                      const float* __restrict__ lam, float* __restrict__ u_out, int B,
                      int H, int W, int n_steps, Rk4 rk, float kappa, float cell,
                      BvCoeffs bv, Epilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const WgTiles sm = carve_wg_tiles(smem_wg);
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x;
  const Own o = make_own(tid);
  load_mats_wg(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float C = crate[env];
    // u: the field; acc: the RK sum; z: the stage input, then j0(z); a: the
    // transform output, then exp(m/2), then the stage's k.
    float u[4][4], acc[4][4], z[4][4], a[4][4] = {};
    load_frag(u_in + off, H, W, o, u);

    for (int s = 0; s < n_steps; ++s) {
      for (int stage = 0; stage < 4; ++stage) {
        // The previous transform's barriers have finished every read of Z^T.
        rk4_stage_input(z, u, a, stage, rk);
        store_operand(sm.zt, z, o, H, W);
        wg_transform(sm, sm.ch, sm.cw, o, a);                      // fwd(z)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            if (o.valid(j, hi, H, W)) {
              const float2 l = __ldg(
                  reinterpret_cast<const float2*>(lam + o.row(2 * hi) * W + o.col(j, 0)));
              a[j][2 * hi] *= l.x;
              a[j][2 * hi + 1] *= l.y;
            }
        store_operand(sm.zt, a, o, H, W);
        wg_transform(sm, sm.ich, sm.icw, o, a);                    // lap
        float ip = 0.f, im = 0.f, unused = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float m = __fsub_rn(bv_mu(bv, z[j][e]), __fmul_rn(kappa, a[j][e]));
            const float jj = bv_j0(bv, z[j][e]);
            const float em = expf(0.5f * m);
            if (o.valid(j, e >> 1, H, W)) {
              ip += __fmul_rn(jj, em);
              im += __fmul_rn(jj, __fdiv_rn(1.0f, em));
            }
            z[j][e] = jj;
            a[j][e] = em;
          }
        block_sum3(ip, im, unused, red, tid);
        const float y = bv_root(C, __fmul_rn(ip, cell), __fmul_rn(im, cell));
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[j][e] = bv_reaction(z[j][e], a[j][e], y);
        rk4_accumulate(acc, a, stage);
      }
      rk4_finish(u, acc, rk);
    }

    save_frag(u_out + off, H, W, o, u);
    // Every thread has read the last reduction's totals before the epilogue
    // (or the next env) writes red again.
    __syncthreads();
    if (ep.stats != nullptr) emit_field_epilogue_wg(u, wg_scratch(sm), red, ep, env, H, W, tid, o);
  }
}

// ---- K6 above 64 x 64: the tiled kernel ------------------------------------
//
// One block owns one env at a time (grid-stride), as above; the field lives
// in u_out, the rest in this block's slot of a scratch that the wrapper
// allocates (bv_cc_macro_scratch): [z, t, zf, em, acc], five H x W f32
// planes.  z is the transform operand and t the intermediate (both bf16 on
// the tensor-core path, whose matrices g_* are then bf16 copies); zf the
// stage input in f32, then j0 of it; em exp(m/2); acc the RK sum.  A stage:
//
//   fwd(z), whose epilogue writes lam fwd(z) as the next operand;
//   inv(.) = lap, whose epilogue forms m, j0 and em at its pixel pair from
//     zf, adds j0 em and j0 / em to the thread's partial integrals and
//     leaves j0 in zf and em in em;
//   one block reduction of the two integrals, then y (every thread alike);
//   a pass over the env's pixels: k, the RK sum, and the next stage input
//     (after k4 the new u), written to zf and, rounded where the operand is,
//     to z.
//
// The closure needs both integrals before any k exists, so the reaction
// cannot ride in a transform's epilogue: the pass after the reduction reads
// the planes once more.  Order of operations as in the 64^2 kernels.

constexpr int kBvTiledPlanes = 5;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
bv_cc_macro_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ crate,
                         const Op<kBf16>* __restrict__ g_ch, const Op<kBf16>* __restrict__ g_cw,
                         const Op<kBf16>* __restrict__ g_ich,
                         const Op<kBf16>* __restrict__ g_icw, const float* __restrict__ lam,
                         float* u_out, float* scratch, int B, int H, int W, int n_steps, Rk4 rk,
                         float kappa, float cell, BvCoeffs bv, Epilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_tl[];
  __shared__ float red[kWarps][3];
  const int tid = threadIdx.x, hw = H * W;
  float* z = scratch + static_cast<size_t>(blockIdx.x) * kBvTiledPlanes * hw;
  float* t = z + hw;
  float* zf = t + hw;
  float* em = zf + hw;
  float* acc = em + hw;

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float C = crate[env];
    float* u = u_out + off;
    __syncthreads();                 // the previous env's last epilogue is done with the planes
    for (int p = 4 * tid; p < hw; p += 4 * kThreads) {
      float v[4];
      ld4(u_in + off + p, v);
      st4(u + p, v);
      st4(zf + p, v);
      put_z4<kBf16>(z, p, H, W, pack4(v));
    }
    for (int s = 0; s < n_steps; ++s) {
      for (int stage = 0; stage < 4; ++stage) {
        tiled_transform<kBf16>(                                   // lam fwd(z)
            smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
              const float2 l = ld2(lam + r * W + c);
              put_z<kBf16>(z, r, c, H, W, make_float2(v.x * l.x, v.y * l.y));
            });
        float ip = 0.f, im = 0.f, unused = 0.f;
        tiled_transform<kBf16>(                                   // lap, then the closure's terms
            smem_tl, z, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
              const int p = r * W + c;
              const float2 x = ld2(zf + p);
              const float xs[2] = {x.x, x.y}, lap[2] = {v.x, v.y};
              float jj[2], e[2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float m = __fsub_rn(bv_mu(bv, xs[i]), __fmul_rn(kappa, lap[i]));
                jj[i] = bv_j0(bv, xs[i]);
                e[i] = expf(0.5f * m);
                ip += __fmul_rn(jj[i], e[i]);
                im += __fmul_rn(jj[i], __fdiv_rn(1.0f, e[i]));
              }
              st2(zf + p, make_float2(jj[0], jj[1]));
              st2(em + p, make_float2(e[0], e[1]));
            });
        block_sum3(ip, im, unused, red, tid);
        const float y = bv_root(C, __fmul_rn(ip, cell), __fmul_rn(im, cell));
        const float c = rk.stage_coef(stage + 1);
        for (int p = 4 * tid; p < hw; p += 4 * kThreads) {
          float jv[4], ev[4], uu[4], a[4] = {}, nx[4];
          ld4(zf + p, jv);
          ld4(em + p, ev);
          ld4(u + p, uu);
          if (stage > 0) ld4(acc + p, a);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float k = bv_reaction(jv[i], ev[i], y);
            a[i] = stage == 0 ? k : __fadd_rn(a[i], (stage == 3 ? 1.0f : 2.0f) * k);
            if (stage == 3) {
              uu[i] = __fadd_rn(uu[i], __fmul_rn(rk.sixth, a[i]));
              nx[i] = uu[i];
            } else {
              nx[i] = __fadd_rn(uu[i], __fmul_rn(c, k));
            }
          }
          if (stage < 3) st4(acc + p, a);     // k4 closes the sum: no store
          else st4(u + p, uu);
          st4(zf + p, nx);
          put_z4<kBf16>(z, p, H, W, pack4(nx));
        }
      }
    }
    if (ep.stats != nullptr) tiled_field_epilogue(u, red, ep, env, H, W, tid);
  }
}

}  // namespace

extern "C" {

// The scratch a launch needs on the current device: `slots` blocks resident
// at once of the kernel that the grid and round_bf16 pick, each with a slot
// of `floats` f32: none at 64^2 and below (0, 0), kBvTiledPlanes H x W
// planes above.  Returns a cudaError_t value.
int bv_cc_macro_scratch(int round_bf16, int H, int W, int* slots, long long* floats) {
  *slots = 0;
  *floats = 0;
  if (!tiled(H, W)) return 0;
  return static_cast<int>(
      round_bf16 != 0
          ? tiled_scratch(bv_cc_macro_tiled_kernel<true>, true, kBvTiledPlanes, H, W, slots,
                          floats)
          : tiled_scratch(bv_cc_macro_tiled_kernel<false>, false, kBvTiledPlanes, H, W, slots,
                          floats));
}

// Launches K6 on `stream`: at 64^2 and below the tensor-core kernel when
// round_bf16 (bf16 matrices), the FMA kernel otherwise; above, the tiled
// kernel of that type, on min(B, n_slots) blocks with `scratch` as
// bv_cc_macro_scratch sizes it (unused at 64^2).  ch16 .. icw16 are the
// matrices as bf16 (read by the tiled tensor-core kernel alone; may be null
// otherwise).  stats == nullptr runs the plain macro; otherwise stats and
// obs are written too.  dt_half, dt, dt_sixth are the RK4 stage constants
// rounded to f32.  Returns a cudaError_t value, 0 on success.
int bv_cc_macro_launch(const float* u, const float* crate, const float* ch, const float* cw,
                       const float* ich, const float* icw, const void* ch16, const void* cw16,
                       const void* ich16, const void* icw16, const float* lam, float* out,
                       float* stats, unsigned char* obs, float* scratch, int n_slots, int B,
                       int H, int W, int n_steps, float dt_half, float dt, float dt_sixth,
                       float kappa, float cell, float omega, float clip_lo, float clip_hi,
                       float j0_floor, int round_bf16, float obs_scale, float obs_offset,
                       float center, void* stream) {
  const bool big = tiled(H, W);
  if ((big ? bad_tiled_grid(B, H, W, n_steps) : bad_grid(B, H, W, n_steps)) ||
      (big && (scratch == nullptr || n_slots < 1 ||
               (round_bf16 != 0 && bad_mats16(ch16, cw16, ich16, icw16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{stats, obs, 1, obs_scale, obs_offset, center};
  const Rk4 rk{dt_half, dt, dt_sixth};
  const BvCoeffs bv{omega, clip_lo, clip_hi, j0_floor};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (big && round_bf16 != 0)
    return static_cast<int>(launch_tiled(bv_cc_macro_tiled_kernel<true>, true, B, n_slots, st, u,
                                         crate, B16(ch16), B16(cw16), B16(ich16), B16(icw16),
                                         lam, out, scratch, B, H, W, n_steps, rk, kappa, cell,
                                         bv, ep));
  if (big)
    return static_cast<int>(launch_tiled(bv_cc_macro_tiled_kernel<false>, false, B, n_slots, st,
                                         u, crate, ch, cw, ich, icw, lam, out, scratch, B, H, W,
                                         n_steps, rk, kappa, cell, bv, ep));
  int resident = 0;
  cudaError_t err;
  if (round_bf16 != 0) {
    if ((err = resident_blocks(bv_cc_macro_wg_kernel, &resident, kWgSmemBytes)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    bv_cc_macro_wg_kernel<<<grid, kThreads, kWgSmemBytes, st>>>(
        u, crate, ch, cw, ich, icw, lam, out, B, H, W, n_steps, rk, kappa, cell, bv, ep);
  } else {
    if ((err = resident_blocks(bv_cc_macro_kernel, &resident)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    bv_cc_macro_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        u, crate, ch, cw, ich, icw, lam, out, B, H, W, n_steps, rk, kappa, cell, bv, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
