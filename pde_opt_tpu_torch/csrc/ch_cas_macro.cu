// Fused semi-implicit Cahn-Hilliard macro-step on the cas (Hartley) spectrum,
// hand-written for Hopper (sm_90a), with the optional RL env epilogue, and
// its backward.
//
// Replaces the TPU kernels of pde_opt_tpu/ops/cas_spectral.py,
// make_ch_cas_fused_macro: `kernel` (the plain macro, K2), `kernel_ep`
// with `_ep_emit` (the macro plus the env epilogue, K1) and `bwd_kernel`
// (the macro's VJP, K3; see the backward kernels below).  It computes
// what they compute, per env, without their MXU layout (no 128-wide env
// packing, no block-diagonal matrices, no int32 detour before uint8, no
// packed kappa accumulator summed outside the kernel):
//
//   fwd(z) = C_H^T z C_W,   inv(z) = C_H^T z C_W / (H*W)   (C: symmetric cas)
//   u~ = fwd(u)
//   n_steps times:  incr = cm * fwd(mu(u)) - cu * u~;  u~ += incr;  u += inv(incr)
//   cm = dt*lam / (1 + A*dt*kappa*lam^2),  cu = dt*kappa*lam^2 / (1 + A*dt*kappa*lam^2)
//
// With bf16 matrices the operand z and the intermediate of each transform
// are rounded to bf16 (the matrices arrive already rounded); products
// accumulate in f32.  The epilogue emits [sum(u-c), sum((u-c)^2), n_finite]
// over finite pixels and the uint8 observation, mean-pooled by `ds` when
// ds > 1.
//
// Bound: per env-substep the four 64x64x64 products are 4*H*W*(H+W) FLOPs,
// 2.1 MFLOP at 64^2; at 4096 envs x 10 substeps that is ~86 GFLOP against
// ~150 MB of field traffic, so the kernel is bound by arithmetic, not by
// device memory.  Design: one block of 256 threads owns one env at a time
// (grid-stride over envs, so each block loads the four matrices once); u,
// u~ and the per-pixel multipliers stay in registers for all substeps, so the
// field touches device memory once in and once out.  Two kernels each for
// the forward and the backward, picked by the matrices' type alone:
//
// - bf16 matrices (the presets' and train_grad's): ch_cas_macro_wg_kernel
//   and ch_cas_macro_bwd_wg_kernel run both products of every transform on
//   the tensor cores (cas_wgmma.cuh: warpgroup wgmma, bf16 operands, f32
//   accumulation, the JAX rounding sites); 48 KB of shared memory, each
//   thread the 16 pixels of its accumulator fragment, capped at 128
//   registers so that two blocks fit an SM.
// - f32 matrices: ch_cas_macro_kernel and ch_cas_macro_bwd_kernel, f32 FMA
//   on the CUDA cores (TF32 would not hold the f32 path's bounds); the four
//   matrices and two f32 transform tiles in 96 KB of shared memory, a 4 x 4
//   output tile a thread from float4 shared-memory loads.  The transform,
//   the tile helpers and the epilogue are shared with K4 and K5
//   (cas_common.cuh).
//
// Grids above 64 x 64 (any H and W that are multiples of 8 up to 256) run
// the tiled kernels at the end of this file, bf16 and f32 alike:
// ch_cas_macro_tiled_kernel (K1, K2) and ch_cas_macro_bwd_tiled_kernel
// (K3).  An env's field, spectrum and intermediates no longer fit one
// block's registers and shared memory there (one f32 256^2 field is 256 KB),
// so they live in device memory and each transform streams 64-wide chunks
// through shared memory (cas_tiled.cuh).  The forward with bf16 matrices on
// square grids up to 128 x 128 runs ch_cas_macro_onchip_kernel instead, which
// keeps an env's state on chip (cas_onchip.cuh; see `onchip`).  The launch
// picks the kernel by grid and matrix type; the 64^2 kernels above are
// unchanged.

#include "cas_common.cuh"
#include "cas_onchip.cuh"
#include "cas_tiled.cuh"
#include "cas_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
ch_cas_macro_kernel(const float* __restrict__ u_in,
                    const float* __restrict__ kappa,
                    const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                    const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                    const float* __restrict__ lam, const float* __restrict__ lam2,
                    float* __restrict__ u_out, int B, int H, int W, int n_steps,
                    float dt, float a_dt, MuPoly mu, Epilogue ep) {
  constexpr bool rnd = false;   // f32 matrices: bf16 runs ch_cas_macro_wg_kernel
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
    const float* ue = u_in + static_cast<size_t>(env) * H * W;
    const float k = kappa[env];
    float u[4][4], ut[4][4], cm[4][4], cu[4][4], f[4][4];
    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (ty4 + i) * W + tx4;
        const float4 uv = *reinterpret_cast<const float4*>(ue + o);
        const float4 lv = *reinterpret_cast<const float4*>(lam + o);
        const float4 l2 = *reinterpret_cast<const float4*>(lam2 + o);
        const float us[4] = {uv.x, uv.y, uv.z, uv.w};
        const float ls[4] = {lv.x, lv.y, lv.z, lv.w};
        const float l2s[4] = {l2.x, l2.y, l2.z, l2.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float denom = 1.0f / (1.0f + a_dt * (k * l2s[j]));
          cm[i][j] = (dt * ls[j]) * denom;
          cu[i][j] = ((dt * k) * l2s[j]) * denom;
          u[i][j] = us[j];
        }
      }
    }
    __syncthreads();              // the previous env's epilogue is done with zs
    if (own) store_tile(zs, ty4, tx4, u, rnd);
    transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, ut);

    for (int s = 0; s < n_steps; ++s) {
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = mu_eval(mu, u[i][j]);
        store_tile(zs, ty4, tx4, f, rnd);
      }
      transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, f);
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float incr = cm[i][j] * f[i][j] - cu[i][j] * ut[i][j];
            ut[i][j] += incr;
            f[i][j] = incr;
          }
        store_tile(zs, ty4, tx4, f, rnd);
      }
      transform(zs, ts, ich, icw, H, W, ty4, tx4, rnd, f);
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] += f[i][j];
      }
    }

    float* uo = u_out + static_cast<size_t>(env) * H * W;
    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(uo + (ty4 + i) * W + tx4) =
            make_float4(u[i][0], u[i][1], u[i][2], u[i][3]);
    }
    if (ep.stats == nullptr) continue;

    // ---- env epilogue (_ep_emit) on the register-resident final field ----
    emit_field_epilogue(u, f, zs, red, ep, env, H, W, tid, ty4, tx4, own);
  }
}

// The bf16 path on the tensor cores: the same macro as ch_cas_macro_kernel
// with every transform a wg_transform (operand and intermediate rounded to
// bf16), the fields in the fragment layout of cas_wgmma.cuh.  Pixels off the
// grid (H or W below 64) are computed on and never stored or summed.
__global__ void __launch_bounds__(kThreads, 2)
ch_cas_macro_wg_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                       const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                       const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                       const float* __restrict__ lam, const float* __restrict__ lam2,
                       float* __restrict__ u_out, int B, int H, int W, int n_steps,
                       float dt, float a_dt, MuPoly mu, Epilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const WgTiles sm = carve_wg_tiles(smem_wg);
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x;
  const Own o = make_own(tid);
  load_mats_wg(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float k = kappa[env];
    float u[4][4], ut[4][4], cm[4][4], cu[4][4], f[4][4];
    load_frag(u_in + off, H, W, o, u);
    load_frag(lam, H, W, o, cm);
    load_frag(lam2, H, W, o, cu);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float denom = 1.0f / (1.0f + a_dt * (k * cu[j][e]));
        cm[j][e] = (dt * cm[j][e]) * denom;
        cu[j][e] = ((dt * k) * cu[j][e]) * denom;
      }
    // The previous env's last barrier has finished every read of the tiles.
    store_operand(sm.zt, u, o, H, W);
    wg_transform(sm, sm.ch, sm.cw, o, ut);                         // u~ = fwd(u)

    for (int s = 0; s < n_steps; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = mu_eval(mu, u[j][e]);
      store_operand(sm.zt, f, o, H, W);
      wg_transform(sm, sm.ch, sm.cw, o, f);                        // fwd(mu(u))
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float incr = cm[j][e] * f[j][e] - cu[j][e] * ut[j][e];
          ut[j][e] += incr;
          f[j][e] = incr;
        }
      store_operand(sm.zt, f, o, H, W);
      wg_transform(sm, sm.ich, sm.icw, o, f);                      // inv(incr)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] += f[j][e];
    }

    save_frag(u_out + off, H, W, o, u);
    if (ep.stats != nullptr) {
      emit_field_epilogue_wg(u, wg_scratch(sm), red, ep, env, H, W, tid, o);
    } else {
      __syncthreads();   // every read of the tiles is done before the next env writes them
    }
  }
}

// ---- K3: the macro's VJP (`bwd_kernel`) -----------------------------------
//
// Per env: re-run the forward substeps, stashing each substep's input field
// in this block's slot of a device-memory scratch (n_steps x H x W f32:
// 160 KB at 64^2 x 10 substeps, more than shared memory holds beside the
// matrices; two resident blocks per SM make ~43 MB of slots, which mostly
// stay in the 50 MB L2), then sweep back with five transforms per substep,
// as the JAX kernel does (1 + 7 n_steps transforms an env in all):
//
//   ghat  = fwd(gbar)
//   kacc += ghat/(H*W) * (dcm * fwd(mu(u_k)) - dcu * fwd(u_k))
//   gbar += mu'(u_k) * inv(cm * ghat) - inv(cu * ghat)
//
//   dcm = d cm/d kappa = -A*dt^2*lam^3*denom^2,  dcu = d cu/d kappa = dt*lam^2*denom^2
//
// Bound: 7 transforms = 14*H*W*(H+W) FLOPs per env-substep (7.3 MFLOP at
// 64^2).  Two kernels, as the forward: ch_cas_macro_bwd_wg_kernel on the
// tensor cores with bf16 matrices (every transform rounds, as the JAX
// kernel's and the plain backward's do), ch_cas_macro_bwd_kernel in f32 FMA
// with f32 matrices.  gbar and kacc stay in registers for the whole sweep;
// the four multipliers are recomputed from lam/lam2 where they are used
// (held for 16 pixels each beside gbar, kacc and ghat they would spill).
// Each block reduces its env's kacc to one float (shuffles, then shared
// memory), as the K1 epilogue reduces stats.

struct StepConsts {
  float dt, a_dt, neg_a_dt2;   // dt, A*dt, -A*dt*dt
};

struct Mult {
  float cm, cu, dcm, dcu;
};

// The multipliers of a pixel with symbols l = lam and l2 = lam^2, in the
// JAX kernel's order of operations.
__device__ __forceinline__ Mult mult_from(float l, float l2, float k, StepConsts c) {
  const float denom = 1.0f / (1.0f + c.a_dt * (k * l2));
  Mult m;
  m.cm = (c.dt * l) * denom;
  m.cu = ((c.dt * k) * l2) * denom;
  m.dcm = ((c.neg_a_dt2 * (l * l2)) * denom) * denom;
  m.dcu = ((c.dt * l2) * denom) * denom;
  return m;
}

// The multipliers of pixel o.
__device__ __forceinline__ Mult mult_at(const float* __restrict__ lam,
                                        const float* __restrict__ lam2, int o,
                                        float k, StepConsts c) {
  return mult_from(__ldg(lam + o), __ldg(lam2 + o), k, c);
}

__global__ void __launch_bounds__(kThreads)
ch_cas_macro_bwd_kernel(const float* __restrict__ u_in,
                        const float* __restrict__ kappa,
                        const float* __restrict__ g_in,
                        const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                        const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                        const float* __restrict__ lam, const float* __restrict__ lam2,
                        float* __restrict__ du_out, float* __restrict__ dk_out,
                        float* __restrict__ scratch, int B, int H, int W, int n_steps,
                        StepConsts c, MuPoly mu, MuPoly dmu) {
  constexpr bool rnd = false;   // f32 matrices: bf16 runs ch_cas_macro_bwd_wg_kernel
  extern __shared__ float4 smem4[];
  const Tiles sm = carve_tiles(reinterpret_cast<float*>(smem4));
  const float *ch = sm.ch, *cw = sm.cw, *ich = sm.ich, *icw = sm.icw;
  float *zs = sm.zs, *ts = sm.ts;
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int ty4 = (tid / 16) * 4;        // first row (H axis) this thread owns
  const int tx4 = (tid % 16) * 4;        // first column (W axis)
  const bool own = ty4 < H && tx4 < W;
  const int hw = H * W;
  const float inv_hw = 1.0f / static_cast<float>(hw);
  // This block's trajectory slot; each thread reads back only the pixels
  // it wrote itself, so the slot needs no barrier.
  float* traj = scratch + static_cast<size_t>(blockIdx.x) * n_steps * hw;

  load_mats(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float k = kappa[env];
    float u[4][4], ut[4][4], f[4][4];

    // ---- forward re-run: traj[s] = the input field of substep s ----
    if (own) {
      load_tile(u_in + off, W, ty4, tx4, u);
      store_tile(zs, ty4, tx4, u, rnd);
    }
    transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, ut);
    for (int s = 0; s < n_steps; ++s) {
      if (own) {
        save_tile(traj + static_cast<size_t>(s) * hw, W, ty4, tx4, u);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = mu_eval(mu, u[i][j]);
        store_tile(zs, ty4, tx4, f, rnd);
      }
      transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, f);
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Mult m = mult_at(lam, lam2, (ty4 + i) * W + tx4 + j, k, c);
            const float incr = m.cm * f[i][j] - m.cu * ut[i][j];
            ut[i][j] += incr;
            f[i][j] = incr;
          }
        store_tile(zs, ty4, tx4, f, rnd);
      }
      transform(zs, ts, ich, icw, H, W, ty4, tx4, rnd, f);
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] += f[i][j];
      }
    }

    // ---- reverse sweep; u, ut and f now hold u_k, ghat and temporaries ----
    float gb[4][4], kacc[4][4];
    if (own) {
      load_tile(g_in + off, W, ty4, tx4, gb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) kacc[i][j] = 0.f;
    }
    for (int s = n_steps - 1; s >= 0; --s) {
      const float* uk = traj + static_cast<size_t>(s) * hw;
      if (own) {
        load_tile(uk, W, ty4, tx4, u);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = mu_eval(mu, u[i][j]);
        store_tile(zs, ty4, tx4, f, rnd);
      }
      transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, f);       // fwd(mu(u_k))
      if (own) store_tile(zs, ty4, tx4, u, rnd);
      transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, u);       // fwd(u_k)
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Mult m = mult_at(lam, lam2, (ty4 + i) * W + tx4 + j, k, c);
            f[i][j] = m.dcm * f[i][j] - m.dcu * u[i][j];
          }
        store_tile(zs, ty4, tx4, gb, rnd);
      }
      transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, ut);      // ghat = fwd(gbar)
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Mult m = mult_at(lam, lam2, (ty4 + i) * W + tx4 + j, k, c);
            kacc[i][j] += (inv_hw * ut[i][j]) * f[i][j];
            f[i][j] = m.cm * ut[i][j];
          }
        store_tile(zs, ty4, tx4, f, rnd);
      }
      transform(zs, ts, ich, icw, H, W, ty4, tx4, rnd, f);     // inv(cm * ghat)
      if (own) {
        load_tile(uk, W, ty4, tx4, u);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Mult m = mult_at(lam, lam2, (ty4 + i) * W + tx4 + j, k, c);
            gb[i][j] += mu_eval(dmu, u[i][j]) * f[i][j];
            f[i][j] = m.cu * ut[i][j];
          }
        store_tile(zs, ty4, tx4, f, rnd);
      }
      transform(zs, ts, ich, icw, H, W, ty4, tx4, rnd, f);     // inv(cu * ghat)
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gb[i][j] -= f[i][j];
      }
    }

    float part = 0.f;
    if (own) {
      save_tile(du_out + off, W, ty4, tx4, gb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part += kacc[i][j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((tid & 31) == 0) red[tid / 32] = part;
    __syncthreads();
    if (tid == 0) {
      float a = 0.f;
      for (int w = 0; w < kWarps; ++w) a += red[w];
      dk_out[env] = a;
    }
    // The next env's first transform holds barriers that order this read of
    // red before the next write.
  }
}

// The multipliers of fragment pixel (j, e); zero off the grid, where lam
// has no entry.
__device__ __forceinline__ Mult mult_frag(const float* __restrict__ lam,
                                          const float* __restrict__ lam2, const Own& o,
                                          int j, int e, int H, int W, float k,
                                          StepConsts c) {
  if (!o.valid(j, e >> 1, H, W)) return Mult{0.f, 0.f, 0.f, 0.f};
  return mult_at(lam, lam2, o.row(e) * W + o.col(j, e), k, c);
}

// The bf16 backward on the tensor cores: ch_cas_macro_bwd_kernel's forward
// re-run and sweep with every transform a wg_transform and every per-pixel
// value in the fragment layout of cas_wgmma.cuh.  kacc is summed into one
// float a thread as it accrues (the same terms in another order, which
// frees 15 registers); pixels off the grid add nothing and are never stored.
__global__ void __launch_bounds__(kThreads, 2)
ch_cas_macro_bwd_wg_kernel(const float* __restrict__ u_in,
                           const float* __restrict__ kappa,
                           const float* __restrict__ g_in,
                           const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                           const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                           const float* __restrict__ lam, const float* __restrict__ lam2,
                           float* __restrict__ du_out, float* __restrict__ dk_out,
                           float* __restrict__ scratch, int B, int H, int W, int n_steps,
                           StepConsts c, MuPoly mu, MuPoly dmu) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const WgTiles sm = carve_wg_tiles(smem_wg);
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const Own o = make_own(tid);
  const int hw = H * W;
  const float inv_hw = 1.0f / static_cast<float>(hw);
  // This block's trajectory slot; each thread reads back only the pixels
  // it wrote itself, so the slot needs no barrier.
  float* traj = scratch + static_cast<size_t>(blockIdx.x) * n_steps * hw;

  load_mats_wg(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float k = kappa[env];
    float u[4][4], ut[4][4], f[4][4];

    // ---- forward re-run: traj[s] = the input field of substep s ----
    load_frag(u_in + off, H, W, o, u);
    store_operand(sm.zt, u, o, H, W);
    wg_transform(sm, sm.ch, sm.cw, o, ut);
    for (int s = 0; s < n_steps; ++s) {
      save_frag(traj + static_cast<size_t>(s) * hw, H, W, o, u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = mu_eval(mu, u[j][e]);
      store_operand(sm.zt, f, o, H, W);
      wg_transform(sm, sm.ch, sm.cw, o, f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Mult m = mult_frag(lam, lam2, o, j, e, H, W, k, c);
          const float incr = m.cm * f[j][e] - m.cu * ut[j][e];
          ut[j][e] += incr;
          f[j][e] = incr;
        }
      store_operand(sm.zt, f, o, H, W);
      wg_transform(sm, sm.ich, sm.icw, o, f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] += f[j][e];
    }

    // ---- reverse sweep; u, ut and f now hold u_k, ghat and temporaries ----
    float gb[4][4], part = 0.f;
    load_frag(g_in + off, H, W, o, gb);
    for (int s = n_steps - 1; s >= 0; --s) {
      const float* uk = traj + static_cast<size_t>(s) * hw;
      load_frag(uk, H, W, o, u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = mu_eval(mu, u[j][e]);
      store_operand(sm.zt, f, o, H, W);
      wg_transform(sm, sm.ch, sm.cw, o, f);                        // fwd(mu(u_k))
      store_operand(sm.zt, u, o, H, W);
      wg_transform(sm, sm.ch, sm.cw, o, u);                        // fwd(u_k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Mult m = mult_frag(lam, lam2, o, j, e, H, W, k, c);
          f[j][e] = m.dcm * f[j][e] - m.dcu * u[j][e];
        }
      store_operand(sm.zt, gb, o, H, W);
      wg_transform(sm, sm.ch, sm.cw, o, ut);                       // ghat = fwd(gbar)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Mult m = mult_frag(lam, lam2, o, j, e, H, W, k, c);
          if (o.valid(j, e >> 1, H, W)) part += (inv_hw * ut[j][e]) * f[j][e];
          f[j][e] = m.cm * ut[j][e];
        }
      store_operand(sm.zt, f, o, H, W);
      wg_transform(sm, sm.ich, sm.icw, o, f);                      // inv(cm * ghat)
      load_frag(uk, H, W, o, u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Mult m = mult_frag(lam, lam2, o, j, e, H, W, k, c);
          gb[j][e] += mu_eval(dmu, u[j][e]) * f[j][e];
          f[j][e] = m.cu * ut[j][e];
        }
      store_operand(sm.zt, f, o, H, W);
      wg_transform(sm, sm.ich, sm.icw, o, f);                      // inv(cu * ghat)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gb[j][e] -= f[j][e];
    }

    save_frag(du_out + off, H, W, o, gb);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
    if ((tid & 31) == 0) red[tid / 32] = part;
    __syncthreads();
    if (tid == 0) {
      float a = 0.f;
      for (int w = 0; w < kWarps; ++w) a += red[w];
      dk_out[env] = a;
    }
    // The next env's first wg_transform holds barriers that order this read
    // of red before the next write.
  }
}

// ---- K1-K3 above 64 x 64: the tiled kernels ---------------------------------
//
// One block owns one env at a time (grid-stride over envs), as above, but an
// env's per-pixel planes live in device memory: the field in u_out (K3's
// gbar in du_out), the rest in this block's slot of a scratch that the
// wrapper allocates (ch_cas_macro_scratch says how large).  Every transform
// is a tiled_transform (cas_tiled.cuh) whose epilogue does the substep's
// elementwise work at a pixel pair and writes the next transform's operand
// plane z there.  The arithmetic and its order per pixel are the 64^2
// kernels'; the multipliers are recomputed from lam and lam2 where they are
// used.

// The multipliers at the pixel pair that starts at p.
struct Mult2 {
  Mult x, y;
};

__device__ __forceinline__ Mult2 mult2(const float* __restrict__ lam,
                                       const float* __restrict__ lam2, int p, float k,
                                       const StepConsts& sc) {
  const float2 l = ld2(lam + p), l2 = ld2(lam2 + p);
  return {mult_from(l.x, l2.x, k, sc), mult_from(l.y, l2.y, k, sc)};
}

// K1/K2: slot = [z, t, u~], three H x W f32 planes (z and t hold bf16 on
// the tensor-core path, the matrices g_* are then bf16 copies).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
ch_cas_macro_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                          const Op<kBf16>* __restrict__ g_ch, const Op<kBf16>* __restrict__ g_cw,
                          const Op<kBf16>* __restrict__ g_ich,
                          const Op<kBf16>* __restrict__ g_icw,
                          const float* __restrict__ lam, const float* __restrict__ lam2,
                          float* u_out, float* scratch, int B, int H, int W, int n_steps,
                          float dt, float a_dt, MuPoly mu, Epilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_tl[];
  __shared__ float red[kWarps][3];
  const int tid = threadIdx.x, hw = H * W;
  const StepConsts sc{dt, a_dt, 0.f};
  float* z = scratch + static_cast<size_t>(blockIdx.x) * 3 * hw;
  float* t = z + hw;
  float* ut = t + hw;

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float k = kappa[env];
    float* u = u_out + off;
    __syncthreads();                 // the previous env's last epilogue is done with the planes
    for (int p = 4 * tid; p < hw; p += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(u_in + off + p);
      *reinterpret_cast<float4*>(u + p) = v;
      put_z4<kBf16>(z, p, H, W, v);
    }
    tiled_transform<kBf16>(                                       // u~ = fwd(u)
        smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
          const int p = r * W + c;
          st2(ut + p, v);
          put_z<kBf16>(z, r, c, H, W, mu2(mu, ld2(u + p)));
        });
    for (int s = 0; s < n_steps; ++s) {
      tiled_transform<kBf16>(                                     // incr = cm fwd(mu(u)) - cu u~
          smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            const Mult2 m = mult2(lam, lam2, p, k, sc);
            const float2 a = ld2(ut + p);
            const float i0 = m.x.cm * v.x - m.x.cu * a.x, i1 = m.y.cm * v.y - m.y.cu * a.y;
            st2(ut + p, make_float2(a.x + i0, a.y + i1));
            put_z<kBf16>(z, r, c, H, W, make_float2(i0, i1));
          });
      tiled_transform<kBf16>(                                     // u += inv(incr)
          smem_tl, z, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            float2 x = ld2(u + p);
            x.x += v.x;
            x.y += v.y;
            st2(u + p, x);
            put_z<kBf16>(z, r, c, H, W, mu2(mu, x));
          });
    }
    if (ep.stats != nullptr) tiled_field_epilogue(u, red, ep, env, H, W, tid);
  }
}

// K3: slot = [traj (max(n_steps, 1) planes), z, t, u~, f, ghat].  The forward
// re-run stores u_0 .. u_{n-1} (the sweep needs no u_n, so the last
// substep's two transforms are not re-run: 1 + 2 (n - 1) transforms), then
// the sweep runs the five transforms a substep of the 64^2 kernels, in
// their order, with gbar in du_out.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
ch_cas_macro_bwd_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                              const float* __restrict__ g_in,
                              const Op<kBf16>* __restrict__ g_ch,
                              const Op<kBf16>* __restrict__ g_cw,
                              const Op<kBf16>* __restrict__ g_ich,
                              const Op<kBf16>* __restrict__ g_icw,
                              const float* __restrict__ lam, const float* __restrict__ lam2,
                              float* du_out, float* __restrict__ dk_out, float* scratch, int B,
                              int H, int W, int n_steps, StepConsts sc, MuPoly mu, MuPoly dmu) {
  extern __shared__ __align__(128) unsigned char smem_tl[];
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, hw = H * W;
  const float inv_hw = 1.0f / static_cast<float>(hw);
  const int n_traj = n_steps > 0 ? n_steps : 1;
  float* traj = scratch + static_cast<size_t>(blockIdx.x) * (n_traj + 5) * hw;
  float* z = traj + static_cast<size_t>(n_traj) * hw;
  float* t = z + hw;
  float* ut = t + hw;
  float* f = ut + hw;
  float* gh = f + hw;

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float k = kappa[env];
    float* gb = du_out + off;
    __syncthreads();                 // the previous env's last epilogue is done with the planes
    for (int p = 4 * tid; p < hw; p += 4 * kThreads) {
      const float4 g4 = *reinterpret_cast<const float4*>(g_in + off + p);
      const float4 u4 = *reinterpret_cast<const float4*>(u_in + off + p);
      *reinterpret_cast<float4*>(gb + p) = g4;
      *reinterpret_cast<float4*>(traj + p) = u4;
      put_z4<kBf16>(z, p, H, W,
                    n_steps >= 2 ? u4
                                 : make_float4(mu_eval(mu, u4.x), mu_eval(mu, u4.y),
                                               mu_eval(mu, u4.z), mu_eval(mu, u4.w)));
    }

    // ---- forward re-run: traj[s] = the input field of substep s ----
    if (n_steps >= 2) {
      tiled_transform<kBf16>(                                     // u~ = fwd(u_0)
          smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            st2(ut + p, v);
            put_z<kBf16>(z, r, c, H, W, mu2(mu, ld2(traj + p)));
          });
    }
    for (int s = 0; s + 1 < n_steps; ++s) {
      float* us = traj + static_cast<size_t>(s) * hw;
      tiled_transform<kBf16>(                                     // incr
          smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            const Mult2 m = mult2(lam, lam2, p, k, sc);
            const float2 a = ld2(ut + p);
            const float i0 = m.x.cm * v.x - m.x.cu * a.x, i1 = m.y.cm * v.y - m.y.cu * a.y;
            st2(ut + p, make_float2(a.x + i0, a.y + i1));
            put_z<kBf16>(z, r, c, H, W, make_float2(i0, i1));
          });
      tiled_transform<kBf16>(                                     // u_{s+1} = u_s + inv(incr)
          smem_tl, z, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            float2 x = ld2(us + p);
            x.x += v.x;
            x.y += v.y;
            st2(us + hw + p, x);
            put_z<kBf16>(z, r, c, H, W, mu2(mu, x));
          });
    }

    // ---- reverse sweep: z holds mu(u_k) as each substep starts ----
    float part = 0.f;
    for (int s = n_steps - 1; s >= 0; --s) {
      const float* uk = traj + static_cast<size_t>(s) * hw;
      tiled_transform<kBf16>(                                     // fwd(mu(u_k))
          smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            st2(f + p, v);
            put_z<kBf16>(z, r, c, H, W, ld2(uk + p));
          });
      tiled_transform<kBf16>(                                     // fwd(u_k)
          smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            const Mult2 m = mult2(lam, lam2, p, k, sc);
            const float2 a = ld2(f + p);
            st2(f + p, make_float2(m.x.dcm * a.x - m.x.dcu * v.x, m.y.dcm * a.y - m.y.dcu * v.y));
            put_z<kBf16>(z, r, c, H, W, ld2(gb + p));
          });
      tiled_transform<kBf16>(                                     // ghat = fwd(gbar)
          smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            const Mult2 m = mult2(lam, lam2, p, k, sc);
            const float2 a = ld2(f + p);
            part += (inv_hw * v.x) * a.x;
            part += (inv_hw * v.y) * a.y;
            st2(gh + p, v);
            put_z<kBf16>(z, r, c, H, W, make_float2(m.x.cm * v.x, m.y.cm * v.y));
          });
      tiled_transform<kBf16>(                                     // inv(cm * ghat)
          smem_tl, z, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            const Mult2 m = mult2(lam, lam2, p, k, sc);
            const float2 a = ld2(uk + p), b = ld2(gh + p), g = ld2(gb + p);
            st2(gb + p, make_float2(g.x + mu_eval(dmu, a.x) * v.x, g.y + mu_eval(dmu, a.y) * v.y));
            put_z<kBf16>(z, r, c, H, W, make_float2(m.x.cu * b.x, m.y.cu * b.y));
          });
      tiled_transform<kBf16>(                                     // inv(cu * ghat)
          smem_tl, z, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            const float2 g = ld2(gb + p);
            st2(gb + p, make_float2(g.x - v.x, g.y - v.y));
            if (s > 0) put_z<kBf16>(z, r, c, H, W, mu2(mu, ld2(uk - hw + p)));
          });
    }

#pragma unroll
    for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
    if ((tid & 31) == 0) red[tid / 32] = part;
    __syncthreads();
    if (tid == 0) {
      float a = 0.f;
      for (int w = 0; w < kWarps; ++w) a += red[w];
      dk_out[env] = a;
    }
    // The next env's first barrier orders this read of red before the next write.
  }
}

// ---- K1/K2 on square grids above 64^2 up to 128^2, bf16 matrices: on chip -----
//
// Replaces the same TPU kernels as the tiled K1/K2 (`kernel_ep`, `kernel`;
// pde_opt_tpu/ops/cas_spectral.py:630, :392) on the grids `onchip` takes,
// which the tiled kernel served before.  Bound at 4096 x 128^2 x 10 (K1,
// ds 1): 0.9399 ms, compute-bound (0.730 ms of products at 989 TFLOP/s bf16,
// 0.210 ms of pointwise work at 67 TFLOP/s f32; portbench/workmodel.py).
//
// Design (cas_onchip.cuh): one block of 512 threads an SM, persistent,
// walking the envs by grid stride.  The bf16 matrices are loaded into shared
// memory once a block (C and C/N: the grid is square, so C_W is C_H and the
// launch's cw16 and icw16 are not read); an env's u stays in registers (32
// f32 a thread, in the fragment layout of the products' accumulator), u~ in
// shared memory in the same layout, Z^T and T in shared memory as bf16;
// device memory is touched once an env to read u_in and kappa, and once to
// write u_out, the stats row and the obs.
// Every product runs over its full depth, eight m64n64k16 back to back.  The
// multipliers are recomputed where they are used (mult_from, the arithmetic
// and order of the kernels above) from lam and lam2 rebuilt bit for bit from
// the two f64 axis symbols in shared memory (oc_symbols): two f32 planes
// would not fit beside the tiles, and reading them through L2 would cost
// 128 KB an env-substep a block.  Budget (ptxas -v, sm_90a): 128 registers
// (the cap of 512 threads an SM), 144 B of spills, 198,656 B of dynamic
// shared memory (kOcSmemBytes) and 256 B static.  Measured at the bound's
// shape: 2.8-2.9 ms, ~32 % of the bound (PERF.md §6).
__global__ void __launch_bounds__(kOcThreads, 1)
ch_cas_macro_onchip_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                           const __nv_bfloat16* __restrict__ g_c,
                           const __nv_bfloat16* __restrict__ g_ic,
                           const double* __restrict__ lam_h, const double* __restrict__ lam_w,
                           float* __restrict__ u_out, int B, int N, int n_steps, float dt,
                           float a_dt, MuPoly mu, Epilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_oc[];
  const OcTiles sm = carve_oc_tiles(smem_oc);
  __shared__ float red[kOcWarps][3];

  const int tid = threadIdx.x;
  const OcOwn o = make_oc_own(tid);
  const StepConsts sc{dt, a_dt, 0.f};
  load_mats_oc(sm, g_c, g_ic, lam_h, lam_w, N, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * N * N;
    const float k = kappa[env];
    float u[8][4], f[8][4];
    load_frag_oc(u_in + off, N, N, o, u);
    // The previous env's last barrier has finished every read of the tiles.
    store_operand_oc(sm.zt, u, o, N, N);
    oc_transform(sm, sm.c, o, f);                                 // u~ = fwd(u)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        oc_pair(sm.ut, j, hi, tid) = make_float2(f[j][2 * hi], f[j][2 * hi + 1]);

    for (int s = 0; s < n_steps; ++s) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = mu_eval(mu, u[j][e]);
      store_operand_oc(sm.zt, f, o, N, N);
      oc_transform(sm, sm.c, o, f);                               // fwd(mu(u))
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float l[2], l2[2];
          oc_symbols(sm, o, j, hi, l, l2);
          float2& ut = oc_pair(sm.ut, j, hi, tid);
          const float2 a = ut;
          const Mult m0 = mult_from(l[0], l2[0], k, sc), m1 = mult_from(l[1], l2[1], k, sc);
          const float i0 = m0.cm * f[j][2 * hi] - m0.cu * a.x;
          const float i1 = m1.cm * f[j][2 * hi + 1] - m1.cu * a.y;
          ut = make_float2(a.x + i0, a.y + i1);
          f[j][2 * hi] = i0;
          f[j][2 * hi + 1] = i1;
        }
      store_operand_oc(sm.zt, f, o, N, N);
      oc_transform(sm, sm.ic, o, f);                              // inv(incr)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] += f[j][e];
    }

    save_frag_oc(u_out + off, N, N, o, u);
    if (ep.stats != nullptr) {
      emit_field_epilogue_oc(u, oc_scratch(sm), red, ep, env, N, N, tid, o);
    } else {
      __syncthreads();   // every read of the tiles is done before the next env writes them
    }
  }
}

// Whether a forward launch runs the on-chip kernel: bf16 matrices on a square
// grid above 64^2 (where ch_cas_macro_wg_kernel stops) up to 128^2 (a
// multiple of 8, as every launch checks); 256^2, 96 x 136, every other grid
// above 64^2 and the f32 FMA path stay on the tiled kernel.
bool onchip(int H, int W, bool round_bf16) {
  return round_bf16 && H == W && H > kLd && H <= kOcMaxGrid;
}

bool bad_shape(int B, int H, int W, int n_steps, int n_coeffs) {
  return (tiled(H, W) ? bad_tiled_grid(B, H, W, n_steps) : bad_grid(B, H, W, n_steps)) ||
         bad_poly(n_coeffs);
}

}  // namespace

extern "C" {

// The scratch a launch needs on the current device: `slots` blocks resident
// at once of the kernel that the grid and round_bf16 pick, each with a slot
// of `floats` f32.  The 64^2 and the on-chip forward need none (0, 0); the
// 64^2 backward (bwd != 0) a trajectory of max(n_steps, 1) planes of H x W a
// slot; the tiled forward 3 planes, the tiled backward max(n_steps, 1) + 5.
// Returns a cudaError_t value.
int ch_cas_macro_scratch(int bwd, int round_bf16, int H, int W, int n_steps, int* slots,
                         long long* floats) {
  const long long hw = static_cast<long long>(H) * W, n = n_steps > 0 ? n_steps : 1;
  *slots = 0;
  *floats = 0;
  cudaError_t err = cudaSuccess;
  if (!tiled(H, W)) {
    if (bwd == 0) return 0;
    err = round_bf16 != 0 ? resident_blocks(ch_cas_macro_bwd_wg_kernel, slots, kWgSmemBytes)
                          : resident_blocks(ch_cas_macro_bwd_kernel, slots);
    *floats = n * hw;
  } else if (bwd == 0) {
    if (onchip(H, W, round_bf16 != 0)) return 0;
    err = round_bf16 != 0
              ? tiled_scratch(ch_cas_macro_tiled_kernel<true>, true, 3, H, W, slots, floats)
              : tiled_scratch(ch_cas_macro_tiled_kernel<false>, false, 3, H, W, slots, floats);
  } else {
    err = round_bf16 != 0
              ? tiled_scratch(ch_cas_macro_bwd_tiled_kernel<true>, true, n + 5, H, W, slots, floats)
              : tiled_scratch(ch_cas_macro_bwd_tiled_kernel<false>, false, n + 5, H, W, slots,
                              floats);
  }
  return static_cast<int>(err);
}

// Whether a forward launch of an H x W grid (with bf16 matrices when
// round_bf16) runs the on-chip kernel (1) or another (0).
int ch_cas_macro_onchip(int H, int W, int round_bf16) {
  return onchip(H, W, round_bf16 != 0) ? 1 : 0;
}

// Launches the macro on `stream`: at 64^2 and below the tensor-core kernel
// when round_bf16 (bf16 matrices), the FMA kernel otherwise; above, where
// ch_cas_macro_onchip says so, the on-chip kernel (one block an SM, no
// scratch), else the tiled kernel of that type, on min(B, n_slots) blocks
// with `scratch` as ch_cas_macro_scratch sizes it (unused by the others).
// ch16 .. icw16 are the matrices as bf16 and lam_h (H), lam_w (W) the f64
// axis symbols that lam and lam2 are built from (read above 64^2 with bf16
// matrices alone; may be null otherwise).  stats == nullptr runs the plain
// macro (K2); otherwise stats and obs are written too (K1).  Returns a
// cudaError_t value, 0 on success.
int ch_cas_macro_launch(const float* u, const float* kappa, const float* ch,
                        const float* cw, const float* ich, const float* icw,
                        const void* ch16, const void* cw16, const void* ich16,
                        const void* icw16, const float* lam, const float* lam2,
                        const double* lam_h, const double* lam_w, float* out,
                        float* stats, unsigned char* obs, float* scratch, int n_slots,
                        int B, int H, int W, int n_steps, float dt, float a_dt,
                        const float* mu_coeffs, int n_coeffs, int round_bf16,
                        int ds, float obs_scale, float obs_offset, float center,
                        void* stream) {
  const bool oc = onchip(H, W, round_bf16 != 0);
  if (bad_shape(B, H, W, n_steps, n_coeffs) || ds < 1 || H % ds || W % ds ||
      (tiled(H, W) && round_bf16 != 0 && bad_mats16(ch16, cw16, ich16, icw16)) ||
      (tiled(H, W) && !oc && (scratch == nullptr || n_slots < 1)) ||
      (oc && (lam_h == nullptr || lam_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const MuPoly mu = make_mu(mu_coeffs, n_coeffs);
  const Epilogue ep{stats, obs, ds, obs_scale, obs_offset, center};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int resident = 0;
  cudaError_t err;
  if (oc) {
    if ((err = resident_blocks(ch_cas_macro_onchip_kernel, &resident, kOcSmemBytes,
                               kOcThreads)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    ch_cas_macro_onchip_kernel<<<grid, kOcThreads, kOcSmemBytes, st>>>(
        u, kappa, B16(ch16), B16(ich16), lam_h, lam_w, out, B, H, n_steps, dt, a_dt, mu, ep);
  } else if (tiled(H, W) && round_bf16 != 0) {
    return static_cast<int>(launch_tiled(ch_cas_macro_tiled_kernel<true>, true, B, n_slots, st, u,
                                         kappa, B16(ch16), B16(cw16), B16(ich16), B16(icw16),
                                         lam, lam2, out, scratch, B, H, W, n_steps, dt, a_dt,
                                         mu, ep));
  } else if (tiled(H, W)) {
    return static_cast<int>(launch_tiled(ch_cas_macro_tiled_kernel<false>, false, B, n_slots, st,
                                         u, kappa, ch, cw, ich, icw, lam, lam2, out, scratch, B,
                                         H, W, n_steps, dt, a_dt, mu, ep));
  } else if (round_bf16 != 0) {
    if ((err = resident_blocks(ch_cas_macro_wg_kernel, &resident, kWgSmemBytes)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    ch_cas_macro_wg_kernel<<<grid, kThreads, kWgSmemBytes, st>>>(
        u, kappa, ch, cw, ich, icw, lam, lam2, out, B, H, W, n_steps, dt, a_dt, mu, ep);
  } else {
    if ((err = resident_blocks(ch_cas_macro_kernel, &resident)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    ch_cas_macro_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        u, kappa, ch, cw, ich, icw, lam, lam2, out, B, H, W, n_steps, dt, a_dt, mu, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward (K3) on `stream`, on the tensor cores when
// round_bf16, tiled above 64^2 (ch16 .. icw16 as for the forward): du (B,
// H, W) and dkappa (B,) from u, kappa and the cotangent g.  `scratch` holds n_slots slots as
// ch_cas_macro_scratch sizes them; the grid is min(B, n_slots).  Returns a
// cudaError_t value.
int ch_cas_macro_bwd_launch(const float* u, const float* kappa, const float* g,
                            const float* ch, const float* cw, const float* ich,
                            const float* icw, const void* ch16, const void* cw16,
                            const void* ich16, const void* icw16, const float* lam,
                            const float* lam2,
                            float* du, float* dkappa, float* scratch, int n_slots,
                            int B, int H, int W, int n_steps, float dt, float a_dt,
                            float neg_a_dt2, const float* mu_coeffs, int n_coeffs,
                            const float* dmu_coeffs, int n_dcoeffs, int round_bf16,
                            void* stream) {
  if (bad_shape(B, H, W, n_steps, n_coeffs) || n_dcoeffs < 1 ||
      n_dcoeffs > kMaxCoeffs || n_slots < 1 || scratch == nullptr ||
      (tiled(H, W) && round_bf16 != 0 && bad_mats16(ch16, cw16, ich16, icw16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const StepConsts c{dt, a_dt, neg_a_dt2};
  const MuPoly mu = make_mu(mu_coeffs, n_coeffs), dmu = make_mu(dmu_coeffs, n_dcoeffs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = B < n_slots ? B : n_slots;
  cudaError_t err;
  if (tiled(H, W) && round_bf16 != 0) {
    return static_cast<int>(launch_tiled(ch_cas_macro_bwd_tiled_kernel<true>, true, B, n_slots,
                                         st, u, kappa, g, B16(ch16), B16(cw16), B16(ich16),
                                         B16(icw16), lam, lam2, du, dkappa, scratch, B, H, W,
                                         n_steps, c, mu, dmu));
  } else if (tiled(H, W)) {
    return static_cast<int>(launch_tiled(ch_cas_macro_bwd_tiled_kernel<false>, false, B, n_slots,
                                         st, u, kappa, g, ch, cw, ich, icw, lam, lam2, du,
                                         dkappa, scratch, B, H, W, n_steps, c, mu, dmu));
  } else if (round_bf16 != 0) {
    if ((err = allow_smem(ch_cas_macro_bwd_wg_kernel, kWgSmemBytes)) != cudaSuccess)
      return static_cast<int>(err);
    ch_cas_macro_bwd_wg_kernel<<<grid, kThreads, kWgSmemBytes, st>>>(
        u, kappa, g, ch, cw, ich, icw, lam, lam2, du, dkappa, scratch, B, H, W, n_steps, c,
        mu, dmu);
  } else {
    if ((err = allow_smem(ch_cas_macro_bwd_kernel)) != cudaSuccess)
      return static_cast<int>(err);
    ch_cas_macro_bwd_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        u, kappa, g, ch, cw, ich, icw, lam, lam2, du, dkappa, scratch, B, H, W, n_steps, c,
        mu, dmu);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ch_cas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
