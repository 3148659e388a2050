// Fused semi-implicit Allen-Cahn macro-step on the cas (Hartley) transform,
// hand-written for Hopper (sm_90a), with the optional RL env epilogue: K4.
//
// Replaces the TPU kernel of pde_opt_tpu/ops/cas_spectral.py,
// make_ac_cas_fused_macro (`kernel`, launched plain at :981 and with the
// epilogue at :1014).  Per env, with the FD Laplacian symbol lam and each
// env's own kappa (no spectrum is carried: R(u) makes the update nonlinear
// in it, so fwd(u) is recomputed every substep):
//
//   fwd(z) = C_H^T z C_W,   inv(z) = C_H^T z C_W / (H*W)   (C: symmetric cas)
//   dd = dt / (1 + A*dt*kappa*(-lam))
//   R == 1 (3 transforms):   u += inv(dd * (kappa*lam * fwd(u) - fwd(mu(u))))
//   general (4 transforms):  lap = inv(lam * fwd(u))
//                            g   = -R(u) * (mu(u) - kappa*lap)
//                            u  += inv(dd * fwd(g))
//
// mu and R are polynomials (Horner, degree <= 7); n_r = 0 selects the R == 1
// path, which the wrapper picks by the JAX package's identity probe.  With
// bf16 matrices each transform's operand and intermediate are rounded to
// bf16, as in the JAX kernel; products accumulate in f32.  The epilogue is
// K1's (cas_common.cuh; its fragment-layout twin in cas_wgmma.cuh on the
// bf16 path): [sum(u-c), sum((u-c)^2), n_finite] and the uint8
// observation clip(u*scale + offset, 0, 255), mean-pooled when ds > 1.
//
// Bound: 3 (or 4) transforms = 6 (or 8) * H*W*(H+W) FLOPs per env-substep,
// 3.1 (4.2) MFLOP at 64^2, against 32 KB of field traffic per env and macro:
// arithmetic-bound, as K1.  Two kernels, picked by the matrices' type alone:
//
// - bf16 matrices (the presets'): ac_cas_macro_wg_kernel runs both products
//   of every transform on the tensor cores (cas_wgmma.cuh: warpgroup wgmma,
//   bf16 operands, f32 accumulation, the JAX rounding sites); 48 KB of shared
//   memory, each thread the 16 pixels of its accumulator fragment, capped at
//   128 registers so that two blocks fit an SM.
// - f32 matrices: ac_cas_macro_kernel, f32 FMA on the CUDA cores (TF32 would
//   not hold the f32 path's bounds).  Design as K1: the four matrices and two
//   f32 transform tiles in 96 KB of shared memory, a 4 x 4 tile a thread.
//
// Both: one block of 256 threads per env at a time (grid-stride), u, lam and
// the implicit multiplier dd in registers for all substeps (16 each a
// thread), the elementwise code in the same order of operations.
//
// Grids above 64 x 64 (any H and W that are multiples of 8 up to 256) run
// ac_cas_macro_tiled_kernel at the end of this file, bf16 and f32 alike: an
// env's planes live in device memory and each transform streams 64-wide
// chunks through shared memory (cas_tiled.cuh, as the tiled CH kernels).
// The launch picks the kernel by grid; the 64^2 kernels are unchanged.

#include "cas_common.cuh"
#include "cas_tiled.cuh"
#include "cas_wgmma.cuh"
#include "kernel_error.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
ac_cas_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                    const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                    const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                    const float* __restrict__ lam, float* __restrict__ u_out, int B,
                    int H, int W, int n_steps, float dt, float a_dt, MuPoly mu, MuPoly R,
                    bool r_identity, Epilogue ep) {
  constexpr bool rnd = false;   // f32 matrices: bf16 runs ac_cas_macro_wg_kernel
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
    const float k = kappa[env];
    float u[4][4], l[4][4], dd[4][4], a[4][4], b[4][4];
    if (own) {
      load_tile(u_in + off, W, ty4, tx4, u);
      load_tile(lam, W, ty4, tx4, l);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dd[i][j] = dt / (1.0f + a_dt * (k * (-l[i][j])));
    }

    for (int s = 0; s < n_steps; ++s) {
      // The previous transform's barriers (or, before the first, the
      // previous env's epilogue) have finished every read of zs.
      if (own) store_tile(zs, ty4, tx4, u, rnd);
      transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, a);            // fwd(u)
      if (r_identity) {
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) b[i][j] = mu_eval(mu, u[i][j]);
          store_tile(zs, ty4, tx4, b, rnd);
        }
        transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, b);          // fwd(mu(u))
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[i][j] = dd[i][j] * ((k * l[i][j]) * a[i][j] - b[i][j]);
          store_tile(zs, ty4, tx4, a, rnd);
        }
      } else {
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = l[i][j] * a[i][j];
          store_tile(zs, ty4, tx4, a, rnd);
        }
        transform(zs, ts, ich, icw, H, W, ty4, tx4, rnd, a);        // lap
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[i][j] = -mu_eval(R, u[i][j]) * (mu_eval(mu, u[i][j]) - k * a[i][j]);
          store_tile(zs, ty4, tx4, a, rnd);
        }
        transform(zs, ts, ch, cw, H, W, ty4, tx4, rnd, a);          // fwd(g)
        if (own) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = dd[i][j] * a[i][j];
          store_tile(zs, ty4, tx4, a, rnd);
        }
      }
      transform(zs, ts, ich, icw, H, W, ty4, tx4, rnd, a);          // inv(.)
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] += a[i][j];
      }
    }

    if (own) save_tile(u_out + off, W, ty4, tx4, u);
    if (ep.stats != nullptr) {
      emit_field_epilogue(u, a, zs, red, ep, env, H, W, tid, ty4, tx4, own);
    } else {
      __syncthreads();   // every read of zs is done before the next env writes it
    }
  }
}

// The bf16 path on the tensor cores: the same macro as ac_cas_macro_kernel
// with every transform a wg_transform (operand and intermediate rounded to
// bf16), the fields in the fragment layout of cas_wgmma.cuh.
__global__ void __launch_bounds__(kThreads, 2)
ac_cas_macro_wg_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                       const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                       const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                       const float* __restrict__ lam, float* __restrict__ u_out, int B,
                       int H, int W, int n_steps, float dt, float a_dt, MuPoly mu,
                       MuPoly R, bool r_identity, Epilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const WgTiles sm = carve_wg_tiles(smem_wg);
  __shared__ float red[kWarps][3];

  const int tid = threadIdx.x;
  const Own o = make_own(tid);
  load_mats_wg(sm, g_ch, g_cw, g_ich, g_icw, H, W, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float k = kappa[env];
    float u[4][4], l[4][4], dd[4][4], a[4][4], b[4][4];
    load_frag(u_in + off, H, W, o, u);
    load_frag(lam, H, W, o, l);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dd[j][e] = dt / (1.0f + a_dt * (k * (-l[j][e])));

    for (int s = 0; s < n_steps; ++s) {
      // The previous transform's barriers (or, before the first, the
      // previous env's last barrier) have finished every read of Z^T.
      store_operand(sm.zt, u, o, H, W);
      wg_transform(sm, sm.ch, sm.cw, o, a);                        // fwd(u)
      if (r_identity) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) b[j][e] = mu_eval(mu, u[j][e]);
        store_operand(sm.zt, b, o, H, W);
        wg_transform(sm, sm.ch, sm.cw, o, b);                      // fwd(mu(u))
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[j][e] = dd[j][e] * ((k * l[j][e]) * a[j][e] - b[j][e]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[j][e] = l[j][e] * a[j][e];
        store_operand(sm.zt, a, o, H, W);
        wg_transform(sm, sm.ich, sm.icw, o, a);                    // lap
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[j][e] = -mu_eval(R, u[j][e]) * (mu_eval(mu, u[j][e]) - k * a[j][e]);
        store_operand(sm.zt, a, o, H, W);
        wg_transform(sm, sm.ch, sm.cw, o, a);                      // fwd(g)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[j][e] = dd[j][e] * a[j][e];
      }
      store_operand(sm.zt, a, o, H, W);
      wg_transform(sm, sm.ich, sm.icw, o, a);                      // inv(.)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] += a[j][e];
    }

    save_frag(u_out + off, H, W, o, u);
    if (ep.stats != nullptr) {
      emit_field_epilogue_wg(u, wg_scratch(sm), red, ep, env, H, W, tid, o);
    } else {
      __syncthreads();   // every read of the tiles is done before the next env writes them
    }
  }
}

// ---- K4 above 64 x 64: the tiled kernel ------------------------------------
//
// One block owns one env at a time (grid-stride), as above; the field lives
// in u_out, the rest in this block's slot of a scratch that the wrapper
// allocates (ac_cas_macro_scratch): [z, t, u~], three H x W f32 planes (z
// and t hold bf16 on the tensor-core path, whose matrices g_* are then bf16
// copies; u~ serves the R == 1 path alone).  Every transform is a
// tiled_transform whose epilogue does the substep's elementwise work at a
// pixel pair, in the 64^2 kernels' order of operations, and writes the next
// transform's operand z there; dd is recomputed from lam where it is used.
// R == 1 keeps fwd(u) as the f32 plane u~ until fwd(mu(u))'s epilogue forms
// dd (kappa lam u~ - fwd(mu(u))); the general path reads u from the output
// plane in lap's epilogue.

constexpr int kAcTiledPlanes = 3;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
ac_cas_macro_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                          const Op<kBf16>* __restrict__ g_ch, const Op<kBf16>* __restrict__ g_cw,
                          const Op<kBf16>* __restrict__ g_ich,
                          const Op<kBf16>* __restrict__ g_icw, const float* __restrict__ lam,
                          float* u_out, float* scratch, int B, int H, int W, int n_steps,
                          float dt, float a_dt, MuPoly mu, MuPoly R, bool r_identity,
                          Epilogue ep) {
  extern __shared__ __align__(128) unsigned char smem_tl[];
  __shared__ float red[kWarps][3];
  const int tid = threadIdx.x, hw = H * W;
  float* z = scratch + static_cast<size_t>(blockIdx.x) * kAcTiledPlanes * hw;
  float* t = z + hw;
  float* ut = t + hw;

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float k = kappa[env];
    float* u = u_out + off;
    // dd = dt / (1 + A dt kappa (-lam)) at the pixel pair that starts at p.
    auto dd2 = [&](int p) {
      const float2 l = ld2(lam + p);
      return make_float2(dt / (1.0f + a_dt * (k * (-l.x))), dt / (1.0f + a_dt * (k * (-l.y))));
    };
    __syncthreads();                 // the previous env's last epilogue is done with the planes
    for (int p = 4 * tid; p < hw; p += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(u_in + off + p);
      *reinterpret_cast<float4*>(u + p) = v;
      put_z4<kBf16>(z, p, H, W, v);
    }
    for (int s = 0; s < n_steps; ++s) {
      if (r_identity) {
        tiled_transform<kBf16>(                                   // u~ = fwd(u)
            smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
              const int p = r * W + c;
              st2(ut + p, v);
              put_z<kBf16>(z, r, c, H, W, mu2(mu, ld2(u + p)));
            });
        tiled_transform<kBf16>(                                   // dd (k lam u~ - fwd(mu(u)))
            smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
              const int p = r * W + c;
              const float2 l = ld2(lam + p), a = ld2(ut + p), d = dd2(p);
              put_z<kBf16>(z, r, c, H, W,
                           make_float2(d.x * ((k * l.x) * a.x - v.x),
                                       d.y * ((k * l.y) * a.y - v.y)));
            });
      } else {
        tiled_transform<kBf16>(                                   // lam fwd(u)
            smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
              const float2 l = ld2(lam + r * W + c);
              put_z<kBf16>(z, r, c, H, W, make_float2(l.x * v.x, l.y * v.y));
            });
        tiled_transform<kBf16>(                                   // g = -R(u) (mu(u) - k lap)
            smem_tl, z, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
              const float2 x = ld2(u + r * W + c);
              put_z<kBf16>(z, r, c, H, W,
                           make_float2(-mu_eval(R, x.x) * (mu_eval(mu, x.x) - k * v.x),
                                       -mu_eval(R, x.y) * (mu_eval(mu, x.y) - k * v.y)));
            });
        tiled_transform<kBf16>(                                   // dd fwd(g)
            smem_tl, z, t, g_ch, g_cw, H, W, tid, [&](int r, int c, float2 v) {
              const float2 d = dd2(r * W + c);
              put_z<kBf16>(z, r, c, H, W, make_float2(d.x * v.x, d.y * v.y));
            });
      }
      tiled_transform<kBf16>(                                     // u += inv(.)
          smem_tl, z, t, g_ich, g_icw, H, W, tid, [&](int r, int c, float2 v) {
            const int p = r * W + c;
            float2 x = ld2(u + p);
            x.x += v.x;
            x.y += v.y;
            st2(u + p, x);
            put_z<kBf16>(z, r, c, H, W, x);
          });
    }
    if (ep.stats != nullptr) tiled_field_epilogue(u, red, ep, env, H, W, tid);
  }
}

}  // namespace

extern "C" {

// The scratch a launch needs on the current device: `slots` blocks resident
// at once of the kernel that the grid and round_bf16 pick, each with a slot
// of `floats` f32: none at 64^2 and below (0, 0), kAcTiledPlanes H x W
// planes above.  Returns a cudaError_t value.
int ac_cas_macro_scratch(int round_bf16, int H, int W, int* slots, long long* floats) {
  *slots = 0;
  *floats = 0;
  if (!tiled(H, W)) return 0;
  return static_cast<int>(
      round_bf16 != 0
          ? tiled_scratch(ac_cas_macro_tiled_kernel<true>, true, kAcTiledPlanes, H, W, slots,
                          floats)
          : tiled_scratch(ac_cas_macro_tiled_kernel<false>, false, kAcTiledPlanes, H, W, slots,
                          floats));
}

// Launches K4 on `stream`: at 64^2 and below the tensor-core kernel when
// round_bf16 (bf16 matrices), the FMA kernel otherwise; above, the tiled
// kernel of that type, on min(B, n_slots) blocks with `scratch` as
// ac_cas_macro_scratch sizes it (unused at 64^2).  ch16 .. icw16 are the
// matrices as bf16 (read by the tiled tensor-core kernel alone; may be null
// otherwise).  n_r == 0 runs the R == 1 path; otherwise R is the polynomial
// r_coeffs.  stats == nullptr runs the plain macro; otherwise stats and obs
// are written too.  Returns a cudaError_t value, 0 on success.
int ac_cas_macro_launch(const float* u, const float* kappa, const float* ch,
                        const float* cw, const float* ich, const float* icw,
                        const void* ch16, const void* cw16, const void* ich16,
                        const void* icw16, const float* lam, float* out, float* stats,
                        unsigned char* obs, float* scratch, int n_slots,
                        int B, int H, int W, int n_steps, float dt, float a_dt,
                        const float* mu_coeffs, int n_mu, const float* r_coeffs, int n_r,
                        int round_bf16, int ds, float obs_scale, float obs_offset,
                        float center, void* stream) {
  const bool big = tiled(H, W);
  if ((big ? bad_tiled_grid(B, H, W, n_steps) : bad_grid(B, H, W, n_steps)) || bad_poly(n_mu) ||
      n_r < 0 || n_r > kMaxCoeffs || ds < 1 || H % ds || W % ds ||
      (big && (scratch == nullptr || n_slots < 1 ||
               (round_bf16 != 0 && bad_mats16(ch16, cw16, ich16, icw16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const MuPoly mu = make_mu(mu_coeffs, n_mu);
  const MuPoly R = make_mu(r_coeffs, n_r);
  const Epilogue ep{stats, obs, ds, obs_scale, obs_offset, center};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int resident = 0;
  cudaError_t err;
  if (big && round_bf16 != 0) {
    return static_cast<int>(launch_tiled(ac_cas_macro_tiled_kernel<true>, true, B, n_slots, st, u,
                                         kappa, B16(ch16), B16(cw16), B16(ich16), B16(icw16),
                                         lam, out, scratch, B, H, W, n_steps, dt, a_dt, mu, R,
                                         n_r == 0, ep));
  } else if (big) {
    return static_cast<int>(launch_tiled(ac_cas_macro_tiled_kernel<false>, false, B, n_slots, st,
                                         u, kappa, ch, cw, ich, icw, lam, out, scratch, B, H, W,
                                         n_steps, dt, a_dt, mu, R, n_r == 0, ep));
  } else if (round_bf16 != 0) {
    if ((err = resident_blocks(ac_cas_macro_wg_kernel, &resident, kWgSmemBytes)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    ac_cas_macro_wg_kernel<<<grid, kThreads, kWgSmemBytes, st>>>(
        u, kappa, ch, cw, ich, icw, lam, out, B, H, W, n_steps, dt, a_dt, mu, R, n_r == 0, ep);
  } else {
    if ((err = resident_blocks(ac_cas_macro_kernel, &resident)) != cudaSuccess)
      return static_cast<int>(err);
    const int grid = B < resident ? B : resident;
    ac_cas_macro_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        u, kappa, ch, cw, ich, icw, lam, out, B, H, W, n_steps, dt, a_dt, mu, R, n_r == 0, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
