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

#include "cas_common.cuh"
#include "cas_wgmma.cuh"

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

}  // namespace

extern "C" {

// Launches K4 on `stream`: the tensor-core kernel when round_bf16 (bf16
// matrices), the FMA kernel otherwise.  n_r == 0 runs the R == 1 path;
// otherwise R is the polynomial r_coeffs.  stats == nullptr runs the plain macro; otherwise stats
// and obs are written too.  Returns a cudaError_t value, 0 on success.
int ac_cas_macro_launch(const float* u, const float* kappa, const float* ch,
                        const float* cw, const float* ich, const float* icw,
                        const float* lam, float* out, float* stats, unsigned char* obs,
                        int B, int H, int W, int n_steps, float dt, float a_dt,
                        const float* mu_coeffs, int n_mu, const float* r_coeffs, int n_r,
                        int round_bf16, int ds, float obs_scale, float obs_offset,
                        float center, void* stream) {
  if (bad_grid(B, H, W, n_steps) || bad_poly(n_mu) || n_r < 0 || n_r > kMaxCoeffs ||
      ds < 1 || H % ds || W % ds)
    return static_cast<int>(cudaErrorInvalidValue);
  const MuPoly mu = make_mu(mu_coeffs, n_mu);
  const MuPoly R = make_mu(r_coeffs, n_r);
  const Epilogue ep{stats, obs, ds, obs_scale, obs_offset, center};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int resident = 0;
  cudaError_t err;
  if (round_bf16 != 0) {
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

const char* ac_cas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
