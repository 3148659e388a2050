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
// K1's (cas_common.cuh): [sum(u-c), sum((u-c)^2), n_finite] and the uint8
// observation clip(u*scale + offset, 0, 255), mean-pooled when ds > 1.
//
// Bound: 3 (or 4) transforms = 6 (or 8) * H*W*(H+W) FLOPs per env-substep,
// 3.1 (4.2) MFLOP at 64^2, f32 FMA on the CUDA cores against 32 KB of field
// traffic per env and macro: arithmetic-bound, as K1.  Design as K1: one
// block of 256 threads per env at a time (grid-stride), the four matrices and
// two transform tiles in 96 KB of shared memory, u, lam and the implicit
// multiplier dd in registers for all substeps (16 each a thread).

#include "cas_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
ac_cas_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                    const float* __restrict__ g_ch, const float* __restrict__ g_cw,
                    const float* __restrict__ g_ich, const float* __restrict__ g_icw,
                    const float* __restrict__ lam, float* __restrict__ u_out, int B,
                    int H, int W, int n_steps, float dt, float a_dt, MuPoly mu, MuPoly R,
                    bool r_identity, bool rnd, Epilogue ep) {
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

}  // namespace

extern "C" {

// Launches K4 on `stream`.  n_r == 0 runs the R == 1 path; otherwise R is the
// polynomial r_coeffs.  stats == nullptr runs the plain macro; otherwise stats
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
  int resident = 0;
  cudaError_t err = resident_blocks(ac_cas_macro_kernel, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < resident ? B : resident;
  ac_cas_macro_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      u, kappa, ch, cw, ich, icw, lam, out, B, H, W, n_steps, dt, a_dt, mu, R, n_r == 0,
      round_bf16 != 0, ep);
  return static_cast<int>(cudaGetLastError());
}

const char* ac_cas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
