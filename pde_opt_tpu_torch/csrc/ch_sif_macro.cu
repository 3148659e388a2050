// Fused semi-implicit Cahn-Hilliard macro-step on the packed DFT, hand-written
// for Hopper (sm_90a): K9a.
//
// Replaces the TPU kernel of pde_opt_tpu/ops/fused_spectral.py,
// make_ch_sif_fused_macro (`kernel`, launched at :340), the macro behind
// algo="dft".  Per env, with the FD Laplacian symbol lam and the env's own
// kappa, the complex spectrum is taken once and carried across substeps:
//
//   uh = F(u)
//   n_steps times:   incr = cm * F(mu(u)) - cu * uh,   uh += incr,   u += Re F^-1(incr)
//   cm = dt lam / (1 + A dt kappa lam^2),   cu = dt kappa lam^2 / (1 + A dt kappa lam^2)
//
// F and F^-1 are separable complex DFTs (sif_common.cuh), with the half
// spectrum kw in [0, W/2] when W2 = W/2 + 1.  mu is a polynomial (Horner,
// degree <= 7).  With bf16 tables the operand and the intermediate of each
// transform are rounded to bf16 where the JAX kernel rounds them; sums are
// f32.  The update's elementwise arithmetic uses _rn intrinsics in the
// plain version's order.
//
// Bound: per env and substep one forward and one inverse transform,
// 2 * (2 H W W2 + 8 H^2 W2) operations = 3.24 MFLOP at 64^2 (W2 = 33), f32
// FMA on the CUDA cores, against 32 KB of field traffic per env and macro:
// arithmetic-bound.  Design: the TPU kernel's MXU packing (the mid-layout,
// 8-row padding, the doubled inverse matrix, lane-duplicated symbols) is not
// rebuilt.  One 256-thread block owns one env at a time; the tables, the
// carried spectrum (17 KB, f32) and two f32 work buffers sit in 106 KB of
// shared memory at 64^2 with bf16 tables, so two blocks share an SM; the
// field stays in registers (a 4 x 4 tile a thread) for all substeps.  The
// work buffers hold bf16-rounded values as f32: stored as bf16, every
// operand load of the h-axis products was a conversion (PERF.md).

#include "sif_common.cuh"

namespace {

template <class S, class T, int KG>
__global__ void __launch_bounds__(kThreads, 2)
ch_sif_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                    SifTables g, float* __restrict__ u_out, int B, SifDims d, int n_steps,
                    float dt, float a_dt, MuPoly mu) {
  extern __shared__ float4 smem4[];
  const SifSmem<T> s = carve_sif<T>(reinterpret_cast<char*>(smem4), d, true);
  const int tid = threadIdx.x;
  const int ty4 = (tid / 16) * 4;        // first row (H axis) this thread owns
  const int tx4 = (tid % 16) * 4;        // first column (W axis)
  const bool own = ty4 < d.H && tx4 < d.W;
  load_dft_tables(s, g, d, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * d.H * d.W;
    const float k = kappa[env];
    const float dtk = __fmul_rn(dt, k);
    float u[4][4], v[4][4];
    // The previous env's last stage C finished every read of Q (= zs) before
    // the barrier ahead of its stage D.
    if (own) {
      load_tile(u_in + off, d.W, ty4, tx4, u);
      store_operand<S>(s.zs, d.H, ty4, tx4, u);
    }
    __syncthreads();
    dft_stage_a<S, T, KG>(s, d, tid);
    __syncthreads();
    dft_stage_b<T, KG>(s, d, tid, [&](int kh, int kw, float xr, float xi) {
      s.uh[kh * d.W2p + kw] = make_float2(xr, xi);                    // uh = F(u)
    });

    for (int step = 0; step < n_steps; ++step) {
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = mu_eval(mu, u[i][j]);
        store_operand<S>(s.zs, d.H, ty4, tx4, v);
      }
      __syncthreads();
      dft_stage_a<S, T, KG>(s, d, tid);
      __syncthreads();
      dft_stage_b<T, KG>(s, d, tid, [&](int kh, int kw, float xr, float xi) {
        float zr = 0.f, zi = 0.f;
        if (kw < d.W2) {
          const float l = __ldg(g.lam + kh * d.W2 + kw), l2 = __ldg(g.lam2 + kh * d.W2 + kw);
          const float den = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, l2))));
          const float cm = __fmul_rn(__fmul_rn(dt, l), den);
          const float cu = __fmul_rn(__fmul_rn(dtk, l2), den);
          const float2 h = s.uh[kh * d.W2p + kw];
          zr = __fsub_rn(__fmul_rn(cm, xr), __fmul_rn(cu, h.x));
          zi = __fsub_rn(__fmul_rn(cm, xi), __fmul_rn(cu, h.y));
          s.uh[kh * d.W2p + kw] = make_float2(__fadd_rn(h.x, zr), __fadd_rn(h.y, zi));
        }
        s.Q[kh * d.W2p + kw] = S::put(zr, zi);                        // incr
      });
      __syncthreads();
      dft_stage_c<S, T, KG>(s, d, tid);
      __syncthreads();
      if (own) {
        dft_stage_d<T>(s, d, ty4, tx4, v);                            // Re F^-1(incr)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = __fadd_rn(u[i][j], v[i][j]);
      }
    }
    if (own) save_tile(u_out + off, d.W, ty4, tx4, u);
  }
}

template <class S, class T, int KG>
cudaError_t launch(const float* u, const float* kappa, const SifTables& g, float* out, int B,
                   const SifDims& d, int n_steps, float dt, float a_dt, const MuPoly& mu,
                   cudaStream_t stream) {
  int smem = 0, grid = 0;
  const cudaError_t err =
      sif_config<T>(ch_sif_macro_kernel<S, T, KG>, d, true, B, &smem, &grid);
  if (err != cudaSuccess) return err;
  ch_sif_macro_kernel<S, T, KG><<<grid, kThreads, smem, stream>>>(u, kappa, g, out, B, d,
                                                                  n_steps, dt, a_dt, mu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K9a on `stream`: u (B, H, W) -> out, the tables as SifTables
// lists them (W2 = W/2 + 1 with the half spectrum, else W), rounding to
// bf16 when round_bf16.  Returns a cudaError_t value, 0 on success.
int ch_sif_macro_launch(const float* u, const float* kappa, const float* wr_w,
                        const float* wi_w, const float* wr_h, const float* wi_h,
                        const float* vr_h, const float* vi_h, const float* vr_w,
                        const float* vi_w, const float* lam, const float* lam2, float* out,
                        int B, int H, int W, int W2, int n_steps, float dt, float a_dt,
                        const float* mu_coeffs, int n_mu, int round_bf16, void* stream) {
  if (bad_sif(B, H, W, W2, n_steps) || bad_poly(n_mu))
    return static_cast<int>(cudaErrorInvalidValue);
  const SifTables g{wr_w, wi_w, wr_h, wi_h, vr_h, vi_h, vr_w, vi_w, lam, lam2};
  const SifDims d = sif_dims(H, W, W2);
  const MuPoly mu = make_mu(mu_coeffs, n_mu);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g4 = sif_group(W2) == 4;
  cudaError_t err;
  if (round_bf16)
    err = g4 ? launch<RF32, BF16, 4>(u, kappa, g, out, B, d, n_steps, dt, a_dt, mu, st)
             : launch<RF32, BF16, 3>(u, kappa, g, out, B, d, n_steps, dt, a_dt, mu, st);
  else
    err = g4 ? launch<F32, F32, 4>(u, kappa, g, out, B, d, n_steps, dt, a_dt, mu, st)
             : launch<F32, F32, 3>(u, kappa, g, out, B, d, n_steps, dt, a_dt, mu, st);
  return static_cast<int>(err);
}

const char* ch_sif_macro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
