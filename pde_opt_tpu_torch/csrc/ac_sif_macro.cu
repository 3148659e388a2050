// Fused semi-implicit Allen-Cahn macro-step on the packed DFT, hand-written
// for Hopper (sm_90a): K9b.
//
// Replaces the TPU kernel of pde_opt_tpu/ops/fused_spectral.py,
// make_ac_sif_fused_macro (`kernel`, launched at :546), the macro behind
// algo="dft".  Per env and substep, with the FD Laplacian symbol lam and the
// env's own kappa (no spectrum is carried: R(u) makes the update nonlinear):
//
//   lap = (u[h+1] - 2u + u[h-1]) / hx^2 + (u[w+1] - 2u + u[w-1]) / hy^2   (periodic)
//   g   = -R(u) * (mu(u) - kappa * lap)          (-(mu(u) - kappa lap) when R == 1)
//   u  += Re F^-1(F(g) * dt / (1 + A dt kappa (-lam)))
//
// F and F^-1 are the separable complex DFTs of sif_common.cuh.  mu and R are
// polynomials (Horner, degree <= 7); n_r = 0 selects R == 1, which the
// wrapper picks by the JAX package's identity probe.  The Laplacian wraps by
// index on a shared-memory copy of the f32 field (the TPU kernel's
// pltpu.roll does not carry over).  With bf16 tables the operand and the
// intermediate of each transform are rounded to bf16, as in the JAX kernel;
// sums are f32, the elementwise arithmetic _rn intrinsics in the plain
// version's order.
//
// Bound: per env and substep one forward and one inverse transform, 3.24
// MFLOP at 64^2 (W2 = 33), f32 FMA on the CUDA cores, against 32 KB of field
// traffic per env and macro: arithmetic-bound.  Design as K9a: one 256-thread
// block per env at a time, the tables, the f32 field (16 KB) and two f32
// work buffers in 106 KB of shared memory at 64^2 with bf16 tables (two
// blocks an SM), the field in registers (a 4 x 4 tile a thread).

#include "sif_common.cuh"

namespace {

template <class S, class T, int KG>
__global__ void __launch_bounds__(kThreads, 2)
ac_sif_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                    SifTables g, float* __restrict__ u_out, int B, SifDims d, int n_steps,
                    float dt, float a_dt, float inv_hx2, float inv_hy2, MuPoly mu, MuPoly R,
                    bool r_identity) {
  extern __shared__ float4 smem4[];
  const SifSmem<T> s = carve_sif<T>(reinterpret_cast<char*>(smem4), d, false);
  const int tid = threadIdx.x;
  const int ty4 = (tid / 16) * 4;        // first row (H axis) this thread owns
  const int tx4 = (tid % 16) * 4;        // first column (W axis)
  const bool own = ty4 < d.H && tx4 < d.W;
  const int H = d.H, W = d.W;
  load_dft_tables(s, g, d, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float k = kappa[env];
    float u[4][4], v[4][4];
    if (own) load_tile(u_in + off, W, ty4, tx4, u);

    for (int step = 0; step < n_steps; ++step) {
      // The previous substep's Laplacian finished every read of uf three
      // barriers ago.
      if (own) save_tile(s.uf, W, ty4, tx4, u);
      __syncthreads();
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = ty4 + i;
          const float* up = s.uf + (h + 1 == H ? 0 : h + 1) * W;
          const float* dn = s.uf + (h == 0 ? H - 1 : h - 1) * W;
          const float* row = s.uf + h * W;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int w = tx4 + j;
            const float c = u[i][j], c2 = __fmul_rn(2.f, c);
            const float lx = __fadd_rn(__fsub_rn(up[w], c2), dn[w]);
            const float ly = __fadd_rn(__fsub_rn(row[w + 1 == W ? 0 : w + 1], c2),
                                       row[w == 0 ? W - 1 : w - 1]);
            const float lap = __fadd_rn(__fmul_rn(lx, inv_hx2), __fmul_rn(ly, inv_hy2));
            const float m = __fsub_rn(mu_eval(mu, c), __fmul_rn(k, lap));
            v[i][j] = r_identity ? -m : __fmul_rn(-mu_eval(R, c), m);
          }
        }
        store_operand<S>(s.zs, H, ty4, tx4, v);
      }
      __syncthreads();
      dft_stage_a<S, T, KG>(s, d, tid);
      __syncthreads();
      dft_stage_b<T, KG>(s, d, tid, [&](int kh, int kw, float xr, float xi) {
        float zr = 0.f, zi = 0.f;
        if (kw < d.W2) {
          const float l = __ldg(g.lam + kh * d.W2 + kw);
          const float dd = __fdiv_rn(dt, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, -l))));
          zr = __fmul_rn(dd, xr);
          zi = __fmul_rn(dd, xi);
        }
        s.Q[kh * d.W2p + kw] = S::put(zr, zi);
      });
      __syncthreads();
      dft_stage_c<S, T, KG>(s, d, tid);
      __syncthreads();
      if (own) {
        dft_stage_d<T>(s, d, ty4, tx4, v);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = __fadd_rn(u[i][j], v[i][j]);
      }
    }
    if (own) save_tile(u_out + off, W, ty4, tx4, u);
  }
}

template <class S, class T, int KG>
cudaError_t launch(const float* u, const float* kappa, const SifTables& g, float* out, int B,
                   const SifDims& d, int n_steps, float dt, float a_dt, float inv_hx2,
                   float inv_hy2, const MuPoly& mu, const MuPoly& R, bool r_identity,
                   cudaStream_t stream) {
  int smem = 0, grid = 0;
  const cudaError_t err =
      sif_config<T>(ac_sif_macro_kernel<S, T, KG>, d, false, B, &smem, &grid);
  if (err != cudaSuccess) return err;
  ac_sif_macro_kernel<S, T, KG><<<grid, kThreads, smem, stream>>>(
      u, kappa, g, out, B, d, n_steps, dt, a_dt, inv_hx2, inv_hy2, mu, R, r_identity);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K9b on `stream`: u (B, H, W) -> out, the tables as SifTables
// lists them (lam2 is not read).  n_r == 0 runs the R == 1 path; otherwise R
// is the polynomial r_coeffs.  Rounds to bf16 when round_bf16.  Returns a
// cudaError_t value, 0 on success.
int ac_sif_macro_launch(const float* u, const float* kappa, const float* wr_w,
                        const float* wi_w, const float* wr_h, const float* wi_h,
                        const float* vr_h, const float* vi_h, const float* vr_w,
                        const float* vi_w, const float* lam, const float* lam2, float* out,
                        int B, int H, int W, int W2, int n_steps, float dt, float a_dt,
                        float inv_hx2, float inv_hy2, const float* mu_coeffs, int n_mu,
                        const float* r_coeffs, int n_r, int round_bf16, void* stream) {
  if (bad_sif(B, H, W, W2, n_steps) || bad_poly(n_mu) || n_r < 0 || n_r > kMaxCoeffs)
    return static_cast<int>(cudaErrorInvalidValue);
  const SifTables g{wr_w, wi_w, wr_h, wi_h, vr_h, vi_h, vr_w, vi_w, lam, lam2};
  const SifDims d = sif_dims(H, W, W2);
  const MuPoly mu = make_mu(mu_coeffs, n_mu);
  const MuPoly R = make_mu(r_coeffs, n_r);
  const bool r1 = n_r == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g4 = sif_group(W2) == 4;
  cudaError_t err;
  if (round_bf16)
    err = g4 ? launch<RF32, BF16, 4>(u, kappa, g, out, B, d, n_steps, dt, a_dt, inv_hx2,
                                     inv_hy2, mu, R, r1, st)
             : launch<RF32, BF16, 3>(u, kappa, g, out, B, d, n_steps, dt, a_dt, inv_hx2,
                                     inv_hy2, mu, R, r1, st);
  else
    err = g4 ? launch<F32, F32, 4>(u, kappa, g, out, B, d, n_steps, dt, a_dt, inv_hx2, inv_hy2,
                                   mu, R, r1, st)
             : launch<F32, F32, 3>(u, kappa, g, out, B, d, n_steps, dt, a_dt, inv_hx2, inv_hy2,
                                   mu, R, r1, st);
  return static_cast<int>(err);
}

const char* ac_sif_macro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
