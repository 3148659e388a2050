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
// F and F^-1 are separable complex DFTs, with the half spectrum kw in
// [0, W/2] when W2 = W/2 + 1.  mu is a polynomial (Horner, degree <= 7).
// With bf16 tables the operand and the intermediate of each transform are
// rounded to bf16 where the JAX kernel rounds them; sums are f32.  The
// update's elementwise arithmetic uses _rn intrinsics in the plain
// version's order.
//
// Bound: per env and substep one forward and one inverse transform,
// 2 * (4 H W W2 + 8 H^2 W2) operations = 3.24 MFLOP at 64^2 (W2 = 33),
// against 32 KB of field traffic per env and macro: arithmetic-bound, on the
// tensor cores with bf16 tables.  The TPU kernel's MXU packing (the
// mid-layout, 8-row padding, the doubled inverse matrix, lane-duplicated
// symbols) is not rebuilt.  Two kernels, picked by the tables' type alone:
//
// - bf16 tables (the default): ch_sif_macro_wg_kernel runs the four
//   products of each transform pair as warpgroup wgmma (sif_wgmma.cuh: the
//   real and imaginary parts one warpgroup each, M = 64, N = W2 padded to a
//   multiple of 8, 40 at 64^2).  The real coefficients cm and cu never mix
//   the parts, so each warpgroup carries its part of uh in registers for the
//   whole macro (20 f32 a thread at 64^2), beside cm and cu, and the field
//   stays in the accumulator fragment where the inverse lands (16 pixels a
//   thread).  Four barriers a substep; 106 KB of shared memory at 64^2.
//   Those registers do not fit two blocks an SM: the kernel runs one block
//   an SM at up to 255 registers (scripts/torch_k9_variants_ab.py).
// - f32 tables: ch_sif_macro_kernel, f32 FMA on the CUDA cores
//   (sif_common.cuh): the tables, the carried spectrum and two work buffers
//   as f32 pairs in shared memory, a 4 x 4 tile of the field a thread.
//
// Both: one block of 256 threads per env at a time (grid-stride).

#include "sif_common.cuh"
#include "sif_wgmma.cuh"

namespace {

template <int KG>
__global__ void __launch_bounds__(kThreads, 2)
ch_sif_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                    SifTables g, float* __restrict__ u_out, int B, SifDims d, int n_steps,
                    float dt, float a_dt, MuPoly mu) {
  extern __shared__ float4 smem4[];
  const SifSmem s = carve_sif(reinterpret_cast<char*>(smem4), d, true);
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
      store_operand(s.zs, d.H, ty4, tx4, u);
    }
    __syncthreads();
    dft_stage_a<KG>(s, d, tid);
    __syncthreads();
    dft_stage_b<KG>(s, d, tid, [&](int kh, int kw, float xr, float xi) {
      s.uh[kh * d.W2p + kw] = make_float2(xr, xi);                    // uh = F(u)
    });

    for (int step = 0; step < n_steps; ++step) {
      if (own) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = mu_eval(mu, u[i][j]);
        store_operand(s.zs, d.H, ty4, tx4, v);
      }
      __syncthreads();
      dft_stage_a<KG>(s, d, tid);
      __syncthreads();
      dft_stage_b<KG>(s, d, tid, [&](int kh, int kw, float xr, float xi) {
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
        s.Q[kh * d.W2p + kw] = make_float2(zr, zi);                   // incr
      });
      __syncthreads();
      dft_stage_c<KG>(s, d, tid);
      __syncthreads();
      if (own) {
        dft_stage_d(s, d, ty4, tx4, v);                               // Re F^-1(incr)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = __fadd_rn(u[i][j], v[i][j]);
      }
    }
    if (own) save_tile(u_out + off, d.W, ty4, tx4, u);
  }
}

// The bf16 path on the tensor cores: the same macro with sif_wgmma.cuh's
// transforms, N = W2 padded to a multiple of 8.  Not capped: at 128
// registers (two blocks an SM) it spills 600 B at N = 40 and took 0.82 ms
// against 0.65 at 4096 x 64^2 x 10 on an H100, and capped with cm and cu
// recomputed every substep 1.62 ms (scripts/torch_k9_variants_ab.py).
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ch_sif_macro_wg_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                       SifTables g, float* __restrict__ u_out, int B, int H, int W, int W2,
                       int n_steps, float dt, float a_dt, MuPoly mu) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const SifWgTiles s = carve_sif_wg(smem_wg, N);
  const int tid = threadIdx.x;
  const Own o = make_own(tid), f = make_spec(tid);
  load_sif_tables_wg<N>(s, g, H, W, W2, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float k = kappa[env];
    const float dtk = __fmul_rn(dt, k);
    // cm and cu at this thread's spectrum entries, 0 beyond H and W2.
    float cm[N / 8][4], cu[N / 8][4], uh[N / 8][4], x[N / 8][4], u[4][4], v[4][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kh = f.row(e), kw = f.col(j, e);
        cm[j][e] = cu[j][e] = 0.f;
        if (kh < H && kw < W2) {
          const float l = __ldg(g.lam + kh * W2 + kw), l2 = __ldg(g.lam2 + kh * W2 + kw);
          const float den = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, l2))));
          cm[j][e] = __fmul_rn(__fmul_rn(dt, l), den);
          cu[j][e] = __fmul_rn(__fmul_rn(dtk, l2), den);
        }
      }
    // The previous env's last stage A finished every read of xa two
    // barriers ago.
    load_frag(u_in + off, H, W, o, u);
    store_field(s.xa, u, o, H, W);
    sif_forward<N>(s, f, uh);                                  // uh = F(u)

    for (int step = 0; step < n_steps; ++step) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][e] = mu_eval(mu, u[j][e]);
      store_field(s.xa, v, o, H, W);
      sif_forward<N>(s, f, x);                                 // F(mu(u))
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = __fsub_rn(__fmul_rn(cm[j][e], x[j][e]), __fmul_rn(cu[j][e], uh[j][e]));
          uh[j][e] = __fadd_rn(uh[j][e], z);
          x[j][e] = f.col(j, e) < W2 ? z : 0.f;                      // incr
        }
      store_transposed<N>(s.zc, x, f);
      sif_inverse<N>(s, f, o, v);                                 // Re F^-1(incr)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] = __fadd_rn(u[j][e], v[j][e]);
    }
    save_frag(u_out + off, H, W, o, u);
  }
}

}  // namespace

extern "C" {

// Launches K9a on `stream`: u (B, H, W) -> out, the tables as SifTables
// lists them (W2 = W/2 + 1 with the half spectrum, else W); the tensor-core
// kernel when round_bf16 (bf16 tables), the FMA kernel otherwise.  Returns a
// cudaError_t value, 0 on success.
int ch_sif_macro_launch(const float* u, const float* kappa, const float* wr_w,
                        const float* wi_w, const float* wr_h, const float* wi_h,
                        const float* vr_h, const float* vi_h, const float* vr_w,
                        const float* vi_w, const float* lam, const float* lam2, float* out,
                        int B, int H, int W, int W2, int n_steps, float dt, float a_dt,
                        const float* mu_coeffs, int n_mu, int round_bf16, void* stream) {
  if (bad_sif(B, H, W, W2, n_steps) || bad_poly(n_mu))
    return static_cast<int>(cudaErrorInvalidValue);
  const SifTables g{wr_w, wi_w, wr_h, wi_h, vr_h, vi_h, vr_w, vi_w, lam, lam2};
  const MuPoly mu = make_mu(mu_coeffs, n_mu);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (round_bf16) {
    err = with_sif_width(W2, [&](auto width) {
      constexpr int N = decltype(width)::value;
      const auto kernel = ch_sif_macro_wg_kernel<N>;
      const int smem = sif_wg_smem_bytes(N);
      int grid = 0;
      cudaError_t e = sif_grid(kernel, smem, B, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, kThreads, smem, st>>>(u, kappa, g, out, B, H, W, W2, n_steps, dt, a_dt, mu);
      return cudaGetLastError();
    });
  } else {
    const SifDims d = sif_dims(H, W, W2);
    int at[7];
    const int smem = sif_smem_bytes(d, true, at);
    const auto kernel = sif_group(W2) == 4 ? ch_sif_macro_kernel<4> : ch_sif_macro_kernel<3>;
    int grid = 0;
    err = sif_grid(kernel, smem, B, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, st>>>(u, kappa, g, out, B, d, n_steps, dt, a_dt, mu);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

const char* ch_sif_macro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
