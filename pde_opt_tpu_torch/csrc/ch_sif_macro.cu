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
//   an SM at up to 255 registers.
// - f32 tables: ch_sif_macro_kernel, f32 FMA on the CUDA cores
//   (sif_common.cuh): the tables, the carried spectrum and two work buffers
//   as f32 pairs in shared memory, a 4 x 4 tile of the field a thread.
//
// Both: one block of 256 threads per env at a time (grid-stride).
//
// Grids above 64 x 64 (any H and W that are multiples of 8 up to 256) run
// ch_sif_macro_tiled_kernel at the end of this file, bf16 and f32 alike: an
// env's planes live in device memory and each transform streams 64-wide
// chunks through shared memory (sif_tiled.cuh).  The launch picks the kernel
// by grid (cas_tiled.cuh's `tiled`); the 64^2 kernels are unchanged.

#include "kernel_error.cuh"
#include "sif_common.cuh"
#include "sif_tiled.cuh"
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
// recomputed every substep 1.62 ms.
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

// ---- K9a above 64 x 64: the tiled kernel -----------------------------------
//
// One block owns one env at a time (grid-stride), as above; the field lives
// in u_out, the rest in this block's slot of a scratch that the wrapper
// allocates (ch_sif_macro_scratch: sif_tiled.cuh's planes and the carried
// spectrum uh, f32 [c][kh]).  Stage B's epilogue forms incr = cm X - cu uh,
// carries uh += incr and writes rnd(incr) as the inverse's operand; stage
// D's does u += y and writes the next operand rnd(mu(u)).  cm and cu are
// recomputed from lam where they are used, in the 64^2 kernels' order.

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
ch_sif_macro_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                          SifTiledTables<kBf16> g, float* u_out, float* scratch, int B,
                          SifTiledDims d, int n_steps, float dt, float a_dt, MuPoly mu) {
  extern __shared__ __align__(128) unsigned char smem_tl[];
  const int tid = threadIdx.x, H = d.H, W = d.W, hw = H * W;
  const SifSlot<kBf16> s = carve_sif_slot<kBf16>(
      scratch + static_cast<size_t>(blockIdx.x) * sif_slot_floats(kBf16, d, true), d);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float k = kappa[env];
    const float dtk = __fmul_rn(dt, k);
    float* u = u_out + off;
    __syncthreads();                 // the previous env's last epilogue is done with the planes
    for (int p = 2 * tid; p < hw; p += 2 * kThreads) {
      const float2 v = ld2(u_in + off + p);
      st2(u + p, v);
      put_pair<kBf16>(s.x, p / W, p % W, H, W, v);
    }
    sif_tiled_forward<kBf16>(smem_tl, s, g, d, tid, [&](int c, int kh, float2 v) {
      st2(s.uh + c * H + kh, v);                                     // uh = F(u)
    });
    // X was last read by stage A, before stage B's opening barrier.
    for (int p = 2 * tid; p < hw; p += 2 * kThreads)
      put_pair<kBf16>(s.x, p / W, p % W, H, W, mu2(mu, ld2(u + p)));
    for (int step = 0; step < n_steps; ++step) {
      sif_tiled_forward<kBf16>(smem_tl, s, g, d, tid, [&](int c, int kh, float2 x) {
        const int kw = c >= d.W2p ? c - d.W2p : c;
        float2 z = make_float2(0.f, 0.f), h = z;
        if (kw < d.W2) {                                             // incr = cm X - cu uh
          const float2 l = ld2(g.lam_t + kw * H + kh), l2 = ld2(g.lam2_t + kw * H + kh);
          h = ld2(s.uh + c * H + kh);
          const float ls[2] = {l.x, l.y}, l2s[2] = {l2.x, l2.y}, xs[2] = {x.x, x.y};
          float hs[2] = {h.x, h.y}, zs[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float den =
                __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, l2s[e]))));
            const float cm = __fmul_rn(__fmul_rn(dt, ls[e]), den);
            const float cu = __fmul_rn(__fmul_rn(dtk, l2s[e]), den);
            zs[e] = __fsub_rn(__fmul_rn(cm, xs[e]), __fmul_rn(cu, hs[e]));
            hs[e] = __fadd_rn(hs[e], zs[e]);
          }
          z = make_float2(zs[0], zs[1]);
          h = make_float2(hs[0], hs[1]);
        }
        st2(s.uh + c * H + kh, h);
        put_spec<kBf16>(s.zz, c, kh, d, z);
      });
      sif_tiled_inverse<kBf16>(smem_tl, s, g, d, tid, [&](int h, int w, float2 y) {
        const int p = h * W + w;                                     // u += Re F^-1(incr)
        float2 x = ld2(u + p);
        x = make_float2(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y));
        st2(u + p, x);
        put_pair<kBf16>(s.x, h, w, H, W, mu2(mu, x));
      });
    }
  }
}

template <bool kBf16>
cudaError_t launch_ch_sif_tiled(const float* u, const float* kappa, const void* const* t,
                                float* out, float* scratch, int n_slots, int B,
                                const SifTiledDims& d, int n_steps, float dt, float a_dt,
                                const MuPoly& mu, cudaStream_t st) {
  const SifTiledTables<kBf16> g{static_cast<const Op<kBf16>*>(t[0]),
                                static_cast<const Op<kBf16>*>(t[1]),
                                static_cast<const Op<kBf16>*>(t[2]),
                                static_cast<const Op<kBf16>*>(t[3]),
                                static_cast<const float*>(t[4]), static_cast<const float*>(t[5])};
  return launch_tiled(ch_sif_macro_tiled_kernel<kBf16>, kBf16, B, n_slots, st, u, kappa, g, out,
                      scratch, B, d, n_steps, dt, a_dt, mu);
}

}  // namespace

extern "C" {

// The scratch a launch needs on the current device: `slots` blocks resident
// at once of the kernel that the grid and round_bf16 pick, each with a slot
// of `floats` f32: none at 64^2 and below (0, 0), sif_tiled.cuh's planes and
// the carried spectrum above.  Returns a cudaError_t value.
int ch_sif_macro_scratch(int round_bf16, int H, int W, int W2, int* slots, long long* floats) {
  *slots = 0;
  *floats = 0;
  if (!tiled(H, W)) return 0;
  const SifTiledDims d = sif_tiled_dims(H, W, W2);
  return static_cast<int>(
      round_bf16 != 0
          ? sif_tiled_scratch(ch_sif_macro_tiled_kernel<true>, true, d, true, slots, floats)
          : sif_tiled_scratch(ch_sif_macro_tiled_kernel<false>, false, d, true, slots, floats));
}

// Launches K9a on `stream`: u (B, H, W) -> out, the tables as SifTables
// lists them (W2 = W/2 + 1 with the half spectrum, else W); at 64^2 and
// below the tensor-core kernel when round_bf16 (bf16 tables), the FMA
// kernel otherwise.  Above, the tiled kernel of that type on min(B,
// n_slots) blocks, with `scratch` as ch_sif_macro_scratch sizes it and the
// tables `tiled` [fw, fh, vh, vw, lam_t, lam2_t] in sif_tiled.cuh's layout
// (bf16 or f32 by round_bf16; unused at 64^2, may be null there).  Returns a
// cudaError_t value, 0 on success.
int ch_sif_macro_launch(const float* u, const float* kappa, const float* wr_w,
                        const float* wi_w, const float* wr_h, const float* wi_h,
                        const float* vr_h, const float* vi_h, const float* vr_w,
                        const float* vi_w, const float* lam, const float* lam2, float* out,
                        const void* const* tiled_tables, float* scratch, int n_slots,
                        int B, int H, int W, int W2, int n_steps, float dt, float a_dt,
                        const float* mu_coeffs, int n_mu, int round_bf16, void* stream) {
  const bool big = tiled(H, W);
  if ((big ? bad_sif_tiled(B, H, W, W2, n_steps, scratch, n_slots, tiled_tables)
           : bad_sif(B, H, W, W2, n_steps)) ||
      bad_poly(n_mu))
    return static_cast<int>(cudaErrorInvalidValue);
  const SifTables g{wr_w, wi_w, wr_h, wi_h, vr_h, vi_h, vr_w, vi_w, lam, lam2};
  const MuPoly mu = make_mu(mu_coeffs, n_mu);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (big) {
    const SifTiledDims d = sif_tiled_dims(H, W, W2);
    err = round_bf16 ? launch_ch_sif_tiled<true>(u, kappa, tiled_tables, out, scratch, n_slots, B,
                                                 d, n_steps, dt, a_dt, mu, st)
                     : launch_ch_sif_tiled<false>(u, kappa, tiled_tables, out, scratch, n_slots,
                                                  B, d, n_steps, dt, a_dt, mu, st);
  } else if (round_bf16) {
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

}  // extern "C"
