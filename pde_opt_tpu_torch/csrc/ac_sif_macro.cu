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
// F and F^-1 are the separable complex DFTs of K9a.  mu and R are
// polynomials (Horner, degree <= 7); n_r = 0 selects R == 1, which the
// wrapper picks by the JAX package's identity probe.  The Laplacian wraps by
// index on a shared-memory copy of the f32 field (the TPU kernel's
// pltpu.roll does not carry over).  With bf16 tables the operand and the
// intermediate of each transform are rounded to bf16, as in the JAX kernel;
// sums are f32, the elementwise arithmetic _rn intrinsics in the plain
// version's order.
//
// Bound: per env and substep one forward and one inverse transform,
// 2 * (4 H W W2 + 8 H^2 W2) operations = 3.24 MFLOP at 64^2 (W2 = 33),
// against 32 KB of field traffic per env and macro: arithmetic-bound, on the
// tensor cores with bf16 tables.  Two kernels, picked by the tables' type
// alone:
//
// - bf16 tables (the default): ac_sif_macro_wg_kernel runs the transforms
//   as warpgroup wgmma (sif_wgmma.cuh, as K9a).  The implicit multiplier is
//   real, so each warpgroup scales its part of the spectrum in registers,
//   where the multiplier sits for the whole env (20 f32 a thread at 64^2).
//   The Laplacian reads neighbours across fragment owners, so the f32 field
//   goes through shared memory once a substep, over the spectrum tiles that
//   are free then; the field itself stays in the accumulator fragment where
//   the inverse lands.  Five barriers a substep; 106 KB of shared memory at
//   64^2, capped at 128 registers (8 B of spills at N = 40), so two blocks
//   share an SM.  The Laplacian reads the field copy as pairs, swizzled so
//   that a warp's 8 rows do not share banks.  On an H100 at 4096 x 64^2 x
//   10 it takes 0.85 ms; uncapped (143
//   registers, one block an SM) 1.05 ms; reading single floats from an
//   unswizzled copy (8-way bank conflicts) 1.33 ms.
// - f32 tables: ac_sif_macro_kernel, f32 FMA on the CUDA cores
//   (sif_common.cuh): the tables, the f32 field and two work buffers in
//   shared memory, a 4 x 4 tile of the field a thread.
//
// Both: one block of 256 threads per env at a time (grid-stride).
//
// Grids above 64 x 64 (any H and W that are multiples of 8 up to 256) run
// ac_sif_macro_tiled_kernel at the end of this file, bf16 and f32 alike
// (sif_tiled.cuh, as K9a's tiled kernel).  The launch picks the kernel by
// grid (cas_tiled.cuh's `tiled`); the 64^2 kernels are unchanged.

#include "kernel_error.cuh"
#include "sif_common.cuh"
#include "sif_tiled.cuh"
#include "sif_wgmma.cuh"

namespace {

template <int KG>
__global__ void __launch_bounds__(kThreads, 2)
ac_sif_macro_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                    SifTables g, float* __restrict__ u_out, int B, SifDims d, int n_steps,
                    float dt, float a_dt, float inv_hx2, float inv_hy2, MuPoly mu, MuPoly R,
                    bool r_identity) {
  extern __shared__ float4 smem4[];
  const SifSmem s = carve_sif(reinterpret_cast<char*>(smem4), d, false);
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
        store_operand(s.zs, H, ty4, tx4, v);
      }
      __syncthreads();
      dft_stage_a<KG>(s, d, tid);
      __syncthreads();
      dft_stage_b<KG>(s, d, tid, [&](int kh, int kw, float xr, float xi) {
        float zr = 0.f, zi = 0.f;
        if (kw < d.W2) {
          const float l = __ldg(g.lam + kh * d.W2 + kw);
          const float dd = __fdiv_rn(dt, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, -l))));
          zr = __fmul_rn(dd, xr);
          zi = __fmul_rn(dd, xi);
        }
        s.Q[kh * d.W2p + kw] = make_float2(zr, zi);
      });
      __syncthreads();
      dft_stage_c<KG>(s, d, tid);
      __syncthreads();
      if (own) {
        dft_stage_d(s, d, ty4, tx4, v);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = __fadd_rn(u[i][j], v[i][j]);
      }
    }
    if (own) save_tile(u_out + off, W, ty4, tx4, u);
  }
}

// Pixel (h, w) of the wgmma kernel's f32 field copy uf: rows of W floats,
// and when W is a multiple of 32 the 8-float groups of row h XOR-swizzled by
// h % 4, so that the 8 rows a warp reads at once fall on different banks
// (two to a bank; unswizzled, at W = 64, all 8 shared one).
__device__ __forceinline__ int uf_idx(int h, int w, int W) {
  return h * W + (W % 32 == 0 ? w ^ ((h & 3) << 3) : w);
}

// The bf16 path on the tensor cores: the same macro with sif_wgmma.cuh's
// transforms, N = W2 padded to a multiple of 8.
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ac_sif_macro_wg_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                       SifTables g, float* __restrict__ u_out, int B, int H, int W, int W2,
                       int n_steps, float dt, float a_dt, float inv_hx2, float inv_hy2,
                       MuPoly mu, MuPoly R, bool r_identity) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const SifWgTiles s = carve_sif_wg(smem_wg, N);
  const int tid = threadIdx.x;
  const Own o = make_own(tid), f = make_spec(tid);
  load_sif_tables_wg<N>(s, g, H, W, W2, tid);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * H * W;
    const float k = kappa[env];
    // The implicit multiplier at this thread's spectrum entries, 0 beyond H
    // and W2.
    float dd[N / 8][4], x[N / 8][4], u[4][4], v[4][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kh = f.row(e), kw = f.col(j, e);
        dd[j][e] = 0.f;
        if (kh < H && kw < W2) {
          const float l = __ldg(g.lam + kh * W2 + kw);
          dd[j][e] = __fdiv_rn(dt, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, -l))));
        }
      }
    load_frag(u_in + off, H, W, o, u);

    for (int step = 0; step < n_steps; ++step) {
      // uf lies over pc and zc: the previous substep's stages B and C
      // finished reading them before the barriers ahead of its stages C
      // and D.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          if (o.valid(j, hi, H, W))
            *reinterpret_cast<float2*>(s.uf + uf_idx(o.row(2 * hi), o.col(j, 0), W)) =
                make_float2(u[j][2 * hi], u[j][2 * hi + 1]);
      __syncthreads();
      // The Laplacian at the pixel pairs (h, c), (h, c + 1): the rows above
      // and below as pairs, the pair's own values from registers.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          v[j][2 * hi] = v[j][2 * hi + 1] = 0.f;
          if (!o.valid(j, hi, H, W)) continue;
          const int h = o.row(2 * hi), c = o.col(j, 0);
          const float2 up = *reinterpret_cast<const float2*>(
              s.uf + uf_idx(h + 1 == H ? 0 : h + 1, c, W));
          const float2 dn = *reinterpret_cast<const float2*>(
              s.uf + uf_idx(h == 0 ? H - 1 : h - 1, c, W));
          const float left = s.uf[uf_idx(h, c == 0 ? W - 1 : c - 1, W)];
          const float right = s.uf[uf_idx(h, c + 2 == W ? 0 : c + 2, W)];
          const float uu[2] = {u[j][2 * hi], u[j][2 * hi + 1]};
          const float above[2] = {up.x, up.y}, below[2] = {dn.x, dn.y};
          const float next[2] = {uu[1], right}, prev[2] = {left, uu[0]};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float c2 = __fmul_rn(2.f, uu[q]);
            const float lx = __fadd_rn(__fsub_rn(above[q], c2), below[q]);
            const float ly = __fadd_rn(__fsub_rn(next[q], c2), prev[q]);
            const float lap = __fadd_rn(__fmul_rn(lx, inv_hx2), __fmul_rn(ly, inv_hy2));
            const float m = __fsub_rn(mu_eval(mu, uu[q]), __fmul_rn(k, lap));
            v[j][2 * hi + q] = r_identity ? -m : __fmul_rn(-mu_eval(R, uu[q]), m);
          }
        }
      store_field(s.xa, v, o, H, W);
      sif_forward<N>(s, f, x);                                 // F(g)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[j][e] = f.col(j, e) < W2 ? __fmul_rn(dd[j][e], x[j][e]) : 0.f;
      store_transposed<N>(s.zc, x, f);
      sif_inverse<N>(s, f, o, v);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] = __fadd_rn(u[j][e], v[j][e]);
    }
    save_frag(u_out + off, H, W, o, u);
  }
}

// ---- K9b above 64 x 64: the tiled kernel -----------------------------------
//
// One block owns one env at a time (grid-stride); the field lives in u_out,
// the transforms' planes in this block's slot of a scratch that the wrapper
// allocates (ac_sif_macro_scratch).  Each substep opens with a pass over the
// pixel pairs that forms g = -R(u) (mu(u) - kappa lap) from the field in
// u_out (its four neighbours, after a barrier) into the operand X; stage B's
// epilogue multiplies the spectrum by dt / (1 + A dt kappa (-lam)) and
// writes it as the inverse's operand; stage D's does u += y.

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
ac_sif_macro_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ kappa,
                          SifTiledTables<kBf16> g, float* u_out, float* scratch, int B,
                          SifTiledDims d, int n_steps, float dt, float a_dt, float inv_hx2,
                          float inv_hy2, MuPoly mu, MuPoly R, bool r_identity) {
  extern __shared__ __align__(128) unsigned char smem_tl[];
  const int tid = threadIdx.x, H = d.H, W = d.W, hw = H * W;
  const SifSlot<kBf16> s = carve_sif_slot<kBf16>(
      scratch + static_cast<size_t>(blockIdx.x) * sif_slot_floats(kBf16, d, false), d);

  for (int env = blockIdx.x; env < B; env += gridDim.x) {
    const size_t off = static_cast<size_t>(env) * hw;
    const float k = kappa[env];
    float* u = u_out + off;
    __syncthreads();                 // the previous env's last epilogue is done with the planes
    for (int p = 2 * tid; p < hw; p += 2 * kThreads) st2(u + p, ld2(u_in + off + p));
    for (int step = 0; step < n_steps; ++step) {
      __syncthreads();               // every write of u (the copy, the last inverse) complete
      for (int p = 2 * tid; p < hw; p += 2 * kThreads) {
        const int h = p / W, c = p % W;
        const float* row = u + h * W;
        const float2 x = ld2(row + c);
        const float2 up = ld2(u + (h + 1 == H ? 0 : h + 1) * W + c);
        const float2 dn = ld2(u + (h == 0 ? H - 1 : h - 1) * W + c);
        const float left = row[c == 0 ? W - 1 : c - 1], right = row[c + 2 == W ? 0 : c + 2];
        const float uu[2] = {x.x, x.y}, above[2] = {up.x, up.y}, below[2] = {dn.x, dn.y};
        const float next[2] = {x.y, right}, prev[2] = {left, x.x};
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float c2 = __fmul_rn(2.f, uu[q]);
          const float lx = __fadd_rn(__fsub_rn(above[q], c2), below[q]);
          const float ly = __fadd_rn(__fsub_rn(next[q], c2), prev[q]);
          const float lap = __fadd_rn(__fmul_rn(lx, inv_hx2), __fmul_rn(ly, inv_hy2));
          const float m = __fsub_rn(mu_eval(mu, uu[q]), __fmul_rn(k, lap));
          v[q] = r_identity ? -m : __fmul_rn(-mu_eval(R, uu[q]), m);
        }
        put_pair<kBf16>(s.x, h, c, H, W, make_float2(v[0], v[1]));
      }
      sif_tiled_forward<kBf16>(smem_tl, s, g, d, tid, [&](int c, int kh, float2 x) {
        const int kw = c >= d.W2p ? c - d.W2p : c;
        float2 z = make_float2(0.f, 0.f);
        if (kw < d.W2) {                                             // dd F(g)
          const float2 l = ld2(g.lam_t + kw * H + kh);
          z.x = __fmul_rn(__fdiv_rn(dt, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, -l.x)))),
                          x.x);
          z.y = __fmul_rn(__fdiv_rn(dt, __fadd_rn(1.f, __fmul_rn(a_dt, __fmul_rn(k, -l.y)))),
                          x.y);
        }
        put_spec<kBf16>(s.zz, c, kh, d, z);
      });
      sif_tiled_inverse<kBf16>(smem_tl, s, g, d, tid, [&](int h, int w, float2 y) {
        const int p = h * W + w;                                     // u += Re F^-1(.)
        const float2 x = ld2(u + p);
        st2(u + p, make_float2(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y)));
      });
    }
  }
}

template <bool kBf16>
cudaError_t launch_ac_sif_tiled(const float* u, const float* kappa, const void* const* t,
                                float* out, float* scratch, int n_slots, int B,
                                const SifTiledDims& d, int n_steps, float dt, float a_dt,
                                float inv_hx2, float inv_hy2, const MuPoly& mu, const MuPoly& R,
                                bool r1, cudaStream_t st) {
  const SifTiledTables<kBf16> g{static_cast<const Op<kBf16>*>(t[0]),
                                static_cast<const Op<kBf16>*>(t[1]),
                                static_cast<const Op<kBf16>*>(t[2]),
                                static_cast<const Op<kBf16>*>(t[3]),
                                static_cast<const float*>(t[4]), static_cast<const float*>(t[5])};
  return launch_tiled(ac_sif_macro_tiled_kernel<kBf16>, kBf16, B, n_slots, st, u, kappa, g, out,
                      scratch, B, d, n_steps, dt, a_dt, inv_hx2, inv_hy2, mu, R, r1);
}

}  // namespace

extern "C" {

// The scratch a launch needs on the current device: `slots` blocks resident
// at once of the kernel that the grid and round_bf16 pick, each with a slot
// of `floats` f32: none at 64^2 and below (0, 0), sif_tiled.cuh's planes
// above.  Returns a cudaError_t value.
int ac_sif_macro_scratch(int round_bf16, int H, int W, int W2, int* slots, long long* floats) {
  *slots = 0;
  *floats = 0;
  if (!tiled(H, W)) return 0;
  const SifTiledDims d = sif_tiled_dims(H, W, W2);
  return static_cast<int>(
      round_bf16 != 0
          ? sif_tiled_scratch(ac_sif_macro_tiled_kernel<true>, true, d, false, slots, floats)
          : sif_tiled_scratch(ac_sif_macro_tiled_kernel<false>, false, d, false, slots, floats));
}

// Launches K9b on `stream`: u (B, H, W) -> out, the tables as SifTables
// lists them (lam2 is not read); at 64^2 and below the tensor-core kernel
// when round_bf16 (bf16 tables), the FMA kernel otherwise; above, the tiled
// kernel of that type, with `scratch`, `n_slots` and `tiled_tables` as
// ch_sif_macro_launch takes them (lam2_t is not read).  n_r == 0 runs the
// R == 1 path; otherwise R is the polynomial r_coeffs.  Returns a
// cudaError_t value, 0 on success.
int ac_sif_macro_launch(const float* u, const float* kappa, const float* wr_w,
                        const float* wi_w, const float* wr_h, const float* wi_h,
                        const float* vr_h, const float* vi_h, const float* vr_w,
                        const float* vi_w, const float* lam, const float* lam2, float* out,
                        const void* const* tiled_tables, float* scratch, int n_slots,
                        int B, int H, int W, int W2, int n_steps, float dt, float a_dt,
                        float inv_hx2, float inv_hy2, const float* mu_coeffs, int n_mu,
                        const float* r_coeffs, int n_r, int round_bf16, void* stream) {
  const bool big = tiled(H, W);
  if ((big ? bad_sif_tiled(B, H, W, W2, n_steps, scratch, n_slots, tiled_tables)
           : bad_sif(B, H, W, W2, n_steps)) ||
      bad_poly(n_mu) || n_r < 0 || n_r > kMaxCoeffs)
    return static_cast<int>(cudaErrorInvalidValue);
  const SifTables g{wr_w, wi_w, wr_h, wi_h, vr_h, vi_h, vr_w, vi_w, lam, lam2};
  const MuPoly mu = make_mu(mu_coeffs, n_mu);
  const MuPoly R = make_mu(r_coeffs, n_r);
  const bool r1 = n_r == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (big) {
    const SifTiledDims d = sif_tiled_dims(H, W, W2);
    err = round_bf16 ? launch_ac_sif_tiled<true>(u, kappa, tiled_tables, out, scratch, n_slots, B,
                                                 d, n_steps, dt, a_dt, inv_hx2, inv_hy2, mu, R,
                                                 r1, st)
                     : launch_ac_sif_tiled<false>(u, kappa, tiled_tables, out, scratch, n_slots,
                                                  B, d, n_steps, dt, a_dt, inv_hx2, inv_hy2, mu,
                                                  R, r1, st);
  } else if (round_bf16) {
    err = with_sif_width(W2, [&](auto width) {
      constexpr int N = decltype(width)::value;
      const auto kernel = ac_sif_macro_wg_kernel<N>;
      const int smem = sif_wg_smem_bytes(N);
      int grid = 0;
      cudaError_t e = sif_grid(kernel, smem, B, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, kThreads, smem, st>>>(u, kappa, g, out, B, H, W, W2, n_steps, dt, a_dt,
                                           inv_hx2, inv_hy2, mu, R, r1);
      return cudaGetLastError();
    });
  } else {
    const SifDims d = sif_dims(H, W, W2);
    int at[7];
    const int smem = sif_smem_bytes(d, false, at);
    const auto kernel = sif_group(W2) == 4 ? ac_sif_macro_kernel<4> : ac_sif_macro_kernel<3>;
    int grid = 0;
    err = sif_grid(kernel, smem, B, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, st>>>(u, kappa, g, out, B, d, n_steps, dt, a_dt, inv_hx2,
                                         inv_hy2, mu, R, r1);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
