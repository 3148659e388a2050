// The packed-DFT transforms on Hopper's tensor cores, for the bf16-table
// paths of K9a (ch_sif_macro.cu) and K9b (ac_sif_macro.cu); their f32-table
// paths keep sif_common.cuh's FMA transforms.
//
// The plain version's transforms (ops/fused_spectral.py _dft_transforms),
// with N = W2p, the kept spectrum width W2 padded to a multiple of 8:
//
//   forward  P_r, P_i = rnd(rnd(x) Wr_w), rnd(rnd(x) Wi_w)                     (stage A)
//            X_r = Wr_h^T P_r - Wi_h^T P_i,   X_i = Wi_h^T P_r + Wr_h^T P_i     (stage B)
//   inverse  C_r = rnd(Vr_h^T rnd(Z_r) - Vi_h^T rnd(Z_i))
//            C_i = rnd(Vi_h^T rnd(Z_r) + Vr_h^T rnd(Z_i))                     (stage C)
//            y   = C_r Vr_w - C_i Vi_w                                        (stage D)
//
// Each stage is one warpgroup product per warpgroup (wgmma m64nNk16, bf16
// operands from shared memory, f32 accumulation) with M = 64 rows along h
// or kh, zero-padded beyond H.  In stages A-C warpgroup 0 computes the real
// part and warpgroup 1 the imaginary part, each 64 x N.  Stages B and C sum
// both terms of a complex combine in one product over K = 2 x 64: the pair
// [P_r | P_i] (or [Z_r | Z_i]) against two of the three K blocks of a
// 64 x 3 x 64 table [Wi_h^T | Wr_h^T | -Wi_h^T] (inverse: the V tables),
// warpgroup 1 reading blocks 0-1 and warpgroup 0 blocks 1-2 (negating a
// bf16 value is exact).  The JAX kernel sums rr - ii as two f32 products;
// one accumulator sums their terms in another order.  Stage D sums over
// K = 2N, [C_r | C_i] against [Vr_w; -Vi_w], and the two warpgroups split
// the w axis, 32 columns each, so that y lands in cas_wgmma.cuh's field
// fragment (`Own`) where the field lives.  Every K extent is a constant of
// the kernel (64 along w and a block of 64 along h, zero-padded beyond W and
// H; 2N along kw), so each product is unrolled with its accumulator in fixed
// registers.
//
// Every operand is K-major in the unswizzled core-matrix layout (`kmaj_idx`,
// kc core matrices along K; LBO 128 B, SBO kc * 128 B).  Between two stages
// a product's fragment is stored as the next product's operand: transposed
// (P and Z are B operands, rows kw, K h or kh) or as is (C is the A operand,
// rows h, K kw), rounded to bf16 where the JAX kernel casts.  Shared memory:
// 106 KB at N = 40 (64^2, half spectrum), room for two blocks an SM.
//
// The spectrum fragment `f`: warpgroup g holds register 4 j + e of its
// 64 x N accumulator, row (kh or h) f.row(e), column kw = f.col(j, e) (an
// `Own` without the field's column offset 32 g).  K9a's and K9b's spectrum
// updates multiply by real coefficients only, so each warpgroup updates its
// own part in registers.
//
// Padding: table entries beyond H, W and W2 are zero, so the padded rows and
// columns of every product are zero for a finite env.  Every tile entry a
// product reads is written again for each env, so a NaN env stays in its
// env.

#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cas_wgmma.cuh"
#include "sif_common.cuh"

namespace {

// Element (r, k) of a K-major tile with kc core matrices along K: core matrix
// (r / 8, k / 8) at 128-byte block (r / 8) kc + k / 8, row r % 8 at 16 bytes,
// k % 8 within it (cas_wgmma.cuh's tile_idx is kc = 8).
__device__ __forceinline__ int kmaj_idx(int r, int k, int kc) {
  return (((r >> 3) * kc + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}

// The block's tiles (bf16, K-major), kc in brackets.
struct SifWgTiles {
  __nv_bfloat16* xa;   // 64 x 64    the field operand x[h][w]                    (8)
  __nv_bfloat16* fw;   // 2N x 64    [Wr_w^T; Wi_w^T]: rows kw, K w                (8)
  __nv_bfloat16* fh;   // 64 x 192   [Wi_h^T | Wr_h^T | -Wi_h^T]: rows kh, K h    (24)
  __nv_bfloat16* vh;   // 64 x 192   [Vi_h^T | Vr_h^T | -Vi_h^T]: rows h, K kh    (24)
  __nv_bfloat16* pc;   // N x 128    [P_r | P_i]^T: rows kw, K h                  (16)
  __nv_bfloat16* zc;   // N x 128    [Z_r | Z_i]^T: rows kw, K kh                 (16)
  __nv_bfloat16* cc;   // 64 x 2N    [C_r | C_i]: rows h, K kw                    (N/4)
  __nv_bfloat16* dw;   // 64 x 2N    [Vr_w; -Vi_w]^T: rows w, K kw                (N/4)
  float* uf;           // K9b's f32 field [h][w] (4 H W <= 512 N bytes), over pc and zc
};

// Bytes of shared memory of SifWgTiles; every tile starts 128-byte aligned.
inline int sif_wg_smem_bytes(int N) { return 2 * (64 * 64 + 2 * 64 * 192 + 5 * 128 * N); }

__device__ __forceinline__ SifWgTiles carve_sif_wg(unsigned char* base, int N) {
  SifWgTiles s;
  s.xa = reinterpret_cast<__nv_bfloat16*>(base);
  s.fw = s.xa + 64 * 64;
  s.fh = s.fw + 2 * N * 64;
  s.vh = s.fh + 64 * 192;
  s.pc = s.vh + 64 * 192;
  s.zc = s.pc + N * 128;
  s.cc = s.zc + N * 128;
  s.dw = s.cc + 64 * 2 * N;
  s.uf = reinterpret_cast<float*>(s.pc);
  return s;
}

// The spectrum fragment of thread tid (see the top of this file).
__device__ __forceinline__ Own make_spec(int tid) {
  Own f = make_own(tid);
  f.col0 -= 32 * f.g;
  return f;
}

// The tables into shared memory as bf16 (the wrapper passes bf16-exact f32),
// zero beyond H, W and W2.
template <int N>
__device__ __forceinline__ void load_sif_tables_wg(const SifWgTiles& s, const SifTables& g,
                                                   int H, int W, int W2, int tid) {
  for (int i = tid; i < 2 * N * 64; i += kThreads) {
    const int r = i >> 6, w = i & 63, kw = r % N;
    const float* t = r < N ? g.wr_w : g.wi_w;
    s.fw[kmaj_idx(r, w, 8)] = __float2bfloat16_rn(w < W && kw < W2 ? t[w * W2 + kw] : 0.f);
  }
  // fh[kh][h] from the forward tables [h][kh]; vh[h][kh] from the inverse
  // tables [kh][h]: both read entry c * H + r.
  for (int i = tid; i < 64 * 192; i += kThreads) {
    const int r = i / 192, k = i % 192, blk = k >> 6, c = k & 63;
    float fv = 0.f, vv = 0.f;
    if (r < H && c < H) {
      fv = blk == 1 ? g.wr_h[c * H + r] : g.wi_h[c * H + r];
      vv = blk == 1 ? g.vr_h[c * H + r] : g.vi_h[c * H + r];
      if (blk == 2) fv = -fv, vv = -vv;
    }
    const int t = kmaj_idx(r, k, 24);
    s.fh[t] = __float2bfloat16_rn(fv);
    s.vh[t] = __float2bfloat16_rn(vv);
  }
  for (int i = tid; i < 64 * 2 * N; i += kThreads) {
    const int r = i / (2 * N), k = i % (2 * N), kw = k % N;
    float v = 0.f;
    if (r < W && kw < W2) v = k < N ? g.vr_w[kw * W + r] : -g.vi_w[kw * W + r];
    s.dw[kmaj_idx(r, k, N / 4)] = __float2bfloat16_rn(v);
  }
}

// The forward transform's operand: xa[h][w] = rnd_bf16(v at pixel (h, w)),
// 0 off the grid.  Every thread must call it: together the threads write
// all 64 x 64 entries.
__device__ __forceinline__ void store_field(__nv_bfloat16* xa, const float v[4][4],
                                            const Own& o, int H, int W) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const bool in = o.valid(j, hi, H, W);
      *reinterpret_cast<__nv_bfloat162*>(xa + tile_idx(o.row(2 * hi), o.col(j, 0))) =
          __floats2bfloat162_rn(in ? v[j][2 * hi] : 0.f, in ? v[j][2 * hi + 1] : 0.f);
    }
}

// d = A B over STEPS k16 steps, this warpgroup's 64 x N: A the 64 rows at a
// (KC_A core matrices along K), B the N rows at b (KC_B).
template <int N, int STEPS, int KC_A, int KC_B>
__device__ __forceinline__ void sif_product(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                            float (*d)[4]) {
  constexpr uint32_t sbo_a = KC_A * kCoreBytes, sbo_b = KC_B * kCoreBytes;
  wgmma_fence_operand<N / 8>(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    wgmma_m64nNk16_bf16<N>(d, wgmma_desc(a + s * kStepElems, kLbo, sbo_a),
                           wgmma_desc(b + s * kStepElems, kLbo, sbo_b), s);
  wgmma_commit();
  wgmma_wait_all();
  wgmma_fence_operand<N / 8>(d);
}

// This warpgroup's spectrum fragment v, transposed into its K block of the
// B operand t (pc or zc): element (kw, 64 g + row), rounded to bf16.
template <int N>
__device__ __forceinline__ void store_transposed(__nv_bfloat16* t, const float (*v)[4],
                                                 const Own& f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[kmaj_idx(f.col(j, e), 64 * f.g + f.row(e), 16)] = __float2bfloat16_rn(v[j][e]);
}

// X = F(x) for the operand every thread has just written into xa
// (store_field): this warpgroup's part (0 real, 1 imaginary) of X[kh][kw]
// in x, fragment f.  Every thread must call it: it holds two barriers.
template <int N>
__device__ __forceinline__ void sif_forward(const SifWgTiles& s, const Own& f, float (*x)[4]) {
  fence_proxy_async();
  __syncthreads();                                        // xa complete, pc free
  float p[N / 8][4];
  sif_product<N, 4, 8, 8>(s.xa, s.fw + f.g * N * 64, p);                  // P_g[h][kw]
  store_transposed<N>(s.pc, p, f);
  fence_proxy_async();
  __syncthreads();                                        // pc complete
  sif_product<N, 8, 24, 16>(s.fh + (1 - f.g) * 512, s.pc, x);             // X_g[kh][kw]
}

// y = Re F^-1(Z) for the spectrum every thread has just written into zc
// (store_transposed, this warpgroup's part); y in the field fragment o.
// Every thread must call it: it holds two barriers.
template <int N>
__device__ __forceinline__ void sif_inverse(const SifWgTiles& s, const Own& f, const Own& o,
                                            float y[4][4]) {
  fence_proxy_async();
  __syncthreads();                                        // zc complete, cc free
  float c[N / 8][4];
  sif_product<N, 8, 24, 16>(s.vh + (1 - f.g) * 512, s.zc, c);             // C_g[h][kw]
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      *reinterpret_cast<__nv_bfloat162*>(
          s.cc + kmaj_idx(f.row(2 * hi), f.g * N + f.col(j, 0), N / 4)) =
          __floats2bfloat162_rn(c[j][2 * hi], c[j][2 * hi + 1]);
  fence_proxy_async();
  __syncthreads();                                        // cc complete
  sif_product<32, N / 8, N / 4, N / 4>(s.cc, s.dw + o.g * 64 * N, y);      // y[h][w]
}

// fn(std::integral_constant<int, N>{}) for N = W2 rounded up to a multiple
// of 8 (W2 <= 64): the kernel instance for the spectrum's width.
template <class Fn>
cudaError_t with_sif_width(int W2, Fn fn) {
  switch ((W2 + 7) / 8) {
    case 1: return fn(std::integral_constant<int, 8>{});
    case 2: return fn(std::integral_constant<int, 16>{});
    case 3: return fn(std::integral_constant<int, 24>{});
    case 4: return fn(std::integral_constant<int, 32>{});
    case 5: return fn(std::integral_constant<int, 40>{});
    case 6: return fn(std::integral_constant<int, 48>{});
    case 7: return fn(std::integral_constant<int, 56>{});
    case 8: return fn(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
