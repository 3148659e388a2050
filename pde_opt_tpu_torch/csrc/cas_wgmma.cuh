// The cas transform on Hopper's tensor cores, for the bf16 paths of the
// macro kernels (ac_cas_macro.cu: K4, bv_cc_macro.cu: K6); the f32 paths keep
// cas_common.cuh's FMA transform.
//
//   transform(Z) = Mh^T Z Mw     (as cas_common.cuh, in the JAX order)
//
// h first: T[k][w] = sum_h Mh[h][k] rnd_bf16(Z)[h][w], rounded to bf16 as it
// is stored (the JAX kernel's `.astype(mats)` on the intermediate), then w:
// out[k][l] = sum_w T[k][w] Mw[w][l], accumulated in f32.  Both products run
// as `wgmma` m64n32k16 bf16 (wgmma_ops.cuh): M = 64 rows, K = 64 in four
// k-steps, and the block's two warpgroups split N, warpgroup g taking
// columns [32 g, 32 g + 32) of T and then of out.  Product 2 needs every
// column of T, so a block barrier sits between the two products, and one
// before product 1 (the operand complete, the previous product 2 done with T).
//
// Shared memory: six 64 x 64 bf16 tiles (48 KB): the four matrices, Z^T and
// T, each K-major in the unswizzled core-matrix layout (`tile_idx`).  A and B
// of product 1 are Mh^T (row k, K h) and Z^T (row w, K h); of product 2 T
// (row k, K w) and Mw^T (row l, K w).  The matrices are stored transposed as
// they load (the cas matrices are symmetric; the transpose keeps the code
// exact for any), converted to bf16 (the wrapper passes bf16-exact f32).
// Grids below 64 x 64 are zero-padded to 64 in shared memory: the padded
// terms are exact zeros, and a NaN in an env reaches only padded rows of T
// and out, which nothing reads.
//
// Pixel ownership (`Own`): each thread owns the 16 pixels of its m64n32
// accumulator fragment, f[j][e] at row row0 + 8 (e / 2), column
// col0 + 8 j + e % 2, with row0 = 16 warp + lane / 4 (warp within its
// warpgroup) and col0 = 32 g + 2 (lane % 4).  Every per-pixel field of a
// kernel (the field, its RK state, lam, ...) lives in that layout, so the
// transform's output lands in registers where the next elementwise step
// reads it, and the field and obs move as float2 / uchar2 pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cas_common.cuh"
#include "wgmma_ops.cuh"

namespace {

constexpr int kTile = kLd * kLd;                 // elements of one operand tile
constexpr int kWgSmemBytes = 6 * kTile * static_cast<int>(sizeof(__nv_bfloat16));
constexpr uint32_t kCoreBytes = 8 * 16;          // one core matrix: 8 rows x 16 B
constexpr uint32_t kLbo = kCoreBytes;            // next core matrix along K
constexpr uint32_t kSbo = 8 * kCoreBytes;        // next 8 rows: past 8 core matrices
constexpr int kStepElems = 2 * 64;               // one k16 step: two core matrices
constexpr int kHalfElems = 32 * kLd;             // 32 rows: one warpgroup's N half

// Element (r, k) of a 64 x 64 K-major tile: core matrix (r / 8, k / 8) at
// 128-byte block r / 8 * 8 + k / 8, row r % 8 at 16 bytes, k % 8 within it.
__device__ __forceinline__ int tile_idx(int r, int k) {
  return (((r >> 3) * 8 + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}

struct WgTiles {
  __nv_bfloat16 *ch, *cw, *ich, *icw, *zt, *t;
};

__device__ __forceinline__ WgTiles carve_wg_tiles(unsigned char* base) {
  WgTiles s;
  s.ch = reinterpret_cast<__nv_bfloat16*>(base);
  s.cw = s.ch + kTile;
  s.ich = s.cw + kTile;
  s.icw = s.ich + kTile;
  s.zt = s.icw + kTile;
  s.t = s.zt + kTile;
  return s;
}

// The f32 64 x 64 scratch (row stride kLd) of the pooled epilogue: Z^T and T
// together, free once the last transform is done.
__device__ __forceinline__ float* wg_scratch(const WgTiles& s) {
  return reinterpret_cast<float*>(s.zt);
}

struct Own {
  int g, row0, col0;
  __device__ __forceinline__ int row(int e) const { return row0 + 8 * (e >> 1); }
  __device__ __forceinline__ int col(int j, int e) const { return col0 + 8 * j + (e & 1); }
  // Pixels (row(2 hi), col(j, 0)) and its right neighbour lie in the grid.
  __device__ __forceinline__ bool valid(int j, int hi, int H, int W) const {
    return row0 + 8 * hi < H && col0 + 8 * j < W;
  }
};

__device__ __forceinline__ Own make_own(int tid) {
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  Own o;
  o.g = tid >> 7;
  o.row0 = 16 * warp + (lane >> 2);
  o.col0 = 32 * o.g + 2 * (lane & 3);
  return o;
}

// The four (H, H) / (W, W) matrices, transposed and zero-padded to 64 x 64.
__device__ __forceinline__ void load_mats_wg(const WgTiles& s, const float* __restrict__ g_ch,
                                             const float* __restrict__ g_cw,
                                             const float* __restrict__ g_ich,
                                             const float* __restrict__ g_icw, int H, int W,
                                             int tid) {
  for (int idx = tid; idx < kTile; idx += kThreads) {
    const int a = idx / kLd, b = idx % kLd;
    const int t = tile_idx(a, b);
    const bool in_h = a < H && b < H, in_w = a < W && b < W;
    s.ch[t] = __float2bfloat16_rn(in_h ? g_ch[b * H + a] : 0.f);
    s.ich[t] = __float2bfloat16_rn(in_h ? g_ich[b * H + a] : 0.f);
    s.cw[t] = __float2bfloat16_rn(in_w ? g_cw[b * W + a] : 0.f);
    s.icw[t] = __float2bfloat16_rn(in_w ? g_icw[b * W + a] : 0.f);
  }
}

// A field (H, W) row-major in global memory into the fragment (0 off the grid).
__device__ __forceinline__ void load_frag(const float* src, int H, int W, const Own& o,
                                          float v[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float2 q = make_float2(0.f, 0.f);
      if (o.valid(j, hi, H, W))
        q = *reinterpret_cast<const float2*>(src + o.row(2 * hi) * W + o.col(j, 0));
      v[j][2 * hi] = q.x;
      v[j][2 * hi + 1] = q.y;
    }
}

__device__ __forceinline__ void save_frag(float* dst, int H, int W, const Own& o,
                                          const float v[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      if (o.valid(j, hi, H, W))
        *reinterpret_cast<float2*>(dst + o.row(2 * hi) * W + o.col(j, 0)) =
            make_float2(v[j][2 * hi], v[j][2 * hi + 1]);
}

// The transform's operand: Z^T[w][h] = rnd_bf16(v at pixel (h, w)), 0 off the
// grid.  Every thread must call it before wg_transform: together the
// threads write all 64 x 64 entries.
__device__ __forceinline__ void store_operand(__nv_bfloat16* zt, const float v[4][4],
                                              const Own& o, int H, int W) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const bool in = o.valid(j, hi, H, W);
#pragma unroll
      for (int e = 2 * hi; e < 2 * hi + 2; ++e)
        zt[tile_idx(o.col(j, e), o.row(e))] = __float2bfloat16_rn(in ? v[j][e] : 0.f);
    }
}

// d = A B over K = 64 for this warpgroup's 64 x 32 block: A the 64 x 64 tile
// a, B the 32 rows of tile b at b_half.
__device__ __forceinline__ void wg_product(const __nv_bfloat16* a, const __nv_bfloat16* b_half,
                                           float d[4][4]) {
  wgmma_fence_operand(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_m64n32k16_bf16(d, wgmma_desc(a + s * kStepElems, kLbo, kSbo),
                         wgmma_desc(b_half + s * kStepElems, kLbo, kSbo), s);
  wgmma_commit();
  wgmma_wait_all();
  wgmma_fence_operand(d);
}

// out = Mh^T Z Mw for the operand every thread has just written with
// store_operand; out in this thread's fragment.  Every thread must call it:
// it holds two barriers.
__device__ __forceinline__ void wg_transform(const WgTiles& s, const __nv_bfloat16* mh,
                                             const __nv_bfloat16* mw, const Own& o,
                                             float out[4][4]) {
  fence_proxy_async();
  __syncthreads();                               // Z^T complete, T free
  float t[4][4];
  wg_product(mh, s.zt + o.g * kHalfElems, t);    // T[k][w], this warpgroup's w
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      *reinterpret_cast<__nv_bfloat162*>(s.t + tile_idx(o.row(2 * hi), o.col(j, 0))) =
          __floats2bfloat162_rn(t[j][2 * hi], t[j][2 * hi + 1]);
  fence_proxy_async();
  __syncthreads();                               // T complete
  wg_product(s.t, mw + o.g * kHalfElems, out);   // out[k][l], this warpgroup's l
}

// The field epilogue of emit_field_epilogue (cas_common.cuh) on a field held
// in the fragment layout: stats [sum(u-c), sum((u-c)^2), n_finite] and the
// uint8 obs (uchar2 pairs at ds == 1; at ds > 1 the centered field goes
// through the f32 scratch and is mean-pooled).  Every thread must call it;
// it ends with a barrier, so the caller may reuse the tiles and red at once.
__device__ __forceinline__ void emit_field_epilogue_wg(const float u[4][4], float* scratch,
                                                       float (*red)[3], const Epilogue& ep,
                                                       int env, int H, int W, int tid,
                                                       const Own& o) {
  if (ep.ds > 1) __syncthreads();                // the last product 2 is done with T
  float s1 = 0.f, s2 = 0.f, nf = 0.f;
  unsigned char* oe = ep.obs + static_cast<size_t>(env) * (H / ep.ds) * (W / ep.ds);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (!o.valid(j, hi, H, W)) continue;
      const int r = o.row(2 * hi), c = o.col(j, 0);
      float uz[2];
      unsigned char q[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = u[j][2 * hi + e];
        const bool fin = isfinite(x);
        uz[e] = fin ? x - ep.center : 0.f;
        s1 += uz[e];
        s2 += uz[e] * uz[e];
        nf += fin ? 1.f : 0.f;
        q[e] = static_cast<unsigned char>(
            fminf(fmaxf((fin ? x : 0.f) * ep.scale + ep.offset, 0.f), 255.f));
      }
      if (ep.ds == 1) {
        *reinterpret_cast<uchar2*>(oe + r * W + c) = make_uchar2(q[0], q[1]);
      } else {
        scratch[r * kLd + c] = uz[0];
        scratch[r * kLd + c + 1] = uz[1];
      }
    }
  block_sum3(s1, s2, nf, red, tid);              // its barrier also completes scratch
  if (tid == 0) {
    float* st = ep.stats + static_cast<size_t>(env) * 3;
    st[0] = s1;
    st[1] = s2;
    st[2] = nf;
  }
  if (ep.ds > 1) {
    const int ds = ep.ds, Hd = H / ds, Wd = W / ds;
    const float inv = 1.0f / static_cast<float>(ds);
    for (int p = tid; p < Hd * Wd; p += kThreads) {
      const int hd = p / Wd, wd = p % Wd;
      float acc = 0.f;
      for (int w = 0; w < ds; ++w) {
        float t = 0.f;
        for (int h = 0; h < ds; ++h) t += scratch[(hd * ds + h) * kLd + wd * ds + w] * inv;
        acc += t * inv;
      }
      oe[p] = static_cast<unsigned char>(
          fminf(fmaxf((acc + ep.center) * ep.scale + ep.offset, 0.f), 255.f));
    }
  }
  __syncthreads();                               // red and the scratch free again
}

}  // namespace
