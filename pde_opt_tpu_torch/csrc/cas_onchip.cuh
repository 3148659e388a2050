// The cas transform with one env's whole state on chip, for square grids
// above 64 x 64 up to 128 x 128 with bf16 matrices (ch_cas_macro.cu: the
// on-chip K1/K2, ch_cas_macro_onchip_kernel).  Beside cas_wgmma.cuh (64^2
// and below) and cas_tiled.cuh (the planes in device memory, up to 256^2).
//
//   transform(Z) = Mh^T Z Mw     (as cas_common.cuh, in the JAX order)
//
// A block of kOcThreads = 512 threads (four warpgroups) owns one env at a
// time and pads every grid to 128 x 128.  Both products run as `wgmma`
// m64n64k16 bf16 over the full contraction: eight k16 steps issued back to
// back, one commit and one wait a product, no barrier inside it.  Warpgroup
// g = 2 ng + mg takes output rows [64 mg, 64 mg + 64) and columns
// [64 ng, 64 ng + 64) of T and then of out.  A block barrier sits before
// each product (the operand complete; before product 1 also the previous
// product 2 done with T).
//
// Shared memory (kOcSmemBytes, 226.5 KB): the matrices C and C/N, Z^T and
// T, four 128 x 128 bf16 tiles K-major in the unswizzled core-matrix layout
// (`oc_idx`: LBO 128 B along K, SBO 2048 B to the next 8 rows); one f32
// field of the caller's (`OcTiles::ut`, 64 KB, each thread's 32 values as
// float2 pairs at stride kOcThreads, `oc_pair`); and a region of 34.5 KB
// that holds either a folded table of per-pixel float2 pairs
// (`OcTiles::fold`, `oc_fold_idx`) and the f64 axis symbols of the FD
// Laplacian at the folded indices, or (OcMult::kRebuild) the symbols lam_h,
// lam_w of every index (zero past the grid).  The grid is square, so C_H =
// C_W = C: one tile is product 1's A and product 2's B.
// The matrices are loaded once a block, transposed and zero-padded as
// load_mats_wg does, from the bf16 copies; nothing of an env's per-pixel
// state goes to device memory between transforms.  A second field in
// registers (32 more a thread beside the field and the accumulator)
// spilled at the 128-register cap of 512 threads, and the spills went
// through L2 (the L1 left beside 194 KB of shared memory is ~30 KB): so one
// field lives in shared memory.  Z is rounded to bf16 as it is written, T as
// it is stored: the JAX rounding sites.  A NaN in an env reaches only padded
// rows of its own T and output, which nothing stores or sums, and every
// transform rewrites all of Z^T and T.
//
// Pixel ownership (`OcOwn`): each thread owns the 32 pixels of its m64n64
// accumulator fragment, f[j][e] (j < 8) at row row0 + 8 (e / 2), column
// col0 + 8 j + e % 2, with row0 = 64 mg + 16 warp + lane / 4 and col0 =
// 64 ng + 2 (lane % 4); the caller's per-pixel f32 fields live in that
// layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cas_common.cuh"
#include "cas_wgmma.cuh"
#include "wgmma_ops.cuh"

namespace {

constexpr int kOcThreads = 512;                  // four warpgroups
constexpr int kOcWarps = kOcThreads / 32;
constexpr int kOcMaxGrid = 128;                  // largest H, W; every grid pads to it
constexpr int kOcTile = kOcMaxGrid * kOcMaxGrid; // elements of one operand tile
constexpr int kOcHalf = 64 * kOcMaxGrid;         // 64 rows: one warpgroup's M or N half
constexpr uint32_t kOcSbo = 16 * kCoreBytes;     // next 8 rows: past 16 core matrices
constexpr int kOcFold = kOcMaxGrid / 2 + 1;      // folded indices of an axis, 0 .. N / 2
// The folded table's stride: 66 = 2 mod 8 float2, so that a half-warp's
// 4 rows x 4 columns two apart (oc_fold_idx) fall in 16 distinct 8-byte banks.
constexpr int kOcFoldLd = kOcFold + 1;
constexpr int kOcFoldBytes = kOcFold * kOcFoldLd * static_cast<int>(sizeof(float2));
constexpr int kOcTableBytes = kOcFoldBytes + 2 * kOcFold * static_cast<int>(sizeof(double));
constexpr int kOcSymBytes = 2 * kOcMaxGrid * static_cast<int>(sizeof(double));
constexpr int kOcSmemBytes = 4 * kOcTile * static_cast<int>(sizeof(__nv_bfloat16)) +
                             kOcTile * static_cast<int>(sizeof(float)) +
                             (kOcTableBytes > kOcSymBytes ? kOcTableBytes : kOcSymBytes);

// Where a kernel on these tiles finds a pixel's multipliers: rebuilt every
// time from the symbols (kRebuild), or read from the folded table (kTable),
// at constant offsets on a 128 x 128 grid (kTable128, OcFoldAt).
enum class OcMult { kRebuild, kTable, kTable128 };

// Element (r, k) of a 128 x 128 K-major tile: core matrix (r / 8, k / 8) at
// 128-byte block r / 8 * 16 + k / 8, row r % 8 at 16 bytes, k % 8 within it.
__device__ __forceinline__ int oc_idx(int r, int k) {
  return (((r >> 3) * 16 + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}

struct OcTiles {
  __nv_bfloat16 *c, *ic, *zt, *t;
  float2* ut;
  float2* fold;           // the folded table (not with kRebuild)
  double *lam_h, *lam_w;  // the symbols: kOcFold each after the table, or
                          // kOcMaxGrid each in its place (kRebuild)
};

__device__ __forceinline__ OcTiles carve_oc_tiles(unsigned char* base, bool table) {
  OcTiles s;
  s.c = reinterpret_cast<__nv_bfloat16*>(base);
  s.ic = s.c + kOcTile;
  s.zt = s.ic + kOcTile;
  s.t = s.zt + kOcTile;
  s.ut = reinterpret_cast<float2*>(s.t + kOcTile);
  s.fold = s.ut + kOcTile / 2;
  s.lam_h = reinterpret_cast<double*>(table ? s.fold + kOcFold * kOcFoldLd : s.fold);
  s.lam_w = s.lam_h + (table ? kOcFold : kOcMaxGrid);
  return s;
}

// The folded index of row or column i of an N x N grid, i < kOcMaxGrid:
// min(i, N - i), and 0 past the grid (N <= i), where the symbol is 0 as it
// is at index 0.  The FD symbols satisfy lam[i] = lam[N - i] in f64 up to an
// ulp; cas_constants checks that the f32 planes built from them agree with
// their folded entries bit for bit (CasConstants.fold) before a launch
// relies on it.
__device__ __forceinline__ int oc_fold(int i, int N) {
  const int f = i < N - i ? i : N - i;
  return f > 0 ? f : 0;
}

// Entry (fi, fj) of the folded table, column-major at stride kOcFoldLd.
__device__ __forceinline__ int oc_fold_idx(int fi, int fj) { return fj * kOcFoldLd + fi; }

// This thread's pair (j, hi) of a field kept in shared memory (OcTiles::ut):
// pixels (row(2 hi), col(j, 0)) and its right neighbour.  Consecutive
// threads read consecutive 8 bytes, so a warp's access has no bank conflict.
__device__ __forceinline__ float2& oc_pair(float2* field, int j, int hi, int tid) {
  return field[(2 * j + hi) * kOcThreads + tid];
}

// The f32 128 x 128 scratch (row stride kOcMaxGrid) of the pooled epilogue:
// Z^T and T together, free once the last transform is done.
__device__ __forceinline__ float* oc_scratch(const OcTiles& s) {
  return reinterpret_cast<float*>(s.zt);
}

struct OcOwn {
  int mg, ng, row0, col0;
  __device__ __forceinline__ int row(int e) const { return row0 + 8 * (e >> 1); }
  __device__ __forceinline__ int col(int j, int e) const { return col0 + 8 * j + (e & 1); }
  // oc_idx(col(j, e), row(e)) and oc_idx(row(2 hi), col(j, 0)) as constant
  // offsets from one base each (col0 % 8 + 1 < 8, so no carry crosses a core
  // matrix): the compiler would otherwise keep 48 addresses live across the
  // loops.
  __device__ __forceinline__ int zt_idx(int j, int e) const {
    return oc_idx(col0, row0) + 1024 * j + 64 * (e >> 1) + 8 * (e & 1);
  }
  __device__ __forceinline__ int t_idx(int j, int hi) const {
    return oc_idx(row0, col0) + 1024 * hi + 64 * j;
  }
  // Pixels (row(2 hi), col(j, 0)) and its right neighbour lie in the grid.
  __device__ __forceinline__ bool valid(int j, int hi, int H, int W) const {
    return row0 + 8 * hi < H && col0 + 8 * j < W;
  }
};

__device__ __forceinline__ OcOwn make_oc_own(int tid) {
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = tid >> 7;
  OcOwn o;
  o.mg = g & 1;
  o.ng = g >> 1;
  o.row0 = 64 * o.mg + 16 * warp + (lane >> 2);
  o.col0 = 64 * o.ng + 2 * (lane & 3);
  return o;
}

// Where this thread finds the folded-table entry of its pixel (row(2 hi),
// col(j, e)): at base[hi] + step * (8 j + e) on a 128 x 128 grid
// (kTable128), where every row of a thread lies in one half of the grid
// and so does every column, the fold there being i or 128 - i (so the
// entries of a hi lie on from that of col(0, 0), mirrored in the upper
// half); else each column is folded as it is read (oc_fold).
template <OcMult kMult>
struct OcFoldAt {
  int base[2];  // entry (oc_fold(row(2 hi)), oc_fold(col(0, 0))), column 0 with kTable
  int step;     // kTable128: +-kOcFoldLd, the next column's offset

  __device__ __forceinline__ float2 at(const float2* fold, const OcOwn& o, int N, int j, int e,
                                       int hi) const {
    if constexpr (kMult == OcMult::kTable128) return fold[base[hi] + step * (8 * j + e)];
    else return fold[base[hi] + kOcFoldLd * oc_fold(o.col(j, e), N)];
  }
};

template <OcMult kMult>
__device__ __forceinline__ OcFoldAt<kMult> make_oc_fold_at(const OcOwn& o, int N) {
  OcFoldAt<kMult> a;
  const int c0 = o.col(0, 0);
  const int fc0 = kMult == OcMult::kTable128 ? oc_fold(c0, N) : 0;
  for (int hi = 0; hi < 2; ++hi) a.base[hi] = oc_fold_idx(oc_fold(o.row(2 * hi), N), fc0);
  a.step = c0 < N - c0 ? kOcFoldLd : -kOcFoldLd;
  return a;
}

// The (N, N) bf16 matrices C and C/N, transposed and zero-padded to
// 128 x 128.
__device__ __forceinline__ void load_mats_oc(const OcTiles& s,
                                             const __nv_bfloat16* __restrict__ g_c,
                                             const __nv_bfloat16* __restrict__ g_ic, int N,
                                             int tid) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int idx = tid; idx < kOcTile; idx += kOcThreads) {
    const int a = idx / kOcMaxGrid, b = idx % kOcMaxGrid;
    const int t = oc_idx(a, b);
    const bool in = a < N && b < N;
    s.c[t] = in ? g_c[b * N + a] : zero;
    s.ic[t] = in ? g_ic[b * N + a] : zero;
  }
}

// The axis symbols of indices 0 .. n - 1 (n = kOcFold beside the table,
// kOcMaxGrid without it), zero past the grid.
__device__ __forceinline__ void load_symbols_oc(const OcTiles& s,
                                                const double* __restrict__ lam_h,
                                                const double* __restrict__ lam_w, int n, int N,
                                                int tid) {
  for (int i = tid; i < n; i += kOcThreads) {
    s.lam_h[i] = i < N ? lam_h[i] : 0.0;
    s.lam_w[i] = i < N ? lam_w[i] : 0.0;
  }
}

// A field (H, W) row-major in global memory into the fragment (0 off the grid).
__device__ __forceinline__ void load_frag_oc(const float* src, int H, int W, const OcOwn& o,
                                             float v[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float2 q = make_float2(0.f, 0.f);
      if (o.valid(j, hi, H, W))
        q = *reinterpret_cast<const float2*>(src + o.row(2 * hi) * W + o.col(j, 0));
      v[j][2 * hi] = q.x;
      v[j][2 * hi + 1] = q.y;
    }
}

__device__ __forceinline__ void save_frag_oc(float* dst, int H, int W, const OcOwn& o,
                                             const float v[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      if (o.valid(j, hi, H, W))
        *reinterpret_cast<float2*>(dst + o.row(2 * hi) * W + o.col(j, 0)) =
            make_float2(v[j][2 * hi], v[j][2 * hi + 1]);
}

// The transform's operand: Z^T[w][h] = rnd_bf16(v at pixel (h, w)), 0 off the
// grid.  Every thread must call it before oc_transform: together the
// threads write all 128 x 128 entries.
__device__ __forceinline__ void store_operand_oc(__nv_bfloat16* zt, const float v[8][4],
                                                 const OcOwn& o, int H, int W) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const bool in = o.valid(j, hi, H, W);
      // One packed conversion for the pair, stored as two bf16 a column
      // apart in Z^T.
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(in ? v[j][2 * hi] : 0.f, in ? v[j][2 * hi + 1] : 0.f);
      zt[o.zt_idx(j, 2 * hi)] = p.x;
      zt[o.zt_idx(j, 2 * hi + 1)] = p.y;
    }
}

// lam and lam2 of a pixel with axis symbols lh, lw, as cas_constants builds
// the planes: lam = f32(lh + lw) and lam2 = f32((lh + lw)^2), the sum and
// its square in f64.  So they equal the planes' entries bit for bit.
__device__ __forceinline__ void oc_lam(double lh, double lw, float& l, float& l2) {
  const double d = lh + lw;
  l = __double2float_rn(d);
  l2 = __double2float_rn(d * d);
}

// lam and lam2 at pixel (row(2 hi), col(j, 0)) and its right neighbour,
// from the symbols in shared memory (load_symbols_oc).
__device__ __forceinline__ void oc_symbols(const OcTiles& s, const OcOwn& o, int j, int hi,
                                           float l[2], float l2[2]) {
  const double lh = s.lam_h[o.row(2 * hi)];
  const double2 lw = *reinterpret_cast<const double2*>(s.lam_w + o.col(j, 0));
  oc_lam(lh, lw.x, l[0], l2[0]);
  oc_lam(lh, lw.y, l[1], l2[1]);
}

// d = A B over K = 128 for this warpgroup's 64 x 64 block: A the 64 rows of
// tile a at a_half, B the 64 rows of tile b at b_half; eight k16 steps
// issued back to back, one commit and one wait.
__device__ __forceinline__ void oc_product(const __nv_bfloat16* a_half,
                                           const __nv_bfloat16* b_half, float d[8][4]) {
  wgmma_fence_operand<8>(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    wgmma_m64nNk16_bf16<64>(d, wgmma_desc(a_half + s * kStepElems, kLbo, kOcSbo),
                            wgmma_desc(b_half + s * kStepElems, kLbo, kOcSbo), s);
  wgmma_commit();
  wgmma_wait_all();
  wgmma_fence_operand<8>(d);
}

// out = M^T Z M (M = C or C/N, both axes) for the operand every thread has
// just written with store_operand_oc; out in this thread's fragment.  T is
// rounded to bf16 as it is stored (the JAX kernel's `.astype(mats)`).  Every
// thread must call it: it holds two barriers.
__device__ __forceinline__ void oc_transform(const OcTiles& s, const __nv_bfloat16* m,
                                             const OcOwn& o, float out[8][4]) {
  fence_proxy_async();
  __syncthreads();                                        // Z^T complete, T free
  float t[8][4];
  oc_product(m + o.mg * kOcHalf, s.zt + o.ng * kOcHalf, t);    // T[k][w]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      *reinterpret_cast<__nv_bfloat162*>(s.t + o.t_idx(j, hi)) =
          __floats2bfloat162_rn(t[j][2 * hi], t[j][2 * hi + 1]);
  fence_proxy_async();
  __syncthreads();                                        // T complete
  oc_product(s.t + o.mg * kOcHalf, m + o.ng * kOcHalf, out);   // out[k][l]
}

// The field epilogue of emit_field_epilogue_wg (cas_wgmma.cuh) on a field in
// the OcOwn fragment: stats and the uint8 obs (uchar2 pairs at ds == 1; at
// ds > 1 the centered field goes through the f32 scratch and is mean-pooled).
// Every thread must call it; it ends with a barrier, so the caller may reuse
// the tiles and red at once.
__device__ __forceinline__ void emit_field_epilogue_oc(const float u[8][4], float* scratch,
                                                       float (*red)[3], const Epilogue& ep,
                                                       int env, int H, int W, int tid,
                                                       const OcOwn& o) {
  if (ep.ds > 1) __syncthreads();                // the last product 2 is done with T
  float s1 = 0.f, s2 = 0.f, nf = 0.f;
  unsigned char* oe = ep.obs + static_cast<size_t>(env) * (H / ep.ds) * (W / ep.ds);
#pragma unroll
  for (int j = 0; j < 8; ++j)
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
        scratch[r * kOcMaxGrid + c] = uz[0];
        scratch[r * kOcMaxGrid + c + 1] = uz[1];
      }
    }
  block_sum3<kOcWarps>(s1, s2, nf, red, tid);    // its barrier also completes scratch
  if (tid == 0) {
    float* st = ep.stats + static_cast<size_t>(env) * 3;
    st[0] = s1;
    st[1] = s2;
    st[2] = nf;
  }
  if (ep.ds > 1) {
    const int ds = ep.ds, Hd = H / ds, Wd = W / ds;
    const float inv = 1.0f / static_cast<float>(ds);
    for (int p = tid; p < Hd * Wd; p += kOcThreads) {
      const int hd = p / Wd, wd = p % Wd;
      float acc = 0.f;
      for (int w = 0; w < ds; ++w) {
        float t = 0.f;
        for (int h = 0; h < ds; ++h)
          t += scratch[(hd * ds + h) * kOcMaxGrid + wd * ds + w] * inv;
        acc += t * inv;
      }
      oe[p] = static_cast<unsigned char>(
          fminf(fmaxf((acc + ep.center) * ep.scale + ep.offset, 0.f), 255.f));
    }
  }
  __syncthreads();                               // red and the scratch free again
}

}  // namespace
