// The cas transform for grids above 64 x 64 (the tiled kernels of K1-K3 in
// ch_cas_macro.cu, K4 in ac_cas_macro.cu, K5 in gpe_strang_macro.cu and K6
// in bv_cc_macro.cu; K7 in sbm_bv_macro.cu takes its grid limits and
// `tiled` from here),
// where one env's fields, spectrum and intermediate no longer fit a block's
// registers and shared memory (one f32 field is 64 KB at 128^2, 256 KB at
// 256^2).
//
//   transform(Z) = Mh^T Z Mw     (as cas_common.cuh, in the JAX order)
//
// An env's per-pixel planes live in device memory (the field in the output,
// the rest in this block's slot of a scratch the wrapper allocates): the
// operand Z and the intermediate T are H x W planes, read back through L2.
// Each product walks its 64 x 64 output tiles one after another; a tile sums
// over the contraction in 64-wide chunks, and every chunk of A and B comes
// into shared memory by cp.async through a ring of stages, kStages - 1
// chunks ahead of the product that reads them (zero past the grid).  So any
// H and W that are multiples of 8 up to kTiledMaxGrid take the same code,
// square or not:
//
// - bf16 matrices: both products on the tensor cores, as cas_wgmma.cuh
//   (`wgmma` m64n32k16, the block's two warpgroups splitting each tile's 64
//   columns, chunks K-major in its core-matrix layout `tile_idx`).  Z and T
//   are stored as bf16 planes, the matrices come as bf16 copies, so a 16-byte
//   copy is one row of a core matrix.  Z is rounded to bf16 as it is
//   written, T as it is stored: the JAX rounding sites.  Both operands of a
//   wgmma are K-major, so Z is kept transposed ([w][h]) and the matrices,
//   which are symmetric (C[x][k] = cas(2 pi x k / N), C/N, rounded entry by
//   entry), are read as they are: every copy reads along a row.  Four
//   stages of 16 KB.
// - f32 matrices: FMA on the CUDA cores, a 4 x 4 output block a thread
//   (cas_common.cuh's layout), f32 planes and chunks stored [k][.]; T is
//   stored transposed ([w][k]) so that every copy reads along a row here
//   too.  Three stages of 32 KB.
//
// Product 2's output never goes back to memory as a plane: each thread hands
// its pixels, two neighbours along W at a time, to the caller's epilogue,
// which reads and writes the env's planes at those pixels alone (the next
// operand included).  The padded terms are exact zeros, and a NaN in an env
// reaches only the padded rows and columns of its own T and output, which
// nothing stores.
//
// Bound: the products' 2 H W (H + W) operations a transform, as at 64^2.
// This first tiled design is held back by device memory instead: the planes
// go out to memory and back every transform (the slots of all resident
// blocks outgrow the 50 MB L2), and every output tile re-reads its chunks.
// Keeping an env's state on chip (a cluster of blocks sharing it through
// distributed shared memory) is later work.

#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "cas_common.cuh"
#include "cas_wgmma.cuh"

namespace {

constexpr int kTiledMaxGrid = 256;    // largest H, W the tiled kernels take
constexpr int kChunk = 64;            // output tile edge and contraction chunk
constexpr int kStagesWg = 4, kStagesFma = 3;
constexpr int kStageElems = 2 * kTile;                 // an A and a B chunk
constexpr int kTiledSmemWg = kStagesWg * kStageElems * static_cast<int>(sizeof(__nv_bfloat16));
constexpr int kTiledSmemFma = kStagesFma * kStageElems * static_cast<int>(sizeof(float));

// The element type of the operand and intermediate planes and of the
// matrices a tiled product reads.
template <bool kBf16>
using Op = std::conditional_t<kBf16, __nv_bfloat16, float>;

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// A polynomial (mu, R) at a pixel pair.
__device__ __forceinline__ float2 mu2(const MuPoly& mu, float2 x) {
  return make_float2(mu_eval(mu, x.x), mu_eval(mu, x.y));
}

// Chunk copies, one 16-byte cp.async each, zero where the source lies past
// the grid.  Tensor cores: rows [r0, r0 + 64) and contraction [k0, k0 + 64)
// of a bf16 plane stored [r][k] into a K-major core-matrix tile (two copies
// a thread).  FMA: contraction [k0, k0 + 64) and columns [c0, c0 + 64) of an
// f32 plane stored [k][c] into a row-major tile (four copies a thread).
__device__ __forceinline__ void copy_chunk_wg(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int ld, int r0, int rows, int k0, int depth,
                                              int tid) {
#pragma unroll
  for (int i = 0; i < kTile / 8 / kThreads; ++i) {
    const int q = tid + i * kThreads, r = q >> 3, k = (q & 7) * 8;
    const bool in = r0 + r < rows && k0 + k < depth;
    cp_async16_zfill(dst + tile_idx(r, k),
                     in ? src + static_cast<size_t>(r0 + r) * ld + k0 + k : src, in);
  }
}

__device__ __forceinline__ void copy_chunk_fma(float* dst, const float* src, int ld, int k0,
                                               int depth, int c0, int cols, int tid) {
#pragma unroll
  for (int i = 0; i < kTile / 4 / kThreads; ++i) {
    const int q = tid + i * kThreads, k = q >> 4, c = (q & 15) << 2;
    const bool in = k0 + k < depth && c0 + c < cols;
    cp_async16_zfill(dst + k * kChunk + c,
                     in ? src + static_cast<size_t>(k0 + k) * ld + c0 + c : src, in);
  }
}

// The output tiles of a product, one after another: tile i at rows m0 = 64
// (i / nt), columns n0 = 64 (i % nt), summed over the contraction in chunks;
// step st is chunk st % kc of tile st / kc.
struct TileWalk {
  int nt, kc, steps;
  __device__ __forceinline__ TileWalk(int M, int N, int depth)
      : nt((N + kChunk - 1) / kChunk),
        kc((depth + kChunk - 1) / kChunk),
        steps((M + kChunk - 1) / kChunk * nt * kc) {}
  __device__ __forceinline__ int m0(int st) const { return st / kc / nt * kChunk; }
  __device__ __forceinline__ int n0(int st) const { return st / kc % nt * kChunk; }
  __device__ __forceinline__ int k0(int st) const { return st % kc * kChunk; }
  __device__ __forceinline__ bool last(int st) const { return st % kc == kc - 1; }
};

// Every 64 x 64 output tile of A B^T on the tensor cores (A: M rows, B: N
// rows, both bf16 planes stored [row][contraction] over the depth):
// done(m0, n0, d) with this warpgroup's 32 columns of the tile in d, in the
// fragment layout of `Own`.  Every thread must call it; it opens with a
// barrier (the caller's writes of A and B complete, the last product done
// with the ring).
template <class Done>
__device__ __forceinline__ void tiled_product_wg(__nv_bfloat16* ring, const __nv_bfloat16* a,
                                                 int lda, int M, const __nv_bfloat16* b,
                                                 int ldb, int N, int depth, int tid,
                                                 const Own& o, Done&& done) {
  const TileWalk tw(M, N, depth);
  auto issue = [&](int st) {                     // chunk st into its stage
    if (st < tw.steps) {
      __nv_bfloat16* sa = ring + (st % kStagesWg) * kStageElems;
      copy_chunk_wg(sa, a, lda, tw.m0(st), M, tw.k0(st), depth, tid);
      copy_chunk_wg(sa + kTile, b, ldb, tw.n0(st), N, tw.k0(st), depth, tid);
    }
    cp_async_commit();
  };
  float d[4][4];
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStagesWg - 1; ++st) issue(st);
  for (int st = 0; st < tw.steps; ++st) {
    cp_async_wait_group<kStagesWg - 2>();        // this thread's copies of chunk st landed
    fence_proxy_async();
    __syncthreads();                             // every thread's; step st - 1 is done
    issue(st + kStagesWg - 1);                   // into step st - 1's stage
    const __nv_bfloat16* sa = ring + (st % kStagesWg) * kStageElems;
    const __nv_bfloat16* sb = sa + kTile + o.g * kHalfElems;
    const int k0 = tw.k0(st);
    wgmma_fence_operand(d);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64nNk16_bf16<32>(d, wgmma_desc(sa + s * kStepElems, kLbo, kSbo),
                              wgmma_desc(sb + s * kStepElems, kLbo, kSbo), (k0 | s) != 0);
    wgmma_commit();
    wgmma_wait_all();
    wgmma_fence_operand(d);
    if (tw.last(st)) done(tw.m0(st), tw.n0(st), d);
  }
}

// The same on the CUDA cores (f32 FMA), A and B f32 planes stored [k][m] and
// [k][n]: done(m0, n0, acc) with acc[i][j] the output at (m0 + ty4 + i,
// n0 + tx4 + j), summed in k order.
template <class Done>
__device__ __forceinline__ void tiled_product_fma(float* ring, const float* a, int lda, int M,
                                                  const float* b, int ldb, int N, int depth,
                                                  int tid, Done&& done) {
  const TileWalk tw(M, N, depth);
  const int ty4 = (tid >> 4) << 2, tx4 = (tid & 15) << 2;
  auto issue = [&](int st) {
    if (st < tw.steps) {
      float* sa = ring + (st % kStagesFma) * kStageElems;
      copy_chunk_fma(sa, a, lda, tw.k0(st), depth, tw.m0(st), M, tid);
      copy_chunk_fma(sa + kTile, b, ldb, tw.k0(st), depth, tw.n0(st), N, tid);
    }
    cp_async_commit();
  };
  float acc[4][4];
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStagesFma - 1; ++st) issue(st);
  for (int st = 0; st < tw.steps; ++st) {
    cp_async_wait_group<kStagesFma - 2>();
    __syncthreads();
    issue(st + kStagesFma - 1);
    if (tw.k0(st) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const float* sa = ring + (st % kStagesFma) * kStageElems;
    const float* sb = sa + kTile;
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(sa + k * kChunk + ty4);
      const float4 bv = *reinterpret_cast<const float4*>(sb + k * kChunk + tx4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (tw.last(st)) done(tw.m0(st), tw.n0(st), acc);
  }
}

// The operand plane z (an H x W plane of the slot) keeps pixel (h, w)
// transposed as bf16 ([w][h]) on the tensor-core path, whose product 1 reads
// Z^T row by row, and row-major as f32 ([h][w]) on the FMA path, which reads
// Z.  put_z writes pixels (h, w) and (h, w + 1), put_z4 the pixels p .. p + 3
// (row-major index, p a multiple of 4).
template <bool kBf16>
__device__ __forceinline__ void put_z(float* z, int h, int w, int H, int W, float2 v) {
  if constexpr (kBf16) {
    __nv_bfloat16* zt = reinterpret_cast<__nv_bfloat16*>(z);
    zt[w * H + h] = __float2bfloat16_rn(v.x);
    zt[(w + 1) * H + h] = __float2bfloat16_rn(v.y);
  } else {
    st2(z + h * W + w, v);
  }
}

template <bool kBf16>
__device__ __forceinline__ void put_z4(float* z, int p, int H, int W, float4 v) {
  const int h = p / W, w = p % W;
  put_z<kBf16>(z, h, w, H, W, make_float2(v.x, v.y));
  put_z<kBf16>(z, h, w + 2, H, W, make_float2(v.z, v.w));
}

// out = Mh^T Z Mw for the operand plane z (as put_z lays it out); t is the
// intermediate's plane; mh, mw the matrices, bf16 copies on the tensor-core
// path.
//
// The caller's epilogue apply(k, l, v) gets out at pixels (k, l) and
// (k, l + 1) in (v.x, v.y), and reads and writes the env's planes there
// alone; every pair of the grid is applied once, by one thread.  Every thread
// must call it: each product opens with a barrier (the caller's writes of
// z, then product 1's of t, complete).  The epilogue runs after the last
// barrier, so a caller that writes a plane next puts a barrier first.
template <bool kBf16, class Apply>
__device__ __forceinline__ void tiled_transform(unsigned char* smem, float* z, float* t,
                                                const Op<kBf16>* __restrict__ mh,
                                                const Op<kBf16>* __restrict__ mw, int H, int W,
                                                int tid, Apply&& apply) {
  if constexpr (kBf16) {
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* zt = reinterpret_cast<__nv_bfloat16*>(z);
    __nv_bfloat16* tb = reinterpret_cast<__nv_bfloat16*>(t);
    const Own o = make_own(tid);
    // T[k][w] = sum_h Mh[k][h] Z^T[w][h], rounded to bf16 as it is stored.
    tiled_product_wg(ring, mh, H, H, zt, H, W, H, tid, o, [&](int m0, int n0, float (*d)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = m0 + o.row(2 * hi), c = n0 + o.col(j, 0);
          if (r < H && c < W)
            *reinterpret_cast<__nv_bfloat162*>(tb + r * W + c) =
                __floats2bfloat162_rn(d[j][2 * hi], d[j][2 * hi + 1]);
        }
    });
    // out[k][l] = sum_w T[k][w] Mw[l][w]
    tiled_product_wg(ring, tb, W, H, mw, W, W, W, tid, o, [&](int m0, int n0, float (*d)[4]) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = m0 + o.row(2 * hi), c = n0 + o.col(j, 0);
          if (r < H && c < W) apply(r, c, make_float2(d[j][2 * hi], d[j][2 * hi + 1]));
        }
    });
  } else {
    float* ring = reinterpret_cast<float*>(smem);
    const int ty4 = (tid >> 4) << 2, tx4 = (tid & 15) << 2;
    // T[k][w] = sum_h Mh[h][k] Z[h][w], stored [w][k] so that product 2
    // reads it as a [k][m] plane.
    tiled_product_fma(ring, mh, H, H, z, W, W, H, tid, [&](int m0, int n0, float (*acc)[4]) {
      const int r = m0 + ty4, c = n0 + tx4;
      if (r < H && c < W) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(t + (c + j) * H + r) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    });
    // out[k][l] = sum_w T[k][w] Mw[w][l]
    tiled_product_fma(ring, t, H, H, mw, W, W, W, tid, [&](int m0, int n0, float (*acc)[4]) {
      const int r = m0 + ty4, c = n0 + tx4;
      if (r < H && c < W) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; j += 2) apply(r + i, c + j, make_float2(acc[i][j], acc[i][j + 1]));
      }
    });
  }
}

// The field epilogue (emit_field_epilogue's stats and obs) on the env's
// final field u, an H x W plane in device memory.  Every thread must call
// it; it opens with a barrier (the field's last writes complete) and ends
// with one (red free again).
__device__ __forceinline__ void tiled_field_epilogue(const float* u, float (*red)[3],
                                                     const Epilogue& ep, int env, int H, int W,
                                                     int tid) {
  __syncthreads();
  const int hw = H * W, ds = ep.ds, Hd = H / ds, Wd = W / ds;
  unsigned char* oe = ep.obs + static_cast<size_t>(env) * Hd * Wd;
  float s1 = 0.f, s2 = 0.f, nf = 0.f;
  for (int p = 2 * tid; p < hw; p += 2 * kThreads) {
    const float2 x = ld2(u + p);
    const float xs[2] = {x.x, x.y};
    unsigned char q[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool fin = isfinite(xs[e]);
      const float uz = fin ? xs[e] - ep.center : 0.f;
      s1 += uz;
      s2 += uz * uz;
      nf += fin ? 1.f : 0.f;
      q[e] = static_cast<unsigned char>(
          fminf(fmaxf((fin ? xs[e] : 0.f) * ep.scale + ep.offset, 0.f), 255.f));
    }
    if (ds == 1) *reinterpret_cast<uchar2*>(oe + p) = make_uchar2(q[0], q[1]);
  }
  block_sum3(s1, s2, nf, red, tid);
  if (tid == 0) {
    float* st = ep.stats + static_cast<size_t>(env) * 3;
    st[0] = s1;
    st[1] = s2;
    st[2] = nf;
  }
  if (ds > 1) {
    const float inv = 1.0f / static_cast<float>(ds);
    for (int p = tid; p < Hd * Wd; p += kThreads) {
      const int hd = p / Wd, wd = p % Wd;
      float acc = 0.f;
      for (int w = 0; w < ds; ++w) {
        float t = 0.f;
        for (int h = 0; h < ds; ++h) {
          const float x = u[(hd * ds + h) * W + wd * ds + w];
          t += (isfinite(x) ? x - ep.center : 0.f) * inv;
        }
        acc += t * inv;
      }
      oe[p] = static_cast<unsigned char>(
          fminf(fmaxf((acc + ep.center) * ep.scale + ep.offset, 0.f), 255.f));
    }
  }
  __syncthreads();
}

bool bad_tiled_grid(int B, int H, int W, int n_steps) {
  return B < 1 || H < 8 || W < 8 || H > kTiledMaxGrid || W > kTiledMaxGrid || H % 8 || W % 8 ||
         n_steps < 0;
}

// Whether a grid runs the tiled kernels of its family (above 64 x 64) or the
// one-block-an-env kernels of cas_common.cuh / cas_wgmma.cuh.
bool tiled(int H, int W) { return H > kLd || W > kLd; }

// The bf16 copies of the matrices that the tiled tensor-core kernels read.
const __nv_bfloat16* B16(const void* p) { return static_cast<const __nv_bfloat16*>(p); }

bool bad_mats16(const void* ch16, const void* cw16, const void* ich16, const void* icw16) {
  return ch16 == nullptr || cw16 == nullptr || ich16 == nullptr || icw16 == nullptr;
}

// The scratch a tiled kernel needs: `slots` blocks resident at once, each
// with a slot of `planes` H x W f32 planes (`floats` f32).
template <class Kernel>
cudaError_t tiled_scratch(Kernel kernel, bool bf16, long long planes, int H, int W, int* slots,
                          long long* floats) {
  *floats = planes * H * W;
  return resident_blocks(kernel, slots, bf16 ? kTiledSmemWg : kTiledSmemFma);
}

// Launches a tiled kernel on min(B, n_slots) blocks, one scratch slot each.
template <class Kernel, class... Args>
cudaError_t launch_tiled(Kernel kernel, bool bf16, int B, int n_slots, cudaStream_t st,
                         Args... args) {
  const int smem = bf16 ? kTiledSmemWg : kTiledSmemFma;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B < n_slots ? B : n_slots, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace
