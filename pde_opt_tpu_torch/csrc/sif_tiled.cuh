// The packed real DFT for grids above 64 x 64: the tiled kernels of K9a
// (ch_sif_macro.cu) and K9b (ac_sif_macro.cu), where one env's tables,
// spectra and work buffers no longer fit a block (one f32 plane is 64 KB at
// 128^2; sif_wgmma.cuh holds M = 64 rows along h in one tile).
//
// The transforms are the plain version's (ops/fused_spectral.py
// _dft_transforms), with W2 = W/2 + 1 (half spectrum) or W, and the kept
// spectrum padded to W2p = W2 rounded up to a multiple of 8.  A complex
// spectrum is stored stacked, real part at columns [0, W2p) and imaginary
// part at [W2p, 2 W2p) (K2 = 2 W2p), and every complex product is one real
// product over a doubled contraction:
//
//   stage A  P[c][h]  = sum_w  FW[c][w] X[h][w]          FW = [Wr_w^T; Wi_w^T]
//   stage B  X[c][kh] = sum_k' BB[c][k'] FH[kh][k']       FH = [Wr_h^T | Wi_h^T]
//   stage C  C[h][c]  = sum_k' VH[h][k'] ZZ[c][k']        VH = [Vr_h^T | Vi_h^T]
//   stage D  y[h][w]  = sum_k  CC[h][k] VW[w][k]          VW = [Vr_w^T | -Vi_w^T]
//
// with k' in [0, 2H) and BB (and ZZ, the same for the spectrum Z) the
// operand [[P_r | P_i]; [-P_i | P_r]] laid out by output column: row c < W2p
// (real output kw = c) holds [P_r[.][kw] | -P_i[.][kw]], row W2p + kw
// (imaginary) holds [P_i[.][kw] | P_r[.][kw]].  So each value of P (and of Z)
// is stored twice, once negated for the imaginary part.  CC = [C_r | C_i] is
// stage C's output as it comes.  The JAX kernel sums rr - ii as two f32
// products; one accumulator sums their terms in another order, as the 64^2
// wgmma kernel does.
//
// Each stage is one tiled product of cas_tiled.cuh (64 x 64 output tiles, the
// contraction in 64-wide chunks through the cp.async ring: tensor cores with
// bf16 tables, FMA with f32), whose epilogue gets the output as pairs along
// its columns and writes the next stage's operand there, so that every pair
// lands next to each other along the next product's contraction.  Every
// operand and work plane lives in device memory, in this block's slot of a
// scratch the wrapper allocates ([X, BB, ZZ, CC] and K9a's carried
// spectrum), read back through L2 as the tiled cas kernels read theirs.  The
// tables come from the wrapper (fused_spectral._tiled_tables) in the layout
// of the path: bf16 [row][contraction] for the tensor cores, f32
// [contraction][row] for FMA.
//
// Rounding sites (bf16 tables): X (the operand), P (stage A's output), Z
// (the spectrum handed to the inverse) and CC are stored as bf16, the plain
// version's four rnd(); sums are f32, the carried spectrum and the field f32.
//
// Padding.  At 128^2 (W2 65, W2p 72) the stacked K2 = 144 takes three
// 64-wide tiles, 32 % of their 192 rows past the 130 kept entries; at 256^2
// (W2 129, K2 272) five, 19 %.  64-wide tiles for each part apart would pad
// more: 49 % at 128^2 (two tiles a part), 33 % at 256^2.  The other axis of
// every product is H or W, whole tiles.
// Table entries beyond W2 are zero, so each padded entry of P, X, Z and C is
// an exact zero for a finite env; the epilogues write every entry of every
// plane they own for each env, so a NaN env stays in its env.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cas_tiled.cuh"

namespace {

// The planes of one slot and the dimensions of the spectrum.
template <bool kBf16>
struct SifSlot {
  Op<kBf16>* x;    // stage A's operand X: N = H rows, contraction W
  Op<kBf16>* bb;   // stage B's operand BB: K2 rows, contraction 2H
  Op<kBf16>* zz;   // stage C's operand ZZ: K2 rows, contraction 2H
  Op<kBf16>* cc;   // stage D's operand CC: H rows, contraction K2
  float* uh;       // K9a's carried spectrum, f32 [c][kh]: K2 x H
};

struct SifTiledDims {
  int H, W, W2, W2p, K2;
};

__host__ __device__ inline SifTiledDims sif_tiled_dims(int H, int W, int W2) {
  const int w2p = (W2 + 7) / 8 * 8;
  return SifTiledDims{H, W, W2, w2p, 2 * w2p};
}

// Floats of one slot: X, BB, ZZ and CC as bf16 (tensor cores) or f32, and
// with carry_spectrum K9a's f32 uh.
__host__ __device__ inline long long sif_slot_floats(bool bf16, const SifTiledDims& d,
                                                     bool carry_spectrum) {
  const long long elems = static_cast<long long>(d.H) * d.W + 2LL * (2LL * d.K2 * d.H) +
                          static_cast<long long>(d.H) * d.K2;
  return (bf16 ? elems / 2 : elems) + (carry_spectrum ? static_cast<long long>(d.K2) * d.H : 0);
}

template <bool kBf16>
__device__ __forceinline__ SifSlot<kBf16> carve_sif_slot(float* slot, const SifTiledDims& d) {
  SifSlot<kBf16> s;
  s.x = reinterpret_cast<Op<kBf16>*>(slot);
  s.bb = s.x + static_cast<size_t>(d.H) * d.W;
  s.zz = s.bb + static_cast<size_t>(2) * d.K2 * d.H;
  s.cc = s.zz + static_cast<size_t>(2) * d.K2 * d.H;
  s.uh = reinterpret_cast<float*>(s.cc + static_cast<size_t>(d.H) * d.K2);
  return s;
}

// The tables in the path's layout (see the top of this file).
template <bool kBf16>
struct SifTiledTables {
  const Op<kBf16>* fw;   // K2 x W
  const Op<kBf16>* fh;   // H x 2H
  const Op<kBf16>* vh;   // H x 2H
  const Op<kBf16>* vw;   // W x K2
  const float* lam_t;    // f32 [kw][kh], W2p x H, zero beyond W2
  const float* lam2_t;
};

// Entries (row, k) and (row, k + 1) of an operand plane of `rows` rows over
// the contraction `depth`: [row][k] bf16 on the tensor cores, [k][row] f32
// on FMA.
template <bool kBf16>
__device__ __forceinline__ void put_pair(Op<kBf16>* p, int row, int k, int rows, int depth,
                                         float2 v) {
  if constexpr (kBf16) {
    *reinterpret_cast<__nv_bfloat162*>(p + static_cast<size_t>(row) * depth + k) =
        __floats2bfloat162_rn(v.x, v.y);
  } else {
    p[static_cast<size_t>(k) * rows + row] = v.x;
    p[static_cast<size_t>(k + 1) * rows + row] = v.y;
  }
}

// A spectrum value pair at (part, kw) and contraction rows j, j + 1 (h or kh)
// into the doubled operand BB or ZZ: row part W2p + kw at j, and row (1 -
// part) W2p + kw at H + j, negated for the imaginary part.
template <bool kBf16>
__device__ __forceinline__ void put_spec(Op<kBf16>* p, int c, int j, const SifTiledDims& d,
                                         float2 v) {
  const int part = c >= d.W2p, kw = c - part * d.W2p;
  put_pair<kBf16>(p, c, j, d.K2, 2 * d.H, v);
  put_pair<kBf16>(p, (1 - part) * d.W2p + kw, d.H + j, d.K2, 2 * d.H,
                  part ? make_float2(-v.x, -v.y) : v);
}

// Every output pair of A B^T (A: M rows, B: N rows, over `depth`, both
// operand planes in the path's layout): apply(r, c, v) with the output at
// (r, c) and (r, c + 1) in (v.x, v.y), every pair once, by one thread.
// Every thread must call it: it opens with a barrier (the caller's writes of
// A and B complete, the last product done with the ring), and the epilogue
// runs after its last barrier.
template <bool kBf16, class Apply>
__device__ __forceinline__ void sif_pairs(unsigned char* smem, const Op<kBf16>* a, int M,
                                          const Op<kBf16>* b, int N, int depth, int tid,
                                          Apply&& apply) {
  if constexpr (kBf16) {
    const Own o = make_own(tid);
    tiled_product_wg(reinterpret_cast<__nv_bfloat16*>(smem), a, depth, M, b, depth, N, depth,
                     tid, o, [&](int m0, int n0, float (*d)[4]) {
#pragma unroll
                       for (int hi = 0; hi < 2; ++hi)
#pragma unroll
                         for (int j = 0; j < 4; ++j) {
                           const int r = m0 + o.row(2 * hi), c = n0 + o.col(j, 0);
                           if (r < M && c < N)
                             apply(r, c, make_float2(d[j][2 * hi], d[j][2 * hi + 1]));
                         }
                     });
  } else {
    const int ty4 = (tid >> 4) << 2, tx4 = (tid & 15) << 2;
    tiled_product_fma(reinterpret_cast<float*>(smem), a, M, M, b, N, N, depth, tid,
                      [&](int m0, int n0, float (*acc)[4]) {
                        const int r = m0 + ty4, c = n0 + tx4;
                        if (r < M && c < N) {
#pragma unroll
                          for (int i = 0; i < 4; ++i)
#pragma unroll
                            for (int j = 0; j < 4; j += 2)
                              apply(r + i, c + j, make_float2(acc[i][j], acc[i][j + 1]));
                        }
                      });
  }
}

// The forward transform of the operand in s.x: spec(c, kh, v) gets X at
// (c, kh) and (c, kh + 1) (c stacked, see the top of this file).  Every
// thread must call it (stages A and B, two barriers).
template <bool kBf16, class Spec>
__device__ __forceinline__ void sif_tiled_forward(unsigned char* smem, const SifSlot<kBf16>& s,
                                                  const SifTiledTables<kBf16>& g,
                                                  const SifTiledDims& d, int tid, Spec&& spec) {
  sif_pairs<kBf16>(smem, g.fw, d.K2, s.x, d.H, d.W, tid,               // P[c][h]
                   [&](int c, int h, float2 v) { put_spec<kBf16>(s.bb, c, h, d, v); });
  sif_pairs<kBf16>(smem, s.bb, d.K2, g.fh, d.H, 2 * d.H, tid, spec);   // X[c][kh]
}

// The inverse transform of the spectrum in s.zz (put_spec): field(h, w, v)
// gets y at (h, w) and (h, w + 1).  Every thread must call it (stages C and
// D, two barriers).
template <bool kBf16, class Field>
__device__ __forceinline__ void sif_tiled_inverse(unsigned char* smem, const SifSlot<kBf16>& s,
                                                  const SifTiledTables<kBf16>& g,
                                                  const SifTiledDims& d, int tid, Field&& field) {
  sif_pairs<kBf16>(smem, g.vh, d.H, s.zz, d.K2, 2 * d.H, tid,          // C[h][c]
                   [&](int h, int c, float2 v) {
                     put_pair<kBf16>(s.cc, h, c, d.H, d.K2, v);
                   });
  sif_pairs<kBf16>(smem, s.cc, d.H, g.vw, d.W, d.K2, tid, field);      // y[h][w]
}

// The scratch of a tiled K9 kernel: `slots` blocks resident at once, each
// with a slot of sif_slot_floats.
template <class Kernel>
cudaError_t sif_tiled_scratch(Kernel kernel, bool bf16, const SifTiledDims& d,
                              bool carry_spectrum, int* slots, long long* floats) {
  *floats = sif_slot_floats(bf16, d, carry_spectrum);
  return resident_blocks(kernel, slots, bf16 ? kTiledSmemWg : kTiledSmemFma);
}

bool bad_sif_tiled(int B, int H, int W, int W2, int n_steps, const void* scratch, int n_slots,
                   const void* const* tables) {
  return bad_tiled_grid(B, H, W, n_steps) || (W2 != W && W2 != W / 2 + 1) ||
         scratch == nullptr || n_slots < 1 || tables == nullptr || tables[0] == nullptr || tables[1] == nullptr ||
         tables[2] == nullptr || tables[3] == nullptr || tables[4] == nullptr ||
         tables[5] == nullptr;
}

}  // namespace
