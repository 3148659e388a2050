// Device code shared by the packed-DFT macro kernels: ch_sif_macro.cu (K9a)
// and ac_sif_macro.cu (K9b).
//
// One block of kThreads = 256 threads owns one env at a time (grid-stride
// over envs), as in cas_common.cuh.  Shared memory holds the DFT tables as
// complex pairs, two work buffers and the per-env state of the macro (K9a:
// the carried spectrum; K9b: the f32 field for the Laplacian).  Each thread
// holds a 4 x 4 tile of the field in registers.  The spectrum keeps kw in
// [0, W2) (W2 = W/2 + 1 with the half spectrum, else W), padded with zeros
// to W2p, a multiple of the column group KG a thread computes.
//
//   forward   A[h][kw]  = sum_w  x[w][h]  * (Wr_w, Wi_w)[w][kw]     (stage A)
//             X[kh][kw] = sum_h  A[h][kw] * (Wr_h, Wi_h)[h][kh]     (stage B)
//   inverse   C[kw][h]  = sum_kh Z[kh][kw] * (Vr_h, Vi_h)[kh][h]    (stage C)
//             y[h][w]   = sum_kw Re(C[kw][h] * (Vr_w, Vi_w)[kw][w]) (stage D)
//
// with complex products and the c_k weights folded into (Vr_w, Vi_w).
// Stages A-C hand a thread one row (h or kh) and KG consecutive columns kw
// at a time, so a warp reads its table entries one a lane and the other
// operand as a broadcast; stage D gives each thread its own 4 x 4 tile.
// Every real sum keeps the JAX kernel's split: real and imaginary parts of
// a complex product accumulate separately and are combined at the end.
//
// Storage: the work buffers (the transform operands and intermediates) and
// the table along w of the forward transform hold f32, rounded to bf16 on
// store with bf16 tables (traits RF32, else F32), so storing a value rounds
// it where the JAX kernel casts to bf16 (the operand of each first product,
// the intermediate before each second) and a load needs no conversion.  The
// h-axis tables and the inverse table along w, read one entry a lane, are
// stored as bf16 pairs with bf16 tables (traits BF16): that keeps the block
// at 106 KB at 64^2, two blocks an SM.  Every sum is f32.

#pragma once

#include <cuda_bf16.h>

#include "cas_common.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // what a block may opt in to on Hopper

// f32 storage.  A pair is a complex value (re, im).
struct F32 {
  using pair = float2;
  static __device__ __forceinline__ float2 get(float2 x) { return x; }
  static __device__ __forceinline__ float2 put(float re, float im) {
    return make_float2(re, im);
  }
  // Four consecutive pairs (32 B, 16-byte aligned) as real and imaginary parts.
  static __device__ __forceinline__ void load4(const float2* p, float re[4], float im[4]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    re[0] = a.x; im[0] = a.y; re[1] = a.z; im[1] = a.w;
    re[2] = b.x; im[2] = b.y; re[3] = b.z; im[3] = b.w;
  }
  // Four consecutive scalars (16 B, 16-byte aligned).
  static __device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};

// f32 storage of values rounded to bf16 on store.
struct RF32 : F32 {
  static __device__ __forceinline__ float2 put(float re, float im) {
    return make_float2(rnd_bf16(re), rnd_bf16(im));
  }
  static __device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    F32::store4(p, rnd_bf16(a), rnd_bf16(b), rnd_bf16(c), rnd_bf16(d));
  }
};

// bf16 pairs (tables only).
struct BF16 {
  using pair = __nv_bfloat162;
  static __device__ __forceinline__ float2 get(__nv_bfloat162 x) {
    return __bfloat1622float2(x);
  }
  static __device__ __forceinline__ __nv_bfloat162 put(float re, float im) {
    return __floats2bfloat162_rn(re, im);
  }
  // Four consecutive pairs (16 B, 16-byte aligned).
  static __device__ __forceinline__ void load4(const __nv_bfloat162* p, float re[4],
                                               float im[4]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      re[i] = v.x;
      im[i] = v.y;
    }
  }
};

// The tables as the wrapper passes them: f32, already rounded to the storage
// type, in the plain version's layout (ops/fused_spectral.py SifConstants).
struct SifTables {
  const float *wr_w, *wi_w;   // (W, W2)  [w][kw]
  const float *wr_h, *wi_h;   // (H, H)   [h][kh]
  const float *vr_h, *vi_h;   // (H, H)   [kh][h]
  const float *vr_w, *vi_w;   // (W2, W)  [kw][w], c_k folded in
  const float *lam, *lam2;    // (H, W2)  [kh][kw]
};

struct SifDims {
  int H, W, W2, W2p, NG;      // NG = W2p / KG column groups
};

// The column group a thread computes: 4 when W2 allows it (the full
// spectrum), else 3 (W2 = W/2 + 1 = 1 mod 4; 33 = 3 * 11 at 64^2).
inline int sif_group(int W2) { return W2 % 4 == 0 ? 4 : 3; }

inline SifDims sif_dims(int H, int W, int W2) {
  const int kg = sif_group(W2);
  const int ng = (W2 + kg - 1) / kg;
  return SifDims{H, W, W2, ng * kg, ng};
}

// Shared-memory regions of one block, 16-byte aligned: the tables (fw in
// f32, the others in the table storage T), the work buffers P (A[h][kw],
// then C[kw][h]) and Q (the field operand x[w][h], then the spectrum
// Z[kh][kw]: never live at once), and the state (K9a: the carried spectrum,
// f32 pairs [kh][kw]; K9b: the f32 field [h][w]).
template <class T>
struct SifSmem {
  float2 *fw, *P, *Q;
  typename T::pair *fh, *ih, *iw;
  float* zs;                  // aliases Q
  float2* uh;                 // K9a
  float* uf;                  // K9b
};

__host__ __device__ inline int sif_align(int bytes) { return (bytes + 15) / 16 * 16; }

// Bytes of shared memory a block needs; offsets of its regions in `at`.
template <class T>
__host__ __device__ inline int sif_smem_bytes(const SifDims& d, bool carry_spectrum,
                                              int at[7]) {
  const int tp = static_cast<int>(sizeof(typename T::pair));
  const int spec = 8 * d.H * d.W2p;
  const int field = 4 * d.W * d.H;
  const int sizes[7] = {8 * d.W * d.W2p, tp * d.H * d.H, tp * d.H * d.H, tp * d.W2p * d.W,
                        spec, spec > field ? spec : field,
                        carry_spectrum ? spec : field};
  int o = 0;
  for (int i = 0; i < 7; ++i) {
    at[i] = o;
    o += sif_align(sizes[i]);
  }
  return o;
}

template <class T>
__device__ __forceinline__ SifSmem<T> carve_sif(char* base, const SifDims& d,
                                                bool carry_spectrum) {
  using TP = typename T::pair;
  int at[7];
  sif_smem_bytes<T>(d, carry_spectrum, at);
  SifSmem<T> s;
  s.fw = reinterpret_cast<float2*>(base + at[0]);
  s.fh = reinterpret_cast<TP*>(base + at[1]);
  s.ih = reinterpret_cast<TP*>(base + at[2]);
  s.iw = reinterpret_cast<TP*>(base + at[3]);
  s.P = reinterpret_cast<float2*>(base + at[4]);
  s.Q = reinterpret_cast<float2*>(base + at[5]);
  s.zs = reinterpret_cast<float*>(base + at[5]);
  s.uh = reinterpret_cast<float2*>(base + at[6]);
  s.uf = reinterpret_cast<float*>(base + at[6]);
  return s;
}

// Copy the tables into shared memory as pairs, zero beyond W2 (the values
// arrive rounded, so storing them as bf16 is exact).
template <class T>
__device__ __forceinline__ void load_dft_tables(const SifSmem<T>& s, const SifTables& g,
                                                const SifDims& d, int tid) {
  for (int i = tid; i < d.W * d.W2p; i += kThreads) {
    const int w = i / d.W2p, kw = i % d.W2p;
    s.fw[i] = kw < d.W2 ? make_float2(g.wr_w[w * d.W2 + kw], g.wi_w[w * d.W2 + kw])
                        : make_float2(0.f, 0.f);
  }
  for (int i = tid; i < d.H * d.H; i += kThreads) {
    s.fh[i] = T::put(g.wr_h[i], g.wi_h[i]);
    s.ih[i] = T::put(g.vr_h[i], g.vi_h[i]);
  }
  for (int i = tid; i < d.W2p * d.W; i += kThreads) {
    s.iw[i] = i < d.W2 * d.W ? T::put(g.vr_w[i], g.vi_w[i]) : T::put(0.f, 0.f);
  }
}

// The thread's 4 x 4 tile v (rows ty4.., columns tx4..) into zs as x[w][h],
// rounded by S: the operand of the forward transform.
template <class S>
__device__ __forceinline__ void store_operand(float* zs, int H, int ty4, int tx4,
                                              const float v[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) S::store4(zs + (tx4 + j) * H + ty4, v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Stage A: P[h][kw] = sum_w zs[w][h] (Wr_w, Wi_w)[w][kw].
template <class S, class T, int KG>
__device__ __forceinline__ void dft_stage_a(const SifSmem<T>& s, const SifDims& d, int tid) {
  for (int t = tid; t < d.H * d.NG; t += kThreads) {
    const int h = t % d.H, kw0 = (t / d.H) * KG;
    float ar[KG], ai[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) ar[j] = ai[j] = 0.f;
#pragma unroll 4
    for (int w = 0; w < d.W; ++w) {
      const float x = s.zs[w * d.H + h];
      const float2* f = s.fw + w * d.W2p + kw0;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const float2 c = f[j];
        ar[j] = fmaf(x, c.x, ar[j]);
        ai[j] = fmaf(x, c.y, ai[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KG; ++j) s.P[h * d.W2p + kw0 + j] = S::put(ar[j], ai[j]);
  }
}

// Stage B: X[kh][kw] = sum_h P[h][kw] (Wr_h, Wi_h)[h][kh], handed to
// epi(kh, kw, re, im) (kw < W2p; X is 0 beyond W2).
template <class T, int KG, class Epi>
__device__ __forceinline__ void dft_stage_b(const SifSmem<T>& s, const SifDims& d, int tid,
                                            Epi epi) {
  for (int t = tid; t < d.H * d.NG; t += kThreads) {
    const int kh = t % d.H, kw0 = (t / d.H) * KG;
    float rr[KG], ii[KG], ri[KG], ir[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) rr[j] = ii[j] = ri[j] = ir[j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < d.H; ++h) {
      const float2 f = T::get(s.fh[h * d.H + kh]);
      const float2* a = s.P + h * d.W2p + kw0;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const float2 v = a[j];
        rr[j] = fmaf(v.x, f.x, rr[j]);
        ii[j] = fmaf(v.y, f.y, ii[j]);
        ri[j] = fmaf(v.x, f.y, ri[j]);
        ir[j] = fmaf(v.y, f.x, ir[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KG; ++j) epi(kh, kw0 + j, rr[j] - ii[j], ri[j] + ir[j]);
  }
}

// Stage C: P[kw][h] = sum_kh Q[kh][kw] (Vr_h, Vi_h)[kh][h].
template <class S, class T, int KG>
__device__ __forceinline__ void dft_stage_c(const SifSmem<T>& s, const SifDims& d, int tid) {
  for (int t = tid; t < d.H * d.NG; t += kThreads) {
    const int h = t % d.H, kw0 = (t / d.H) * KG;
    float rr[KG], ii[KG], ri[KG], ir[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) rr[j] = ii[j] = ri[j] = ir[j] = 0.f;
#pragma unroll 4
    for (int kh = 0; kh < d.H; ++kh) {
      const float2 v = T::get(s.ih[kh * d.H + h]);
      const float2* q = s.Q + kh * d.W2p + kw0;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const float2 z = q[j];
        rr[j] = fmaf(z.x, v.x, rr[j]);
        ii[j] = fmaf(z.y, v.y, ii[j]);
        ri[j] = fmaf(z.x, v.y, ri[j]);
        ir[j] = fmaf(z.y, v.x, ir[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KG; ++j) s.P[(kw0 + j) * d.H + h] = S::put(rr[j] - ii[j], ri[j] + ir[j]);
  }
}

// Stage D on the thread's own tile: y[h][w] = sum_kw Re(P[kw][h] (Vr_w, Vi_w)[kw][w]).
template <class T>
__device__ __forceinline__ void dft_stage_d(const SifSmem<T>& s, const SifDims& d, int ty4,
                                            int tx4, float y[4][4]) {
  float a[4][4], b[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
#pragma unroll 2
  for (int kw = 0; kw < d.W2; ++kw) {
    float cr[4], ci[4], vr[4], vi[4];
    F32::load4(s.P + kw * d.H + ty4, cr, ci);
    T::load4(s.iw + kw * d.W + tx4, vr, vi);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = fmaf(cr[i], vr[j], a[i][j]);
        b[i][j] = fmaf(ci[i], vi[j], b[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) y[i][j] = a[i][j] - b[i][j];
}

// Grid, spectrum width and polynomial checks shared by both launchers.
inline bool bad_sif(int B, int H, int W, int W2, int n_steps) {
  return bad_grid(B, H, W, n_steps) || (W2 != W && W2 != W / 2 + 1);
}

// Set the kernel's shared memory, size the grid to the blocks resident at
// once (at most B), and report what to launch.
template <class T, class Kernel>
cudaError_t sif_config(Kernel kernel, const SifDims& d, bool carry_spectrum, int B,
                       int* smem, int* grid) {
  int at[7];
  *smem = sif_smem_bytes<T>(d, carry_spectrum, at);
  if (*smem > kMaxSmem) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, &resident, *smem);
  if (err != cudaSuccess) return err;
  *grid = B < resident ? B : resident;
  return cudaSuccess;
}

}  // namespace
