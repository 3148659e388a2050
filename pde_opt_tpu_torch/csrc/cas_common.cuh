// Device code shared by the port's macro kernels (ch_cas_macro.cu: K1-K3,
// ac_cas_macro.cu: K4, gpe_strang_macro.cu: K5, bv_cc_macro.cu: K6 use the
// cas transforms; sbm_bv_macro.cu: K7 the tiles, block sum and launch
// helpers).
//
// Layout common to all of them: one block of kThreads = 256 threads owns one
// env at a time (grid-stride over envs); the four cas matrices C_H, C_W and
// the inverse pair C/N sit in shared memory with row stride kLd = 64, beside
// two transform tiles zs (the operand) and ts (the intermediate); each
// thread holds a 4 x 4 tile of every per-pixel field in registers.
//
//   transform(Z) = Mh^T Z Mw     (Mh, Mw symmetric cas matrices, or C/N)
//
// With bf16 matrices the operand and the intermediate are rounded to bf16
// (the matrices arrive already rounded); products accumulate in f32 on the
// CUDA cores.  Everything here sits in an anonymous namespace: each kernel
// source is its own shared library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLd = 64;          // row stride of every shared tile (max H, W)
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCoeffs = 8;    // polynomials of degree <= 7
// ch, cw, ich, icw, zs, ts: six 64 x 64 f32 tiles, 96 KB.
constexpr int kSmemBytes = 6 * kLd * kLd * static_cast<int>(sizeof(float));

struct MuPoly {
  float c[kMaxCoeffs];   // c[i] multiplies x^i; zero above the degree
};

// The field epilogue of K1 and K4: [sum(u-c), sum((u-c)^2), n_finite] over
// finite pixels and the uint8 observation clip(u*scale + offset, 0, 255)
// (NaN pixels read as 0), mean-pooled over ds x ds blocks when ds > 1.
struct Epilogue {
  float* stats;          // (B, 3) or nullptr for the plain macro
  unsigned char* obs;    // (B, H/ds, W/ds)
  int ds;
  float scale, offset, center;
};

// The shared-memory tiles of one block, carved from dynamic shared memory.
struct Tiles {
  float *ch, *cw, *ich, *icw, *zs, *ts;
};

__device__ __forceinline__ Tiles carve_tiles(float* base) {
  Tiles t;
  t.ch = base;
  t.cw = t.ch + kLd * kLd;
  t.ich = t.cw + kLd * kLd;
  t.icw = t.ich + kLd * kLd;
  t.zs = t.icw + kLd * kLd;
  t.ts = t.zs + kLd * kLd;
  return t;
}

// Copy the four (H, H) / (W, W) cas matrices into shared memory.
__device__ __forceinline__ void load_mats(const Tiles& s, const float* __restrict__ g_ch,
                                          const float* __restrict__ g_cw,
                                          const float* __restrict__ g_ich,
                                          const float* __restrict__ g_icw, int H, int W,
                                          int tid) {
  for (int idx = tid; idx < H * H; idx += kThreads) {
    const int r = idx / H, c = idx % H;
    s.ch[r * kLd + c] = g_ch[idx];
    s.ich[r * kLd + c] = g_ich[idx];
  }
  for (int idx = tid; idx < W * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    s.cw[r * kLd + c] = g_cw[idx];
    s.icw[r * kLd + c] = g_icw[idx];
  }
}

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Horner's rule over all kMaxCoeffs coefficients (zero above the degree):
// constant indices keep the coefficients in registers, not local memory.
__device__ __forceinline__ float mu_eval(const MuPoly& mu, float x) {
  float p = 0.f;
#pragma unroll
  for (int i = kMaxCoeffs - 1; i >= 0; --i) p = p * x + mu.c[i];
  return p;
}

// acc[i][j] = sum_d A[d][r0 + i] * B[d][c0 + j]   (both tiles stored [d][.])
__device__ __forceinline__ void mm_tn(const float* __restrict__ A,
                                      const float* __restrict__ B, int depth,
                                      int r0, int c0, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < depth; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(A + d * kLd + r0);
    const float4 b = *reinterpret_cast<const float4*>(B + d * kLd + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out = Mh^T Z Mw for the (H, W) tile Z that the caller has just written to
// zs.  The intermediate (Z^T Mh, stored [w][k] in ts) is rounded to bf16
// when rnd is set.  Every thread must call it: it holds two barriers.
__device__ __forceinline__ void transform(const float* zs, float* ts,
                                          const float* mh, const float* mw,
                                          int H, int W, int ty4, int tx4,
                                          bool rnd, float out[4][4]) {
  __syncthreads();                                   // zs complete
  if (ty4 < W && tx4 < H) {
    float t[4][4];
    mm_tn(zs, mh, H, ty4, tx4, t);                   // t[w][k]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v;
      v.x = rnd ? rnd_bf16(t[i][0]) : t[i][0];
      v.y = rnd ? rnd_bf16(t[i][1]) : t[i][1];
      v.z = rnd ? rnd_bf16(t[i][2]) : t[i][2];
      v.w = rnd ? rnd_bf16(t[i][3]) : t[i][3];
      *reinterpret_cast<float4*>(ts + (ty4 + i) * kLd + tx4) = v;
    }
  }
  __syncthreads();                                   // ts complete
  if (ty4 < H && tx4 < W) mm_tn(ts, mw, W, ty4, tx4, out);   // out[k][l]
}

__device__ __forceinline__ void store_tile(float* zs, int ty4, int tx4,
                                           const float v[4][4], bool rnd) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 q;
    q.x = rnd ? rnd_bf16(v[i][0]) : v[i][0];
    q.y = rnd ? rnd_bf16(v[i][1]) : v[i][1];
    q.z = rnd ? rnd_bf16(v[i][2]) : v[i][2];
    q.w = rnd ? rnd_bf16(v[i][3]) : v[i][3];
    *reinterpret_cast<float4*>(zs + (ty4 + i) * kLd + tx4) = q;
  }
}

__device__ __forceinline__ void load_tile(const float* src, int W, int ty4, int tx4,
                                          float v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = *reinterpret_cast<const float4*>(src + (ty4 + i) * W + tx4);
    v[i][0] = q.x;
    v[i][1] = q.y;
    v[i][2] = q.z;
    v[i][3] = q.w;
  }
}

__device__ __forceinline__ void save_tile(float* dst, int W, int ty4, int tx4,
                                          const float v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + (ty4 + i) * W + tx4) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// Sum a, b, c over the block's threads.  Lane 0 of each warp writes its
// warp's sums to red; after the barrier every thread reads the same totals
// (summed in the same order).  The caller must put a barrier between this
// call and the next write to red.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c,
                                           float (*red)[3], int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if ((tid & 31) == 0) {
    red[tid / 32][0] = a;
    red[tid / 32][1] = b;
    red[tid / 32][2] = c;
  }
  __syncthreads();
  a = b = c = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w][0];
    b += red[w][1];
    c += red[w][2];
  }
}

// The field epilogue (the JAX kernels' `_ep_emit`) on the register-resident
// final field u of env `env`; f is scratch.  Every thread must call it.
// Ends with a barrier, so the caller may reuse zs and red at once.
__device__ __forceinline__ void emit_field_epilogue(const float u[4][4], float f[4][4],
                                                    float* zs, float (*red)[3],
                                                    const Epilogue& ep, int env, int H,
                                                    int W, int tid, int ty4, int tx4,
                                                    bool own) {
  float s1 = 0.f, s2 = 0.f, nf = 0.f;
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool fin = isfinite(u[i][j]);
        const float uz = fin ? u[i][j] - ep.center : 0.f;
        s1 += uz;
        s2 += uz * uz;
        nf += fin ? 1.f : 0.f;
        f[i][j] = uz;
      }
  }
  if (ep.ds == 1) {
    if (own) {
      unsigned char* oe = ep.obs + static_cast<size_t>(env) * H * W;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned char q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = isfinite(u[i][j]) ? u[i][j] : 0.f;
          q[j] = static_cast<unsigned char>(
              fminf(fmaxf(x * ep.scale + ep.offset, 0.f), 255.f));
        }
        *reinterpret_cast<uchar4*>(oe + (ty4 + i) * W + tx4) =
            make_uchar4(q[0], q[1], q[2], q[3]);
      }
    }
  } else if (own) {
    store_tile(zs, ty4, tx4, f, false);   // centered, NaN-masked field
  }
  block_sum3(s1, s2, nf, red, tid);        // its barrier also completes zs
  if (tid == 0) {
    float* st = ep.stats + static_cast<size_t>(env) * 3;
    st[0] = s1;
    st[1] = s2;
    st[2] = nf;
  }
  if (ep.ds > 1) {
    const int ds = ep.ds, Hd = H / ds, Wd = W / ds;
    const float inv = 1.0f / static_cast<float>(ds);
    unsigned char* oe = ep.obs + static_cast<size_t>(env) * Hd * Wd;
    for (int o = tid; o < Hd * Wd; o += kThreads) {
      const int hd = o / Wd, wd = o % Wd;
      float acc = 0.f;
      for (int w = 0; w < ds; ++w) {
        float t = 0.f;
        for (int h = 0; h < ds; ++h) t += zs[(hd * ds + h) * kLd + wd * ds + w] * inv;
        acc += t * inv;
      }
      oe[o] = static_cast<unsigned char>(
          fminf(fmaxf((acc + ep.center) * ep.scale + ep.offset, 0.f), 255.f));
    }
  }
  __syncthreads();                         // red and zs free again
}

// Every kernel here needs more than the default 48 KB of shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem_bytes = kSmemBytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// Blocks of `kernel` (of `threads` threads) that fit on the current device
// at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* blocks, int smem_bytes = kSmemBytes,
                            int threads = kThreads) {
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem_bytes)) != cudaSuccess)
    return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

bool bad_grid(int B, int H, int W, int n_steps) {
  return B < 1 || H < 8 || W < 8 || H > kLd || W > kLd || H % 8 || W % 8 || n_steps < 0;
}

bool bad_poly(int n_coeffs) { return n_coeffs < 1 || n_coeffs > kMaxCoeffs; }

MuPoly make_mu(const float* coeffs, int n) {
  MuPoly mu;
  for (int i = 0; i < kMaxCoeffs; ++i) mu.c[i] = i < n ? coeffs[i] : 0.f;
  return mu;
}

}  // namespace
