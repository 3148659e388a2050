// Device code shared by the Butler-Volmer macro kernels (bv_cc_macro.cu: K6,
// sbm_bv_macro.cu: K7): the presets' coefficient functions, the alpha = 1/2
// galvanostatic closure and the RK4 update, each in the plain version's order
// of operations.  The _rn intrinsics keep nvcc from contracting a product and
// a sum into one fused multiply-add where the plain version rounds twice.
// Accurate logf, expf, sqrtf and IEEE division throughout: the log ratio near
// its clip and the root of the closure's quadratic lose digits under the
// approximate intrinsics.

#pragma once

#include <cuda_runtime.h>

namespace {

// LogRatioMu(omega, clip) and SqrtJ0(floor): mu(c) = log(x/(1-x)) + omega(1-2c)
// with x = clip(c, lo, hi), and j0(c) = sqrt(max(c(1-c), floor)).  lo and hi
// arrive rounded to f32, as the f32 lambda rounds them.
struct BvCoeffs {
  float omega, lo, hi, floor;
};

// The comparisons pass a NaN through, as torch.clamp does: a poisoned env
// stays NaN and its epilogue flags it.
__device__ __forceinline__ float bv_mu(const BvCoeffs& b, float c) {
  const float x = c < b.lo ? b.lo : (c > b.hi ? b.hi : c);
  return __fadd_rn(logf(__fdiv_rn(x, 1.0f - x)), __fmul_rn(b.omega, 1.0f - 2.0f * c));
}

__device__ __forceinline__ float bv_j0(const BvCoeffs& b, float c) {
  const float v = __fmul_rn(c, 1.0f - c);
  return sqrtf(v < b.floor ? b.floor : v);
}

// The positive root y = (-C + sqrt(C^2 + 4 I+ I-)) / (2 I+) of the
// constant-current constraint (y = exp(v/2)).
__device__ __forceinline__ float bv_root(float C, float ip, float im) {
  const float disc = __fadd_rn(__fmul_rn(C, C), __fmul_rn(__fmul_rn(4.0f, ip), im));
  return __fdiv_rn(__fadd_rn(-C, __fsqrt_rn(disc)), __fmul_rn(2.0f, ip));
}

// The reaction j (1/(em y) - em y), written j (inv_em / y - em y), with
// inv_em = 1/em computed by a caller that needs it before y (K7).
__device__ __forceinline__ float bv_reaction(float j, float em, float inv_em, float y) {
  return __fmul_rn(j, __fsub_rn(__fdiv_rn(inv_em, y), __fmul_rn(em, y)));
}

__device__ __forceinline__ float bv_reaction(float j, float em, float y) {
  return bv_reaction(j, em, __fdiv_rn(1.0f, em), y);
}

// Four consecutive floats, 16-byte aligned, to and from an array (the
// tiled kernels' pixel groups); ldg4 through the read-only cache.
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void ldg4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ float4 pack4(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = pack4(v);
}

// RK4 stage constants: the stage inputs u + c k with c = dt/2, dt/2, dt, and
// u1 = u + dt/6 (k1 + 2 k2 + 2 k3 + k4), each rounded to f32 on the host.
struct Rk4 {
  float half, full, sixth;
  __device__ __forceinline__ float stage_coef(int stage) const {
    return stage == 3 ? full : half;
  }
};

// acc accumulates ((k1 + 2 k2) + 2 k3) + k4 in the plain version's order.
__device__ __forceinline__ void rk4_accumulate(float acc[4][4], const float k[4][4],
                                               int stage) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (stage == 0)
        acc[i][j] = k[i][j];
      else
        acc[i][j] = __fadd_rn(acc[i][j], (stage == 3 ? 1.0f : 2.0f) * k[i][j]);
    }
}

// z = u + c k (the next stage's input), or u itself for the first stage.
__device__ __forceinline__ void rk4_stage_input(float z[4][4], const float u[4][4],
                                                const float k[4][4], int stage,
                                                const Rk4& rk) {
  const float c = rk.stage_coef(stage);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      z[i][j] = stage == 0 ? u[i][j] : __fadd_rn(u[i][j], __fmul_rn(c, k[i][j]));
}

__device__ __forceinline__ void rk4_finish(float u[4][4], const float acc[4][4],
                                           const Rk4& rk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) u[i][j] = __fadd_rn(u[i][j], __fmul_rn(rk.sixth, acc[i][j]));
}

}  // namespace
