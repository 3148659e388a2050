// An env fleet's auto-reset and in-place state write-back in one pass,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX env resets under lax.cond inside its jitted
// step, where XLA fuses the select and the state update.  Eager PyTorch ran
// the same work as about eighteen elementwise launches a fleet step (scale and
// clamp of the reset draw, its observation, the selects of field, control,
// observation, time and step count, then one copy a state tensor), each a
// pass over the fleet.  The work is a handful of f32 operations a pixel, so
// the pass is bound by memory traffic; its floor is one read of the stepped
// field y1, one write of the state's field, and one read and one write of the
// uint8 observation, with the reset draw z read only for envs that ended.
//
// For each env e, terminated[e] selects:
//
//   y[e]        = ended ? clamp(mean + noise * z[e], lo, hi) : y1[e]
//   obs_next[e] = ended ? (uint8) clamp(y[e] * obs_scale, 0, 255) : obs[e]
//   cv[e], t[e], steps[e] = ended ? (reset_cv, 0, 0) : (cv1[e], t1[e], steps1[e])
//   done[e]     = false
//
// in torch's order of operations: the product and the sum round apart (the
// _rn intrinsics keep nvcc from contracting them into one fused multiply-add),
// the clamps pass a NaN through as torch.clamp does, and the observation
// truncates toward zero.  obs is read only; the caller keeps it as the step's
// final observation.
//
// Design: a block owns a contiguous chunk of kChunk pixels of one env, so the
// env's flag and scalars are read once a block and the block of chunk 0
// writes the scalars.  A thread owns 16 adjacent pixels: four 16-byte loads
// and stores of the field and one of the observation, where the pixel count
// is a multiple of 16 and every plane is 16-byte aligned; else it walks its
// pixels one at a time.  The launch is asynchronous on the caller's stream.

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 16;                    // pixels a thread
constexpr int kChunk = kThreads * kPix;     // pixels a block

struct Reset {
  float mean, noise, lo, hi, cv, obs_scale;
};

// torch.clamp: a NaN passes through.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float reset_value(const Reset& r, float z) {
  return clamp(__fadd_rn(r.mean, __fmul_rn(r.noise, z)), r.lo, r.hi);
}

__device__ __forceinline__ unsigned char observe(const Reset& r, float y) {
  return static_cast<unsigned char>(
      static_cast<int>(clamp(__fmul_rn(y, r.obs_scale), 0.f, 255.f)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    fleet_reset_kernel(const unsigned char* __restrict__ terminated,
                       const float* __restrict__ y1, const float* __restrict__ z,
                       const unsigned char* __restrict__ obs, const float* __restrict__ cv1,
                       const float* __restrict__ t1, const int* __restrict__ steps1,
                       float* __restrict__ y, unsigned char* __restrict__ obs_next,
                       float* __restrict__ cv, float* __restrict__ t, int* __restrict__ steps,
                       unsigned char* __restrict__ done, long long n, int chunks, Reset r) {
  const long long env = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - env * chunks);
  const bool ended = terminated[env] != 0;
  if (chunk == 0 && threadIdx.x == 0) {
    cv[env] = ended ? r.cv : cv1[env];
    t[env] = ended ? 0.f : t1[env];
    steps[env] = ended ? 0 : steps1[env];
    done[env] = 0;
  }
  const long long p = static_cast<long long>(chunk) * kChunk + threadIdx.x * kPix;
  if (p >= n) return;
  const long long at = env * n + p;
  if (kVec) {
    const float4* src = reinterpret_cast<const float4*>((ended ? z : y1) + at);
    float4* dst = reinterpret_cast<float4*>(y + at);
    if (!ended) {
#pragma unroll
      for (int j = 0; j < kPix / 4; ++j) dst[j] = src[j];
      *reinterpret_cast<uint4*>(obs_next + at) = *reinterpret_cast<const uint4*>(obs + at);
      return;
    }
    __align__(16) unsigned char q[kPix];
#pragma unroll
    for (int j = 0; j < kPix / 4; ++j) {
      const float4 v = src[j];
      const float4 u = make_float4(reset_value(r, v.x), reset_value(r, v.y),
                                   reset_value(r, v.z), reset_value(r, v.w));
      dst[j] = u;
      q[4 * j] = observe(r, u.x);
      q[4 * j + 1] = observe(r, u.y);
      q[4 * j + 2] = observe(r, u.z);
      q[4 * j + 3] = observe(r, u.w);
    }
    *reinterpret_cast<uint4*>(obs_next + at) = *reinterpret_cast<const uint4*>(q);
  } else {
    const int m = n - p < kPix ? static_cast<int>(n - p) : kPix;
    for (int i = 0; i < m; ++i) {
      if (ended) {
        const float u = reset_value(r, z[at + i]);
        y[at + i] = u;
        obs_next[at + i] = observe(r, u);
      } else {
        y[at + i] = y1[at + i];
        obs_next[at + i] = obs[at + i];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches the pass on `stream` for B envs of n pixels each: terminated (B,)
// bool; y1, z and y (B, n) f32; obs and obs_next (B, n) uint8; cv1, t1, cv, t
// (B,) f32; steps1, steps (B,) int32; done (B,) bool.  Every array is dense.
// Returns a cudaError_t value, 0 on success (cudaErrorInvalidValue for an
// empty fleet or a grid beyond 2^31 - 1 blocks).
int fleet_reset_launch(const void* terminated, const float* y1, const float* z,
                       const void* obs, const float* cv1, const float* t1, const int* steps1,
                       float* y, void* obs_next, float* cv, float* t, int* steps, void* done,
                       int B, long long n, float mean, float noise, float lo, float hi,
                       float reset_cv, float obs_scale, void* stream) {
  if (B < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long grid = chunks * B;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % kPix == 0 && aligned16(y1) && aligned16(z) && aligned16(y) &&
                   aligned16(obs) && aligned16(obs_next);
  const auto kernel = vec ? fleet_reset_kernel<true> : fleet_reset_kernel<false>;
  const Reset r{mean, noise, lo, hi, reset_cv, obs_scale};
  kernel<<<static_cast<int>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(terminated), y1, z,
      static_cast<const unsigned char*>(obs), cv1, t1, steps1, y,
      static_cast<unsigned char*>(obs_next), cv, t, steps, static_cast<unsigned char*>(done),
      n, static_cast<int>(chunks), r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
