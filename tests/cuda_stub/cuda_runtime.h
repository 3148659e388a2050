// A CPU stand-in for the parts of the CUDA runtime and device language that
// the port's kernel sources use, so that tests/test_torch_cuda_cpu_build.py
// can compile a kernel source with g++ and run it on CPU tensors.
//
// A launch runs its blocks one after another; each block is kThreads
// std::threads that share the block's dynamic shared memory and the
// kernel's `__shared__` arrays (function statics).  __syncthreads is a
// std::barrier over the block, a warp shuffle an exchange through a per-warp
// buffer between two barriers of the warp's 32 threads.  The test rewrites
// two things the C++ grammar has no room for: `kernel<<<grid, block, smem,
// stream>>>(args)` becomes `stub_launch(kernel, grid, block, smem, stream,
// args)` and `extern __shared__ T name[];` becomes a pointer to the block's
// dynamic shared memory (`stub_dynamic_smem()`).
//
// Compile with -std=c++20 -ffp-contract=off: a product and a sum stay two
// roundings, as the kernels' _rn intrinsics ask.

#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

using std::isfinite;

struct uint3 {
  unsigned x, y, z;
};
struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct uchar2 {
  unsigned char x, y;
};
struct uchar4 {
  unsigned char x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline uchar2 make_uchar2(unsigned char x, unsigned char y) { return {x, y}; }
inline uchar4 make_uchar4(unsigned char x, unsigned char y, unsigned char z,
                          unsigned char w) {
  return {x, y, z, w};
}

inline thread_local uint3 threadIdx{0, 0, 0};
inline thread_local uint3 blockIdx{0, 0, 0};
inline uint3 blockDim{0, 1, 1};
inline uint3 gridDim{0, 1, 1};

// ---- the block a launch is running ----------------------------------------

struct StubWarp {
  std::barrier<> bar{32};
  float buf[32];
};

struct StubBlock {
  explicit StubBlock(int threads, size_t smem)
      : bar(threads),
        warps(threads / 32),
        smem(new std::max_align_t[smem / sizeof(std::max_align_t) + 1]) {}
  std::barrier<> bar;
  std::vector<StubWarp> warps;
  std::unique_ptr<std::max_align_t[]> smem;
};

inline StubBlock* stub_block = nullptr;

inline void* stub_dynamic_smem() { return stub_block->smem.get(); }

inline void __syncthreads() { stub_block->bar.arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  StubWarp& w = stub_block->warps[threadIdx.x / 32];
  const unsigned lane = threadIdx.x % 32;
  w.buf[lane] = v;
  w.bar.arrive_and_wait();
  const float r = w.buf[lane ^ static_cast<unsigned>(lane_mask)];
  w.bar.arrive_and_wait();
  return r;
}

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }

// ---- the runtime API ----------------------------------------------------------

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
typedef struct StubStream* cudaStream_t;

inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// One SM holding one block: a launch is a single block that walks every env
// (grid-stride), the path the card takes once the envs outnumber its blocks.
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
void stub_launch(Kernel kernel, int grid, int block, size_t smem, cudaStream_t,
                 Args... args) {
  gridDim.x = static_cast<unsigned>(grid);
  blockDim.x = static_cast<unsigned>(block);
  for (int b = 0; b < grid; ++b) {
    StubBlock blk(block, smem);
    stub_block = &blk;
    std::vector<std::thread> threads;
    threads.reserve(block);
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        kernel(args...);
      });
    for (auto& th : threads) th.join();
    stub_block = nullptr;
  }
}
