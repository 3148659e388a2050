// The Ampere-and-later asynchronous copy (cp.async): global to shared memory
// without passing through registers, waited on by the issuing thread before
// the barrier that publishes what it copied.  K8's 3D march brings the next
// u plane in with it (cp.async.wait_all); the tiled cas transform of K1-K3
// (cas_tiled.cuh) keeps a ring of chunks in flight (commit groups, waited
// on with cp.async.wait_group).  Nothing else of the port issues cp.async, so
// a CPU build can stand a header of the same name in for this one
// (tests/cuda_stub/async_copy.cuh copies at once).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// 16 bytes, both addresses 16-byte aligned; cached in L2 only (.cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 4 bytes, both addresses 4-byte aligned (.ca: the only cache mode for it).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 16 bytes as cp_async16 where `in`, else 16 zero bytes (source size 0: gmem
// is not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// Close this thread's group of cp.async issued since the last commit (an
// empty group counts too).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still copying.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until every cp.async this thread issued has written shared memory.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
