// The Ampere-and-later asynchronous copy (cp.async) that K8's 3D march uses
// to bring the next u plane into shared memory while it computes: global to
// shared without passing through registers, waited on by the issuing thread
// (cp.async.wait_all) before the barrier that publishes the plane.  Nothing
// else of the port issues cp.async, so a CPU build can stand a header of the
// same name in for this one (tests/cuda_stub/async_copy.cuh copies at once).

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

// Wait until every cp.async this thread issued has written shared memory.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
