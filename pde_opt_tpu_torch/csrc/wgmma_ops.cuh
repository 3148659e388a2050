// The Hopper (sm_90a) PTX that cas_wgmma.cuh's warpgroup transform needs:
// the shared-memory matrix descriptor, one bf16 warpgroup product shape
// (m64n32k16, f32 accumulate, both operands from shared memory) and the
// fences around it.  Nothing else of the port writes PTX for the tensor
// cores, so a CPU build can stand a header of the same name in for this one
// (tests/cuda_stub/wgmma_ops.cuh computes the same product in plain C++).
//
// Operand layout: no swizzle (the descriptor's layout type 0, "interleave"),
// both operands K-major.  A core matrix is 8 rows of 16 bytes (8 bf16 along
// K) stored contiguously (128 bytes); the leading byte offset (LBO) steps to
// the next core matrix along K, the stride byte offset (SBO) to the next 8
// rows along M or N.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// The 64-bit wgmma descriptor of a K-major, unswizzled operand that starts at
// `smem` (16-byte aligned): start address, LBO and SBO in 16-byte units in
// bits [0, 14), [16, 30) and [32, 46); base offset 0; layout type 0 in bits
// [62, 64).
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFFu) >> 4) << 32);
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy, through which wgmma reads its operands.  Each writing thread
// runs it before the barrier that precedes the product.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulator across
// the asynchronous product (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void wgmma_fence_operand(float d[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (+)= A B for a 64 x 16 A and a 16 x 32 B, bf16, accumulated in f32 by the
// 128 threads of one warpgroup; scale_d == 0 overwrites d.  d[j][e] is the
// accumulator fragment's register 4 j + e: row 16 warp + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2 of the 64 x 32 result.
__device__ __forceinline__ void wgmma_m64n32k16_bf16(float d[4][4], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

}  // namespace
