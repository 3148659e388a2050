// The Hopper (sm_90a) PTX that the port's warpgroup transforms need
// (cas_wgmma.cuh, sif_wgmma.cuh): the shared-memory matrix descriptor, the
// bf16 warpgroup products m64nNk16 for N = 8, 16, ..., 64 (f32 accumulate,
// both operands from shared memory) and the fences around them.  Nothing
// else of the port writes PTX for the tensor cores, so a CPU build can stand
// a header of the same name in for this one (tests/cuda_stub/wgmma_ops.cuh
// computes the same product in plain C++).
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
// the asynchronous product (CUTLASS's warpgroup_fence_operand): the J
// groups of four registers of an m64n(8 J) fragment.
template <int J = 4>
__device__ __forceinline__ void wgmma_fence_operand(float (*d)[4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_MMA(n, regs, a, b, s, ...)                                                    \
  asm volatile("{\n"                                                                     \
               ".reg .pred p;\n"                                                         \
               "setp.ne.b32 p, " s ", 0;\n"                                              \
               "wgmma.mma_async.sync.aligned.m64n" #n "k16.f32.bf16.bf16 " regs ", " a  \
               ", " b ", p, 1, 1, 0, 0;\n"                                                \
               "}\n"                                                                     \
               : __VA_ARGS__                                                               \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// d (+)= A B for a 64 x 16 A and a 16 x N B, bf16, accumulated in f32 by the
// 128 threads of one warpgroup; scale_d == 0 overwrites d.  d[j][e] (j < N /
// 8) is the accumulator fragment's register 4 j + e: row 16 warp + lane / 4
// + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 of the 64 x N result.
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_bf16(float (*d)[4], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  static_assert(N >= 8 && N <= 64 && N % 8 == 0, "N in 8, 16, ..., 64");
  if constexpr (N == 8) {
    WG_MMA(8, "{%0, %1, %2, %3}", "%4", "%5", "%6", WG_D4(0));
  } else if constexpr (N == 16) {
    WG_MMA(16, "{%0, %1, %2, %3, %4, %5, %6, %7}", "%8", "%9", "%10", WG_D4(0), WG_D4(1));
  } else if constexpr (N == 24) {
    WG_MMA(24, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}", "%12", "%13", "%14",
           WG_D4(0), WG_D4(1), WG_D4(2));
  } else if constexpr (N == 32) {
    WG_MMA(32,
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}",
           "%16", "%17", "%18", WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3));
  } else if constexpr (N == 40) {
    WG_MMA(40,
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
           "%17, %18, %19}",
           "%20", "%21", "%22", WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4));
  } else if constexpr (N == 48) {
    WG_MMA(48,
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
           "%17, %18, %19, %20, %21, %22, %23}",
           "%24", "%25", "%26", WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5));
  } else if constexpr (N == 56) {
    WG_MMA(56,
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
           "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}",
           "%28", "%29", "%30", WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5),
           WG_D4(6));
  } else {
    WG_MMA(64,
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
           "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}",
           "%32", "%33", "%34", WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5),
           WG_D4(6), WG_D4(7));
  }
}

#undef WG_MMA
#undef WG_D4

}  // namespace
