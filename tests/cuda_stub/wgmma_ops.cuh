// A CPU stand-in for pde_opt_tpu_torch/csrc/wgmma_ops.cuh: the same
// functions, with the warpgroup product computed in plain C++.
//
// The descriptor keeps the card's bit layout (start address, LBO and SBO in
// 16-byte units in bits [0, 14), [16, 30), [32, 46)), with addresses taken
// from the start of the block's dynamic shared memory, and the product reads
// its operands back through it as the PTX ISA lays out an unswizzled K-major
// operand: element (r, k) at start + (r / 8) SBO + (r % 8) 16 B + (k / 8) LBO
// + (k % 8) 2 B.  So a kernel that builds a wrong descriptor, or lays its
// tiles out otherwise, computes a wrong product here too.  Each thread
// computes its own accumulator fragment (register 4 j + e: row 16 warp +
// lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2), summing the 16
// exact bf16 products in k order in f32.  The product is synchronous, so the
// fences do nothing; the kernel's barriers still order its threads.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

inline uint64_t wgmma_desc(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  const uint32_t addr = static_cast<uint32_t>(static_cast<const char*>(smem) -
                                              static_cast<const char*>(stub_dynamic_smem()));
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFFu) >> 4) << 32);
}

inline void fence_proxy_async() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait_all() {}
inline void wgmma_fence_operand(float (*)[4]) {}

// Element (r, k) of the operand that `desc` describes.
inline float stub_operand(uint64_t desc, int r, int k) {
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFFu) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFFu) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFFu) << 4;
  const uint32_t byte = start + (r >> 3) * sbo + (r & 7) * 16 + (k >> 3) * lbo + (k & 7) * 2;
  __nv_bfloat16 h;
  std::memcpy(&h, static_cast<const char*>(stub_dynamic_smem()) + byte, sizeof h);
  return __bfloat162float(h);
}

inline void wgmma_m64n32k16_bf16(float d[4][4], uint64_t desc_a, uint64_t desc_b,
                                 int scale_d) {
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int warp = static_cast<int>((threadIdx.x / 32) % 4);
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + lane / 4 + 8 * (e / 2);
      const int col = 8 * j + 2 * (lane % 4) + e % 2;
      float acc = scale_d ? d[j][e] : 0.f;
      for (int k = 0; k < 16; ++k)
        acc += stub_operand(desc_a, row, k) * stub_operand(desc_b, col, k);
      d[j][e] = acc;
    }
}

}  // namespace
