// A CPU stand-in for pde_opt_tpu_torch/csrc/async_copy.cuh: each cp.async
// copies (or zero-fills) at once, so the commits and waits do nothing; the
// kernel's barriers still order its threads.

#pragma once

#include <cstring>

#include <cuda_runtime.h>

namespace {

inline void cp_async16(void* smem, const void* gmem) { std::memcpy(smem, gmem, 16); }
inline void cp_async4(void* smem, const void* gmem) { std::memcpy(smem, gmem, 4); }
inline void cp_async16_zfill(void* smem, const void* gmem, bool in) {
  if (in)
    std::memcpy(smem, gmem, 16);
  else
    std::memset(smem, 0, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait_group() {}
inline void cp_async_wait_all() {}

}  // namespace
