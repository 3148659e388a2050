// The C entry that every kernel library exports beside its own: the message
// of a CUDA error code that one of the library's entries returned.  Each
// library is one translation unit, which includes this header once.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
