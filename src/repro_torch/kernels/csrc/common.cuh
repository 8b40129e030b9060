// Shared by every kernel library: the C entry point that turns the
// cudaError_t a launcher returned into its message for the Python wrapper.
#pragma once

#include <cuda_runtime.h>

#define KERNEL_ERROR_STRING_FN                                              \
  extern "C" const char* kernel_error_string(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code));             \
  }
