// Shared by every kernel library: the C entry point that turns the
// cudaError_t a launcher returned into its message for the Python wrapper,
// and the decoupled look-back status words of K1 (partition.cu) and K2
// (radix_sort.cu).
#pragma once

#include <cuda_runtime.h>

#define KERNEL_ERROR_STRING_FN                                              \
  extern "C" const char* kernel_error_string(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code));             \
  }

// Look-back status word: (flag << 32) | count in one 64-bit word, written
// and read with one relaxed access each, so a reader never sees a flag
// without its count. Flag 0 (the memset) reads as "not published yet".
using status_t = unsigned long long;

__device__ __forceinline__ void store_status(status_t* p, unsigned flag,
                                             int count) {
  const status_t v =
      (static_cast<status_t>(flag) << 32) | static_cast<unsigned>(count);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ status_t load_status(const status_t* p) {
  status_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The sum of the counts of the tiles before the caller's: walk back from
// p (the word of the tile just before), `stride` words a tile, adding
// aggregates until a word carries the inclusive flag, and add that one
// too. Spins on words not published yet; every tile waited on must belong
// to a block that is already running.
__device__ __forceinline__ int look_back(const status_t* p, long long stride,
                                         unsigned flag_aggregate,
                                         unsigned flag_inclusive) {
  int prefix = 0;
  for (;;) {
    const status_t w = load_status(p);
    const unsigned flag = static_cast<unsigned>(w >> 32);
    if (flag == flag_aggregate) {
      prefix += static_cast<int>(static_cast<unsigned>(w));
      p -= stride;
    } else if (flag == flag_inclusive) {
      return prefix + static_cast<int>(static_cast<unsigned>(w));
    }
  }
}
