// K3: bitonic sort of (key, 32-bit payload) rows, ascending, NOT stable.
//
// Replaces the TPU kernel src/repro/kernels/bitonic_sort.py:_bitonic_kernel
// / _compare_exchange (sort_kv_segments_pallas / sort_segments_pallas).
// Rows arrive padded to a power of two s = 2^m with the key type's
// maximum (+inf for floats); the same network as the TPU kernel runs:
// stage (k, j) compares elements i and i + 2^j (bit j of i clear) and
// orders the pair ascending iff bit k of i is 0.
//
// Bound on the H100: memory. The TPU kernel held a whole row in VMEM; the
// main-path rows here are 2^24 long, far beyond the 227 KB of shared
// memory a block may use. So the m(m+1)/2 stages split by partner
// distance: every stage with 2^j >= the 4096-element tile is one pass over
// device memory (coalesced, one thread per pair), and every run of stages
// with 2^j below the tile runs inside one shared-memory kernel per tile
// (32 KB of keys and payloads). For m = 24 that is 78 global passes and
// 13 shared-memory launches. int32, uint32 and float32 keys.
#include "common.cuh"

KERNEL_ERROR_STRING_FN

namespace k3 {

constexpr int kTileLog = 12;
constexpr int kSharedThreads = 512;
constexpr int kGlobalThreads = 256;

template <typename K, bool KV>
__device__ __forceinline__ void compare_exchange(K* keys, unsigned* vals,
                                                 long long lo, long long hi,
                                                 bool up) {
  const K a = keys[lo], b = keys[hi];
  if (up ? (a > b) : (a < b)) {
    keys[lo] = b;
    keys[hi] = a;
    if (KV) {
      const unsigned t = vals[lo];
      vals[lo] = vals[hi];
      vals[hi] = t;
    }
  }
}

// One stage (k, j = 2^jlog) over device memory, one thread per pair.
template <typename K, bool KV>
__global__ void __launch_bounds__(kGlobalThreads)
bitonic_global(K* keys, unsigned* vals, long long rows, int slog, int k,
               int jlog) {
  const long long half = 1ll << (slog - 1);
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= rows * half) return;
  const long long row = p >> (slog - 1), q = p & (half - 1);
  const long long jmask = (1ll << jlog) - 1;
  const long long lo = ((q & ~jmask) << 1) | (q & jmask);
  const long long hi = lo + (1ll << jlog);
  const bool up = ((lo >> k) & 1) == 0;
  const long long off = row << slog;
  compare_exchange<K, KV>(keys + off, KV ? vals + off : nullptr, lo, hi, up);
}

// Stages k in [k_lo, k_hi], each with every j < min(k, tlog), on one tile
// of 2^tlog elements held in shared memory. grid (s / tile, rows).
template <typename K, bool KV>
__global__ void __launch_bounds__(kSharedThreads)
bitonic_shared(K* keys, unsigned* vals, int slog, int tlog, int k_lo, int k_hi) {
  extern __shared__ unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  const int tile = 1 << tlog;
  unsigned* sv = reinterpret_cast<unsigned*>(sk + tile);
  const long long base = static_cast<long long>(blockIdx.x) << tlog;
  const long long off = (static_cast<long long>(blockIdx.y) << slog) + base;
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    sk[x] = keys[off + x];
    if (KV) sv[x] = vals[off + x];
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    const int jtop = (k - 1 < tlog - 1) ? k - 1 : tlog - 1;
    for (int jlog = jtop; jlog >= 0; --jlog) {
      const int jmask = (1 << jlog) - 1;
      for (int q = threadIdx.x; q < tile / 2; q += blockDim.x) {
        const int lo = ((q & ~jmask) << 1) | (q & jmask);
        const int hi = lo + (1 << jlog);
        const bool up = (((base + lo) >> k) & 1) == 0;
        compare_exchange<K, KV>(sk, sv, lo, hi, up);
      }
      __syncthreads();
    }
  }
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    keys[off + x] = sk[x];
    if (KV) vals[off + x] = sv[x];
  }
}

template <typename K, bool KV>
cudaError_t run_network(void* keys_p, void* vals_p, long long rows, int slog,
                        cudaStream_t st) {
  K* keys = static_cast<K*>(keys_p);
  unsigned* vals = static_cast<unsigned*>(vals_p);
  const int tlog = slog < kTileLog ? slog : kTileLog;
  const int tile = 1 << tlog;
  const int threads = tile / 2 < kSharedThreads ? tile / 2 : kSharedThreads;
  const size_t smem = static_cast<size_t>(tile) * (sizeof(K) + (KV ? 4 : 0));
  const dim3 tiles_grid(static_cast<unsigned>(1ll << (slog - tlog)),
                        static_cast<unsigned>(rows));
  const long long pairs = rows << (slog - 1);
  const unsigned global_blocks =
      static_cast<unsigned>((pairs + kGlobalThreads - 1) / kGlobalThreads);
  bitonic_shared<K, KV><<<tiles_grid, threads, smem, st>>>(keys, vals, slog,
                                                           tlog, 1, tlog);
  for (int k = tlog + 1; k <= slog; ++k) {
    for (int jlog = k - 1; jlog >= tlog; --jlog) {
      bitonic_global<K, KV><<<global_blocks, kGlobalThreads, 0, st>>>(
          keys, vals, rows, slog, k, jlog);
    }
    bitonic_shared<K, KV><<<tiles_grid, threads, smem, st>>>(keys, vals, slog,
                                                             tlog, k, k);
  }
  return cudaGetLastError();
}

template <typename K>
cudaError_t dispatch_kv(void* keys, void* vals, long long rows, int slog,
                        cudaStream_t st) {
  return vals != nullptr ? run_network<K, true>(keys, vals, rows, slog, st)
                         : run_network<K, false>(keys, vals, rows, slog, st);
}

}  // namespace k3

// keys, vals: (rows, 2^slog), sorted in place; vals may be null.
// key_mode: 0 uint32, 1 int32, 2 float32.
extern "C" int bitonic_sort_launch(void* keys, void* vals, long long rows,
                                   long long slog, long long key_mode,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(slog);
  cudaError_t err;
  if (key_mode == 1) {
    err = k3::dispatch_kv<int>(keys, vals, rows, m, st);
  } else if (key_mode == 2) {
    err = k3::dispatch_kv<float>(keys, vals, rows, m, st);
  } else {
    err = k3::dispatch_kv<unsigned>(keys, vals, rows, m, st);
  }
  return static_cast<int>(err);
}
