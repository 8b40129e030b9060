// K1: batched stable partition rank + per-destination histogram.
//
// Replaces the TPU kernel src/repro/kernels/partition.py:_rank_kernel
// (partition_rank_pallas): one pass over int32 destination ids giving each
// record's rank among earlier records of the same destination, and the
// int32 per-destination counts. Ids outside [0, num_dest) count nothing
// and get rank 0.
//
// Bound on the H100: memory. A record costs 4 B read and 4 B written and
// no arithmetic to speak of. The TPU kernel carried the running
// per-destination base from grid step to grid step; Hopper blocks run in
// no order, so the design (multisplit.cuh) splits that into a per-tile
// histogram, a scan over tiles, and a per-tile rank pass seeded with the
// tile's base. Each pass streams the ids with coalesced 128-byte warp
// loads; the rank inside a warp comes from __match_any_sync, so no
// shared-memory atomics are taken. Envelope: num_dest <= 4096 (per-warp
// counters for 8 warps fit in 128 KB of shared memory), rows <= 65535.
#include "multisplit.cuh"

KERNEL_ERROR_STRING_FN

namespace k1 {

struct DestGet {
  const int* dest;
  long long n;
  int num_dest;
  long long row;
  __device__ __forceinline__ int operator()(long long i) const {
    const int d = dest[row * n + i];
    return (d >= 0 && d < num_dest) ? d : -1;
  }
};

struct RankEmit {
  int* rank;
  long long n;
  long long row;
  __device__ __forceinline__ void operator()(long long i, int, int r) const {
    rank[row * n + i] = r;
  }
};

}  // namespace k1

// dest, rank: (rows, n) int32; counts: (rows, num_dest) int32;
// hist: (rows, num_dest, ceil(n / 4096)) int32 scratch.
extern "C" int partition_rank_launch(const void* dest, void* rank, void* counts,
                                     void* hist, long long rows, long long n,
                                     long long num_dest, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(num_dest);
  const k1::DestGet get{static_cast<const int*>(dest), n, nb, 0};
  const k1::RankEmit emit{static_cast<int*>(rank), n, 0};
  cudaError_t err = ms::hist_and_scan(get, rows, n, nb, static_cast<int*>(hist),
                                      static_cast<int*>(counts), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ms::rank_tiles(get, emit, rows, n, nb, static_cast<const int*>(hist),
                       static_cast<const int*>(counts), 0, s);
  return static_cast<int>(err);
}
