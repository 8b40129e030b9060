// Stable multisplit of row tiles: the shared core of the partition-rank
// kernel (K1, bucket = destination id) and each pass of the radix sort
// (K2, bucket = 8-bit digit).
//
// Rows are cut into tiles of kTile consecutive elements; one block owns
// one (tile, row). Inside a block each warp owns a contiguous run of
// kPerWarp elements and walks it in 32-element steps, so "earlier" is
// (warp, step, lane) order, which is the element order. Within a step,
// __match_any_sync groups the lanes holding the same bucket and
// __popc(peers & lanemask_lt) is a lane's rank among them; the group's
// leader adds the group size to the warp's per-bucket counter in shared
// memory. Per-warp counters then become exclusive bases by a prefix across
// warps, seeded with the tile's base from a scan over tiles.
//
// Three launches replace the TPU kernel's sequential grid (whose running
// base lived in a revisited output block):
//   1. tile_hist_kernel:  per-tile bucket counts  -> hist[row][bucket][tile]
//   2. scan_tiles_kernel: exclusive scan over tiles for every (row, bucket),
//                         totals -> counts[row][bucket]
//   3. tile_rank_kernel:  recount, prefix across warps from the tile base,
//                         then each element's stable rank -> emit().
// Counts are int32 (exact to 2^31 records per row and bucket).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace ms {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;
constexpr int kPerWarp = kTile / kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Count each warp's run of the tile into cnt[warp * nb + bucket].
// get(i) returns the bucket of element i of the row, or -1 for "no bucket".
template <typename Get>
__device__ __forceinline__ void warp_counts(const Get& get, long long tile_begin,
                                            long long n, int nb, int* cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* mine = cnt + warp * nb;
  const long long run = tile_begin + static_cast<long long>(warp) * kPerWarp;
  for (int step = 0; step < kPerWarp; step += 32) {
    if (run + step >= n) break;  // warp-uniform
    const long long i = run + step + lane;
    const int b = i < n ? get(i) : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    if (lane == __ffs(peers) - 1 && b >= 0) mine[b] += __popc(peers);
    __syncwarp();
  }
}

__device__ __forceinline__ void zero_shared(int* cnt, int count) {
  for (int x = threadIdx.x; x < count; x += blockDim.x) cnt[x] = 0;
}

// grid (tiles, rows): hist[(row * nb + b) * tiles + tile] = tile's count.
template <typename Get>
__global__ void __launch_bounds__(kThreads)
tile_hist_kernel(Get get, long long n, int nb, long long tiles, int* hist) {
  extern __shared__ int cnt[];
  const long long row = blockIdx.y, tile = blockIdx.x;
  Get g = get;
  g.row = row;
  zero_shared(cnt, kWarps * nb);
  __syncthreads();
  warp_counts(g, tile * kTile, n, nb, cnt);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += cnt[w * nb + b];
    hist[(row * nb + b) * tiles + tile] = total;
  }
}

// One warp per (row, bucket): exclusive scan of its `tiles` counts in
// place; the total goes to counts[row * nb + b].
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(int* hist, int* counts, long long pairs, long long tiles) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (pair >= pairs) return;  // warp-uniform
  int* h = hist + pair * tiles;
  int carry = 0;
  for (long long t0 = 0; t0 < tiles; t0 += 32) {
    const long long t = t0 + lane;
    const int v = t < tiles ? h[t] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (t < tiles) h[t] = carry + x - v;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) counts[pair] = carry;
}

// grid (tiles, rows). base(b) of bucket b for this tile is
// hist[(row*nb + b)*tiles + tile] (scanned) plus, when with_bucket_base,
// the exclusive sum of counts[row][0..b) (the radix sort's digit base).
// emit(i, b, rank) is called for every element i < n of the tile; rank is
// only meaningful for b >= 0.
template <typename Get, typename Emit>
__global__ void __launch_bounds__(kThreads)
tile_rank_kernel(Get get, Emit emit, long long n, int nb, long long tiles,
                 const int* hist, const int* counts, int with_bucket_base) {
  extern __shared__ int cnt[];  // kWarps * nb counters, then nb bucket bases
  int* bucket_base = cnt + kWarps * nb;
  const long long row = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Get g = get;
  Emit e = emit;
  g.row = row;
  e.row = row;
  zero_shared(cnt, kWarps * nb);
  if (with_bucket_base && threadIdx.x == 0) {
    int run = 0;
    for (int b = 0; b < nb; ++b) {
      bucket_base[b] = run;
      run += counts[row * nb + b];
    }
  }
  __syncthreads();
  warp_counts(g, tile * kTile, n, nb, cnt);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int run = hist[(row * nb + b) * tiles + tile] +
              (with_bucket_base ? bucket_base[b] : 0);
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * nb + b];
      cnt[w * nb + b] = run;
      run += c;
    }
  }
  __syncthreads();
  int* mine = cnt + warp * nb;
  const long long run = tile * kTile + static_cast<long long>(warp) * kPerWarp;
  const unsigned lt = (1u << lane) - 1u;
  for (int step = 0; step < kPerWarp; step += 32) {
    if (run + step >= n) break;  // warp-uniform
    const long long i = run + step + lane;
    const int b = i < n ? g(i) : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    const int rank = b >= 0 ? mine[b] + __popc(peers & lt) : 0;
    if (i < n) e(i, b, rank);
    __syncwarp();
    if (lane == __ffs(peers) - 1 && b >= 0) mine[b] += __popc(peers);
    __syncwarp();
  }
}

inline size_t rank_smem_bytes(int nb) {
  return static_cast<size_t>(kWarps * nb + nb) * sizeof(int);
}

// Launch hist + scan (+ nothing else): fills hist (scanned) and counts.
template <typename Get>
inline cudaError_t hist_and_scan(const Get& get, long long rows, long long n,
                                 int nb, int* hist, int* counts,
                                 cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kWarps * nb) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tile_hist_kernel<Get>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rank_smem_bytes(nb)));
  if (err != cudaSuccess) return err;
  tile_hist_kernel<Get><<<dim3(tiles, rows), kThreads, smem, stream>>>(
      get, n, nb, tiles, hist);
  const long long pairs = rows * nb;
  scan_tiles_kernel<<<(pairs + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      hist, counts, pairs, tiles);
  return cudaGetLastError();
}

template <typename Get, typename Emit>
inline cudaError_t rank_tiles(const Get& get, const Emit& emit, long long rows,
                              long long n, int nb, const int* hist,
                              const int* counts, int with_bucket_base,
                              cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  const size_t smem = rank_smem_bytes(nb);
  cudaError_t err = cudaFuncSetAttribute(
      tile_rank_kernel<Get, Emit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_rank_kernel<Get, Emit><<<dim3(tiles, rows), kThreads, smem, stream>>>(
      get, emit, n, nb, tiles, hist, counts, with_bucket_base);
  return cudaGetLastError();
}

}  // namespace ms
