// K4: batched int32 bucket histogram, streaming.
//
// Replaces the TPU kernel src/repro/kernels/bucket_hist.py:_hist_kernel
// (bucket_histogram_pallas, pallas_call at :68): the int32 count of ids
// per bucket, ids outside [0, num_buckets) counting nothing, exact past
// 2^24 ids per bucket.
//
// Bound on the H100: memory. An id costs 4 B read and one shared atomic;
// the counts are written once. The TPU kernel kept one output block
// resident across a sequential grid and added a ones @ one_hot MXU product
// per tile into it. Hopper blocks run in no order and have no use for a
// matrix product here, so the design streams the ids:
//   - a bounded grid, about kBlocks blocks over all rows (a few an SM):
//     block (x, row) counts one contiguous chunk of its row, walking it
//     with 16-byte loads, kUnroll of them in flight a thread;
//   - every id in range adds 1 to the block's shared-memory histogram with
//     a plain atomicAdd (one sub-histogram a warp, against the same few
//     addresses at 8 buckets, measured no faster: PERF.md, K4);
//   - one flush a block: each non-zero bin added to the output with one
//     global atomicAdd. With kBlocks blocks in all, few global atomics
//     land on any bin.
// The output is zeroed by one cudaMemsetAsync in the C entry point: one
// device memset of rows x num_buckets int32, no scratch and no state kept
// between calls (a last-block reduction would need a zeroed counter too).
// Counters are int32 throughout (exact to 2^31 - 1 ids per row and bucket).
// Envelope: num_buckets <= 4096, rows <= 65535.
// The measured times are in PERF.md (K4).
#include <stdint.h>

#include "common.cuh"

KERNEL_ERROR_STRING_FN

namespace k4 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                      // ids a 16-byte load
constexpr int kUnroll = 4;                   // 16-byte loads in flight
constexpr long long kBlocks = 512;           // aimed for over all rows
constexpr long long kMinChunk = 16384;       // a row's blocks <= n / it
constexpr int kCopies = 1;                   // shared histograms a block
constexpr int kMaxBuckets = 4096;

__device__ __forceinline__ void count(int* h, int id, int nb) {
  if (static_cast<unsigned>(id) < static_cast<unsigned>(nb))
    atomicAdd(h + id, 1);
}

// grid (blocks per row, rows): block x counts ids [x chunk, (x + 1) chunk)
// of its row into shared memory, then adds its counts into out[row].
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ ids, int* __restrict__ out, long long n,
            long long chunk, int nb) {
  extern __shared__ int h[];                 // kCopies x nb
  const int tid = threadIdx.x;
  for (int x = tid; x < kCopies * nb; x += kThreads) h[x] = 0;
  __syncthreads();
  int* mine = h + ((tid >> 5) % kCopies) * nb;
  const long long row = blockIdx.y;
  const int* p = ids + row * n;
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(n, begin + chunk);
  // head: the ids before the first 16-byte boundary (the row need not
  // start on one), then 16-byte loads, then fewer than kVec ids of tail
  const long long to_boundary = static_cast<long long>(
      ((16u - (reinterpret_cast<uintptr_t>(p + begin) & 15u)) & 15u) / 4u);
  const long long body = begin + min(to_boundary, end - begin);
  if (begin + tid < body) count(mine, __ldg(p + begin + tid), nb);
  const long long nvec = (end - body) / kVec;
  const int4* v = reinterpret_cast<const int4*>(p + body);
  for (long long j0 = tid; j0 < nvec;
       j0 += static_cast<long long>(kThreads) * kUnroll) {
    int4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + static_cast<long long>(u) * kThreads;
      x[u] = j < nvec ? __ldcs(v + j) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count(mine, x[u].x, nb);
      count(mine, x[u].y, nb);
      count(mine, x[u].z, nb);
      count(mine, x[u].w, nb);
    }
  }
  const long long tail = body + nvec * kVec;
  if (tail + tid < end) count(mine, __ldg(p + tail + tid), nb);
  __syncthreads();
  int* rout = out + row * nb;
  for (int b = tid; b < nb; b += kThreads) {
    int c = 0;
    for (int k = 0; k < kCopies; ++k) c += h[k * nb + b];
    if (c != 0) atomicAdd(rout + b, c);
  }
}

}  // namespace k4

// ids: (rows, n) int32; out: (rows, num_buckets) int32, zeroed here.
// chunk, blocks_per_row: hist_plan's (bucket_hist.py); a call whose plan
// differs from this layout is refused.
extern "C" int bucket_hist_launch(const void* ids, void* out, long long rows,
                                  long long n, long long num_buckets,
                                  long long plan_chunk,
                                  long long plan_blocks_per_row,
                                  void* stream) {
  using namespace k4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 65535 || n < 1 || num_buckets < 1 ||
      num_buckets > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  // the grid: about kBlocks blocks over all rows, no more a row than
  // chunks of kMinChunk ids would make; a chunk is a multiple of kVec ids
  long long per_row = (n + kMinChunk - 1) / kMinChunk;
  if (per_row > kBlocks / rows) per_row = kBlocks / rows;
  if (per_row < 1) per_row = 1;
  long long chunk = (n + per_row - 1) / per_row;
  chunk = (chunk + kVec - 1) / kVec * kVec;
  per_row = (n + chunk - 1) / chunk;
  if (plan_chunk != chunk || plan_blocks_per_row != per_row)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(rows * num_buckets) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kCopies * num_buckets) * sizeof(int);
  hist_kernel<<<dim3(static_cast<unsigned>(per_row),
                     static_cast<unsigned>(rows)),
                kThreads, smem, s>>>(static_cast<const int*>(ids),
                                     static_cast<int*>(out), n, chunk,
                                     static_cast<int>(num_buckets));
  return static_cast<int>(cudaGetLastError());
}
