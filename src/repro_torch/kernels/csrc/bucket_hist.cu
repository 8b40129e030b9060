// K4: batched int32 bucket histogram.
//
// Replaces the TPU kernel src/repro/kernels/bucket_hist.py:_hist_kernel
// (bucket_histogram_pallas): the int32 count of ids per bucket, ids outside
// [0, num_buckets) counting nothing, exact past 2^24 records per bucket.
//
// Bound on the H100: memory. An id costs 4 B read and a few integer
// operations; the counts are written once. The TPU kernel kept one output
// block resident across a sequential grid and added a ones @ one_hot MXU
// product per tile into it. Hopper blocks run in no order and have no use
// for a matrix product here, so the design is:
//   - grid (chunks, rows): each block owns kChunk consecutive ids of one row
//     and a shared-memory histogram of num_buckets int32 counters;
//   - each warp step groups the lanes holding the same bucket with
//     __match_any_sync, and the group's leader adds __popc(peers) to the
//     shared counter, so a run of equal ids costs one shared atomic per
//     warp step instead of 32 (the all-one-id case does not serialise);
//   - the block flushes its non-zero counters into the zeroed int32
//     (rows, num_buckets) output with one global atomicAdd each.
// Counters are int32 throughout (exact to 2^31 ids per row and bucket).
// Envelope: num_buckets <= 4096 (16 KB of shared memory), rows <= 65535.
#include <cuda_runtime.h>

#include "common.cuh"

KERNEL_ERROR_STRING_FN

namespace k4 {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
bucket_hist_kernel(const int* __restrict__ ids, int* __restrict__ out,
                   long long n, int nb) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const int* rid = ids + row * n;
  const long long begin = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(n, begin + kChunk);
  const int lane = threadIdx.x & 31;
  // the loop bound is the same for every thread of the block, so every
  // lane of a warp reaches each __match_any_sync
  for (long long off = begin; off < end; off += blockDim.x) {
    const long long i = off + threadIdx.x;
    int b = i < end ? __ldg(rid + i) : -1;
    if (b < 0 || b >= nb) b = -1;
    const unsigned peers = __match_any_sync(kFull, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(hist + b, __popc(peers));
  }
  __syncthreads();
  int* rout = out + row * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int c = hist[b];
    if (c != 0) atomicAdd(rout + b, c);
  }
}

}  // namespace k4

// ids: (rows, n) int32; out: (rows, num_buckets) int32, zeroed by the caller.
extern "C" int bucket_hist_launch(const void* ids, void* out, long long rows,
                                  long long n, long long num_buckets,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (n + k4::kChunk - 1) / k4::kChunk;
  const size_t smem = static_cast<size_t>(num_buckets) * sizeof(int);
  k4::bucket_hist_kernel<<<dim3(static_cast<unsigned>(chunks),
                                static_cast<unsigned>(rows)),
                           k4::kThreads, smem, s>>>(
      static_cast<const int*>(ids), static_cast<int*>(out), n,
      static_cast<int>(num_buckets));
  return static_cast<int>(cudaGetLastError());
}
