// K3: row sort of (key, 32-bit payload) pairs, ascending, NOT stable.
//
// Replaces the TPU kernel src/repro/kernels/bitonic_sort.py:_bitonic_kernel
// (sort_kv_segments_pallas / sort_segments_pallas, pallas_call at :117).
// Keys are int32, uint32 or float32 bits; the payload (if any) moves with
// its key; the order among equal keys is unspecified.
//
// Bound on the H100: memory, 16 bytes per element for kv (keys and
// payloads read once, written once). The TPU kernel held a whole row in
// VMEM, so its network's O(log^2 s) depth cost no memory traffic; on
// Hopper a row of 2^23 elements is far beyond the 227 KB of shared memory
// a block may use, and the network run across device memory made one
// pass per stage (91 launches, 47.45 ms at (8, 2^23 + 8) on an NVIDIA
// H100 80GB HBM3 at 700 W). This design makes 1 + ceil(log2(s / T))
// passes, each one read and one write of 8 bytes per element:
//
//  * One 64-bit word per element in flight: the key's order-preserving
//    unsigned bits (the bijection of radix_sort.py:key_to_sortable_bits)
//    in the high half, the payload bits in the low half (0 keys-only), so
//    an element moves as one word and one 32-bit compare of the high
//    halves orders two of them. Packing happens in the first pass's
//    loads, unpacking in the last pass's stores.
//  * No padding in memory: slots at index s and beyond are read as the
//    all-ones word and nothing is written outside [0, s). The one tile of
//    a row that holds such slots compares whole words, so they sort after
//    every real element, a real maximum key included.
//  * Pass 1, block sort: each block of 512 threads sorts a tile of
//    T = 8192 elements, 16 a thread. Each warp's 512 elements go through
//    the bitonic network without a __syncthreads: distances inside a
//    thread in registers, the others with __shfl_xor_sync. The 16 warp
//    runs then merge in 4 merge-path rounds in shared memory (68 KB,
//    padded), each thread finding its own diagonal and merging 16
//    outputs. (Carrying the network on across warps instead takes 10
//    more __syncthreads rounds through shared memory, and was the slower
//    of the two on the card.)
//  * Passes 2 onward, merge-path merges: runs of T, 2T, ... are merged
//    pairwise until one run covers the row. A partition kernel finds the
//    split of every 4096-output chunk by binary search on the merge path's
//    diagonal; each block stages its slices of both runs in shared memory,
//    each thread finds its own diagonal there and merges 16 outputs, and
//    the block writes them back coalesced. A run with no partner is copied
//    through. All rows go in one launch per pass.
//
// Passes ping-pong between two scratch buffers of rows x s words; the
// last pass writes the outputs. Measured at (8, 2^23 + 8) int32 kv on
// the card above: 5.86 ms in 23 launches (chip_smoke.py; PERF.md section
// 6, K3).
#include "common.cuh"

KERNEL_ERROR_STRING_FN

namespace k3 {

using u64 = unsigned long long;

constexpr int kSortThreads = 512;
constexpr int kItems = 16;                           // per thread, pass 1
constexpr int kTile = kSortThreads * kItems;         // T = 8192
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 16;                      // per thread, merges
constexpr int kChunk = kMergeThreads * kMergeItems;  // 4096 outputs a block
constexpr int kPartitionThreads = 256;
constexpr u64 kPadWord = ~0ull;

// One 8-byte word of padding after every kRun: a thread's kRun
// consecutive elements then start kRun + 1 words apart, so a half-warp's
// 64-bit accesses at the same item index fall on distinct banks.
template <int kRun>
__device__ __forceinline__ int padded(int i) { return i + i / kRun; }

// mode: 0 uint32, 1 int32, 2 float32 bits.
__device__ __forceinline__ unsigned to_sortable(unsigned k, int mode) {
  if (mode == 1) return k ^ 0x80000000u;
  if (mode == 2) return (k >> 31) ? ~k : (k | 0x80000000u);
  return k;
}

__device__ __forceinline__ unsigned from_sortable(unsigned b, int mode) {
  if (mode == 1) return b ^ 0x80000000u;
  if (mode == 2) return (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return b;
}

// Where a pass reads its input (pass 1 only) and writes its output: the
// scratch words `dst`, or, when `dst` is null, the unpacked outputs.
struct Io {
  const unsigned* keys;
  const unsigned* vals;  // null: keys only
  u64* dst;
  unsigned* out_keys;
  unsigned* out_vals;    // null: keys only
  int mode;
};

__device__ __forceinline__ u64 load_packed(const Io& io, long long g) {
  const unsigned k = to_sortable(io.keys[g], io.mode);
  const unsigned v = io.vals != nullptr ? io.vals[g] : 0u;
  return (static_cast<u64>(k) << 32) | v;
}

__device__ __forceinline__ void store(const Io& io, long long g, u64 w) {
  if (io.dst != nullptr) {
    io.dst[g] = w;
    return;
  }
  io.out_keys[g] = from_sortable(static_cast<unsigned>(w >> 32), io.mode);
  if (io.out_vals != nullptr) io.out_vals[g] = static_cast<unsigned>(w);
}

// Elements order by key alone (the high half): ties may come out in any
// order, and one 32-bit compare decides each pair. A tile that holds
// padding orders by the whole word (kFull), so that a real key equal to
// the maximum never lands behind a padding word.
__device__ __forceinline__ unsigned key_of(u64 w) {
  return static_cast<unsigned>(w >> 32);
}

template <bool kFull>
__device__ __forceinline__ bool before(u64 a, u64 b) {
  return kFull ? a < b : key_of(a) < key_of(b);
}

// Orders the pair ascending.
template <bool kFull>
__device__ __forceinline__ void cmpx(u64& a, u64& b) {
  const bool swap = before<kFull>(b, a);
  const u64 lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// The lower (keep_min) or upper element of a pair split across threads.
template <bool kFull>
__device__ __forceinline__ u64 keep(u64 mine, u64 other, bool keep_min) {
  const bool take = keep_min ? before<kFull>(other, mine)
                             : before<kFull>(mine, other);
  return take ? other : mine;
}

// Merges the sorted runs A = at(0 .. na) and B = at(na .. na + nb) (one
// index space, A first) and writes outputs [t0, t0 + kOut) of the merge,
// those below n, to y: the merge path's split at diagonal t0 by binary
// search (ties to A), then kOut steps with both heads in registers.
template <bool kFull, int kOut, typename At>
__device__ __forceinline__ void merge_run(const At& at, int na, int nb,
                                          int t0, int n, u64 (&y)[kOut]) {
  int lo = t0 - nb > 0 ? t0 - nb : 0;
  int hi = t0 < na ? t0 : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before<kFull>(at(na + t0 - 1 - mid), at(mid))) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int ai = lo, bi = t0 - lo;
  u64 ha = ai < na ? at(ai) : 0, hb = bi < nb ? at(na + bi) : 0;
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    if (t0 + r < n) {
      const bool take_a = bi >= nb || (ai < na && !before<kFull>(hb, ha));
      y[r] = take_a ? ha : hb;
      if (take_a) {
        ++ai;
        ha = ai < na ? at(ai) : 0;
      } else {
        ++bi;
        hb = bi < nb ? at(na + bi) : 0;
      }
    }
  }
}

// Sorts a warp's 32 * kItems elements, element i = lane * kItems + r in
// x[r], with the bitonic network in the form that sorts every block
// ascending: merge level k (blocks of k elements) first compares i with
// its mirror i ^ (k - 1), then i with i ^ j for j = k/4 ... 1; each pair
// puts the smaller key at the lower index. Distances inside a thread run
// in registers, the others with __shfl_xor_sync.
template <bool kFull>
__device__ __forceinline__ void sort_warp(u64 (&x)[kItems], int lane) {
#pragma unroll
  for (int k = 2; k <= kItems; k <<= 1) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if ((r & (k >> 1)) == 0) cmpx<kFull>(x[r], x[r ^ (k - 1)]);
    }
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        if ((r & j) == 0) cmpx<kFull>(x[r], x[r | j]);
      }
    }
  }
#pragma unroll
  for (int k = 2 * kItems; k <= 32 * kItems; k <<= 1) {
    // mirror step: lane ^ (k / kItems - 1) holds the mirror of x[r] in
    // its x[kItems - 1 - r]
    const bool lower = (lane & (k / kItems >> 1)) == 0;
    u64 o[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      o[r] = __shfl_xor_sync(0xffffffffu, x[kItems - 1 - r], k / kItems - 1);
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) x[r] = keep<kFull>(x[r], o[r], lower);
    // half-cleaners across lanes: the partner is lane ^ (j / kItems)
#pragma unroll
    for (int j = k >> 2; j >= kItems; j >>= 1) {
      const bool low = (lane & (j / kItems)) == 0;
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        x[r] = keep<kFull>(x[r], __shfl_xor_sync(0xffffffffu, x[r], j / kItems),
                           low);
      }
    }
#pragma unroll
    for (int j = kItems >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        if ((r & j) == 0) cmpx<kFull>(x[r], x[r | j]);
      }
    }
  }
}

// Sorts the tile, element i = tid * kItems + r in x[r] on entry and on
// exit: each warp's run with the bitonic network, then log2(kTile / warp
// run) rounds of merge-path merges of run pairs in shared memory.
template <bool kFull>
__device__ __forceinline__ void sort_tile(u64 (&x)[kItems], u64* sm,
                                          int tid) {
  constexpr int kWarpItems = 32 * kItems;
  sort_warp<kFull>(x, tid & 31);
  const int i0 = tid * kItems;
#pragma unroll 1
  for (int run = kWarpItems; run < kTile; run <<= 1) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r) sm[padded<kItems>(i0 + r)] = x[r];
    __syncthreads();
    const int base = i0 / (2 * run) * (2 * run);
    const auto at = [sm, base](int i) { return sm[padded<kItems>(base + i)]; };
    merge_run<kFull>(at, run, run, i0 - base, 2 * run, x);
  }
}

// Pass 1: grid (tiles per row, rows); each block sorts one tile of a row.
// Two blocks an SM (at most 64 registers a thread): the shared-memory
// merge rounds wait on load latency, which the second block hides.
__global__ void __launch_bounds__(kSortThreads, 2)
block_sort(Io io, long long s) {
  extern __shared__ u64 sm[];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const long long base = static_cast<long long>(blockIdx.y) * s + first;
  const long long left = s - first;
  const int n = left < kTile ? static_cast<int>(left) : kTile;
#pragma unroll 4
  for (int m = 0; m < kItems; ++m) {
    const int i = m * kSortThreads + tid;
    sm[padded<kItems>(i)] = i < n ? load_packed(io, base + i) : kPadWord;
  }
  __syncthreads();
  u64 x[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) x[r] = sm[padded<kItems>(tid * kItems + r)];
  if (n == kTile) {
    sort_tile<false>(x, sm, tid);
  } else {
    sort_tile<true>(x, sm, tid);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) sm[padded<kItems>(tid * kItems + r)] = x[r];
  __syncthreads();
#pragma unroll 4
  for (int m = 0; m < kItems; ++m) {
    const int i = m * kSortThreads + tid;
    if (i < n) store(io, base + i, sm[padded<kItems>(i)]);
  }
}

// The pair of runs that output position d of a merge pass falls in: it
// starts at `base`; run A has `la` elements, run B (at base + run) `lb`.
struct Pair {
  long long base, la, lb;
};

__device__ __forceinline__ Pair pair_of(long long d, long long s,
                                        long long run) {
  Pair p;
  p.base = d / (2 * run) * (2 * run);
  p.la = s - p.base < run ? s - p.base : run;
  const long long rest = s - p.base - run;
  p.lb = rest <= 0 ? 0 : (rest < run ? rest : run);
  return p;
}

// Merge pass, step 1: for chunk c of every row, the number of run-A
// elements among the pair's first (c * kChunk - base) outputs (merge path,
// ties to A). grid (ceil(chunks / kPartitionThreads), rows).
__global__ void __launch_bounds__(kPartitionThreads)
merge_partition(const u64* src, int* splits, long long s, long long run,
                long long chunks) {
  const long long c =
      static_cast<long long>(blockIdx.x) * kPartitionThreads + threadIdx.x;
  if (c >= chunks) return;
  const long long row = blockIdx.y;
  const long long d = c * kChunk;
  const Pair p = pair_of(d, s, run);
  const long long diag = d - p.base;
  const u64* a = src + row * s + p.base;
  const u64* b = a + run;  // read only when lb > 0, and then la == run
  long long lo = diag - p.lb > 0 ? diag - p.lb : 0;
  long long hi = diag < p.la ? diag : p.la;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (key_of(a[mid]) <= key_of(b[diag - 1 - mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  splits[row * chunks + c] = static_cast<int>(lo);
}

// Merge pass, step 2: grid (chunks, rows); block c writes the pair's
// outputs [c * kChunk, c * kChunk + kChunk) of its row.
__global__ void __launch_bounds__(kMergeThreads)
merge_pass(const u64* __restrict__ src, const int* splits, Io io, long long s,
           long long run, long long chunks) {
  __shared__ u64 sm[kChunk + kChunk / kMergeItems];
  const int tid = threadIdx.x;
  const long long row = blockIdx.y, c = blockIdx.x;
  const long long d = c * kChunk;
  const Pair p = pair_of(d, s, run);
  const long long diag0 = d - p.base;
  const long long end = p.la + p.lb;
  const long long diag1 = diag0 + kChunk < end ? diag0 + kChunk : end;
  const long long i0 = splits[row * chunks + c];
  const long long i1 = diag1 == end ? p.la : splits[row * chunks + c + 1];
  const int na = static_cast<int>(i1 - i0);
  const int n = static_cast<int>(diag1 - diag0);
  const int nb = n - na;
  const u64* a = src + row * s + p.base + i0;
  const u64* b = src + row * s + p.base + run + (diag0 - i0);
  for (int x = tid; x < n; x += kMergeThreads) {
    sm[x] = x < na ? a[x] : b[x - na];
  }
  __syncthreads();

  // this thread's outputs [t0, t0 + kMergeItems) of the chunk
  const int t0 = tid * kMergeItems < n ? tid * kMergeItems : n;
  u64 y[kMergeItems];
  const u64* const staged = sm;
  const auto at = [staged](int i) { return staged[i]; };
  merge_run<false>(at, na, nb, t0, n, y);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMergeItems; ++r) {
    if (t0 + r < n) sm[padded<kMergeItems>(t0 + r)] = y[r];
  }
  __syncthreads();
  const long long out0 = row * s + d;
#pragma unroll
  for (int r = 0; r < kMergeItems; ++r) {
    const int x = r * kMergeThreads + tid;
    if (x < n) store(io, out0 + x, sm[padded<kMergeItems>(x)]);
  }
}

cudaError_t run(Io io, u64* buf0, u64* buf1, int* splits, long long rows,
                long long s, int passes, cudaStream_t st) {
  const long long tiles = (s + kTile - 1) / kTile;
  // the plan the wrapper computed must be this kernel's
  if (passes < 0 || passes > 40 || (1ll << passes) < tiles ||
      (passes > 0 && (1ll << (passes - 1)) >= tiles) ||
      (passes > 0 && buf0 == nullptr) || (passes > 1 && buf1 == nullptr) ||
      (passes > 0 && splits == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int smem = (kTile + kTile / kItems) * static_cast<int>(sizeof(u64));
  cudaError_t err = cudaFuncSetAttribute(
      block_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned y = static_cast<unsigned>(rows);
  Io first = io;
  first.dst = passes > 0 ? buf0 : nullptr;
  block_sort<<<dim3(static_cast<unsigned>(tiles), y), kSortThreads, smem,
               st>>>(first, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long chunks = (s + kChunk - 1) / kChunk;
  const unsigned pblocks = static_cast<unsigned>(
      (chunks + kPartitionThreads - 1) / kPartitionThreads);
  for (int pass = 1; pass <= passes; ++pass) {
    const long long run = static_cast<long long>(kTile) << (pass - 1);
    const u64* src = (pass - 1) % 2 == 0 ? buf0 : buf1;
    Io out = io;
    out.dst = pass == passes ? nullptr : (pass % 2 == 0 ? buf0 : buf1);
    merge_partition<<<dim3(pblocks, y), kPartitionThreads, 0, st>>>(
        src, splits, s, run, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    merge_pass<<<dim3(static_cast<unsigned>(chunks), y), kMergeThreads, 0,
                 st>>>(src, splits, out, s, run, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace k3

// keys, vals: (rows, s) inputs, never written; vals and out_vals may be
// null (keys only). out_keys, out_vals: (rows, s) outputs. buf0, buf1:
// (rows, s) 8-byte scratch words (buf0 needed when passes >= 1, buf1 when
// passes >= 2); splits: (rows, ceil(s / 4096)) int32. passes = the number
// of merge passes, ceil(log2(ceil(s / 8192))), as the wrapper's plan.
// key_mode: 0 uint32, 1 int32, 2 float32.
extern "C" int bitonic_sort_launch(const void* keys, const void* vals,
                                   void* out_keys, void* out_vals, void* buf0,
                                   void* buf1, void* splits, long long rows,
                                   long long s, long long passes,
                                   long long key_mode, void* stream) {
  k3::Io io;
  io.keys = static_cast<const unsigned*>(keys);
  io.vals = static_cast<const unsigned*>(vals);
  io.dst = nullptr;
  io.out_keys = static_cast<unsigned*>(out_keys);
  io.out_vals = static_cast<unsigned*>(out_vals);
  io.mode = static_cast<int>(key_mode);
  return static_cast<int>(k3::run(
      io, static_cast<k3::u64*>(buf0), static_cast<k3::u64*>(buf1),
      static_cast<int*>(splits), rows, s, static_cast<int>(passes),
      static_cast<cudaStream_t>(stream)));
}
