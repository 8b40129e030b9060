// K2: stable LSD radix sort of (key, 32-bit payload) rows, one sweep a
// digit.
//
// Replaces the TPU kernel src/repro/kernels/radix_sort.py:_make_radix_kernel
// (sort_kv_segments_radix, pallas_call at :227; sort_segments_radix,
// pallas_call at :268). Keys (int32, uint32 or float32 bits) go through the
// order-preserving sortable-bits bijection on load and back on the last
// store, with unsigned arithmetic; -0.0 sorts before +0.0, NaN is
// unsupported. Each row sorts independently and stably: equal keys keep
// their input order. The payload (if any) moves bit-exactly with its key.
//
// Bound on the H100: memory. The TPU kernel permuted rows with one-hot
// matmuls (Mosaic has no scatter) inside a 4 MiB VMEM budget; neither
// carries over. The design is CUB's Onesweep (Adinets & Merrill, 2022),
// fitted to this card. Per element it moves 68 bytes: 4 in one upfront
// read of the keys, then 16 in each of the 4 digit passes (keys and
// payloads read once, written once).
//
//  * One histogram launch reads the keys once and counts all 4 x 256
//    digits of every row (hist_kernel) with shared-memory atomics, then
//    adds the block's counts into the row's. The wordcount's input is 75%
//    one key, so most increments of a warp land on one address; on the
//    card plain atomics took no longer there than counting runs of equal
//    digits in registers first, or one histogram a warp (PERF.md, K2).
//  * One launch per digit pass (pass_kernel), a chained scan with
//    decoupled look-back. A block takes its tile id from a per-pass global
//    counter, not from blockIdx, so tiles start in row order and every
//    tile a block waits on belongs to a block that is already running:
//    the look-back always makes progress. The block loads its tile
//    (T = 8192 elements, 16 a thread), ranks every key stably inside the
//    tile by its digit (each warp's 512 consecutive elements in 32-lane
//    steps: 8 ballots find the lanes with the same digit, the lowest of
//    them updates the warp's counter), publishes its 256 per-digit counts,
//    and one thread per digit walks back over the row's earlier tiles for
//    its prefix. Status words hold flag and count in one 64-bit word
//    (flag high, count low), so a row may hold up to 2^31 - 1 elements;
//    the flags carry the pass number, so one status array zeroed once a
//    call serves all 4 passes.
//  * Writes staged in shared memory: the ranked keys (and payloads) are
//    put in digit order in shared memory, then written out from there, so
//    consecutive threads write consecutive addresses of each digit's run.
//    A tile of 8192 averages 32 elements (128 bytes) per digit run on
//    random keys. The row's digit base comes from a 256-wide scan of the
//    histogram that each block does itself: no scan launch.
//
// A pass block is 512 threads at 64 registers with 81 KB of shared memory
// (keys and payloads staged apart), two blocks an SM; a third block (one
// staging buffer, 40 registers) spilled and ran slower, as did one block
// of 95 registers, 20 items a thread, and __match_any_sync in place of
// the ballots (PERF.md, K2). Five launches a call (one histogram, four
// passes) and one memset of the scratch (tile counters, histograms,
// status words). Passes ping-pong:
// in -> tmp -> out -> tmp -> out. Envelope: rows <= 65535, row length
// < 2^31. The measured times are in PERF.md (K2).
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

KERNEL_ERROR_STRING_FN

namespace k2 {

using u64 = status_t;

constexpr int kRadix = 256;
constexpr int kPasses = 4;
constexpr int kThreads = 512;
constexpr int kItems = 16;                      // per thread
constexpr int kTile = kThreads * kItems;        // T = 8192
constexpr int kWarps = kThreads / 32;
constexpr int kWarpItems = kItems * 32;         // consecutive, per warp
constexpr int kHistThreads = 256;
constexpr int kHistUnroll = 8;
constexpr long long kHistMinChunk = 8192;       // elements a histogram block
constexpr long long kHistBlocks = 2048;         // aimed for over all rows
constexpr int kHeaderInts = 16;                 // the pass tile counters
constexpr unsigned kFull = 0xffffffffu;

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

// Look-back status words (store_status, look_back): common.cuh. Flags of
// pass p: its tile's own count (aggregate) and the count of the
// row's tiles up to and including it (inclusive). Zero, and the flags of
// earlier passes, read as "not published yet".
__device__ __forceinline__ unsigned flag_aggregate(int pass) {
  return 2u * pass + 1u;
}
__device__ __forceinline__ unsigned flag_inclusive(int pass) {
  return 2u * pass + 2u;
}

// grid (blocks per row, rows): hist[row][d][digit d of each key] += 1.
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const unsigned* __restrict__ keys, long long s, long long chunk,
            int key_mode, int* __restrict__ hist) {
  __shared__ int h[kPasses * kRadix];
  for (int x = threadIdx.x; x < kPasses * kRadix; x += kHistThreads) h[x] = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const unsigned* p = keys + row * s;
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(s, begin + chunk);
  for (long long i0 = begin + threadIdx.x; i0 < end;
       i0 += static_cast<long long>(kHistThreads) * kHistUnroll) {
    unsigned k[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kHistThreads;
      k[u] = i < end ? p[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (i0 + static_cast<long long>(u) * kHistThreads >= end) break;
      const unsigned b = to_sortable(k[u], key_mode);
#pragma unroll
      for (int d = 0; d < kPasses; ++d)
        atomicAdd(&h[d * kRadix + ((b >> (8 * d)) & 0xff)], 1);
    }
  }
  __syncthreads();
  int* g = hist + row * (kPasses * kRadix);
  for (int x = threadIdx.x; x < kPasses * kRadix; x += kHistThreads)
    if (h[x]) atomicAdd(&g[x], h[x]);
}

// One digit pass over all rows; one block a tile, rows * tiles blocks.
// in_mode >= 0: the keys are raw (pass 0) and map to sortable bits on
// load; out_mode >= 0: map back on store (pass 3).
template <bool kKV>
__global__ void __launch_bounds__(kThreads, 2)
pass_kernel(const unsigned* __restrict__ keys_in,
            const unsigned* __restrict__ vals_in,
            unsigned* __restrict__ keys_out, unsigned* __restrict__ vals_out,
            long long s, int tiles, int pass, int in_mode, int out_mode,
            int* tile_counter, const int* __restrict__ hist, u64* status) {
  // stage_k[kTile], stage_v[kTile] (kv only), then kWarps x 256 counters
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* stage_k = smem;
  unsigned* stage_v = smem + kTile;
  int* cnt = reinterpret_cast<int*>(smem + (kKV ? 2 : 1) * kTile);
  __shared__ int s_delta[kRadix];   // output position - staged position
  __shared__ int s_warp_sum[2][kRadix / 32];
  __shared__ int s_tile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int x = tid; x < kWarps * kRadix; x += kThreads) cnt[x] = 0;
  __syncthreads();
  const int g = s_tile;                       // row * tiles + tile
  const long long row = g / tiles;
  const int tile = g - static_cast<int>(row) * tiles;
  const long long tile_begin = row * s + static_cast<long long>(tile) * kTile;
  const int valid = static_cast<int>(
      min(static_cast<long long>(kTile), s - static_cast<long long>(tile) * kTile));
  const int shift = 8 * pass;

  // 1. Load: warp w owns the tile's elements [512 w, 512 w + 512), item i
  // of lane l is element 512 w + 32 i + l. Slots past the row read as the
  // all-ones sortable key: they rank after every real element of the tile
  // (last digit, highest index) and are never written.
  const int first = warp * kWarpItems + lane;
  unsigned k[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int li = first + 32 * i;
    k[i] = li < valid ? keys_in[tile_begin + li] : kFull;
  }
  if (in_mode >= 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (first + 32 * i < valid) k[i] = to_sortable(k[i], in_mode);
  }

  if (kKV) {   // the payloads are read after the ranking: warm L2 now
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int li = first + 32 * i;
      if (li < valid)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(vals_in + tile_begin + li));
    }
  }

  // 2. Stable rank inside each warp: pos[i] = earlier elements of the
  // warp with the same digit.
  int* mine = cnt + warp * kRadix;
  const unsigned lt = (1u << lane) - 1u;
  int pos[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = (k[i] >> shift) & 0xffu;
    unsigned peers = kFull;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned bit = (d >> b) & 1u;
      const unsigned vote = __ballot_sync(kFull, bit);
      peers &= bit ? vote : ~vote;
    }
    const int leader = __ffs(peers) - 1;
    int prior = 0;
    if (lane == leader) {
      prior = mine[d];
      mine[d] = prior + __popc(peers);
    }
    prior = __shfl_sync(kFull, prior, leader);
    pos[i] = prior + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();

  // 3. Thread d < 256 owns digit d: the tile's count, the warps' bases
  // inside it, the published status, and two exclusive scans over the
  // digits (the tile's staging offsets, the row's digit bases).
  int total = 0, row_count = 0;
  if (tid < kRadix) {
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * kRadix + tid];
      cnt[w * kRadix + tid] = total;
      total += c;
    }
    store_status(status + static_cast<u64>(g) * kRadix + tid,
                 tile == 0 ? flag_inclusive(pass) : flag_aggregate(pass),
                 total);
    row_count = hist[row * (kPasses * kRadix) + pass * kRadix + tid];
  }
  int inc_t = total, inc_r = row_count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yt = __shfl_up_sync(kFull, inc_t, o);
    const int yr = __shfl_up_sync(kFull, inc_r, o);
    if (lane >= o) {
      inc_t += yt;
      inc_r += yr;
    }
  }
  if (tid < kRadix && lane == 31) {
    s_warp_sum[0][warp] = inc_t;
    s_warp_sum[1][warp] = inc_r;
  }
  __syncthreads();
  int staged = 0, row_base = 0;
  if (tid < kRadix) {
    staged = inc_t - total;
    row_base = inc_r - row_count;
    for (int w = 0; w < warp; ++w) {
      staged += s_warp_sum[0][w];
      row_base += s_warp_sum[1][w];
    }
    for (int w = 0; w < kWarps; ++w) cnt[w * kRadix + tid] += staged;
  }
  __syncthreads();

  // 4. Stage the keys in digit order and load the payloads.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = (k[i] >> shift) & 0xffu;
    pos[i] += cnt[warp * kRadix + d];
    stage_k[pos[i]] = k[i];
  }
  unsigned v[kItems];
  if (kKV) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int li = first + 32 * i;
      v[i] = li < valid ? vals_in[tile_begin + li] : 0u;
    }
  }
  // 5. Look-back, one thread a digit, while the payload loads are in
  // flight (the later it starts, the more likely the tile before has
  // published its inclusive count); then stage the payloads.
  if (tid < kRadix) {
    int prefix = 0;
    if (tile > 0) {
      prefix = look_back(status + static_cast<u64>(g - 1) * kRadix + tid,
                         kRadix, flag_aggregate(pass), flag_inclusive(pass));
      store_status(status + static_cast<u64>(g) * kRadix + tid,
                   flag_inclusive(pass), prefix + total);
    }
    s_delta[tid] = row_base + prefix - staged;
  }
  if (kKV) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) stage_v[pos[i]] = v[i];
  }
  __syncthreads();

  // 6. Write out in staged (digit) order: consecutive threads, consecutive
  // addresses inside each digit's run.
  const long long row_begin = row * s;
  for (int j = tid; j < valid; j += kThreads) {
    const unsigned key = stage_k[j];
    const long long dst = row_begin + s_delta[(key >> shift) & 0xffu] + j;
    keys_out[dst] = out_mode >= 0 ? from_sortable(key, out_mode) : key;
    if (kKV) vals_out[dst] = stage_v[j];
  }
}

inline size_t pass_smem_bytes(bool kv) {
  return static_cast<size_t>((kv ? 2 : 1) * kTile + kWarps * kRadix) *
         sizeof(unsigned);
}

template <bool kKV>
cudaError_t run_passes(const unsigned* keys_in, const unsigned* vals_in,
                       unsigned* keys_out, unsigned* vals_out,
                       unsigned* keys_tmp, unsigned* vals_tmp, int* counters,
                       const int* hist, u64* status, long long rows,
                       long long s, int key_mode, cudaStream_t st) {
  const size_t smem = pass_smem_bytes(kKV);
  cudaError_t err = cudaFuncSetAttribute(
      pass_kernel<kKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (s + kTile - 1) / kTile;
  const unsigned* src_k = keys_in;
  const unsigned* src_v = vals_in;
  for (int pass = 0; pass < kPasses; ++pass) {
    unsigned* dst_k = pass % 2 == 0 ? keys_tmp : keys_out;
    unsigned* dst_v = pass % 2 == 0 ? vals_tmp : vals_out;
    pass_kernel<kKV><<<static_cast<unsigned>(rows * tiles), kThreads, smem,
                       st>>>(
        src_k, src_v, dst_k, dst_v, s, static_cast<int>(tiles), pass,
        pass == 0 ? key_mode : -1, pass == kPasses - 1 ? key_mode : -1,
        counters + pass, hist, status);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return cudaSuccess;
}

}  // namespace k2

// keys_*, vals_*: (rows, s) 32-bit; vals_* may all be null (keys only).
// tiles, scratch_bytes: radix_plan's (radix_sort.py); a call whose plan
// differs from this layout is refused. scratch: 64 + rows * 4 * 256 * 4 +
// rows * tiles * 256 * 8 bytes (tile counters, histograms, status words),
// zeroed here by one memset.
extern "C" int radix_sort_launch(const void* keys_in, const void* vals_in,
                                 void* keys_out, void* vals_out,
                                 void* keys_tmp, void* vals_tmp,
                                 void* scratch, long long scratch_bytes,
                                 long long rows, long long s,
                                 long long plan_tiles, long long key_mode,
                                 void* stream) {
  using namespace k2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (s + kTile - 1) / kTile;
  const long long hist_ints = rows * kPasses * kRadix;
  const long long need = (kHeaderInts + hist_ints) * 4LL +
                         rows * tiles * kRadix * 8LL;
  if (rows < 1 || rows > 65535 || s < 1 || s > 0x7fffffffLL ||
      rows * tiles > 0x7fffffffLL || plan_tiles != tiles ||
      scratch_bytes != need)
    return static_cast<int>(cudaErrorInvalidValue);
  int* counters = static_cast<int*>(scratch);
  int* hist = counters + kHeaderInts;
  u64* status = reinterpret_cast<u64*>(hist + hist_ints);
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(need), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  long long per_row = (s + kHistMinChunk - 1) / kHistMinChunk;
  per_row = std::min(per_row, std::max(1LL, kHistBlocks / rows));
  const long long chunk = (s + per_row - 1) / per_row;
  hist_kernel<<<dim3(static_cast<unsigned>(per_row),
                     static_cast<unsigned>(rows)),
                kHistThreads, 0, st>>>(static_cast<const unsigned*>(keys_in),
                                       s, chunk, static_cast<int>(key_mode),
                                       hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const auto* ki = static_cast<const unsigned*>(keys_in);
  const auto* vi = static_cast<const unsigned*>(vals_in);
  auto* ko = static_cast<unsigned*>(keys_out);
  auto* vo = static_cast<unsigned*>(vals_out);
  auto* kt = static_cast<unsigned*>(keys_tmp);
  auto* vt = static_cast<unsigned*>(vals_tmp);
  err = vals_in != nullptr
            ? run_passes<true>(ki, vi, ko, vo, kt, vt, counters, hist, status,
                               rows, s, static_cast<int>(key_mode), st)
            : run_passes<false>(ki, vi, ko, vo, kt, vt, counters, hist,
                                status, rows, s, static_cast<int>(key_mode), st);
  return static_cast<int>(err);
}
