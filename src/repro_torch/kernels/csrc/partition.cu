// K1: batched stable partition rank + per-destination histogram, one sweep.
//
// Replaces the TPU kernel src/repro/kernels/partition.py:_rank_kernel
// (partition_rank_pallas, pallas_call at :89): one pass over int32
// destination ids giving each record's rank among the earlier records of
// its row with the same destination, and the int32 per-destination counts
// of each row. Ids outside [0, num_dest) count nothing and get rank 0.
//
// Bound on the H100: memory. A record costs 4 B read and 4 B written and a
// few ballots. The TPU kernel carried the running per-destination base
// from grid step to grid step in a revisited output block; Hopper blocks
// run in no order, so the design is one launch of a chained scan with
// decoupled look-back (Merrill & Garland, 2016), the digit pass of K2
// (radix_sort.cu) with the scatter replaced by a write of the rank:
//
//  * A block takes its tile id from a global counter, not from blockIdx,
//    so the row's tiles start in order and every tile a block waits on
//    belongs to a block that is already running (forward progress). The
//    rows' tiles are interleaved (id = tile * rows + row): a tile's
//    predecessor in its row started `rows` blocks earlier, so the
//    look-back finds it further along.
//  * The block loads its tile (24 ids a thread, 4-byte coalesced loads, all
//    in flight at once) and ranks every id stably inside its warp: warp w
//    owns 768 consecutive ids and walks them in 32-lane steps; "no
//    destination" (an id out of range, or a slot past the row) is the
//    value num_dest, so ceil(log2(num_dest + 1)) ballots find the lanes
//    with the same value, and the lowest of them updates the warp's
//    counter in shared memory.
//  * One thread a destination turns the warps' counts into bases, publishes
//    the tile's count as a 64-bit (flag, count) status word (common.cuh),
//    and walks back over the row's earlier tiles for its prefix. The block
//    that holds a row's last tile writes the row's totals, so `counts`
//    needs no zeroing.
//  * Each rank is written once, with coalesced stores: 8 B a record in all,
//    the bound's traffic.
//
// Up to 1024 destinations a block is 16 warps (T = 12288 ids) and an id
// takes one register (its destination and its rank inside the warp packed
// in 16 bits each), so 24 ids a thread fit two blocks an SM at 64
// registers; above 1024, per-warp counters for 16 warps would not fit
// beside a second block, so a block is 4 warps (T = 3072). One launch and
// one memset (the tile counter and the status words) a call. On the card,
// 16, 20, 28 or 32 ids a thread, three blocks an SM, 8-warp blocks, tiles
// row after row, a look-back reading up to 32 earlier tiles at once, and
// resident blocks prefetching their next tile with cp.async were all
// slower (PERF.md, K1). Envelope: 1 <= num_dest <= 4096, rows <= 65535, a
// row below 2^31 ids. The measured times are in PERF.md (K1).
#include <mutex>

#include "common.cuh"

KERNEL_ERROR_STRING_FN

namespace k1 {

constexpr int kItems = 24;                  // ids a thread
constexpr int kWarpItems = 32 * kItems;     // consecutive ids a warp
constexpr int kNarrowWarps = 16;            // num_dest <= kNarrowDest
constexpr int kWideWarps = 4;               // above
constexpr int kNarrowBlocks = 2;            // blocks an SM (registers)
constexpr int kWideBlocks = 4;
constexpr int kNarrowDest = 1024;
constexpr int kMaxDest = 4096;
constexpr int kHeaderInts = 16;             // the tile counter
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFlagAggregate = 1u;     // the tile's own count
constexpr unsigned kFlagInclusive = 2u;     // the row's count up to the tile

// dest, rank: (rows, n); counts: (rows, nd); one block a tile, rows * tiles
// blocks; bits = ceil(log2(nd + 1)). Shared memory: kWarps x nd per-warp
// counters (then the warps' bases), then nd tile totals. Status words:
// (tiles, rows, nd), indexed by the tile id.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, kWarps == kNarrowWarps
                                                     ? kNarrowBlocks
                                                     : kWideBlocks)
rank_kernel(const int* __restrict__ dest, int* __restrict__ rank,
            int* __restrict__ counts, long long n, int rows, int tiles,
            int nd, int bits, int* tile_counter, status_t* status) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTile = kWarps * kWarpItems;
  extern __shared__ int cnt[];
  int* tile_total = cnt + kWarps * nd;
  __shared__ int s_tile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int x = tid; x < kWarps * nd; x += kThreads) cnt[x] = 0;
  __syncthreads();
  const int g = s_tile;                       // tile * rows + row
  const long long row = g % rows;
  const int tile = g / rows;
  const long long tile_begin = row * n + static_cast<long long>(tile) * kTile;
  const int valid = static_cast<int>(min(
      static_cast<long long>(kTile), n - static_cast<long long>(tile) * kTile));

  // 1. Load: item i of lane l is id 768 w + 32 i + l of the tile; slots
  // past the row and ids out of range become nd ("no destination").
  const int first = warp * kWarpItems + lane;
  unsigned v[kItems];   // the destination; after 2, (destination << 16) | pos
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int li = first + 32 * i;
    v[i] = li < valid ? static_cast<unsigned>(__ldg(dest + tile_begin + li))
                      : nd;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (v[i] >= static_cast<unsigned>(nd)) v[i] = nd;

  // 2. Stable rank inside each warp: pos = earlier ids of the warp with the
  // same destination (< kWarpItems), packed beside the destination (<=
  // kMaxDest) so that an id takes one register.
  int* mine = cnt + warp * nd;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = v[i];
    unsigned peers = kFull;
    for (int b = 0; b < bits; ++b) {
      const unsigned bit = (d >> b) & 1u;
      const unsigned vote = __ballot_sync(kFull, bit);
      peers &= bit ? vote : ~vote;
    }
    const int leader = __ffs(peers) - 1;
    int prior = 0;
    if (lane == leader && d < static_cast<unsigned>(nd)) {
      prior = mine[d];
      mine[d] = prior + __popc(peers);
    }
    prior = __shfl_sync(kFull, prior, leader);
    v[i] = (d << 16) | static_cast<unsigned>(prior + __popc(peers & lt));
    __syncwarp();
  }
  __syncthreads();

  // 3. Thread t owns destinations t, t + kThreads, ...: the warps' bases
  // inside the tile, and the tile's count published at once (so that later
  // tiles' look-backs need not wait on this block's own look-back).
  status_t* tile_status = status + static_cast<long long>(g) * nd;
  // words from a tile's to those of the tile before it in its row
  const long long stride = static_cast<long long>(rows) * nd;
  for (int x = tid; x < nd; x += kThreads) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * nd + x];
      cnt[w * nd + x] = total;
      total += c;
    }
    tile_total[x] = total;
    store_status(tile_status + x,
                 tile == 0 ? kFlagInclusive : kFlagAggregate, total);
  }
  // 4. Look-back for the row's ids before the tile; the row's last tile
  // writes the row's totals.
  for (int x = tid; x < nd; x += kThreads) {
    const int total = tile_total[x];
    int prefix = 0;
    if (tile > 0) {
      prefix = look_back(tile_status - stride + x, stride, kFlagAggregate,
                         kFlagInclusive);
      store_status(tile_status + x, kFlagInclusive, prefix + total);
      for (int w = 0; w < kWarps; ++w) cnt[w * nd + x] += prefix;
    }
    if (tile == tiles - 1) counts[row * nd + x] = prefix + total;
  }
  __syncthreads();

  // 5. Write each rank once, coalesced.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int li = first + 32 * i;
    const int d = static_cast<int>(v[i] >> 16);
    if (li < valid)
      rank[tile_begin + li] =
          d < nd ? cnt[warp * nd + d] + static_cast<int>(v[i] & 0xffffu) : 0;
  }
}

inline int warps_for(long long nd) {
  return nd <= kNarrowDest ? kNarrowWarps : kWideWarps;
}

inline size_t smem_bytes(int warps, long long nd) {
  return static_cast<size_t>((warps + 1) * nd) * sizeof(int);
}

// The largest shared memory each form can ask for is allowed once per
// device and process, not on every call.
template <int kWarps>
cudaError_t allow_smem(long long max_dest) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    result[dev] = cudaFuncSetAttribute(
        rank_kernel<kWarps>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kWarps, max_dest)));
  });
  return result[dev];
}

template <int kWarps>
cudaError_t launch(const int* dest, int* rank, int* counts, long long rows,
                   long long n, long long tiles, int nd, int* tile_counter,
                   status_t* status, cudaStream_t st) {
  cudaError_t err =
      allow_smem<kWarps>(kWarps == kNarrowWarps ? kNarrowDest : kMaxDest);
  if (err != cudaSuccess) return err;
  int bits = 0;
  while ((1 << bits) <= nd) ++bits;           // ceil(log2(nd + 1))
  rank_kernel<kWarps><<<static_cast<unsigned>(rows * tiles), kWarps * 32,
                        smem_bytes(kWarps, nd), st>>>(
      dest, rank, counts, n, static_cast<int>(rows), static_cast<int>(tiles),
      nd, bits, tile_counter, status);
  return cudaGetLastError();
}

}  // namespace k1

// dest, rank: (rows, n) int32; counts: (rows, num_dest) int32, written
// whole (no zeroing needed). tile, tiles, scratch_bytes: partition_plan's
// (partition.py); a call whose plan differs from this layout is refused.
// scratch: 64 + rows * tiles * num_dest * 8 bytes (the tile counter, then
// the status words, (tiles, rows, num_dest)), zeroed here by one memset.
extern "C" int partition_rank_launch(const void* dest, void* rank,
                                     void* counts, void* scratch,
                                     long long scratch_bytes, long long rows,
                                     long long n, long long num_dest,
                                     long long plan_tile, long long plan_tiles,
                                     void* stream) {
  using namespace k1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = warps_for(num_dest);
  const long long tile = static_cast<long long>(warps) * kWarpItems;
  const long long tiles = (n + tile - 1) / tile;
  const long long need = kHeaderInts * 4LL + rows * tiles * num_dest * 8LL;
  if (rows < 1 || rows > 65535 || n < 1 || n > 0x7fffffffLL ||
      num_dest < 1 || num_dest > kMaxDest || rows * tiles > 0x7fffffffLL ||
      plan_tile != tile || plan_tiles != tiles || scratch_bytes != need)
    return static_cast<int>(cudaErrorInvalidValue);
  int* tile_counter = static_cast<int*>(scratch);
  status_t* status = reinterpret_cast<status_t*>(tile_counter + kHeaderInts);
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(need), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* d = static_cast<const int*>(dest);
  auto* r = static_cast<int*>(rank);
  auto* c = static_cast<int*>(counts);
  const int nd = static_cast<int>(num_dest);
  err = warps == kNarrowWarps
            ? launch<kNarrowWarps>(d, r, c, rows, n, tiles, nd, tile_counter,
                                   status, st)
            : launch<kWideWarps>(d, r, c, rows, n, tiles, nd, tile_counter,
                                 status, st);
  return static_cast<int>(err);
}
