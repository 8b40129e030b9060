// K2: stable LSD radix sort of (key, 32-bit payload) rows.
//
// Replaces the TPU kernel src/repro/kernels/radix_sort.py:_make_radix_kernel
// (sort_kv_segments_radix / sort_segments_radix). Keys (int32, uint32 or
// float32 bits) go through the order-preserving sortable-bits bijection
// on load and back on the last store, with unsigned arithmetic; -0.0
// sorts before +0.0, NaN is unsupported. Each row sorts independently and
// stably: equal keys keep their input order.
//
// Bound on the H100: memory. 4 passes of 8-bit digits each read the keys
// three times (histogram, recount, scatter) and the payload once, and
// write both once. The TPU kernel permuted rows with one-hot matmuls
// because Mosaic has no scatter, inside a 4 MiB VMEM budget; neither
// carries over. Each pass here is the multisplit of multisplit.cuh with
// the digit as bucket: per-tile digit histograms, a scan over tiles per
// (row, digit), then a stable scatter to
//   out[digit base + tile base + warp base + rank within the warp].
// Ping-pong buffers: in -> tmp -> out -> tmp -> out. Envelope: rows <=
// 65535, row length < 2^31.
#include "multisplit.cuh"

KERNEL_ERROR_STRING_FN

namespace k2 {

// mode: 0 uint32, 1 int32, 2 float32 bits; -1 = already sortable.
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

struct DigitGet {
  const unsigned* keys;
  long long s;
  int shift;
  int in_mode;
  long long row;
  __device__ __forceinline__ int operator()(long long i) const {
    unsigned k = keys[row * s + i];
    if (in_mode >= 0) k = to_sortable(k, in_mode);
    return static_cast<int>((k >> shift) & 0xffu);
  }
};

struct ScatterEmit {
  const unsigned* keys_in;
  const unsigned* vals_in;
  unsigned* keys_out;
  unsigned* vals_out;
  long long s;
  int in_mode;
  int out_mode;
  long long row;
  __device__ __forceinline__ void operator()(long long i, int, int pos) const {
    unsigned k = keys_in[row * s + i];
    if (in_mode >= 0) k = to_sortable(k, in_mode);
    if (out_mode >= 0) k = from_sortable(k, out_mode);
    keys_out[row * s + pos] = k;
    if (vals_in != nullptr) vals_out[row * s + pos] = vals_in[row * s + i];
  }
};

}  // namespace k2

// keys_*, vals_*: (rows, s) 32-bit; vals_* may all be null (keys only).
// hist: (rows, 256, ceil(s / 4096)) int32, counts: (rows, 256) int32.
extern "C" int radix_sort_launch(const void* keys_in, const void* vals_in,
                                 void* keys_out, void* vals_out,
                                 void* keys_tmp, void* vals_tmp, void* hist,
                                 void* counts, long long rows, long long s,
                                 long long key_mode, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* src_k = static_cast<const unsigned*>(keys_in);
  const unsigned* src_v = static_cast<const unsigned*>(vals_in);
  for (int pass = 0; pass < 4; ++pass) {
    unsigned* dst_k = static_cast<unsigned*>(pass % 2 == 0 ? keys_tmp : keys_out);
    unsigned* dst_v = static_cast<unsigned*>(pass % 2 == 0 ? vals_tmp : vals_out);
    const int in_mode = pass == 0 ? static_cast<int>(key_mode) : -1;
    const int out_mode = pass == 3 ? static_cast<int>(key_mode) : -1;
    const k2::DigitGet get{src_k, s, 8 * pass, in_mode, 0};
    const k2::ScatterEmit emit{src_k, src_v, dst_k, dst_v, s, in_mode, out_mode, 0};
    cudaError_t err = ms::hist_and_scan(get, rows, s, 256, static_cast<int*>(hist),
                                        static_cast<int*>(counts), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = ms::rank_tiles(get, emit, rows, s, 256, static_cast<const int*>(hist),
                         static_cast<const int*>(counts), 1, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaGetLastError());
}
