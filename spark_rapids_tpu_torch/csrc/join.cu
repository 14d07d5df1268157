// Single fixed-width-key inner equi-join of the port: a sorted build side,
// a binary-search probe and the expansion into gather maps.  Built for
// sm_90a by kernels/_lib.py and called through ctypes from kernels/join.py.
// Every entry point launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of its launches.
//
// <- spark_rapids_tpu/kernels/join.py:154 _probe_single, :226
//    _expand_single (behind join_probe :457, join_expand :484,
//    join_gather_maps :496)
//
// Keys.  Every key becomes the order-preserving uint64 of csrc/sort.cu:
// integers (int, date, long, Decimal64) sign-extend to 64 bits and flip
// the sign bit, so an int key and a long key compare by value; doubles
// take Java's total order after -0.0 -> 0.0 and every NaN -> the
// canonical NaN, so -0.0 matches 0.0 and NaN matches NaN (Spark's join
// equality); bool is 0 or 1.  A null key matches nothing.
//
// Build (once per query).  The wrapper sorts the build rows by their key
// with the ported radix sort, nulls last (perm); join_build_keys_kernel
// writes the key and the validity of each sorted position.  The null tail
// needs no host read of its length: the probe's comparisons treat a null
// build row as greater than every key.
//   Bound: bytes: per build row its key, validity and perm read, 9 bytes
//   written.
//
// Probe.  One thread per stream row runs a lower and an upper bound over
// the sorted build keys (log2 of the build size steps, from L2: the
// build of q3's path is 186 and ~857 keys), and writes the first match
// and the number of matches.  A multi-column exclusive scan
// (csrc/scan.cuh) turns the counts into output offsets and the total,
// which the wrapper reads back once to allocate the maps.
//   Bound: bytes: per stream row the key and validity read, 8 bytes of
//   (lo, count) written and read by the scan (the search steps are L2
//   hits, not counted).
//
// Expand.  One thread per stream row writes its (li = row, ri =
// perm[lo + j]) pairs at its offset: rows in stream order, each row's
// matches in build order (the radix sort is stable), as the reference's.
//   Bound: bytes: 8 bytes per output pair, plus each matched row's lo,
//   count and offset.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;

// key kinds (kernels/join.py _KIND)
constexpr int kInt32 = 0;   // int, date
constexpr int kInt64 = 1;   // long, Decimal64
constexpr int kF64 = 2;     // double
constexpr int kBool = 3;    // bool

__device__ __forceinline__ uint64_t order_key(const void* data, int kind,
                                              int64_t r) {
  switch (kind) {
    case kInt32:
      return static_cast<uint64_t>(static_cast<int64_t>(
                 static_cast<const int32_t*>(data)[r])) ^ (1ull << 63);
    case kInt64:
      return static_cast<uint64_t>(static_cast<const int64_t*>(data)[r]) ^
             (1ull << 63);
    case kF64: {
      double d = static_cast<const double*>(data)[r];
      uint64_t bits;
      if (d != d) {
        bits = 0x7FF8000000000000ull;      // canonical NaN
      } else {
        if (d == 0.0) d = 0.0;             // -0.0 -> 0.0
        bits = static_cast<uint64_t>(__double_as_longlong(d));
      }
      return (bits >> 63) ? ~bits : (bits | (1ull << 63));
    }
    default:
      return static_cast<const uint8_t*>(data)[r] != 0;
  }
}

__global__ void __launch_bounds__(kThreads)
join_build_keys_kernel(const void* __restrict__ data,
                       const uint8_t* __restrict__ valid, int kind,
                       const int32_t* __restrict__ perm, int64_t n,
                       uint64_t* __restrict__ keys,
                       uint8_t* __restrict__ key_valid) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = perm[i];
  const bool v = valid[r] != 0;
  key_valid[i] = v;
  keys[i] = v ? order_key(data, kind, r) : 0ull;
}

__global__ void __launch_bounds__(kThreads)
join_probe_kernel(const void* __restrict__ data,
                  const uint8_t* __restrict__ valid, int kind, int64_t n,
                  const uint64_t* __restrict__ keys,
                  const uint8_t* __restrict__ key_valid, int64_t nb,
                  int32_t* __restrict__ lo_out, int32_t* __restrict__ count) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  if (valid[r] == 0) {     // a null key matches nothing
    lo_out[r] = 0;
    count[r] = 0;
    return;
  }
  const uint64_t k = order_key(data, kind, r);
  // lower bound: the first build position not less than k (a null build
  // row is greater than every key)
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (key_valid[mid] != 0 && keys[mid] < k) lo = mid + 1; else hi = mid;
  }
  const int64_t first = lo;
  hi = nb;   // upper bound: the first position greater than k
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (key_valid[mid] != 0 && keys[mid] <= k) lo = mid + 1; else hi = mid;
  }
  lo_out[r] = static_cast<int32_t>(first);
  count[r] = static_cast<int32_t>(lo - first);
}

__global__ void __launch_bounds__(kThreads)
join_expand_kernel(const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ perm, int64_t n,
                   int32_t* __restrict__ li, int32_t* __restrict__ ri) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t base = offsets[r];
  const int32_t m = offsets[r + 1] - base;
  const int32_t first = lo[r];
  for (int32_t j = 0; j < m; ++j) {
    li[base + j] = static_cast<int32_t>(r);
    ri[base + j] = perm[first + j];
  }
}

unsigned grid_rows(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int srt_join_scan_tile() { return scan::kScanTile; }

// keys[n] (uint64) and key_valid[n] of the build rows in sorted order perm.
int srt_join_build_keys(int kind, const void* data, const uint8_t* valid,
                        const int32_t* perm, int64_t n, uint64_t* keys,
                        uint8_t* key_valid, cudaStream_t stream) {
  if (kind < kInt32 || kind > kBool) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    join_build_keys_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        data, valid, kind, perm, n, keys, key_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// For n stream rows against nb sorted build keys: lo[n], the first match,
// and offsets[n + 1], the exclusive scan of the match counts (int32), with
// total[0] (int64) the number of pairs.  tile_sums holds ceil(n /
// srt_join_scan_tile()) int64, at least one.
int srt_join_probe(int kind, const void* data, const uint8_t* valid,
                   int64_t n, const uint64_t* keys, const uint8_t* key_valid,
                   int64_t nb, int32_t* lo, int32_t* offsets,
                   int64_t* tile_sums, int64_t* total, cudaStream_t stream) {
  if (kind < kInt32 || kind > kBool) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    join_probe_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        data, valid, kind, n, keys, key_valid, nb, lo, offsets);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan::ScanCols cols{};
  cols.v[0] = offsets;
  return scan::scan_columns(cols, 1, n, tile_sums, total, stream);
}

// li[total] and ri[total]: the pairs, after srt_join_probe.
int srt_join_expand(const int32_t* lo, const int32_t* offsets,
                    const int32_t* perm, int64_t n, int32_t* li, int32_t* ri,
                    cudaStream_t stream) {
  if (n > 0) {
    join_expand_kernel<<<grid_rows(n), kThreads, 0, stream>>>(lo, offsets,
                                                              perm, n, li, ri);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
