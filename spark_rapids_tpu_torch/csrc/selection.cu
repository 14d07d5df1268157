// Row-selection kernels of the port: stream compaction, gather and concat,
// fixed-width and string.  Built for sm_90a by kernels/_lib.py and called through ctypes
// from kernels/selection.py.  Every entry point launches on the caller's
// stream, allocates nothing, and returns the cudaError_t of its launches.
//
// compaction  <- spark_rapids_tpu/kernels/selection.py:65 compaction_map
//   Bound: bytes.  It reads the bool mask once per pass (n bytes, twice) and
//   writes 4 bytes per selected row; at q6's 1.8% selectivity the mask
//   reads dominate.  Design: three launches with no atomics, so the output
//   is stable (row order kept, as Spark's filter needs) and deterministic:
//   (1) per-tile counts with cub::BlockReduce, (2) one block scans the tile
//   counts into tile offsets and the total, (3) each tile re-reads its mask
//   bytes, ranks them with cub::BlockScan and writes the row ids.  The
//   wrapper reads the total between (2) and (3) and allocates the output at
//   its exact size, the cuDF count-then-allocate pattern.
//
// gather      <- spark_rapids_tpu/kernels/selection.py:84 gather_column,
//                :191 gather_batch
//   Bound: bytes: 4 bytes of index plus (width + 1) bytes read and written
//   per output row and column; a width is 1, 2, 4, 8 or 16 bytes (a
//   Decimal128 row's two limbs) or a multiple of 16 (a fixed-length array
//   row: HyperLogLog's 512 registers), moved as 16-byte chunks by the row's
//   thread; the entry points refuse any other width, which the wrapper
//   (kernels/selection.py _row_bytes) refuses first.  Design: one launch for up to kMaxGatherCols
//   columns, passed by value as a parameter struct; each thread reads its
//   row index once and moves that row of every column, so the index map is
//   read once per batch and not once per column.  Reads are random (the
//   map's rows are sorted, so neighbouring threads mostly hit neighbouring
//   sectors at high selectivity and scattered ones at low).  An index out
//   of [0, n_src) gives a null row with zero data, as at selection.py:110.
//   That makes it the join's null-extending gather too (selection.py:308
//   gather_batch_checked): a left join's -1 gives a null row, a string
//   row of length 0 whose bytes are never read, and a source of no rows
//   (an empty build) is never read at all.
//
// gather of string planes <- spark_rapids_tpu/kernels/selection.py:84
//                gather_column, string branch :160-186
//   Count, then allocate.  In the same launch as the fixed-width columns, a
//   string column (width 0) writes each output row's length (0 for a null
//   or out-of-range row) into its new offsets plane; a multi-column
//   exclusive scan (csrc/scan.cuh) turns the lengths into offsets and the
//   byte totals; the wrapper reads the totals back once, allocates the
//   bytes, and gather_bytes_kernel copies each row's bytes with L threads
//   per row (L = 1, 8 or 32 from the average length, so short strings do
//   not idle a warp and long ones are read by neighbouring lanes).
//   Bound: bytes: per row 4 bytes of index, 8 of source offsets, 4 + 1
//   written, plus each gathered byte read and written once.
//
// concat      <- spark_rapids_tpu/kernels/selection.py:429
//                concat_batches_device (fixed-width planes)
//   Bound: bytes: (width + 1) bytes read and written per row.  Design: one
//   launch per column over all k pieces; a device array holds the pieces'
//   data and validity pointers and their row offsets, and each output row
//   finds its piece by binary search over the k + 1 offsets (k is ~58 on
//   the q6 path, so the search stays in L1).
//
// concat of string planes <- spark_rapids_tpu/kernels/selection.py:429
//                concat_batches_device (string planes)
//   A piece's offsets need not start at 0 (a shuffle block is a view), so
//   each piece is rebased.  One block scans the pieces' byte counts
//   (offsets[n_p] - offsets[0]) into byte bases and the total, which the
//   wrapper reads back once to allocate the bytes; then one thread per
//   output row writes validity and the rebased offset, and one thread per
//   output byte copies it from its piece (found by binary search over the
//   byte bases; each piece's bytes are contiguous).
//   Bound: bytes: per row 4 + 1 read and written, per byte 1 read and 1
//   written.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "scan.cuh"

namespace {

constexpr int kCompactThreads = 256;
constexpr int kCompactItems = 8;
constexpr int kCompactTile = kCompactThreads * kCompactItems;
constexpr int kScanThreads = 1024;
constexpr int kMaxGatherCols = 16;
constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kCompactThreads)
compaction_count_kernel(const uint8_t* __restrict__ mask, int64_t n,
                        int32_t* __restrict__ tile_counts) {
  using Reduce = cub::BlockReduce<int, kCompactThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCompactTile;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kCompactItems; ++i) {
    // striped: neighbouring threads read neighbouring bytes
    const int64_t j = base + static_cast<int64_t>(i) * kCompactThreads + threadIdx.x;
    if (j < n) c += mask[j] != 0;
  }
  const int total = Reduce(tmp).Sum(c);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: exclusive scan of the tile counts, carried across chunks of
// kScanThreads; tile_offsets[ntiles] receives the total.
__global__ void __launch_bounds__(kScanThreads)
compaction_scan_kernel(const int32_t* __restrict__ tile_counts, int64_t ntiles,
                       int32_t* __restrict__ tile_offsets) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t start = 0; start < ntiles; start += kScanThreads) {
    const int64_t i = start + threadIdx.x;
    const int v = i < ntiles ? tile_counts[i] : 0;
    int excl, chunk_total;
    Scan(tmp).ExclusiveSum(v, excl, chunk_total);
    if (i < ntiles) tile_offsets[i] = carry + excl;
    __syncthreads();  // every thread has read carry and released tmp
    if (threadIdx.x == 0) carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_offsets[ntiles] = carry;
}

__global__ void __launch_bounds__(kCompactThreads)
compaction_scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
                          const int32_t* __restrict__ tile_offsets,
                          int32_t* __restrict__ out) {
  using Scan = cub::BlockScan<int, kCompactThreads>;
  __shared__ typename Scan::TempStorage tmp;
  // blocked: thread t owns rows [t * items, (t + 1) * items) of the tile,
  // so an exclusive scan of per-thread counts gives stable ranks
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCompactTile +
                       static_cast<int64_t>(threadIdx.x) * kCompactItems;
  bool keep[kCompactItems];
  int c = 0;
#pragma unroll
  for (int i = 0; i < kCompactItems; ++i) {
    const int64_t j = base + i;
    keep[i] = j < n && mask[j] != 0;
    c += keep[i];
  }
  int rank;
  Scan(tmp).ExclusiveSum(c, rank);
  int32_t pos = tile_offsets[blockIdx.x] + rank;
#pragma unroll
  for (int i = 0; i < kCompactItems; ++i) {
    if (keep[i]) out[pos++] = static_cast<int32_t>(base + i);
  }
}

struct GatherCols {
  const void* src[kMaxGatherCols];
  const uint8_t* src_valid[kMaxGatherCols];
  void* dst[kMaxGatherCols];
  uint8_t* dst_valid[kMaxGatherCols];
  int width[kMaxGatherCols];
};

template <typename W>
__device__ __forceinline__ void move_row(const void* src, void* dst,
                                         int32_t s, int64_t r, bool valid) {
  static_cast<W*>(dst)[r] = valid ? static_cast<const W*>(src)[s] : W(0);
}

// a Decimal128 row: its two int64 limbs (8-byte aligned, not 16)
struct Limbs2 {
  uint64_t lo, hi;
  Limbs2() = default;
  __device__ explicit Limbs2(int) : lo(0), hi(0) {}
};

// a wider fixed-stride row (a multiple of 16 bytes: a fixed-length array,
// HyperLogLog's registers) as 16-byte chunks; nothing read when !valid
__device__ __forceinline__ void move_wide_row(int chunks, const void* src,
                                              void* dst, int32_t s, int64_t r,
                                              bool valid) {
  const Limbs2* from = static_cast<const Limbs2*>(src) +
                       static_cast<int64_t>(s) * chunks;
  Limbs2* to = static_cast<Limbs2*>(dst) + r * chunks;
  for (int c = 0; c < chunks; ++c) to[c] = valid ? from[c] : Limbs2(0);
}

// the widths the row moves take (width_ok); a string plane is width 0
__device__ __forceinline__ void move_row_width(int width, const void* src,
                                               void* dst, int32_t s, int64_t r,
                                               bool valid) {
  switch (width) {
    case 16: move_row<Limbs2>(src, dst, s, r, valid); break;
    case 8: move_row<uint64_t>(src, dst, s, r, valid); break;
    case 4: move_row<uint32_t>(src, dst, s, r, valid); break;
    case 2: move_row<uint16_t>(src, dst, s, r, valid); break;
    case 1: move_row<uint8_t>(src, dst, s, r, valid); break;
    default: move_wide_row(width / 16, src, dst, s, r, valid); break;
  }
}

bool width_ok(int width) {
  return width == 1 || width == 2 || width == 4 || width == 8 ||
         (width >= 16 && width % 16 == 0);
}

__global__ void __launch_bounds__(kRowThreads)
gather_kernel(GatherCols cols, int ncols, const int32_t* __restrict__ idx,
              int64_t m, int64_t n_src) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (r >= m) return;
  const int32_t s = idx[r];
  const bool inb = s >= 0 && s < n_src;
  for (int c = 0; c < ncols; ++c) {
    const bool v = inb && cols.src_valid[c][s] != 0;  // no read when !inb
    cols.dst_valid[c][r] = v;
    if (cols.width[c] == 0) {   // string: the row's length, scanned later
      const int32_t* so = static_cast<const int32_t*>(cols.src[c]);
      static_cast<int32_t*>(cols.dst[c])[r] = v ? so[s + 1] - so[s] : 0;
    } else {
      move_row_width(cols.width[c], cols.src[c], cols.dst[c], s, r, v);
    }
  }
}

struct StringCols {
  const int32_t* src_off[kMaxGatherCols];
  const uint8_t* src[kMaxGatherCols];
  const int32_t* dst_off[kMaxGatherCols];
  uint8_t* dst[kMaxGatherCols];
};

// grid (ceil(m * L / kRowThreads), string columns): L threads per row
template <int L>
__global__ void __launch_bounds__(kRowThreads)
gather_bytes_kernel(StringCols cols, const int32_t* __restrict__ idx,
                    int64_t m) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  const int64_t r = t / L;
  const int lane = static_cast<int>(t % L);
  if (r >= m) return;
  const int c = blockIdx.y;
  const int32_t d0 = cols.dst_off[c][r];
  const int32_t len = cols.dst_off[c][r + 1] - d0;
  if (len == 0) return;   // null, empty or out of range: nothing to read
  const int32_t s0 = cols.src_off[c][idx != nullptr ? idx[r] : r];
  for (int32_t b = lane; b < len; b += L) cols.dst[c][d0 + b] = cols.src[c][s0 + b];
}

// desc: [k] data pointers then [k] validity pointers; offsets: [k + 1].
__global__ void __launch_bounds__(kRowThreads)
concat_kernel(const uint64_t* __restrict__ desc,
              const int64_t* __restrict__ offsets, int k, int width,
              void* __restrict__ dst, uint8_t* __restrict__ dst_valid,
              int64_t total) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (r >= total) return;
  int lo = 0, hi = k - 1;  // largest p with offsets[p] <= r
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= r) lo = mid; else hi = mid - 1;
  }
  const int32_t within = static_cast<int32_t>(r - offsets[lo]);
  const void* src = reinterpret_cast<const void*>(desc[lo]);
  const uint8_t* src_valid = reinterpret_cast<const uint8_t*>(desc[k + lo]);
  const bool v = src_valid[within] != 0;
  dst_valid[r] = v;
  move_row_width(width, src, dst, within, r, v);
}

// desc: [k] offsets pointers, [k] validity pointers, [k] data pointers;
// rows: [k + 1] row offsets.  One block: bases[p] = the bytes of pieces
// before p, bases[k] = the total.
__global__ void __launch_bounds__(kRowThreads)
concat_string_bases_kernel(const uint64_t* __restrict__ desc,
                           const int64_t* __restrict__ rows, int k,
                           int64_t* __restrict__ bases) {
  using Scan = cub::BlockScan<int64_t, kRowThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int64_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int start = 0; start < k; start += kRowThreads) {
    const int p = start + threadIdx.x;
    int64_t bytes = 0;
    if (p < k) {
      const int32_t* so = reinterpret_cast<const int32_t*>(desc[p]);
      bytes = so[rows[p + 1] - rows[p]] - so[0];
    }
    int64_t excl, chunk_total;
    Scan(tmp).ExclusiveSum(bytes, excl, chunk_total);
    if (p < k) bases[p] = carry + excl;
    __syncthreads();
    if (threadIdx.x == 0) carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) bases[k] = carry;
}

// the largest p in [0, k) with bounds[p] <= x
__device__ __forceinline__ int piece_of(const int64_t* bounds, int k,
                                        int64_t x) {
  int lo = 0, hi = k - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bounds[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kRowThreads)
concat_string_rows_kernel(const uint64_t* __restrict__ desc,
                          const int64_t* __restrict__ rows,
                          const int64_t* __restrict__ bases, int k,
                          int32_t* __restrict__ dst_off,
                          uint8_t* __restrict__ dst_valid, int64_t total) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (r >= total) return;
  const int p = piece_of(rows, k, r);
  const int64_t within = r - rows[p];
  const int32_t* so = reinterpret_cast<const int32_t*>(desc[p]);
  const uint8_t* sv = reinterpret_cast<const uint8_t*>(desc[k + p]);
  dst_valid[r] = sv[within] != 0;
  dst_off[r] = static_cast<int32_t>(bases[p] + so[within] - so[0]);
  if (r == 0) dst_off[total] = static_cast<int32_t>(bases[k]);
}

__global__ void __launch_bounds__(kRowThreads)
concat_string_bytes_kernel(const uint64_t* __restrict__ desc,
                           const int64_t* __restrict__ bases, int k,
                           uint8_t* __restrict__ dst, int64_t total_bytes) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (b >= total_bytes) return;
  const int p = piece_of(bases, k, b);
  const int32_t* so = reinterpret_cast<const int32_t*>(desc[p]);
  const uint8_t* sd = reinterpret_cast<const uint8_t*>(desc[2 * k + p]);
  dst[b] = sd[so[0] + (b - bases[p])];
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

int srt_compaction_tile() { return kCompactTile; }

int srt_max_gather_cols() { return kMaxGatherCols; }

int srt_scan_tile() { return scan::kScanTile; }

// Steps (1) and (2): tile_counts[ntiles], tile_offsets[ntiles + 1].
int srt_compaction_count(const uint8_t* mask, int64_t n, int32_t* tile_counts,
                         int32_t* tile_offsets, cudaStream_t stream) {
  const int64_t ntiles = cdiv(n, kCompactTile);
  if (ntiles > 0) {
    compaction_count_kernel<<<static_cast<unsigned>(ntiles), kCompactThreads, 0,
                              stream>>>(mask, n, tile_counts);
  }
  compaction_scan_kernel<<<1, kScanThreads, 0, stream>>>(tile_counts, ntiles,
                                                          tile_offsets);
  return static_cast<int>(cudaGetLastError());
}

// Step (3): out[total] receives the selected row ids in row order.
int srt_compaction_scatter(const uint8_t* mask, int64_t n,
                           const int32_t* tile_offsets, int32_t* out,
                           cudaStream_t stream) {
  const int64_t ntiles = cdiv(n, kCompactTile);
  if (ntiles > 0) {
    compaction_scatter_kernel<<<static_cast<unsigned>(ntiles), kCompactThreads,
                                0, stream>>>(mask, n, tile_offsets, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Host arrays of ncols (<= kMaxGatherCols) column pointers and widths.  A
// string column has width 0, its source offsets in src and its new offsets
// plane (m + 1 int32) in dst: those planes are scanned in place after the
// row pass, and totals[j] (int64) receives the byte count of the j-th
// string column; tile_sums holds (string columns) * ceil(m /
// srt_scan_tile()) int64, at least one.  Without string columns both may
// be null.
int srt_gather(int ncols, const void* const* src,
               const uint8_t* const* src_valid, void* const* dst,
               uint8_t* const* dst_valid, const int* widths, int64_t n_src,
               const int32_t* idx, int64_t m, int64_t* tile_sums,
               int64_t* totals, cudaStream_t stream) {
  if (ncols < 1 || ncols > kMaxGatherCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherCols cols{};
  scan::ScanCols strings{};
  int nstr = 0;
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = src[c];
    cols.src_valid[c] = src_valid[c];
    cols.dst[c] = dst[c];
    cols.dst_valid[c] = dst_valid[c];
    cols.width[c] = widths[c];
    if (widths[c] == 0) {
      strings.v[nstr++] = static_cast<int32_t*>(dst[c]);
    } else if (!width_ok(widths[c])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (nstr > 0 && (tile_sums == nullptr || totals == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m > 0) {
    gather_kernel<<<static_cast<unsigned>(cdiv(m, kRowThreads)), kRowThreads,
                    0, stream>>>(cols, ncols, idx, m, n_src);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0 && nstr > 0) {
    err = scan::scan_columns(strings, nstr, m, tile_sums, totals, stream);
  }
  return err;
}

// The bytes of nstr gathered string columns, after srt_gather: host arrays
// of source offsets, source bytes, new offsets and new bytes; lanes (1, 8
// or 32) threads copy one row.  With idx null, row r's bytes start at
// src_off[c][r]: a plane of per-row source starts (SUBSTRING's kept ranges,
// csrc/strings.cu).
int srt_gather_bytes(int nstr, const int32_t* const* src_off,
                     const uint8_t* const* src, const int32_t* const* dst_off,
                     uint8_t* const* dst, const int32_t* idx, int64_t m,
                     int lanes, cudaStream_t stream) {
  if (nstr < 1 || nstr > kMaxGatherCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StringCols cols{};
  for (int c = 0; c < nstr; ++c) {
    cols.src_off[c] = src_off[c];
    cols.src[c] = src[c];
    cols.dst_off[c] = dst_off[c];
    cols.dst[c] = dst[c];
  }
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(cdiv(m * lanes, kRowThreads)),
                  static_cast<unsigned>(nstr));
  switch (lanes) {
    case 1:
      gather_bytes_kernel<1><<<grid, kRowThreads, 0, stream>>>(cols, idx, m);
      break;
    case 8:
      gather_bytes_kernel<8><<<grid, kRowThreads, 0, stream>>>(cols, idx, m);
      break;
    case 32:
      gather_bytes_kernel<32><<<grid, kRowThreads, 0, stream>>>(cols, idx, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_concat(const uint64_t* desc, const int64_t* offsets, int k, int width,
               void* dst, uint8_t* dst_valid, int64_t total,
               cudaStream_t stream) {
  if (k < 1 || !width_ok(width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    concat_kernel<<<static_cast<unsigned>(cdiv(total, kRowThreads)), kRowThreads,
                    0, stream>>>(desc, offsets, k, width, dst, dst_valid, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// Step 1 of a string concat: bases[k + 1] (int64), the byte base of each
// piece and the total.  desc: [k] offsets, [k] validity and [k] data
// pointers; rows: [k + 1] row offsets (int64), both on the device.
int srt_concat_string_bases(const uint64_t* desc, const int64_t* rows, int k,
                            int64_t* bases, cudaStream_t stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  concat_string_bases_kernel<<<1, kRowThreads, 0, stream>>>(desc, rows, k,
                                                             bases);
  return static_cast<int>(cudaGetLastError());
}

// Step 2: the rebased offsets (total + 1), validity (total) and bytes
// (total_bytes, read back from bases[k]).
int srt_concat_strings(const uint64_t* desc, const int64_t* rows,
                       const int64_t* bases, int k, int32_t* dst_off,
                       uint8_t* dst_valid, uint8_t* dst, int64_t total,
                       int64_t total_bytes, cudaStream_t stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (total > 0) {
    concat_string_rows_kernel<<<static_cast<unsigned>(cdiv(total, kRowThreads)),
                                kRowThreads, 0, stream>>>(
        desc, rows, bases, k, dst_off, dst_valid, total);
  }
  if (total_bytes > 0) {
    concat_string_bytes_kernel<<<static_cast<unsigned>(
                                     cdiv(total_bytes, kRowThreads)),
                                 kRowThreads, 0, stream>>>(desc, bases, k, dst,
                                                           total_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
