// Row-selection kernels of the port: stream compaction, fixed-width gather
// and concat.  Built for sm_90a by kernels/_lib.py and called through ctypes
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
//   per output row and column.  Design: one launch for up to kMaxGatherCols
//   columns, passed by value as a parameter struct; each thread reads its
//   row index once and moves that row of every column, so the index map is
//   read once per batch and not once per column.  Reads are random (the
//   map's rows are sorted, so neighbouring threads mostly hit neighbouring
//   sectors at high selectivity and scattered ones at low).  An index out
//   of [0, n_src) gives a null row with zero data, as at selection.py:110.
//
// concat      <- spark_rapids_tpu/kernels/selection.py:429
//                concat_batches_device (fixed-width planes)
//   Bound: bytes: (width + 1) bytes read and written per row.  Design: one
//   launch per column over all k pieces; a device array holds the pieces'
//   data and validity pointers and their row offsets, and each output row
//   finds its piece by binary search over the k + 1 offsets (k is ~58 on
//   the q6 path, so the search stays in L1).
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

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

__device__ __forceinline__ void move_row_width(int width, const void* src,
                                               void* dst, int32_t s, int64_t r,
                                               bool valid) {
  switch (width) {
    case 8: move_row<uint64_t>(src, dst, s, r, valid); break;
    case 4: move_row<uint32_t>(src, dst, s, r, valid); break;
    case 2: move_row<uint16_t>(src, dst, s, r, valid); break;
    default: move_row<uint8_t>(src, dst, s, r, valid); break;
  }
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
    move_row_width(cols.width[c], cols.src[c], cols.dst[c], s, r, v);
  }
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

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

int srt_compaction_tile() { return kCompactTile; }

int srt_max_gather_cols() { return kMaxGatherCols; }

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

// Host arrays of ncols (<= kMaxGatherCols) column pointers and widths.
int srt_gather(int ncols, const void* const* src,
               const uint8_t* const* src_valid, void* const* dst,
               uint8_t* const* dst_valid, const int* widths, int64_t n_src,
               const int32_t* idx, int64_t m, cudaStream_t stream) {
  if (ncols < 1 || ncols > kMaxGatherCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherCols cols{};
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = src[c];
    cols.src_valid[c] = src_valid[c];
    cols.dst[c] = dst[c];
    cols.dst_valid[c] = dst_valid[c];
    cols.width[c] = widths[c];
  }
  if (m > 0) {
    gather_kernel<<<static_cast<unsigned>(cdiv(m, kRowThreads)), kRowThreads,
                    0, stream>>>(cols, ncols, idx, m, n_src);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_concat(const uint64_t* desc, const int64_t* offsets, int k, int width,
               void* dst, uint8_t* dst_valid, int64_t total,
               cudaStream_t stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (total > 0) {
    concat_kernel<<<static_cast<unsigned>(cdiv(total, kRowThreads)), kRowThreads,
                    0, stream>>>(desc, offsets, k, width, dst, dst_valid, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
