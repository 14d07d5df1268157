// Multi-column exclusive scan of int32 counts, in place, shared by the
// string gather (csrc/selection.cu: gathered lengths -> offsets) and the
// join (csrc/join.cu: match counts -> output offsets).  Everything here is
// in namespace scan inside an anonymous namespace, so each source that
// includes it gets its own copy and nothing is exported.
//
// For each of ncols arrays v[c][0..m) (m + 1 slots), v[c][i] becomes the sum
// of v[c][0..i), v[c][m] the total truncated to int32, and totals[c] the
// total as int64 (the caller reads it back and raises at >= 2**31).  Three
// launches, no atomics, so the result is deterministic:
//   (1) scan_tile_kernel: grid (tiles, ncols), each block sums one tile;
//   (2) scan_carry_kernel: one block per column scans its tile sums in
//       place (carried across chunks of kScanCarryThreads) and writes the
//       total;
//   (3) scan_apply_kernel: each block re-reads its tile in the blocked
//       arrangement (thread t owns kScanItems consecutive slots), scans it
//       with cub::BlockScan and writes its own slots back, so the scan can
//       run in place.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {
namespace scan {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanCarryThreads = 256;   // 1024 int64 lanes spill
constexpr int kMaxScanCols = 16;

struct ScanCols {
  int32_t* v[kMaxScanCols];
};

__global__ void __launch_bounds__(kScanThreads)
scan_tile_kernel(ScanCols cols, int64_t m, int64_t ntiles,
                 int64_t* __restrict__ tile_sums) {
  using Reduce = cub::BlockReduce<int64_t, kScanThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int32_t* v = cols.v[blockIdx.y];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  int64_t s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t j = base + static_cast<int64_t>(i) * kScanThreads + threadIdx.x;
    if (j < m) s += v[j];
  }
  const int64_t total = Reduce(tmp).Sum(s);
  if (threadIdx.x == 0) {
    tile_sums[static_cast<int64_t>(blockIdx.y) * ntiles + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kScanCarryThreads)
scan_carry_kernel(ScanCols cols, int64_t m, int64_t ntiles,
                  int64_t* __restrict__ tile_sums,
                  int64_t* __restrict__ totals) {
  using Scan = cub::BlockScan<int64_t, kScanCarryThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int64_t carry;
  int64_t* row = tile_sums + static_cast<int64_t>(blockIdx.x) * ntiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t start = 0; start < ntiles; start += kScanCarryThreads) {
    const int64_t i = start + threadIdx.x;
    const int64_t x = i < ntiles ? row[i] : 0;
    int64_t excl, chunk_total;
    Scan(tmp).ExclusiveSum(x, excl, chunk_total);
    if (i < ntiles) row[i] = carry + excl;
    __syncthreads();  // every thread has read carry and released tmp
    if (threadIdx.x == 0) carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    totals[blockIdx.x] = carry;
    cols.v[blockIdx.x][m] = static_cast<int32_t>(carry);
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_apply_kernel(ScanCols cols, int64_t m, int64_t ntiles,
                  const int64_t* __restrict__ tile_sums) {
  using Scan = cub::BlockScan<int64_t, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  int32_t* v = cols.v[blockIdx.y];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile +
                       static_cast<int64_t>(threadIdx.x) * kScanItems;
  int32_t x[kScanItems];
  int64_t s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    x[i] = base + i < m ? v[base + i] : 0;
    s += x[i];
  }
  int64_t run;
  Scan(tmp).ExclusiveSum(s, run);
  run += tile_sums[static_cast<int64_t>(blockIdx.y) * ntiles + blockIdx.x];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < m) v[base + i] = static_cast<int32_t>(run);
    run += x[i];
  }
}

// tile_sums holds ncols * ceil(m / kScanTile) int64 (at least one).
inline int scan_columns(ScanCols cols, int ncols, int64_t m,
                        int64_t* tile_sums, int64_t* totals,
                        cudaStream_t stream) {
  if (ncols < 1 || ncols > kMaxScanCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ntiles = (m + kScanTile - 1) / kScanTile;
  if (ntiles > 0) {
    scan_tile_kernel<<<dim3(static_cast<unsigned>(ntiles), ncols),
                       kScanThreads, 0, stream>>>(cols, m, ntiles, tile_sums);
  }
  scan_carry_kernel<<<ncols, kScanCarryThreads, 0, stream>>>(
      cols, m, ntiles, tile_sums, totals);
  if (ntiles > 0) {
    scan_apply_kernel<<<dim3(static_cast<unsigned>(ntiles), ncols),
                        kScanThreads, 0, stream>>>(cols, m, ntiles, tile_sums);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan
}  // namespace
