// Whole-batch masked reduction of the port: SUM over the valid rows of one
// f64 or i64 column, with the count of valid rows and the "nvalid > 0" flag.
// Built for sm_90a by kernels/_lib.py and called through ctypes from
// kernels/reduction.py.  The entry point launches on the caller's stream,
// allocates nothing, and returns the cudaError_t of its launches.
//
// Replaces spark_rapids_tpu/plan/execs/aggregate.py:274 _global_update
// (SUM and COUNT_VALID; COUNT_STAR is the batch's host row count in the
// exact-size port, and its merge is this SUM over i64 partial counts).
//
// Bound: bytes.  It reads 8 + 1 bytes per row once and writes 17 bytes.
// Design: two deterministic passes and no atomics, so a float sum is the
// same from run to run.  Pass 1 gives each block a fixed tile of rows and
// writes the tile's (sum, count) to a scratch array with cub::BlockReduce;
// pass 2 is one block that folds the tile partials in a fixed order and
// writes value[0] (0 when no row is valid), valid[0] and count[0].  i64
// sums add as uint64 so that they wrap as jnp.sum does, without signed
// overflow.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kFinalThreads = 1024;

template <typename T> struct Acc;
template <> struct Acc<double> { using type = double; };
template <> struct Acc<int64_t> { using type = unsigned long long; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_sum_tiles(const T* __restrict__ data, const uint8_t* __restrict__ valid,
                 int64_t n, typename Acc<T>::type* __restrict__ tile_sum,
                 int64_t* __restrict__ tile_cnt) {
  using A = typename Acc<T>::type;
  using ReduceA = cub::BlockReduce<A, kThreads>;
  using ReduceN = cub::BlockReduce<int64_t, kThreads>;
  __shared__ typename ReduceA::TempStorage tmp_a;
  __shared__ typename ReduceN::TempStorage tmp_n;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  A s = A(0);
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + static_cast<int64_t>(i) * kThreads + threadIdx.x;
    if (j < n && valid[j]) {
      s += static_cast<A>(data[j]);
      ++c;
    }
  }
  const A bs = ReduceA(tmp_a).Sum(s);
  const int64_t bc = ReduceN(tmp_n).Sum(c);
  if (threadIdx.x == 0) {
    tile_sum[blockIdx.x] = bs;
    tile_cnt[blockIdx.x] = bc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
masked_sum_final(const typename Acc<T>::type* __restrict__ tile_sum,
                 const int64_t* __restrict__ tile_cnt, int64_t ntiles,
                 T* __restrict__ value, uint8_t* __restrict__ out_valid,
                 int64_t* __restrict__ count) {
  using A = typename Acc<T>::type;
  using ReduceA = cub::BlockReduce<A, kFinalThreads>;
  using ReduceN = cub::BlockReduce<int64_t, kFinalThreads>;
  __shared__ typename ReduceA::TempStorage tmp_a;
  __shared__ typename ReduceN::TempStorage tmp_n;
  A s = A(0);
  int64_t c = 0;
  for (int64_t i = threadIdx.x; i < ntiles; i += kFinalThreads) {
    s += tile_sum[i];
    c += tile_cnt[i];
  }
  const A total = ReduceA(tmp_a).Sum(s);
  const int64_t nvalid = ReduceN(tmp_n).Sum(c);
  if (threadIdx.x == 0) {
    value[0] = nvalid > 0 ? static_cast<T>(total) : T(0);
    out_valid[0] = nvalid > 0;
    count[0] = nvalid;
  }
}

template <typename T>
int launch(const T* data, const uint8_t* valid, int64_t n, void* scratch_sum,
           int64_t* scratch_cnt, T* value, uint8_t* out_valid, int64_t* count,
           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  A* tile_sum = static_cast<A*>(scratch_sum);
  if (ntiles > 0) {
    masked_sum_tiles<T><<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
        data, valid, n, tile_sum, scratch_cnt);
  }
  masked_sum_final<T><<<1, kFinalThreads, 0, stream>>>(
      tile_sum, scratch_cnt, ntiles, value, out_valid, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int srt_reduction_tile() { return kTile; }

// is_f64: 1 for double data, 0 for int64.  scratch_sum and scratch_cnt hold
// one 8-byte slot per tile of srt_reduction_tile() rows (at least one).
int srt_masked_sum(int is_f64, const void* data, const uint8_t* valid,
                   int64_t n, void* scratch_sum, int64_t* scratch_cnt,
                   void* value, uint8_t* out_valid, int64_t* count,
                   cudaStream_t stream) {
  if (is_f64) {
    return launch<double>(static_cast<const double*>(data), valid, n,
                          scratch_sum, scratch_cnt, static_cast<double*>(value),
                          out_valid, count, stream);
  }
  return launch<int64_t>(static_cast<const int64_t*>(data), valid, n,
                         scratch_sum, scratch_cnt, static_cast<int64_t*>(value),
                         out_valid, count, stream);
}

}  // extern "C"
