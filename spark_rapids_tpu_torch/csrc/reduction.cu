// Reductions of the port over f64 or i64 columns with validity: the
// whole-batch masked sum and the segmented sum of a grouped aggregate.
// Built for sm_90a by kernels/_lib.py and called through ctypes from
// kernels/reduction.py.  Every entry point launches on the caller's stream,
// allocates nothing, and returns the cudaError_t of its launches.  Both are
// deterministic (no float atomics: a sum is the same from run to run), and
// i64 sums add as uint64 so that they wrap as jnp's sums do, without
// signed overflow.
//
// masked_sum   <- spark_rapids_tpu/plan/execs/aggregate.py:274
//                 _global_update (SUM and COUNT_VALID; COUNT_STAR is the
//                 batch's host row count in the exact-size port, and its
//                 merge is this SUM over i64 partial counts)
//   Bound: bytes.  It reads 8 + 1 bytes per row once and writes 17 bytes.
//   Design: two passes.  Pass 1 gives each block a fixed tile of rows and
//   writes the tile's (sum, count) to a scratch array with
//   cub::BlockReduce; pass 2 is one block that folds the tile partials in a
//   fixed order and writes value[0] (0 when no row is valid), valid[0] and
//   count[0].
//
// segmented_sum <- spark_rapids_tpu/kernels/groupby.py:166 seg_sum, :151
//                  seg_count_valid, :159 seg_count_star
//   Per segment of contiguous rows (the groups of a sorted batch, given by
//   their int32 start rows): the sum of the valid rows, nvalid > 0, nvalid
//   and the row count.  Bound: bytes: 8 + 1 bytes read per row, 4 per
//   segment start, 8 + 1 + 8 + 8 written per segment.  Design: it must do
//   well both for a few long segments (a partial aggregate: ~7 groups over
//   1M rows; one block per segment would fill 7 of 132 SMs) and for many
//   short ones (the final merge), so it tiles the rows, not the segments.
//   Pass 1: each block takes a tile of kSegTile rows; a thread takes
//   kSegItems consecutive rows and finds its first row's segment by binary
//   search; a cub::BlockScan with a reduce-by-key operator carries each
//   run's sum across threads.  A run that ends inside the tile writes its
//   segment's result when the segment began in the tile, else the tile's
//   head carry; the run still open at the tile's end writes the tile's tail
//   carry.  Pass 2 (a thread per segment) writes the counts, and for a
//   segment over several tiles adds the carries in tile order: the tail of
//   its first tile, whole middle tiles, the head of its last.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

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


constexpr int kSegThreads = 256;
constexpr int kSegItems = 8;
constexpr int kSegTile = kSegThreads * kSegItems;  // 2048 rows a tile
constexpr int kSegFinalThreads = 256;

// The open run of one segment: the reduce-by-key element of the scan.
template <typename A>
struct Run {
  int seg;
  A sum;
  long long cnt;
};

template <typename A>
struct RunOp {
  __device__ __forceinline__ Run<A> operator()(const Run<A>& a,
                                               const Run<A>& b) const {
    if (a.seg != b.seg) return b;
    return Run<A>{b.seg, a.sum + b.sum, a.cnt + b.cnt};
  }
};

// Last segment whose start row is <= r (starts[0] == 0, increasing).
__device__ __forceinline__ int segment_of(const int32_t* __restrict__ starts,
                                          int g, int64_t r) {
  int lo = 0, hi = g - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= r) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kSegThreads)
segmented_sum_tiles(const T* __restrict__ data,
                    const uint8_t* __restrict__ valid, int64_t n,
                    const int32_t* __restrict__ starts, int g,
                    T* __restrict__ out_sum, int64_t* __restrict__ out_cnt,
                    typename Acc<T>::type* __restrict__ head_sum,
                    int64_t* __restrict__ head_cnt,
                    typename Acc<T>::type* __restrict__ tail_sum,
                    int64_t* __restrict__ tail_cnt) {
  using A = typename Acc<T>::type;
  using Scan = cub::BlockScan<Run<A>, kSegThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kSegTile;
  const int64_t tile_end = tile0 + kSegTile < n ? tile0 + kSegTile : n;
  const int64_t r0 = tile0 + static_cast<int64_t>(threadIdx.x) * kSegItems;
  int segs[kSegItems];
  A vals[kSegItems];
  int flags[kSegItems];
  Run<A> agg{-1, A(0), 0};
  if (r0 < tile_end) {
    int s = segment_of(starts, g, r0);
#pragma unroll
    for (int k = 0; k < kSegItems; ++k) {
      const int64_t r = r0 + k;
      if (r < tile_end) {
        while (s + 1 < g && starts[s + 1] <= r) ++s;
        const bool v = valid[r] != 0;
        segs[k] = s;
        vals[k] = v ? static_cast<A>(data[r]) : A(0);
        flags[k] = v;
        if (s != agg.seg) agg = Run<A>{s, A(0), 0};
        agg.sum += vals[k];
        agg.cnt += flags[k];
      }
    }
  }
  Run<A> prefix;
  Scan(tmp).ExclusiveScan(agg, prefix, Run<A>{-1, A(0), 0}, RunOp<A>());
  if (r0 >= tile_end) return;
  Run<A> run{-1, A(0), 0};
#pragma unroll
  for (int k = 0; k < kSegItems; ++k) {
    const int64_t r = r0 + k;
    if (r >= tile_end) break;
    const int s = segs[k];
    if (k == 0) {
      run = prefix.seg == s ? prefix : Run<A>{s, A(0), 0};
    }
    run.sum += vals[k];
    run.cnt += flags[k];
    const bool ends_here = r + 1 == n || (s + 1 < g && starts[s + 1] == r + 1);
    if (ends_here) {
      if (starts[s] >= tile0) {           // the whole segment is in the tile
        out_sum[s] = static_cast<T>(run.sum);
        out_cnt[s] = run.cnt;
      } else {                            // it began in an earlier tile
        head_sum[blockIdx.x] = run.sum;
        head_cnt[blockIdx.x] = run.cnt;
      }
      if (k + 1 < kSegItems && r + 1 < tile_end) {
        run = Run<A>{segs[k + 1], A(0), 0};
      }
    } else if (r + 1 == tile_end) {       // open past the tile's end
      tail_sum[blockIdx.x] = run.sum;
      tail_cnt[blockIdx.x] = run.cnt;
      if (starts[s] < tile0) {            // the whole tile is one segment
        head_sum[blockIdx.x] = run.sum;
        head_cnt[blockIdx.x] = run.cnt;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSegFinalThreads)
segmented_sum_final(const int32_t* __restrict__ starts, int g, int64_t n,
                    const typename Acc<T>::type* __restrict__ head_sum,
                    const int64_t* __restrict__ head_cnt,
                    const typename Acc<T>::type* __restrict__ tail_sum,
                    const int64_t* __restrict__ tail_cnt,
                    T* __restrict__ out_sum, uint8_t* __restrict__ out_valid,
                    int64_t* __restrict__ out_cnt,
                    int64_t* __restrict__ out_rows) {
  using A = typename Acc<T>::type;
  const int s = blockIdx.x * kSegFinalThreads + threadIdx.x;
  if (s >= g) return;
  const int64_t start = starts[s];
  const int64_t end = s + 1 < g ? starts[s + 1] : n;
  const int64_t ta = start / kSegTile;
  const int64_t tb = (end - 1) / kSegTile;
  int64_t cnt;
  if (ta == tb) {
    cnt = out_cnt[s];                     // pass 1 wrote the whole segment
  } else {
    A sum = tail_sum[ta];
    cnt = tail_cnt[ta];
    for (int64_t t = ta + 1; t <= tb; ++t) {
      sum += head_sum[t];
      cnt += head_cnt[t];
    }
    out_sum[s] = static_cast<T>(sum);
    out_cnt[s] = cnt;
  }
  out_valid[s] = cnt > 0;
  out_rows[s] = end - start;
}

template <typename T>
int launch_segmented(const T* data, const uint8_t* valid, int64_t n,
                     const int32_t* starts, int g, void* scratch_sum,
                     int64_t* scratch_cnt, T* out_sum, uint8_t* out_valid,
                     int64_t* out_cnt, int64_t* out_rows,
                     cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (n <= 0 || g <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t ntiles = (n + kSegTile - 1) / kSegTile;
  A* head_sum = static_cast<A*>(scratch_sum);
  A* tail_sum = head_sum + ntiles;
  int64_t* head_cnt = scratch_cnt;
  int64_t* tail_cnt = scratch_cnt + ntiles;
  segmented_sum_tiles<T><<<static_cast<unsigned>(ntiles), kSegThreads, 0,
                           stream>>>(data, valid, n, starts, g, out_sum,
                                     out_cnt, head_sum, head_cnt, tail_sum,
                                     tail_cnt);
  segmented_sum_final<T><<<static_cast<unsigned>(
                               (g + kSegFinalThreads - 1) / kSegFinalThreads),
                           kSegFinalThreads, 0, stream>>>(
      starts, g, n, head_sum, head_cnt, tail_sum, tail_cnt, out_sum,
      out_valid, out_cnt, out_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int srt_reduction_tile() { return kTile; }

int srt_segment_tile() { return kSegTile; }

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

// starts[g]: the first row of each segment, increasing, starts[0] == 0.
// scratch_sum and scratch_cnt hold two 8-byte slots per tile of
// srt_segment_tile() rows.
int srt_segmented_sum(int is_f64, const void* data, const uint8_t* valid,
                      int64_t n, const int32_t* starts, int g,
                      void* scratch_sum, int64_t* scratch_cnt, void* out_sum,
                      uint8_t* out_valid, int64_t* out_cnt, int64_t* out_rows,
                      cudaStream_t stream) {
  if (is_f64) {
    return launch_segmented<double>(
        static_cast<const double*>(data), valid, n, starts, g, scratch_sum,
        scratch_cnt, static_cast<double*>(out_sum), out_valid, out_cnt,
        out_rows, stream);
  }
  return launch_segmented<int64_t>(
      static_cast<const int64_t*>(data), valid, n, starts, g, scratch_sum,
      scratch_cnt, static_cast<int64_t*>(out_sum), out_valid, out_cnt,
      out_rows, stream);
}

}  // extern "C"
