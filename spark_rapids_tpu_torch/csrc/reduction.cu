// Reductions of the port over columns with validity: the whole-batch
// masked sum and the segmented sum of a grouped aggregate (f64 or i64),
// and the MIN / MAX and M2 (variance) reductions, segmented and
// whole-batch.  Built for sm_90a by kernels/_lib.py and called through
// ctypes from kernels/reduction.py.  Every entry point launches on the
// caller's stream, allocates nothing, and returns the cudaError_t of its
// launches.  All are deterministic (no float atomics: a result is the same
// from run to run), and i64 sums add as uint64 so that they wrap as jnp's
// sums do, without signed overflow.
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
#include <type_traits>
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

// ---------------------------------------------------------------------------
// MIN / MAX and M2: one tile design for any associative state.
//
// segmented_extreme <- spark_rapids_tpu/kernels/groupby.py:228 seg_min,
//                      :256 seg_max (with _extreme :219)
// masked_extreme    <- spark_rapids_tpu/plan/execs/aggregate.py:274
//                      _global_update, its MIN / MAX branch :292-316
// segmented_m2      <- spark_rapids_tpu/kernels/groupby.py:179
//                      seg_m2_update, :200 seg_m2_merge
// masked_m2         <- spark_rapids_tpu/plan/execs/aggregate.py:286-291
//                      (_global_update's M2) and :318 _global_m2_merge
//
// A policy P says what a row contributes (load), how two partial states
// combine (associative; for MIN / MAX also commutative) and how a
// segment's final state is written.  The segmented pair is
// segmented_sum's design with the state in place of (sum, count): pass 1
// tiles the rows (kSegItems consecutive rows a thread, the first row's
// segment by binary search, a cub::BlockScan of (segment, state) runs);
// a segment inside one tile is written there, one over several tiles
// leaves its tile pieces as head and tail carries, which pass 2 (a thread
// per segment) folds in tile order.  So it does as well for 13 segments
// of ~80,000 rows as for ~500,000 segments of one or two rows: a thread
// per segment would serialise the long ones.  The whole-batch pair is
// masked_sum's: per-tile block reductions, then one block over the tiles
// in a fixed order.
//
// Extremes follow Spark's order, which the reference spells out and which
// fminf / fmin would not give (they return the non-NaN operand): the state
// holds the extreme of the valid non-NaN values, the valid count and two
// flags, "a valid non-NaN value" (MIN is NaN without one) and "a valid
// NaN" (MAX is NaN with one); -0.0 is below 0.0, as the reference's
// extremes give it on the CPU.  BOOLEAN is the extreme of its byte.  A
// segment with no valid row writes 0 and valid = 0 (the canonical null
// slot).  Bound: bytes, the data and validity read once, the starts read
// and the results written once.
//
// M2 keeps the reference's two-pass numerics (not Welford): update sums
// (x - mean)^2 over the valid rows, merge sums M2_i + n_i (mean_i - mean)^2
// (Chan), each with mean = s / max(n, 1) from the group's (s, n), which
// the caller took with segmented_sum / masked_sum.  A thread keeps the
// mean of the segment it last read, so a division is paid per segment
// and thread, not per row.  Each row's term is rounded as the plain
// version rounds it (__dmul_rn, no contraction into an FMA); only the
// order of the additions differs.  Bound: bytes (8 bytes of x or 8 + 8 +
// 8 of a partial row, and 1 of validity, per row).

constexpr int kStateBytes = 32;   // scratch slot: the largest state fits

template <class P>
struct PRun {
  int seg;
  typename P::S s;
};

template <class P>
struct PRunOp {
  __device__ __forceinline__ PRun<P> operator()(const PRun<P>& a,
                                                const PRun<P>& b) const {
    if (a.seg != b.seg) return b;
    return PRun<P>{b.seg, P::combine(a.s, b.s)};
  }
};

template <class P>
struct PCombine {
  __device__ __forceinline__ typename P::S operator()(
      const typename P::S& a, const typename P::S& b) const {
    return P::combine(a, b);
  }
};

template <class P>
__global__ void __launch_bounds__(kSegThreads)
seg_reduce_tiles(P p_in, int64_t n, const int32_t* __restrict__ starts,
                 int g, typename P::S* __restrict__ head,
                 typename P::S* __restrict__ tail) {
  using S = typename P::S;
  P p = p_in;   // a load may keep state (the M2 policies' segment mean)
  using R = PRun<P>;
  using Scan = cub::BlockScan<R, kSegThreads>;
  static_assert(sizeof(S) <= kStateBytes, "state larger than its slot");
  __shared__ typename Scan::TempStorage tmp;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kSegTile;
  const int64_t tile_end = tile0 + kSegTile < n ? tile0 + kSegTile : n;
  const int64_t r0 = tile0 + static_cast<int64_t>(threadIdx.x) * kSegItems;
  int segs[kSegItems];
  S vals[kSegItems];
  R agg{-1, P::identity()};
  if (r0 < tile_end) {
    int s = segment_of(starts, g, r0);
#pragma unroll
    for (int k = 0; k < kSegItems; ++k) {
      const int64_t r = r0 + k;
      if (r < tile_end) {
        while (s + 1 < g && starts[s + 1] <= r) ++s;
        segs[k] = s;
        vals[k] = p.load(r, s);
        agg = agg.seg == s ? R{s, P::combine(agg.s, vals[k])}
                           : R{s, vals[k]};
      }
    }
  }
  R prefix;
  Scan(tmp).ExclusiveScan(agg, prefix, R{-1, P::identity()}, PRunOp<P>());
  if (r0 >= tile_end) return;
  R run{-1, P::identity()};
#pragma unroll
  for (int k = 0; k < kSegItems; ++k) {
    const int64_t r = r0 + k;
    if (r >= tile_end) break;
    const int s = segs[k];
    if (k == 0) run = prefix.seg == s ? prefix : R{s, P::identity()};
    run.s = P::combine(run.s, vals[k]);
    const bool ends_here = r + 1 == n || (s + 1 < g && starts[s + 1] == r + 1);
    if (ends_here) {
      if (starts[s] >= tile0) {           // the whole segment is in the tile
        p.write(s, run.s);
      } else {                            // it began in an earlier tile
        head[blockIdx.x] = run.s;
      }
      if (k + 1 < kSegItems && r + 1 < tile_end) {
        run = R{segs[k + 1], P::identity()};
      }
    } else if (r + 1 == tile_end) {       // open past the tile's end
      tail[blockIdx.x] = run.s;
      if (starts[s] < tile0) head[blockIdx.x] = run.s;  // the whole tile
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kSegFinalThreads)
seg_reduce_final(P p, const int32_t* __restrict__ starts, int g, int64_t n,
                 const typename P::S* __restrict__ head,
                 const typename P::S* __restrict__ tail) {
  const int s = blockIdx.x * kSegFinalThreads + threadIdx.x;
  if (s >= g) return;
  const int64_t start = starts[s];
  const int64_t end = s + 1 < g ? starts[s + 1] : n;
  const int64_t ta = start / kSegTile;
  const int64_t tb = (end - 1) / kSegTile;
  if (ta == tb) return;                   // pass 1 wrote it
  typename P::S acc = tail[ta];
  for (int64_t t = ta + 1; t <= tb; ++t) acc = P::combine(acc, head[t]);
  p.write(s, acc);
}

template <class P>
int launch_seg_reduce(const P& p, int64_t n, const int32_t* starts, int g,
                      void* scratch, cudaStream_t stream) {
  if (n <= 0 || g <= 0) return static_cast<int>(cudaGetLastError());
  using S = typename P::S;
  const int64_t ntiles = (n + kSegTile - 1) / kSegTile;
  S* head = static_cast<S*>(scratch);
  S* tail = head + ntiles;
  seg_reduce_tiles<P><<<static_cast<unsigned>(ntiles), kSegThreads, 0,
                        stream>>>(p, n, starts, g, head, tail);
  seg_reduce_final<P><<<static_cast<unsigned>(
                            (g + kSegFinalThreads - 1) / kSegFinalThreads),
                        kSegFinalThreads, 0, stream>>>(p, starts, g, n, head,
                                                       tail);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
__global__ void __launch_bounds__(kThreads)
masked_reduce_tiles(P p_in, int64_t n,
                    typename P::S* __restrict__ tile_state) {
  using S = typename P::S;
  P p = p_in;
  using Reduce = cub::BlockReduce<S, kThreads>;
  static_assert(sizeof(S) <= kStateBytes, "state larger than its slot");
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  S acc = P::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t j = base + static_cast<int64_t>(i) * kThreads + threadIdx.x;
    if (j < n) acc = P::combine(acc, p.load(j, 0));
  }
  const S total = Reduce(tmp).Reduce(acc, PCombine<P>());
  if (threadIdx.x == 0) tile_state[blockIdx.x] = total;
}

template <class P>
__global__ void __launch_bounds__(kFinalThreads)
masked_reduce_final(P p, const typename P::S* __restrict__ tile_state,
                    int64_t ntiles) {
  using S = typename P::S;
  using Reduce = cub::BlockReduce<S, kFinalThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  S acc = P::identity();
  for (int64_t i = threadIdx.x; i < ntiles; i += kFinalThreads) {
    acc = P::combine(acc, tile_state[i]);
  }
  const S total = Reduce(tmp).Reduce(acc, PCombine<P>());
  if (threadIdx.x == 0) p.write(0, total);
}

template <class P>
int launch_masked_reduce(const P& p, int64_t n, void* scratch,
                         cudaStream_t stream) {
  using S = typename P::S;
  const int64_t ntiles = n > 0 ? (n + kTile - 1) / kTile : 0;
  S* tile_state = static_cast<S*>(scratch);
  if (ntiles > 0) {
    masked_reduce_tiles<P><<<static_cast<unsigned>(ntiles), kThreads, 0,
                             stream>>>(p, n, tile_state);
  }
  masked_reduce_final<P><<<1, kFinalThreads, 0, stream>>>(p, tile_state,
                                                          ntiles);
  return static_cast<int>(cudaGetLastError());
}

// -- MIN / MAX ----------------------------------------------------------------

template <typename T> struct Bounds;
template <> struct Bounds<uint8_t> {   // BOOLEAN as its byte
  static __device__ __forceinline__ uint8_t lo() { return 0; }
  static __device__ __forceinline__ uint8_t hi() { return 1; }
};
template <> struct Bounds<int32_t> {
  static __device__ __forceinline__ int32_t lo() { return INT32_MIN; }
  static __device__ __forceinline__ int32_t hi() { return INT32_MAX; }
};
template <> struct Bounds<int64_t> {
  static __device__ __forceinline__ int64_t lo() { return INT64_MIN; }
  static __device__ __forceinline__ int64_t hi() { return INT64_MAX; }
};
template <> struct Bounds<float> {
  static __device__ __forceinline__ float lo() {
    return __int_as_float(static_cast<int>(0xff800000u));
  }
  static __device__ __forceinline__ float hi() {
    return __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ float nan() {
    return __int_as_float(0x7fc00000);     // the canonical quiet NaN
  }
  static __device__ __forceinline__ bool neg(float x) {
    return __float_as_int(x) < 0;
  }
};
template <> struct Bounds<double> {
  static __device__ __forceinline__ double lo() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
  }
  static __device__ __forceinline__ double hi() {
    return __longlong_as_double(0x7ff0000000000000ll);
  }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
  static __device__ __forceinline__ bool neg(double x) {
    return __double_as_longlong(x) < 0;
  }
};

template <typename T>
struct ExtremeState {
  T v;                 // the extreme of the valid non-NaN values
  long long nvalid;
  int nonnan;          // a valid non-NaN value was seen
  int nan;             // a valid NaN was seen
};

template <typename T, bool IsMin>
struct ExtremePolicy {
  using S = ExtremeState<T>;
  static constexpr bool kFloat = std::is_floating_point<T>::value;
  const T* data;
  const uint8_t* valid;
  T* out;
  uint8_t* out_valid;
  int64_t* out_count;      // may be null

  static __device__ __forceinline__ S identity() {
    return S{IsMin ? Bounds<T>::hi() : Bounds<T>::lo(), 0, 0, 0};
  }
  // b replaces a where it is smaller (MIN) or larger (MAX); of two equal
  // floats, -0.0 is the smaller
  static __device__ __forceinline__ T pick(T a, T b) {
    bool take_b = IsMin ? b < a : a < b;
    if constexpr (kFloat) {
      if (a == b) {
        take_b = IsMin ? Bounds<T>::neg(b) && !Bounds<T>::neg(a)
                       : Bounds<T>::neg(a) && !Bounds<T>::neg(b);
      }
    }
    return take_b ? b : a;
  }
  static __device__ __forceinline__ S combine(const S& a, const S& b) {
    return S{pick(a.v, b.v), a.nvalid + b.nvalid, a.nonnan | b.nonnan,
             a.nan | b.nan};
  }
  __device__ __forceinline__ S load(int64_t r, int) const {
    S s = identity();
    if (valid[r]) {
      const T x = data[r];
      s.nvalid = 1;
      if (kFloat && x != x) {
        s.nan = 1;
      } else {
        s.v = x;
        s.nonnan = 1;
      }
    }
    return s;
  }
  __device__ __forceinline__ void write(int seg, const S& s) const {
    T v = s.v;
    if constexpr (kFloat) {
      if (IsMin ? !s.nonnan : s.nan) v = Bounds<T>::nan();
    }
    if (s.nvalid == 0) v = T(0);
    out[seg] = v;
    out_valid[seg] = s.nvalid > 0;
    if (out_count != nullptr) out_count[seg] = s.nvalid;
  }
};

// segmented: over the segments of starts[g]; else the whole batch
template <class P>
int reduce_launch(const P& p, bool segmented, int64_t n,
                  const int32_t* starts, int g, void* scratch,
                  cudaStream_t stream) {
  if (segmented) return launch_seg_reduce(p, n, starts, g, scratch, stream);
  return launch_masked_reduce(p, n, scratch, stream);
}

template <typename T, bool IsMin>
int extreme_typed(bool segmented, const void* data, const uint8_t* valid,
                  int64_t n, const int32_t* starts, int g, void* scratch,
                  void* out, uint8_t* out_valid, int64_t* out_count,
                  cudaStream_t stream) {
  const ExtremePolicy<T, IsMin> p{static_cast<const T*>(data), valid,
                                  static_cast<T*>(out), out_valid,
                                  out_count};
  return reduce_launch(p, segmented, n, starts, g, scratch, stream);
}

template <typename T>
int extreme_dispatch(bool segmented, int is_min, const void* data,
                     const uint8_t* valid, int64_t n, const int32_t* starts,
                     int g, void* scratch, void* out, uint8_t* out_valid,
                     int64_t* out_count, cudaStream_t stream) {
  if (is_min) {
    return extreme_typed<T, true>(segmented, data, valid, n, starts, g,
                                  scratch, out, out_valid, out_count, stream);
  }
  return extreme_typed<T, false>(segmented, data, valid, n, starts, g,
                                 scratch, out, out_valid, out_count, stream);
}

// dtype codes of the entry points (kernels/reduction.py _DTYPE_CODE)
enum : int { kBool = 0, kI32 = 1, kI64 = 2, kF32 = 3, kF64 = 4 };

int extreme(bool segmented, int dtype, int is_min, const void* data,
            const uint8_t* valid, int64_t n, const int32_t* starts, int g,
            void* scratch, void* out, uint8_t* out_valid, int64_t* out_count,
            cudaStream_t stream) {
  switch (dtype) {
    case kBool:
      return extreme_dispatch<uint8_t>(segmented, is_min, data, valid, n,
                                       starts, g, scratch, out, out_valid,
                                       out_count, stream);
    case kI32:
      return extreme_dispatch<int32_t>(segmented, is_min, data, valid, n,
                                       starts, g, scratch, out, out_valid,
                                       out_count, stream);
    case kI64:
      return extreme_dispatch<int64_t>(segmented, is_min, data, valid, n,
                                       starts, g, scratch, out, out_valid,
                                       out_count, stream);
    case kF32:
      return extreme_dispatch<float>(segmented, is_min, data, valid, n,
                                     starts, g, scratch, out, out_valid,
                                     out_count, stream);
    case kF64:
      return extreme_dispatch<double>(segmented, is_min, data, valid, n,
                                      starts, g, scratch, out, out_valid,
                                      out_count, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- M2 -------------------------------------------------------------------------

// The mean of a segment, s / max(n, 1), kept for the segment last read.
struct SegmentMean {
  const double* sum;
  const int64_t* count;
  int seg;
  double mean;

  __device__ __forceinline__ double of(int s) {
    if (s != seg) {
      seg = s;
      mean = __ddiv_rn(sum[s], fmax(static_cast<double>(count[s]), 1.0));
    }
    return mean;
  }
};

template <typename T>
struct M2UpdatePolicy {
  using S = double;
  const T* x;
  const uint8_t* valid;
  SegmentMean mean;
  double* out;

  static __device__ __forceinline__ S identity() { return 0.0; }
  static __device__ __forceinline__ S combine(S a, S b) {
    return __dadd_rn(a, b);
  }
  __device__ __forceinline__ S load(int64_t r, int s) {
    if (!valid[r]) return 0.0;
    const double d = __dsub_rn(static_cast<double>(x[r]), mean.of(s));
    return __dmul_rn(d, d);
  }
  __device__ __forceinline__ void write(int s, S v) const { out[s] = v; }
};

struct M2MergePolicy {
  using S = double;
  const double* m2;
  const uint8_t* valid;
  const double* part_sum;
  const int64_t* part_count;
  SegmentMean mean;
  double* out;

  static __device__ __forceinline__ S identity() { return 0.0; }
  static __device__ __forceinline__ S combine(S a, S b) {
    return __dadd_rn(a, b);
  }
  __device__ __forceinline__ S load(int64_t r, int s) {
    if (!valid[r]) return 0.0;
    const double ni = static_cast<double>(part_count[r]);
    const double mi = __ddiv_rn(part_sum[r], fmax(ni, 1.0));
    const double d = __dsub_rn(mi, mean.of(s));
    return __dadd_rn(m2[r], __dmul_rn(__dmul_rn(ni, d), d));
  }
  __device__ __forceinline__ void write(int s, S v) const { out[s] = v; }
};

template <typename T>
int m2_update_typed(bool segmented, const void* x, const uint8_t* valid,
                    int64_t n, const int32_t* starts, int g,
                    const double* sum, const int64_t* count, void* scratch,
                    double* out, cudaStream_t stream) {
  const M2UpdatePolicy<T> p{static_cast<const T*>(x), valid,
                            SegmentMean{sum, count, -1, 0.0}, out};
  return reduce_launch(p, segmented, n, starts, g, scratch, stream);
}

int m2(bool segmented, int dtype, int merge, const void* x,
       const uint8_t* valid, const double* part_sum,
       const int64_t* part_count, int64_t n, const int32_t* starts, int g,
       const double* sum, const int64_t* count, void* scratch, double* out,
       cudaStream_t stream) {
  if (merge) {
    if (dtype != kF64) return static_cast<int>(cudaErrorInvalidValue);
    const M2MergePolicy p{static_cast<const double*>(x), valid, part_sum,
                          part_count, SegmentMean{sum, count, -1, 0.0}, out};
    return reduce_launch(p, segmented, n, starts, g, scratch, stream);
  }
  switch (dtype) {
    case kI32:
      return m2_update_typed<int32_t>(segmented, x, valid, n, starts, g, sum,
                                      count, scratch, out, stream);
    case kI64:
      return m2_update_typed<int64_t>(segmented, x, valid, n, starts, g, sum,
                                      count, scratch, out, stream);
    case kF32:
      return m2_update_typed<float>(segmented, x, valid, n, starts, g, sum,
                                    count, scratch, out, stream);
    case kF64:
      return m2_update_typed<double>(segmented, x, valid, n, starts, g, sum,
                                     count, scratch, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int srt_reduce_state_bytes() { return kStateBytes; }

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

// MIN (is_min) or MAX of each segment: out[g] at the data's type, out_valid
// [g].  dtype: 0 bool, 1 int32, 2 int64, 3 float, 4 double.  scratch holds
// two srt_reduce_state_bytes() slots per tile of srt_segment_tile() rows.
int srt_segmented_extreme(int dtype, int is_min, const void* data,
                          const uint8_t* valid, int64_t n,
                          const int32_t* starts, int g, void* scratch,
                          void* out, uint8_t* out_valid,
                          cudaStream_t stream) {
  return extreme(true, dtype, is_min, data, valid, n, starts, g, scratch,
                 out, out_valid, nullptr, stream);
}

// The same over the whole batch: out[1], out_valid[1], out_count[1] (the
// valid count).  scratch holds one srt_reduce_state_bytes() slot per tile
// of srt_reduction_tile() rows (at least one).
int srt_masked_extreme(int dtype, int is_min, const void* data,
                       const uint8_t* valid, int64_t n, void* scratch,
                       void* out, uint8_t* out_valid, int64_t* out_count,
                       cudaStream_t stream) {
  return extreme(false, dtype, is_min, data, valid, n, nullptr, 1, scratch,
                 out, out_valid, out_count, stream);
}

// M2 of each segment into out[g] (double).  Update (merge = 0): x of
// dtype 1-4 with its validity.  Merge (merge = 1): x the partial rows'
// double M2 with its validity, part_sum and part_count their s_i and n_i.
// sum[g] and count[g]: each segment's s and n.  Scratch as for
// srt_segmented_extreme.
int srt_segmented_m2(int dtype, int merge, const void* x,
                     const uint8_t* valid, const double* part_sum,
                     const int64_t* part_count, int64_t n,
                     const int32_t* starts, int g, const double* sum,
                     const int64_t* count, void* scratch, double* out,
                     cudaStream_t stream) {
  return m2(true, dtype, merge, x, valid, part_sum, part_count, n, starts, g,
            sum, count, scratch, out, stream);
}

// The same over the whole batch, one group: sum[1], count[1], out[1].
// Scratch as for srt_masked_extreme.
int srt_masked_m2(int dtype, int merge, const void* x, const uint8_t* valid,
                  const double* part_sum, const int64_t* part_count,
                  int64_t n, const double* sum, const int64_t* count,
                  void* scratch, double* out, cudaStream_t stream) {
  return m2(false, dtype, merge, x, valid, part_sum, part_count, n, nullptr,
            1, sum, count, scratch, out, stream);
}

}  // extern "C"
