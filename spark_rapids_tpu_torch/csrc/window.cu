// Window kernels of the port: the layout of a partition-sorted batch, frame
// sums and counts, RANGE frame bounds and frame extremes.  Built for sm_90a
// by kernels/_lib.py and called through ctypes from kernels/window.py.
// Every entry point launches on the caller's stream, allocates nothing
// (the wrapper hands it its scratch), and returns the cudaError_t of its
// launches.  No atomics: every result is the same from run to run.
//
// window_layout      <- spark_rapids_tpu/kernels/window.py:45 window_layout
//                       (the layout row_number :75, rank :79 and
//                       dense_rank :83 read)
//   From the bool partition and peer boundary flags at sorted positions
//   (true at the first row of each partition / peer run; a partition
//   boundary is a peer boundary too): int32 seg_start (the last partition
//   boundary at or before the row), seg_end (the next partition boundary
//   after it, or n), run_id (peer boundaries at or before it, less one),
//   run_first and run_last (the next peer boundary less one, or n - 1).
//   Bound: bytes: 2 bytes read and 20 written per row.  Design: a forward
//   (max, max, count) scan and a backward (min, min) scan as tiles with a
//   carry pass, as csrc/scan.cuh does: pass 1 reduces each tile of kTile
//   rows, pass 2 (one block) scans the tile aggregates in both directions,
//   pass 3 rescans each tile with cub::BlockScan from its carry, once in
//   the rows' order and once against it, and writes the five arrays.
//
// frame_sum          <- spark_rapids_tpu/kernels/window.py:113
//                       rows_frame_sum, :100 running_sum_range, :255
//                       bounded_sum_count (:88 _prefix_sum, :94 _at_or_zero)
//   The sum of the valid values (int64 wrapping, or f64) and their count
//   over each row's inclusive position frame [lower, upper], which lies in
//   the row's partition; an empty frame (upper < lower) gives 0 and 0.
//   Bound: bytes: per row 8 + 1 read for the value, 12 for seg_start,
//   lower and upper, 16 written.  Design: a prefix scan that restarts at
//   each partition start (tile reduce, one-block carry, tile apply, as
//   window_layout), then one difference a row.  Error model (f64): the
//   prefix is a double-double (hi + lo, each addition by TwoSum), so the
//   difference of two prefixes is the frame's sum to about one rounding
//   of the sum itself, not of the prefix (the reference's difference of
//   one f64 cumsum errs by the prefix's magnitude); the finite values are
//   summed, and the NaN, +inf and -inf of the frame are counted apart, so
//   that an infinity before the frame does not poison it: the frame's sum
//   is NaN with a NaN or with both infinities, else +-inf with one, else
//   the finite sum.
//
// range_frame_bounds <- spark_rapids_tpu/kernels/window.py:216
//                       frame_bounds_range
//   For each row, the inclusive bounds of RANGE BETWEEN p PRECEDING AND f
//   FOLLOWING over the partition-sorted ascending order key (int32 or
//   int64): the first position of [seg_start, seg_end) whose key is at
//   least key - p and the last whose key is at most key + f (either side
//   may be unbounded).  key - p and key + f wrap in the key's type, as the
//   reference's do.  Bound: bytes (the key is read once per row; the
//   searches hit L2).  Design: a thread per row and each side its binary
//   search, the reference's steps exactly (mid = (lo + hi) / 2), so that
//   the result is the reference's also where the run is not sorted (a null
//   order key sits first with its zeroed data).
//
// frame_extreme      <- spark_rapids_tpu/kernels/window.py:268
//                       bounded_min_max, :144 running_min_range, :151
//                       running_max_range (:133 _segmented_scan)
//   MIN or MAX of the valid values over each row's inclusive frame
//   [lower, upper].  Values are compared as int64 order keys: bool, int32
//   and int64 as themselves, floats by their bits with all but the sign
//   flipped where the sign is set, every NaN first made the canonical one,
//   so that NaN is above +inf (Spark's order: MIN skips NaN unless the
//   frame holds nothing else, MAX is NaN with any) and -0.0 below 0.0.  A
//   frame with no valid value gives the type's identity (MIN: the type's
//   largest or +inf, MAX: its smallest or -inf) and nonempty = 0 where the
//   frame is empty.  Bound: bytes: the table's levels are written and read
//   once each, 8 bytes a row a level.  Design: the reference's sparse
//   table: level 0 the keys, level l the extreme of level l - 1 at i and
//   at i + 2^(l - 1), one launch a level (levels 0..floor(log2(max_len))
//   only); then a thread per row combines two level-l entries that cover
//   the frame, l = 31 - __clz(length).
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 256;

// ---------------------------------------------------------------------------
// tiles with a carry pass, shared by window_layout and frame_sum

// Pass 2: one block scans the tile aggregates agg[0..ntiles) into the
// exclusive carries carry[0..ntiles): forward from the first tile, or
// (reverse) from the last, in chunks of kCarryThreads.
template <class S, class Op>
__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const S* __restrict__ agg, S* __restrict__ carry, int64_t ntiles,
             S identity, Op op, int reverse) {
  using Scan = cub::BlockScan<S, kCarryThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ S running;
  if (threadIdx.x == 0) running = identity;
  __syncthreads();
  for (int64_t start = 0; start < ntiles; start += kCarryThreads) {
    const int64_t k = start + threadIdx.x;
    const int64_t t = reverse ? ntiles - 1 - k : k;
    const S x = k < ntiles ? agg[t] : identity;
    const S init = running;
    S excl;
    Scan(tmp).ExclusiveScan(x, excl, init, op);
    if (k < ntiles) carry[t] = excl;
    __syncthreads();   // every thread has read running and released tmp
    if (threadIdx.x == kCarryThreads - 1) running = op(excl, x);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// window_layout

struct Fwd {          // forward scan: last partition / peer boundary, count
  int32_t part;
  int32_t peer;
  int32_t count;
};

struct FwdOp {
  __device__ Fwd operator()(const Fwd& a, const Fwd& b) const {
    return Fwd{a.part > b.part ? a.part : b.part,
               a.peer > b.peer ? a.peer : b.peer, a.count + b.count};
  }
};

struct Bwd {          // backward scan: next partition / peer boundary
  int32_t part;
  int32_t peer;
};

struct BwdOp {
  __device__ Bwd operator()(const Bwd& a, const Bwd& b) const {
    return Bwd{a.part < b.part ? a.part : b.part,
               a.peer < b.peer ? a.peer : b.peer};
  }
};

__device__ __forceinline__ Fwd fwd_of(const uint8_t* part,
                                      const uint8_t* peer, int64_t i) {
  const bool pa = part[i] != 0;
  const bool pe = pa || peer[i] != 0;
  const int32_t r = static_cast<int32_t>(i);
  return Fwd{pa ? r : -1, pe ? r : -1, pe ? 1 : 0};
}

__device__ __forceinline__ Bwd bwd_of(const uint8_t* part,
                                      const uint8_t* peer, int64_t i,
                                      int32_t none) {
  const bool pa = part[i] != 0;
  const bool pe = pa || peer[i] != 0;
  const int32_t r = static_cast<int32_t>(i);
  return Bwd{pa ? r : none, pe ? r : none};
}

// Pass 1: each tile's forward and backward aggregates.  A thread takes
// kItems consecutive rows (the blocked arrangement).
__global__ void __launch_bounds__(kThreads)
layout_tiles(const uint8_t* __restrict__ part, const uint8_t* __restrict__ peer,
             int64_t n, Fwd* __restrict__ fwd, Bwd* __restrict__ bwd) {
  using FScan = cub::BlockScan<Fwd, kThreads>;
  using BScan = cub::BlockScan<Bwd, kThreads>;
  __shared__ typename FScan::TempStorage ftmp;
  __shared__ typename BScan::TempStorage btmp;
  const int32_t none = static_cast<int32_t>(n);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     static_cast<int64_t>(threadIdx.x) * kItems;
  Fwd f{-1, -1, 0};
  Bwd b{none, none};
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    if (i < n) {
      f = FwdOp()(f, fwd_of(part, peer, i));
      b = BwdOp()(b, bwd_of(part, peer, i, none));
    }
  }
  Fwd fx;
  Bwd bx;
  FScan(ftmp).ExclusiveScan(f, fx, Fwd{-1, -1, 0}, FwdOp());
  BScan(btmp).ExclusiveScan(b, bx, Bwd{none, none}, BwdOp());
  if (threadIdx.x == kThreads - 1) {
    fwd[blockIdx.x] = FwdOp()(fx, f);
    bwd[blockIdx.x] = BwdOp()(bx, b);
  }
}

// Pass 3: the tile again from its carries.  Forward: the blocked
// arrangement, each row's inclusive (seg_start, run_first, run_id).
// Backward: thread t takes the tile's kItems rows that end kItems * t rows
// before the tile's end, in descending order, so that the forward block
// scan over threads is a scan against the rows' order; each row's
// exclusive next boundaries give seg_end and run_last.
__global__ void __launch_bounds__(kThreads)
layout_apply(const uint8_t* __restrict__ part, const uint8_t* __restrict__ peer,
             int64_t n, const Fwd* __restrict__ fwd_carry,
             const Bwd* __restrict__ bwd_carry, int32_t* __restrict__ seg_start,
             int32_t* __restrict__ seg_end, int32_t* __restrict__ run_id,
             int32_t* __restrict__ run_first, int32_t* __restrict__ run_last) {
  using FScan = cub::BlockScan<Fwd, kThreads>;
  using BScan = cub::BlockScan<Bwd, kThreads>;
  __shared__ typename FScan::TempStorage ftmp;
  __shared__ typename BScan::TempStorage btmp;
  const int32_t none = static_cast<int32_t>(n);
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t r0 = tile0 + static_cast<int64_t>(threadIdx.x) * kItems;
  Fwd f{-1, -1, 0};
  for (int k = 0; k < kItems; ++k) {
    if (r0 + k < n) f = FwdOp()(f, fwd_of(part, peer, r0 + k));
  }
  Fwd run;
  FScan(ftmp).ExclusiveScan(f, run, fwd_carry[blockIdx.x], FwdOp());
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    if (i >= n) break;
    run = FwdOp()(run, fwd_of(part, peer, i));
    seg_start[i] = run.part;
    run_first[i] = run.peer;
    run_id[i] = run.count - 1;
  }
  // backward: row tile0 + kTile - 1 - (kItems * t + k)
  const int64_t top = tile0 + kTile - 1 -
                      static_cast<int64_t>(threadIdx.x) * kItems;
  Bwd b{none, none};
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = top - k;
    if (i < n) b = BwdOp()(b, bwd_of(part, peer, i, none));
  }
  Bwd next;
  BScan(btmp).ExclusiveScan(b, next, bwd_carry[blockIdx.x], BwdOp());
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = top - k;
    if (i >= n) continue;
    seg_end[i] = next.part;
    run_last[i] = next.peer - 1;
    next = BwdOp()(next, bwd_of(part, peer, i, none));
  }
}

// ---------------------------------------------------------------------------
// frame_sum

// NaN and infinity by their bits
__device__ __forceinline__ bool is_nan(double x) {
  return (__double_as_longlong(x) & 0x7FFFFFFFFFFFFFFFll) >
         0x7FF0000000000000ll;
}

__device__ __forceinline__ bool is_inf(double x) {
  return (__double_as_longlong(x) & 0x7FFFFFFFFFFFFFFFll) ==
         0x7FF0000000000000ll;
}

__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_int(x) & 0x7FFFFFFF) > 0x7F800000;
}

// TwoSum: s + e == a + b exactly (no multiplication, so no contraction)
__device__ __forceinline__ void two_sum(double a, double b, double& s,
                                        double& e) {
  s = a + b;
  const double bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// a prefix in the restarting scan: restart marks a partition start in the
// span it covers (the value then counts from the last one)
struct SumF64 {
  double hi, lo;
  int64_t count;
  int32_t nan, pinf, ninf;
  int32_t restart;
};

struct SumF64Op {
  __device__ SumF64 operator()(const SumF64& a, const SumF64& b) const {
    if (b.restart) return b;
    double s, e;
    two_sum(a.hi, b.hi, s, e);
    e += a.lo + b.lo;
    double h, l;
    two_sum(s, e, h, l);
    return SumF64{h, l, a.count + b.count, a.nan + b.nan, a.pinf + b.pinf,
                  a.ninf + b.ninf, a.restart};
  }
};

struct SumI64 {
  unsigned long long s;    // wraps, as the reference's int64 sums do
  int64_t count;
  int32_t restart;
};

struct SumI64Op {
  __device__ SumI64 operator()(const SumI64& a, const SumI64& b) const {
    if (b.restart) return b;
    return SumI64{a.s + b.s, a.count + b.count, a.restart};
  }
};

struct F64Policy {
  using S = SumF64;
  using Op = SumF64Op;
  const double* data;
  static __host__ __device__ __forceinline__ S identity() {
    return S{0.0, 0.0, 0, 0, 0, 0, 0};
  }
  __device__ S load(int64_t i, bool ok, bool restart) const {
    S s = identity();
    s.restart = restart;
    if (!ok) return s;
    const double x = data[i];
    s.count = 1;
    if (is_nan(x)) {
      s.nan = 1;
    } else if (is_inf(x)) {
      if (x > 0) s.pinf = 1; else s.ninf = 1;
    } else {
      s.hi = x;
    }
    return s;
  }
};

struct I64Policy {
  using S = SumI64;
  using Op = SumI64Op;
  const int64_t* data;
  static __host__ __device__ __forceinline__ S identity() {
    return S{0ull, 0, 0};
  }
  __device__ S load(int64_t i, bool ok, bool restart) const {
    return S{ok ? static_cast<unsigned long long>(data[i]) : 0ull,
             ok ? 1 : 0, restart ? 1 : 0};
  }
};

template <class P>
__device__ __forceinline__ typename P::S sum_load(
    const P& p, const uint8_t* valid, const int32_t* seg_start, int64_t i) {
  return p.load(i, valid[i] != 0, seg_start[i] == i);
}

template <class P>
__global__ void __launch_bounds__(kThreads)
sum_tiles(P p, const uint8_t* __restrict__ valid,
          const int32_t* __restrict__ seg_start, int64_t n,
          typename P::S* __restrict__ agg) {
  using S = typename P::S;
  using Scan = cub::BlockScan<S, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     static_cast<int64_t>(threadIdx.x) * kItems;
  S s = P::identity();
  for (int k = 0; k < kItems; ++k) {
    if (r0 + k < n) s = typename P::Op()(s, sum_load(p, valid, seg_start,
                                                      r0 + k));
  }
  S x;
  Scan(tmp).ExclusiveScan(s, x, P::identity(), typename P::Op());
  if (threadIdx.x == kThreads - 1) agg[blockIdx.x] = typename P::Op()(x, s);
}

// the prefixes, as separate arrays (structure of arrays)
struct Prefix {
  void* sum;            // double hi, or int64
  double* lo;           // f64 only
  int64_t* count;
  int32_t* nan;         // f64 only
  int32_t* pinf;
  int32_t* ninf;
};

__device__ __forceinline__ void store(const Prefix& o, int64_t i,
                                      const SumF64& s) {
  static_cast<double*>(o.sum)[i] = s.hi;
  o.lo[i] = s.lo;
  o.count[i] = s.count;
  o.nan[i] = s.nan;
  o.pinf[i] = s.pinf;
  o.ninf[i] = s.ninf;
}

__device__ __forceinline__ void store(const Prefix& o, int64_t i,
                                      const SumI64& s) {
  static_cast<unsigned long long*>(o.sum)[i] = s.s;
  o.count[i] = s.count;
}

template <class P>
__global__ void __launch_bounds__(kThreads)
sum_apply(P p, const uint8_t* __restrict__ valid,
          const int32_t* __restrict__ seg_start, int64_t n,
          const typename P::S* __restrict__ carry, Prefix out) {
  using S = typename P::S;
  using Scan = cub::BlockScan<S, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     static_cast<int64_t>(threadIdx.x) * kItems;
  S s = P::identity();
  for (int k = 0; k < kItems; ++k) {
    if (r0 + k < n) s = typename P::Op()(s, sum_load(p, valid, seg_start,
                                                      r0 + k));
  }
  S run;
  Scan(tmp).ExclusiveScan(s, run, carry[blockIdx.x], typename P::Op());
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    if (i >= n) break;
    run = typename P::Op()(run, sum_load(p, valid, seg_start, i));
    store(out, i, run);
  }
}

// Pass 4: one difference a row.  The frame [lower, upper] lies in the
// row's partition, so the prefix before it is the one at lower - 1 when
// that is still in the partition, else none.
__global__ void __launch_bounds__(kThreads)
sum_query_f64(Prefix pre, const int32_t* __restrict__ seg_start,
              const int32_t* __restrict__ lower,
              const int32_t* __restrict__ upper, int64_t n,
              double* __restrict__ out, int64_t* __restrict__ out_count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t lo = lower[i];
  const int64_t hi = upper[i];
  if (hi < lo) {
    out[i] = 0.0;
    out_count[i] = 0;
    return;
  }
  const double* phi = static_cast<const double*>(pre.sum);
  double ah = phi[hi], al = pre.lo[hi];
  int64_t cnt = pre.count[hi];
  int32_t nan = pre.nan[hi], pinf = pre.pinf[hi], ninf = pre.ninf[hi];
  if (lo > seg_start[i]) {
    const int64_t b = lo - 1;
    double s, e;
    two_sum(ah, -phi[b], s, e);
    e += al - pre.lo[b];
    ah = s;
    al = e;
    cnt -= pre.count[b];
    nan -= pre.nan[b];
    pinf -= pre.pinf[b];
    ninf -= pre.ninf[b];
  }
  double v = ah + al;
  if (nan > 0 || (pinf > 0 && ninf > 0)) {
    v = __longlong_as_double(0x7FF8000000000000ll);
  } else if (pinf > 0) {
    v = __longlong_as_double(0x7FF0000000000000ll);
  } else if (ninf > 0) {
    v = __longlong_as_double(static_cast<long long>(0xFFF0000000000000ull));
  }
  out[i] = v;
  out_count[i] = cnt;
}

__global__ void __launch_bounds__(kThreads)
sum_query_i64(Prefix pre, const int32_t* __restrict__ seg_start,
              const int32_t* __restrict__ lower,
              const int32_t* __restrict__ upper, int64_t n,
              int64_t* __restrict__ out, int64_t* __restrict__ out_count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t lo = lower[i];
  const int64_t hi = upper[i];
  if (hi < lo) {
    out[i] = 0;
    out_count[i] = 0;
    return;
  }
  const unsigned long long* ps =
      static_cast<const unsigned long long*>(pre.sum);
  unsigned long long s = ps[hi];
  int64_t cnt = pre.count[hi];
  if (lo > seg_start[i]) {
    s -= ps[lo - 1];
    cnt -= pre.count[lo - 1];
  }
  out[i] = static_cast<int64_t>(s);
  out_count[i] = cnt;
}

template <class P>
int frame_sum(const P& p, const uint8_t* valid, const int32_t* seg_start,
              int64_t n, void* scratch, Prefix pre, cudaStream_t stream) {
  using S = typename P::S;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  S* agg = static_cast<S*>(scratch);
  S* carry = agg + ntiles;
  const unsigned grid = static_cast<unsigned>(ntiles);
  sum_tiles<P><<<grid, kThreads, 0, stream>>>(p, valid, seg_start, n, agg);
  carry_kernel<S, typename P::Op><<<1, kCarryThreads, 0, stream>>>(
      agg, carry, ntiles, P::identity(), typename P::Op(), 0);
  sum_apply<P><<<grid, kThreads, 0, stream>>>(p, valid, seg_start, n, carry,
                                             pre);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// range_frame_bounds

// the reference's lower_bound (strict: key < target goes right) or
// upper_bound (key <= target goes right) over [lo, hi)
template <typename K>
__device__ __forceinline__ int64_t search(const K* key, int64_t lo,
                                          int64_t hi, K target, bool strict) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    const K v = key[mid];
    const bool right = strict ? v < target : v <= target;
    if (right) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename K, typename U>
__global__ void __launch_bounds__(kThreads)
range_bounds(const K* __restrict__ key, const int32_t* __restrict__ seg_start,
             const int32_t* __restrict__ seg_end, int64_t n, int has_lower,
             int64_t preceding, int has_upper, int64_t following,
             int32_t* __restrict__ lower, int32_t* __restrict__ upper) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t s = seg_start[i];
  const int64_t e = seg_end[i];
  const U k = static_cast<U>(key[i]);
  if (has_lower) {
    const K target = static_cast<K>(k - static_cast<U>(preceding));
    lower[i] = static_cast<int32_t>(search<K>(key, s, e, target, true));
  } else {
    lower[i] = static_cast<int32_t>(s);
  }
  if (has_upper) {
    const K target = static_cast<K>(k + static_cast<U>(following));
    upper[i] = static_cast<int32_t>(search<K>(key, s, e, target, false) - 1);
  } else {
    upper[i] = static_cast<int32_t>(e - 1);
  }
}

// ---------------------------------------------------------------------------
// frame_extreme

enum ExtremeType { kBool = 0, kInt32 = 1, kInt64 = 2, kFloat = 3, kDouble = 4 };

constexpr long long kMaxKey = 0x7FFFFFFFFFFFFFFFll;
constexpr long long kMinKey = -kMaxKey - 1;

__device__ __forceinline__ long long order_key(int dtype, const void* data,
                                               int64_t i) {
  switch (dtype) {
    case kBool:
      return static_cast<const uint8_t*>(data)[i] != 0;
    case kInt32:
      return static_cast<const int32_t*>(data)[i];
    case kInt64:
      return static_cast<const long long*>(data)[i];
    case kFloat: {
      const float x = static_cast<const float*>(data)[i];
      const int32_t b = is_nan(x) ? 0x7FC00000 : __float_as_int(x);
      return b < 0 ? (b ^ 0x7FFFFFFF) : b;
    }
    default: {
      const double x = static_cast<const double*>(data)[i];
      const long long b = is_nan(x) ? 0x7FF8000000000000ll
                                    : __double_as_longlong(x);
      return b < 0 ? (b ^ kMaxKey) : b;
    }
  }
}

__device__ __forceinline__ void store_key(int dtype, bool is_min, void* out,
                                          int64_t i, long long k) {
  const bool none = k == (is_min ? kMaxKey : kMinKey);
  switch (dtype) {
    case kBool:
      static_cast<uint8_t*>(out)[i] = none ? (is_min ? 1 : 0)
                                           : static_cast<uint8_t>(k);
      break;
    case kInt32:
      static_cast<int32_t*>(out)[i] =
          none ? (is_min ? 0x7FFFFFFF : static_cast<int32_t>(0x80000000u))
               : static_cast<int32_t>(k);
      break;
    case kInt64:
      static_cast<long long*>(out)[i] = k;
      break;
    case kFloat: {
      const int32_t b = static_cast<int32_t>(k);
      static_cast<float*>(out)[i] =
          none ? (is_min ? __int_as_float(0x7F800000)
                         : __int_as_float(static_cast<int>(0xFF800000u)))
               : __int_as_float(b < 0 ? (b ^ 0x7FFFFFFF) : b);
      break;
    }
    default:
      static_cast<double*>(out)[i] =
          none ? (is_min ? __longlong_as_double(0x7FF0000000000000ll)
                         : __longlong_as_double(static_cast<long long>(
                               0xFFF0000000000000ull)))
               : __longlong_as_double(k < 0 ? (k ^ kMaxKey) : k);
  }
}

__device__ __forceinline__ long long pick(bool is_min, long long a,
                                          long long b) {
  return is_min ? (a < b ? a : b) : (a > b ? a : b);
}

__global__ void __launch_bounds__(kThreads)
extreme_level0(int dtype, int is_min, const void* __restrict__ data,
               const uint8_t* __restrict__ valid, int64_t n,
               long long* __restrict__ level) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  level[i] = valid[i] ? order_key(dtype, data, i)
                      : (is_min ? kMaxKey : kMinKey);
}

__global__ void __launch_bounds__(kThreads)
extreme_level(int is_min, const long long* __restrict__ prev, int64_t n,
              int64_t half, long long* __restrict__ next) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long a = prev[i];
  next[i] = i + half < n ? pick(is_min, a, prev[i + half]) : a;
}

__global__ void __launch_bounds__(kThreads)
extreme_query(int dtype, int is_min, const long long* __restrict__ table,
              int64_t n, const int32_t* __restrict__ lower,
              const int32_t* __restrict__ upper, void* __restrict__ out,
              uint8_t* __restrict__ nonempty) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t lo = lower[i];
  const int64_t hi = upper[i];
  const long long none = is_min ? kMaxKey : kMinKey;
  if (hi < lo) {
    store_key(dtype, is_min, out, i, none);
    nonempty[i] = 0;
    return;
  }
  const int len = static_cast<int>(hi - lo + 1);
  const int lvl = 31 - __clz(len);
  const long long* row = table + static_cast<int64_t>(lvl) * n;
  const long long k = pick(is_min, row[lo], row[hi - (1ll << lvl) + 1]);
  store_key(dtype, is_min, out, i, k);
  nonempty[i] = 1;
}

inline unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int srt_window_tile() { return kTile; }

// Bytes of one tile's scan state: window_layout's forward and backward
// aggregates, or frame_sum's (f64 or i64) prefix state.
int srt_window_state_bytes(int kind) {
  switch (kind) {
    case 0: return static_cast<int>(sizeof(Fwd) + sizeof(Bwd));
    case 1: return static_cast<int>(sizeof(SumF64));
    default: return static_cast<int>(sizeof(SumI64));
  }
}

// part[n], peer[n]: the boundary flags (bool bytes).  Outputs int32[n]
// each.  scratch: 2 * ceil(n / srt_window_tile()) tiles of
// srt_window_state_bytes(0) bytes.
int srt_window_layout(const uint8_t* part, const uint8_t* peer, int64_t n,
                      void* scratch, int32_t* seg_start, int32_t* seg_end,
                      int32_t* run_id, int32_t* run_first, int32_t* run_last,
                      cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t ntiles = (n + kTile - 1) / kTile;
  Fwd* fwd = static_cast<Fwd*>(scratch);
  Fwd* fwd_carry = fwd + ntiles;
  Bwd* bwd = reinterpret_cast<Bwd*>(fwd_carry + ntiles);
  Bwd* bwd_carry = bwd + ntiles;
  const unsigned grid = static_cast<unsigned>(ntiles);
  const int32_t none = static_cast<int32_t>(n);
  layout_tiles<<<grid, kThreads, 0, stream>>>(part, peer, n, fwd, bwd);
  carry_kernel<Fwd, FwdOp><<<1, kCarryThreads, 0, stream>>>(
      fwd, fwd_carry, ntiles, Fwd{-1, -1, 0}, FwdOp(), 0);
  carry_kernel<Bwd, BwdOp><<<1, kCarryThreads, 0, stream>>>(
      bwd, bwd_carry, ntiles, Bwd{none, none}, BwdOp(), 1);
  layout_apply<<<grid, kThreads, 0, stream>>>(part, peer, n, fwd_carry,
                                              bwd_carry, seg_start, seg_end,
                                              run_id, run_first, run_last);
  return static_cast<int>(cudaGetLastError());
}

// is_f64: data double[n] (else int64[n]) with valid[n]; seg_start[n] from
// window_layout; lower[n], upper[n] the frames.  out[n] (double or int64),
// out_count[n].  scratch: 2 * ceil(n / srt_window_tile()) tiles of
// srt_window_state_bytes(1 or 2) bytes.  The prefixes: psum[n] (8 bytes a
// row), pcount[n]; f64 also plo[n] (double), pnan, ppinf, pninf (int32[n]).
int srt_frame_sum(int is_f64, const void* data, const uint8_t* valid,
                  const int32_t* seg_start, const int32_t* lower,
                  const int32_t* upper, int64_t n, void* scratch, void* psum,
                  double* plo, int64_t* pcount, int32_t* pnan, int32_t* ppinf,
                  int32_t* pninf, void* out, int64_t* out_count,
                  cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Prefix pre{psum, plo, pcount, pnan, ppinf, pninf};
  int err;
  if (is_f64) {
    err = frame_sum(F64Policy{static_cast<const double*>(data)}, valid,
                    seg_start, n, scratch, pre, stream);
    if (err) return err;
    sum_query_f64<<<blocks(n), kThreads, 0, stream>>>(
        pre, seg_start, lower, upper, n, static_cast<double*>(out),
        out_count);
  } else {
    err = frame_sum(I64Policy{static_cast<const int64_t*>(data)}, valid,
                    seg_start, n, scratch, pre, stream);
    if (err) return err;
    sum_query_i64<<<blocks(n), kThreads, 0, stream>>>(
        pre, seg_start, lower, upper, n, static_cast<int64_t*>(out),
        out_count);
  }
  return static_cast<int>(cudaGetLastError());
}

// key[n]: int64 (is_i64) or int32, ascending within each partition;
// seg_start[n], seg_end[n] from window_layout.  A side with has_* = 0 is
// unbounded.  lower[n], upper[n]: int32.
int srt_range_frame_bounds(int is_i64, const void* key,
                           const int32_t* seg_start, const int32_t* seg_end,
                           int64_t n, int has_lower, int64_t preceding,
                           int has_upper, int64_t following, int32_t* lower,
                           int32_t* upper, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (is_i64) {
    range_bounds<long long, unsigned long long>
        <<<blocks(n), kThreads, 0, stream>>>(
            static_cast<const long long*>(key), seg_start, seg_end, n,
            has_lower, preceding, has_upper, following, lower, upper);
  } else {
    range_bounds<int32_t, uint32_t><<<blocks(n), kThreads, 0, stream>>>(
        static_cast<const int32_t*>(key), seg_start, seg_end, n, has_lower,
        preceding, has_upper, following, lower, upper);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 bool, 1 int32, 2 int64, 3 float, 4 double; data[n], valid[n];
// lower[n], upper[n] with every frame at most max_len rows; table: levels *
// n int64 (levels = floor(log2(max_len)) + 1).  out[n] of the dtype,
// nonempty[n] (bool).
int srt_frame_extreme(int dtype, int is_min, const void* data,
                      const uint8_t* valid, int64_t n, const int32_t* lower,
                      const int32_t* upper, int levels, long long* table,
                      void* out, uint8_t* nonempty, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype < kBool || dtype > kDouble || levels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  extreme_level0<<<blocks(n), kThreads, 0, stream>>>(dtype, is_min, data,
                                                     valid, n, table);
  for (int l = 1; l < levels; ++l) {
    extreme_level<<<blocks(n), kThreads, 0, stream>>>(
        is_min, table + static_cast<int64_t>(l - 1) * n, n, 1ll << (l - 1),
        table + static_cast<int64_t>(l) * n);
  }
  extreme_query<<<blocks(n), kThreads, 0, stream>>>(dtype, is_min, table, n,
                                                    lower, upper, out,
                                                    nonempty);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
