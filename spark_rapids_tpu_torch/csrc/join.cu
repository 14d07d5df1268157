// Joins of the port, inner, left, right, full, semi and anti, on one
// fixed-width key or on several keys (strings among them): a sorted build
// side, a binary-search probe and the expansion into gather maps; the
// cross join's pairs; and the final maps of a join with a residual
// condition.  Built for sm_90a by kernels/_lib.py and
// called through ctypes from kernels/join.py.  Every entry point launches
// on the caller's stream, allocates nothing, and returns the cudaError_t of
// its launches.
//
// <- spark_rapids_tpu/kernels/join.py:154 _probe_single, :226
//    _expand_single, :275 _probe_multi, :420 _expand_multi (behind
//    join_probe :457, join_expand :484, join_gather_maps :496), their left
//    branches (:203-206, :237-246; :395), their semi and anti branches
//    (:197-201, :212, :231-233; :397-400, :440-441), their right and full
//    branches (:393-416, :445-452), :250 _probe_cross and :260
//    _expand_cross, and :44 conditional_join_maps
//
// Modes.  A probe runs in one of four modes, one per join type it serves
// (kernels/join.py _MODES): inner, left, left semi, left anti.
//
// Left join.  In left mode a probe writes max(matches, 1) as a stream
// row's count, so a row with no match (a null key included) gets one
// output row, and writes lo = -1 for it; the shared expand writes ri = -1
// where lo < 0, which the gather turns into a null row.  The inner probe
// never writes a negative lo.
//
// Semi and anti joins (<- spark_rapids_tpu/kernels/join.py:197-201
// _probe_single, :212 _expand_left_only_mask, :231-233 _expand_single;
// :397-400 _probe_multi, :440-441 _expand_multi).  A row needs only to
// know whether it has a match: the lower bound and one comparison, no
// upper bound.  In semi mode a row writes a count of 1 where it has a
// match, in anti mode where it has none (a null key included: it matches
// nothing); it writes no lo.  The scan turns the 0/1 counts into output
// positions and the number of rows, which the wrapper reads back once, as
// for the other modes; join_expand_left_only_kernel then writes each kept
// row's index at its position.  Rows come out in stream order, each once,
// and there is no right map: the gather takes the left columns alone.
//   Bound (probe): bytes: per stream row its key (or words) and validity
//   read, the 4-byte count written and read by the scan.  Bound (expand):
//   bytes: the n + 1 offsets read, 4 bytes per kept row written.
//
// Right and full joins (K1) <- spark_rapids_tpu/kernels/join.py:393-416
// _probe_multi's right / full branches, :445-452 _expand_multi's append.
// A right join probes in inner mode, a full join in left mode; the expand
// then also stores 1 in matched[perm[lo + j]], a byte per build row, for
// every pair it writes (the flags of a build outlive its stream groups:
// the wrapper zeroes them once, each group's expand sets more).  Many
// threads may store the same 1 into one byte: a benign race, all writers
// store the same value, and the launch boundary orders the stores before
// the compaction that reads them, so no atomics are needed.  After the
// last group the wrapper compacts the flags' complement in build-row
// order (csrc/selection.cu) into the appended (-1, row) pairs, so there
// is no second pass over the pairs.
//   Bound: bytes: the maps written (8 bytes a pair), each matched row's lo,
//   offsets and perm entries read, and one flag byte per pair.
//
// Cross join (K2) <- spark_rapids_tpu/kernels/join.py:250 _probe_cross,
// :260 _expand_cross.  One thread per pair k < nl * nr writes li = k / nr
// and ri = k % nr (int32): the pairs in left-row order, each left row's in
// right-row order; also the candidates of a keyless join with a
// condition.  No probe: the counts are nl * nr.
//   Bound: bytes: 8 bytes written per pair.
//
// Keys.  Every key becomes the order-preserving uint64 of csrc/sort.cu:
// integers (byte, short, int, date, long, Decimal64) sign-extend to 64 bits and flip
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
// Several keys.  The reference sorts both sides together once
// (_probe_multi); here the build side alone is sorted once per join, and
// each key tuple becomes a row of order words, compared
// lexicographically.  A fixed-width key is its one uint64 order key (as
// above); a string key is nchunks big-endian 8-byte chunks (zero past
// the end, csrc/strings.cuh, as the sort's keys) and then its
// length, the least significant word.  The wrapper sorts the build rows by
// (any key null, the keys) with the ported radix sort, reads back the
// longest build string of each string key (nchunks = ceil(longest / 8)),
// and join_key_words_kernel writes each sorted row's words and whether all
// its keys are valid.  A stream row's words are written by the same
// kernel at the build's chunk counts, so a stream string longer than every
// build string keeps its full length as its last word: it compares greater
// than every build row that shares its chunks and matches none of them,
// and the order the binary search relies on is the build's own.  One
// thread per stream row then runs a lexicographic lower and upper bound
// over the build's word rows (a build row with a null key is greater than
// every tuple), the scan of csrc/scan.cuh makes the offsets, and the
// expand above turns (lo, count) into pairs through perm: _expand_multi
// shares join_expand_kernel.
//   Bound (words): bytes: each key column read once, 8 bytes a word
//   written.  Bound (probe): bytes: the stream's words read once, 8 bytes
//   of (lo, count) written and read by the scan, the build's words read
//   once.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "scan.cuh"
#include "strings.cuh"

namespace {

constexpr int kThreads = 256;

// key kinds (kernels/join.py _KIND)
constexpr int kInt32 = 0;   // int, date
constexpr int kInt64 = 1;   // long, Decimal64
constexpr int kF64 = 2;     // double
constexpr int kBool = 3;    // bool
constexpr int kString = 4;  // string (several-key path only)
constexpr int kDec128 = 5;  // two-limb decimal (several-key path only): two
                            // words, the signed high limb with its sign bit
                            // flipped, then the low limb (csrc/sort.cu's
                            // kDec128Hi and kDec128Lo)
constexpr int kInt8 = 6;    // byte
constexpr int kInt16 = 7;   // short
constexpr int kMaxKeys = 16;

// probe modes (kernels/join.py _MODES)
constexpr int kInner = 0;
constexpr int kLeft = 1;
constexpr int kSemi = 2;
constexpr int kAnti = 3;

// the key columns of one side, passed by value to the words kernel
struct KeyCols {
  int nkeys;
  int kinds[kMaxKeys];
  int nchunks[kMaxKeys];                // string keys: chunks written
  const void* data[kMaxKeys];
  const uint8_t* valid[kMaxKeys];
  const int32_t* offsets[kMaxKeys];     // string keys only
};

__device__ __forceinline__ uint64_t order_key(const void* data, int kind,
                                              int64_t r) {
  switch (kind) {
    case kInt32:
      return static_cast<uint64_t>(static_cast<int64_t>(
                 static_cast<const int32_t*>(data)[r])) ^ (1ull << 63);
    case kInt64:
      return static_cast<uint64_t>(static_cast<const int64_t*>(data)[r]) ^
             (1ull << 63);
    case kInt8:
      return static_cast<uint64_t>(static_cast<int64_t>(
                 static_cast<const int8_t*>(data)[r])) ^ (1ull << 63);
    case kInt16:
      return static_cast<uint64_t>(static_cast<int64_t>(
                 static_cast<const int16_t*>(data)[r])) ^ (1ull << 63);
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

// A stream row's (first match, count): in left mode a row with no match
// gets (-1, 1), one null-extended output row; in semi and anti mode only
// the 0/1 count is written.
__device__ __forceinline__ void write_match(int64_t r, int64_t first,
                                            int64_t matches, int mode,
                                            int32_t* lo_out, int32_t* count) {
  if (mode >= kSemi) {
    count[r] = (matches > 0) == (mode == kSemi);
    return;
  }
  if (mode == kLeft && matches == 0) {
    lo_out[r] = -1;
    count[r] = 1;
    return;
  }
  lo_out[r] = static_cast<int32_t>(first);
  count[r] = static_cast<int32_t>(matches);
}

__global__ void __launch_bounds__(kThreads)
join_probe_kernel(const void* __restrict__ data,
                  const uint8_t* __restrict__ valid, int kind, int64_t n,
                  const uint64_t* __restrict__ keys,
                  const uint8_t* __restrict__ key_valid, int64_t nb, int mode,
                  int32_t* __restrict__ lo_out, int32_t* __restrict__ count) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  if (valid[r] == 0) {     // a null key matches nothing
    write_match(r, 0, 0, mode, lo_out, count);
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
  if (mode >= kSemi) {     // one comparison: is the lower bound a match
    const bool hit = first < nb && key_valid[first] != 0 && keys[first] == k;
    write_match(r, first, hit, mode, lo_out, count);
    return;
  }
  hi = nb;   // upper bound: the first position greater than k
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (key_valid[mid] != 0 && keys[mid] <= k) lo = mid + 1; else hi = mid;
  }
  write_match(r, first, lo - first, mode, lo_out, count);
}

// matched (K1, a right or full join; may be null): each pair's build row
// is flagged.
__global__ void __launch_bounds__(kThreads)
join_expand_kernel(const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ perm, int64_t n,
                   int32_t* __restrict__ li, int32_t* __restrict__ ri,
                   uint8_t* __restrict__ matched) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t base = offsets[r];
  const int32_t m = offsets[r + 1] - base;
  const int32_t first = lo[r];
  if (first < 0) {   // a left or full join's row with no match
    li[base] = static_cast<int32_t>(r);
    ri[base] = -1;
    return;
  }
  for (int32_t j = 0; j < m; ++j) {
    const int32_t b = perm[first + j];
    li[base + j] = static_cast<int32_t>(r);
    ri[base + j] = b;
    if (matched != nullptr) matched[b] = 1;
  }
}

// K2: pair k of nl x nr is (k / nr, k % nr).
__global__ void __launch_bounds__(kThreads)
join_expand_cross_kernel(int64_t total, int64_t nr,
                         int32_t* __restrict__ li, int32_t* __restrict__ ri) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= total) return;
  const int64_t l = k / nr;
  li[k] = static_cast<int32_t>(l);
  ri[k] = static_cast<int32_t>(k - l * nr);
}

// A semi or anti join's map: a kept row (count 1) writes its index at its
// offset; there is no right map.
__global__ void __launch_bounds__(kThreads)
join_expand_left_only_kernel(const int32_t* __restrict__ offsets, int64_t n,
                             int32_t* __restrict__ li) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t base = offsets[r];
  if (offsets[r + 1] != base) li[base] = static_cast<int32_t>(r);
}

__global__ void __launch_bounds__(kThreads)
join_key_words_kernel(KeyCols cols, const int32_t* __restrict__ perm,
                      int64_t n, int nwords, uint64_t* __restrict__ words,
                      uint8_t* __restrict__ valid_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = perm != nullptr ? perm[i] : i;
  bool v = true;
  for (int k = 0; k < cols.nkeys; ++k) v = v && cols.valid[k][r] != 0;
  valid_out[i] = v;
  uint64_t* w = words + i * nwords;
  if (!v) {
    for (int j = 0; j < nwords; ++j) w[j] = 0ull;
    return;
  }
  int j = 0;
  for (int k = 0; k < cols.nkeys; ++k) {
    if (cols.kinds[k] == kDec128) {
      const int64_t* limbs = static_cast<const int64_t*>(cols.data[k]);
      w[j++] = static_cast<uint64_t>(limbs[2 * r + 1]) ^ (1ull << 63);
      w[j++] = static_cast<uint64_t>(limbs[2 * r]);
      continue;
    }
    if (cols.kinds[k] != kString) {
      w[j++] = order_key(cols.data[k], cols.kinds[k], r);
      continue;
    }
    const int32_t b = cols.offsets[k][r];
    const int32_t len = cols.offsets[k][r + 1] - b;
    const uint8_t* p = static_cast<const uint8_t*>(cols.data[k]) + b;
    for (int c = 0; c < cols.nchunks[k]; ++c) w[j++] = string_chunk(p, len, c);
    w[j++] = static_cast<uint64_t>(len);
  }
}

// -1, 0 or 1 as the word row a orders before, with or after b
__device__ __forceinline__ int compare_words(const uint64_t* a,
                                             const uint64_t* b, int nwords) {
  for (int j = 0; j < nwords; ++j) {
    if (a[j] != b[j]) return a[j] < b[j] ? -1 : 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
join_multi_probe_kernel(const uint64_t* __restrict__ swords,
                        const uint8_t* __restrict__ svalid, int64_t n,
                        const uint64_t* __restrict__ bwords,
                        const uint8_t* __restrict__ bvalid, int64_t nb,
                        int nwords, int mode, int32_t* __restrict__ lo_out,
                        int32_t* __restrict__ count) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  if (svalid[r] == 0) {     // a null in any key matches nothing
    write_match(r, 0, 0, mode, lo_out, count);
    return;
  }
  const uint64_t* s = swords + r * nwords;
  // lower bound: the first build row not less than s (a build row with a
  // null key is greater than every tuple)
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    const uint64_t* b = bwords + mid * nwords;
    if (bvalid[mid] != 0 && compare_words(b, s, nwords) < 0)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int64_t first = lo;
  if (mode >= kSemi) {     // one comparison: is the lower bound a match
    const bool hit = first < nb && bvalid[first] != 0 &&
                     compare_words(bwords + first * nwords, s, nwords) == 0;
    write_match(r, first, hit, mode, lo_out, count);
    return;
  }
  hi = nb;   // upper bound: the first build row greater than s
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    const uint64_t* b = bwords + mid * nwords;
    if (bvalid[mid] != 0 && compare_words(b, s, nwords) <= 0)
      lo = mid + 1;
    else
      hi = mid;
  }
  write_match(r, first, lo - first, mode, lo_out, count);
}

// Conditional join maps.  Three segments of candidates make the output,
// in its order: 0, the candidate pairs (a pair is selected where it
// passed the condition); 1, the left rows (selected where live and, by
// join type, unmatched, matched or either); 2, the right rows (live and
// unmatched).  A join type turns segments on or off (inner: 0; left: 0
// and 1; right: 0 and 2; full: all; semi, anti and existence: 1 alone).
// cond_mark_kernel first stores a byte flag for every row a passing pair
// touches, lmatched and rmatched (many threads may store the same 1: no
// atomics are needed).  Then the compaction of csrc/selection.cu runs over
// the segments laid end to end as tiles of kCjTile elements: a count per
// tile, the exclusive scan of csrc/scan.cuh over all tiles, whose offsets
// are then the output positions themselves and whose total the wrapper
// reads back once, and a scatter in which each tile ranks its selected
// elements with cub::BlockScan and writes (li, ri) directly: the pair, or
// (row, -1), or (-1, row).  Deterministic and stable: the output order is
// the reference's (passing pairs in candidate order, then the unmatched
// left rows in row order, then the unmatched right rows).
//   Bound: bytes: the pass mask, li and ri read once, lmatched and
//   rmatched written, the live flags read, 8 bytes per output row written.
constexpr int kCjThreads = 256;
constexpr int kCjItems = 8;
constexpr int kCjTile = kCjThreads * kCjItems;

struct CondSegs {
  int64_t n[3];           // elements of each segment (0: segment off)
  int64_t tile_base[4];   // first tile of each segment, then the total
  const uint8_t* pass;
  const int32_t* li;
  const int32_t* ri;
  const uint8_t* left_live;
  const uint8_t* right_live;
  const uint8_t* lmatched;
  const uint8_t* rmatched;
  int left_want;          // 0 unmatched left rows, 1 matched, -1 every one
};

__device__ __forceinline__ bool cond_selected(const CondSegs& s, int seg,
                                              int64_t i) {
  if (seg == 0) return s.pass[i] != 0;
  if (seg == 1) {
    return s.left_live[i] != 0 &&
           (s.left_want < 0 || (s.lmatched[i] != 0) == (s.left_want == 1));
  }
  return s.right_live[i] != 0 && s.rmatched[i] == 0;
}

__device__ __forceinline__ int cond_segment(const CondSegs& s, int64_t t) {
  return t < s.tile_base[1] ? 0 : (t < s.tile_base[2] ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads)
cond_mark_kernel(const uint8_t* __restrict__ pass,
                 const int32_t* __restrict__ li,
                 const int32_t* __restrict__ ri, int64_t npairs, int64_t nl,
                 int64_t nr, uint8_t* __restrict__ lmatched,
                 uint8_t* __restrict__ rmatched) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= npairs || pass[k] == 0) return;
  const int32_t l = li[k], r = ri[k];
  if (l >= 0 && l < nl) lmatched[l] = 1;
  if (r >= 0 && r < nr) rmatched[r] = 1;
}

__global__ void __launch_bounds__(kCjThreads)
cond_count_kernel(CondSegs s, int32_t* __restrict__ tile_counts) {
  using Reduce = cub::BlockReduce<int, kCjThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t t = blockIdx.x;
  const int seg = cond_segment(s, t);
  const int64_t base = (t - s.tile_base[seg]) * kCjTile;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kCjItems; ++i) {
    // striped: neighbouring threads read neighbouring bytes
    const int64_t j = base + static_cast<int64_t>(i) * kCjThreads + threadIdx.x;
    if (j < s.n[seg]) c += cond_selected(s, seg, j);
  }
  const int total = Reduce(tmp).Sum(c);
  if (threadIdx.x == 0) tile_counts[t] = total;
}

__global__ void __launch_bounds__(kCjThreads)
cond_scatter_kernel(CondSegs s, const int32_t* __restrict__ tile_offsets,
                    int32_t* __restrict__ li_out,
                    int32_t* __restrict__ ri_out) {
  using Scan = cub::BlockScan<int, kCjThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t t = blockIdx.x;
  const int seg = cond_segment(s, t);
  // blocked: thread u owns elements [u * items, (u + 1) * items) of the
  // tile, so an exclusive scan of per-thread counts gives stable ranks
  const int64_t base = (t - s.tile_base[seg]) * kCjTile +
                       static_cast<int64_t>(threadIdx.x) * kCjItems;
  bool keep[kCjItems];
  int c = 0;
#pragma unroll
  for (int i = 0; i < kCjItems; ++i) {
    const int64_t j = base + i;
    keep[i] = j < s.n[seg] && cond_selected(s, seg, j);
    c += keep[i];
  }
  int rank;
  Scan(tmp).ExclusiveSum(c, rank);
  int64_t pos = static_cast<int64_t>(tile_offsets[t]) + rank;
#pragma unroll
  for (int i = 0; i < kCjItems; ++i) {
    if (!keep[i]) continue;
    const int64_t j = base + i;
    if (seg == 0) {
      li_out[pos] = s.li[j];
      ri_out[pos] = s.ri[j];
    } else if (seg == 1) {
      li_out[pos] = static_cast<int32_t>(j);
      ri_out[pos] = -1;
    } else {
      li_out[pos] = -1;
      ri_out[pos] = static_cast<int32_t>(j);
    }
    ++pos;
  }
}

// The segments of a join type: bit 1 pairs, 2 left rows, 4 right rows.
bool cond_segs(int segments, int left_want, const uint8_t* pass,
               const int32_t* li, const int32_t* ri, int64_t npairs,
               const uint8_t* left_live, int64_t nl, const uint8_t* right_live,
               int64_t nr, const uint8_t* lmatched, const uint8_t* rmatched,
               CondSegs* s) {
  if (segments < 1 || segments > 7 || left_want < -1 || left_want > 1) {
    return false;
  }
  s->n[0] = (segments & 1) ? npairs : 0;
  s->n[1] = (segments & 2) ? nl : 0;
  s->n[2] = (segments & 4) ? nr : 0;
  s->tile_base[0] = 0;
  for (int k = 0; k < 3; ++k) {
    s->tile_base[k + 1] = s->tile_base[k] + (s->n[k] + kCjTile - 1) / kCjTile;
  }
  s->pass = pass;
  s->li = li;
  s->ri = ri;
  s->left_live = left_live;
  s->right_live = right_live;
  s->lmatched = lmatched;
  s->rmatched = rmatched;
  s->left_want = left_want;
  return true;
}

// The key columns from the ctypes arrays; false if one is out of range.
bool key_cols(int nkeys, const int* kinds, const int* nchunks,
              const void* const* data, const void* const* valid,
              const void* const* offsets, int nwords, KeyCols* out) {
  if (nkeys < 1 || nkeys > kMaxKeys) return false;
  int words = 0;
  out->nkeys = nkeys;
  for (int k = 0; k < nkeys; ++k) {
    if (kinds[k] < kInt32 || kinds[k] > kInt16) return false;
    if (kinds[k] == kString && (nchunks[k] < 0 || offsets[k] == nullptr))
      return false;
    out->kinds[k] = kinds[k];
    out->nchunks[k] = kinds[k] == kString ? nchunks[k] : 0;
    out->data[k] = data[k];
    out->valid[k] = static_cast<const uint8_t*>(valid[k]);
    out->offsets[k] = static_cast<const int32_t*>(offsets[k]);
    words += kinds[k] == kString ? nchunks[k] + 1
             : kinds[k] == kDec128 ? 2 : 1;
  }
  return words == nwords;
}

unsigned grid_rows(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// a kind of one fixed-width key (the single-key build and probe)
bool single_kind(int kind) {
  return kind >= kInt32 && kind <= kInt16 && kind != kString &&
         kind != kDec128;
}

}  // namespace

extern "C" {

int srt_join_scan_tile() { return scan::kScanTile; }

// keys[n] (uint64) and key_valid[n] of the build rows in sorted order perm.
int srt_join_build_keys(int kind, const void* data, const uint8_t* valid,
                        const int32_t* perm, int64_t n, uint64_t* keys,
                        uint8_t* key_valid, cudaStream_t stream) {
  if (!single_kind(kind)) {
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
// total[0] (int64) the number of pairs.  mode: 0 inner; 1 left, a row with
// no match gets one pair (lo = -1); 2 semi and 3 anti, a row's count is 1
// where it is kept and lo is not written (it may be null).  tile_sums
// holds ceil(n / srt_join_scan_tile()) int64, at least one.
int srt_join_probe(int kind, const void* data, const uint8_t* valid,
                   int64_t n, const uint64_t* keys, const uint8_t* key_valid,
                   int64_t nb, int mode, int32_t* lo, int32_t* offsets,
                   int64_t* tile_sums, int64_t* total, cudaStream_t stream) {
  if (!single_kind(kind) || mode < kInner || mode > kAnti) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    join_probe_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        data, valid, kind, n, keys, key_valid, nb, mode, lo, offsets);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan::ScanCols cols{};
  cols.v[0] = offsets;
  return scan::scan_columns(cols, 1, n, tile_sums, total, stream);
}

// li[total] and ri[total]: the pairs, after srt_join_probe; matched (may
// be null: K1) receives a 1 for each pair's build row perm[lo + j] (the
// caller zeroed it once per build).
int srt_join_expand(const int32_t* lo, const int32_t* offsets,
                    const int32_t* perm, int64_t n, int32_t* li, int32_t* ri,
                    uint8_t* matched, cudaStream_t stream) {
  if (n > 0) {
    join_expand_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        lo, offsets, perm, n, li, ri, matched);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2: li[nl * nr] and ri[nl * nr] (int32), every pair, left-major; nl * nr
// must stay below 2**31.
int srt_join_expand_cross(int64_t nl, int64_t nr, int32_t* li, int32_t* ri,
                          cudaStream_t stream) {
  if (nl < 0 || nr < 0 || nl * nr >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = nl * nr;
  if (total > 0) {
    join_expand_cross_kernel<<<grid_rows(total), kThreads, 0, stream>>>(
        total, nr, li, ri);
  }
  return static_cast<int>(cudaGetLastError());
}

// li[total]: the kept rows of a semi or anti probe, from its offsets[n + 1].
int srt_join_expand_left_only(const int32_t* offsets, int64_t n, int32_t* li,
                              cudaStream_t stream) {
  if (n > 0) {
    join_expand_left_only_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        offsets, n, li);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_join_max_keys() { return kMaxKeys; }

// words[n * nwords] (uint64, row-major) and valid[n] of the key tuples of
// rows perm[0..n) (perm null: rows 0..n); each string key takes
// nchunks[k] chunks and its length.  Host arrays: kinds, nchunks and the
// column pointers (offsets null for a fixed-width key).
int srt_join_key_words(int nkeys, const int* kinds, const int* nchunks,
                       const void* const* data, const void* const* valid,
                       const void* const* offsets, const int32_t* perm,
                       int64_t n, int nwords, uint64_t* words,
                       uint8_t* valid_out, cudaStream_t stream) {
  KeyCols cols;
  if (!key_cols(nkeys, kinds, nchunks, data, valid, offsets, nwords, &cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    join_key_words_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        cols, perm, n, nwords, words, valid_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// For n stream rows (their key columns as above; swords[n * nwords] and
// svalid[n] are scratch) against nb build word rows: lo[n], offsets[n + 1]
// and total[0], as srt_join_probe gives them (mode as there).
int srt_join_multi_probe(int nkeys, const int* kinds, const int* nchunks,
                         const void* const* data, const void* const* valid,
                         const void* const* offsets, int64_t n, int nwords,
                         uint64_t* swords, uint8_t* svalid,
                         const uint64_t* bwords, const uint8_t* bvalid,
                         int64_t nb, int mode, int32_t* lo,
                         int32_t* offsets_out, int64_t* tile_sums,
                         int64_t* total, cudaStream_t stream) {
  if (mode < kInner || mode > kAnti) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = srt_join_key_words(nkeys, kinds, nchunks, data, valid, offsets,
                               nullptr, n, nwords, swords, svalid, stream);
  if (err != 0) return err;
  if (n > 0) {
    join_multi_probe_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        swords, svalid, n, bwords, bvalid, nb, nwords, mode, lo,
        offsets_out);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan::ScanCols cols{};
  cols.v[0] = offsets_out;
  return scan::scan_columns(cols, 1, n, tile_sums, total, stream);
}

int srt_cond_join_tile() { return kCjTile; }

// Step 1 of conditional_join_maps over npairs candidates (li, ri, pass)
// against nl left and nr right rows: lmatched[nl] and rmatched[nr] (bool),
// the rows a passing pair touches; then tile_counts[tiles + 1] (int32),
// the output offset of every tile of the enabled segments, and total[0]
// (int64), the output rows.  tiles is the sum over the enabled segments
// of ceil(rows / srt_cond_join_tile()); tile_sums holds ceil(tiles /
// srt_join_scan_tile()) int64, at least one.  accumulate_right: rmatched
// is not zeroed first, so that the flags of a build's stream groups add up
// (the caller leaves the right rows' segment out and appends them once).
int srt_cond_join_count(int segments, int left_want, const uint8_t* pass,
                        const int32_t* li, const int32_t* ri, int64_t npairs,
                        const uint8_t* left_live, int64_t nl,
                        const uint8_t* right_live, int64_t nr,
                        uint8_t* lmatched, uint8_t* rmatched,
                        int32_t* tile_counts, int64_t* tile_sums,
                        int64_t* total, int accumulate_right,
                        cudaStream_t stream) {
  CondSegs s;
  if (!cond_segs(segments, left_want, pass, li, ri, npairs, left_live, nl,
                 right_live, nr, lmatched, rmatched, &s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaMemsetAsync(lmatched, 0, nl > 0 ? nl : 0, stream);
  if (e == cudaSuccess && !accumulate_right) {
    e = cudaMemsetAsync(rmatched, 0, nr > 0 ? nr : 0, stream);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (npairs > 0) {
    cond_mark_kernel<<<grid_rows(npairs), kThreads, 0, stream>>>(
        pass, li, ri, npairs, nl, nr, lmatched, rmatched);
  }
  const int64_t tiles = s.tile_base[3];
  if (tiles > 0) {
    cond_count_kernel<<<static_cast<unsigned>(tiles), kCjThreads, 0,
                        stream>>>(s, tile_counts);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan::ScanCols cols{};
  cols.v[0] = tile_counts;
  return scan::scan_columns(cols, 1, tiles, tile_sums, total, stream);
}

// Step 2, after the wrapper has read total back: li_out[total] and
// ri_out[total] (int32, -1 for the side a row null-extends).
int srt_cond_join_scatter(int segments, int left_want, const uint8_t* pass,
                          const int32_t* li, const int32_t* ri,
                          int64_t npairs, const uint8_t* left_live,
                          int64_t nl, const uint8_t* right_live, int64_t nr,
                          const uint8_t* lmatched, const uint8_t* rmatched,
                          const int32_t* tile_counts, int32_t* li_out,
                          int32_t* ri_out, cudaStream_t stream) {
  CondSegs s;
  if (!cond_segs(segments, left_want, pass, li, ri, npairs, left_live, nl,
                 right_live, nr, lmatched, rmatched, &s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = s.tile_base[3];
  if (tiles > 0) {
    cond_scatter_kernel<<<static_cast<unsigned>(tiles), kCjThreads, 0,
                          stream>>>(s, tile_counts, li_out, ri_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
