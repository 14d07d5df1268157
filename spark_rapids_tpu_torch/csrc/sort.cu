// Stable radix passes of the port: the stable partition reorder of a hash
// exchange and the LSD radix argsort.  Built for sm_90a by kernels/_lib.py
// and called through ctypes from kernels/partition.py and kernels/sort.py.
// Every entry point launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of its launches.
//
// One pass family serves both: a pass reorders (key, row id) pairs stably by
// one digit of at most 8 bits.
//   (1) radix_hist_kernel: each block counts the digits of one tile of
//       kTile rows (warp-aggregated shared atomics: counts only, so their
//       order does not matter) into hist[digit * ntiles + tile];
//   (2) radix_scan_kernel: block d scans digit d's tile counts in place
//       (tile-minor) and writes the digit's total;
//   (3) radix_scatter_kernel: each block scans the digit totals, so that a
//       (digit, tile) starts after every smaller digit and after the same
//       digit in earlier tiles, which keeps the pass stable; then it walks
//       its tile in row order, 256 rows at a time.  A row's rank among the
//       equal digits before it is __popc of the lower lanes of its
//       __match_any_sync peers, plus the counts of lower warps of the chunk
//       (shared memory), plus the running count of earlier chunks.  No global atomics: a global
//       counter per digit would not keep row order.
//
// partition  <- spark_rapids_tpu/kernels/partition.py:27 hash_partition
//   LSD passes over the int32 partition ids (pmod of the murmur3 hash, from
//   csrc/hash.cu), ceil(log2(num_partitions)) bits in all, 8 per pass: the
//   stable order by partition id.  With one pass (at most 256 partitions)
//   the per-partition counts are the digit totals; with more, each
//   partition's count is the width of its run in the sorted ids (two
//   binary searches, one thread per partition).
//   Bound: bytes: 4 bytes of id read and 4 of row id written per row (the
//   histogram re-reads the ids once more).
//
// R1 round_robin_order <- spark_rapids_tpu/kernels/partition.py:67
//                         round_robin_partition
//   Row i goes to partition (i + start) % n.  The reference lexsorts the
//   partition ids; here partition p holds the rows r0 + q * n in order,
//   r0 = (p - start) mod n, so the stable order has a closed form: with
//   s = (-start) mod n, rows = n * Q + R and g(x) = (x / n) * R + min(x %
//   n, R) (the integers below x whose residue is < R), partition p starts
//   at p * Q + g(s + p) - g(s); s + p < 2n, so g takes no division.  One
//   thread per output row binary-searches its partition over those starts
//   (no table in memory) and writes its source row; the gather then moves
//   the columns.  The counts are host
//   arithmetic (kernels/partition.py), so a round-robin map batch takes no
//   radix pass and no read of its counts.
//   Bound: bytes: 4 bytes of row id written per row; ~2 log2(n) integer
//   operations a row.
//
// sort       <- spark_rapids_tpu/kernels/sort.py:200 sort_indices, :241
//               sort_batch, with the key builders _data_key_fixed :101,
//               _null_key :117 and f64_total_order_u64 :52 (the non-TPU
//               branch :68-70)
//   Each key column, least significant first, becomes an order-preserving
//   unsigned key (sign bit flipped for integers; doubles by Java's total
//   order: ~bits when negative, bits | sign when not; inverted for DESC;
//   0 for a null row) in the current row order, then takes one pass per
//   byte: 4 for 32-bit keys, 8 for 64-bit keys, 1 for bool.  Only a
//   column with nulls takes one more pass, on its null flag, more
//   significant than its data and less than every earlier key column.
//   Bound: bytes: per pass the key and the row id are read and written
//   once (the histogram reads the key again).
//
// BYTE and SHORT keys <- spark_rapids_tpu/kernels/sort.py:101
//                        _data_key_fixed over int8 and int16
//   Two more kinds, kInt8 and kInt16: the value with its sign bit flipped
//   on its own width, so a key takes 1 or 2 digit passes, not 4.
//   Bound: bytes: per pass the 1- or 2-byte key and the row id read and
//   written once.
//
// string_hash_key (K3) <- spark_rapids_tpu/kernels/sort.py:183
//                         _string_hash_key (over :160 _string_data_keys)
//   One thread per row folds the row's nchunks chunks into one uint64 by
//   FNV-1a (h = (h ^ chunk) * 1099511628211 from 14695981039346656037); a
//   chunk is 7 bytes in 9-bit lanes, byte + 1 and 0 past the end, the
//   first byte in the most significant lane, as the reference's.  A null
//   row writes 0.  nchunks comes from the column's longest valid row
//   (srt_string_max_length), the same for every row, so equal strings
//   hash equal.  The sort then takes the word as a kRawU64 key (8 passes)
//   in place of a string's chunk and length passes: the reference's
//   hash_string_keys option, for a caller that can take split groups.
//   Bound: bytes: the offsets, the row's bytes and its validity read, 8
//   bytes written per row; ~3 integer operations a byte (the lane, the
//   shift, the or) and 2 a chunk.
//
// string keys <- spark_rapids_tpu/kernels/sort.py:160 _string_data_keys
//   csrc/strings.cu writes each string's big-endian 8-byte chunks and its
//   length as ready unsigned keys (kinds kRawU64, kRawU32 here); a string
//   column is then the length (least significant, on only as many bytes as
//   the longest length needs), then the chunks from last to first, then
//   its null pass: UTF8String.binaryCompare order.
//
// Decimal128 keys <- spark_rapids_tpu/kernels/sort.py:123
//                    _decimal128_data_keys
//   Two more key kinds over a two-limb column (int64 [n, 2], low limb
//   first): kDec128Hi, the signed high limb with its sign bit flipped, and
//   kDec128Lo, the low limb as unsigned: int128 order, the high word most
//   significant.  Both are complemented for DESC and 0 on a null row, as
//   every key here.  A decimal column sorts as its low word's 8 passes,
//   then its high word's, then its null pass.
//   Bound: bytes: 16 bytes of limbs read and 16 of words written per row.
//
// order words <- spark_rapids_tpu/plan/execs/range_sort.py:43 _encode_fn
//   The range sort's per-row uint64 words, word-plane major: the null
//   word (1 sorts after 0, as null_key_kernel) and the key kernel's data
//   word of one plane, for every key kind above.  A string key is its
//   chunks and its length from csrc/strings.cu, each taken as kRawU64 /
//   kRawU32; a Decimal128 key its kDec128Hi and kDec128Lo words.
//   Bound: bytes: each key read once, 8 bytes a word written.
//
// range_partition <- spark_rapids_tpu/plan/execs/range_sort.py:96-113
//                    make_router.route
//   Each row's bucket is the number of sampled boundaries whose word row is
//   lexicographically <= the row's words (so equal keys never split), by a
//   binary search over the boundaries, which are sorted.  They are staged
//   in shared memory when they fit in 48 KB (255 boundaries of 24 words);
//   more boundaries or longer keys (a long string's chunks) read them
//   from global memory, through L1.  The words are plane major, so a
//   warp's loads of one word are coalesced; a row's first word is held in
//   a register and the others are read only on a tie.  The reorder and
//   the bucket counts are srt_partition's stable counting scatter over the
//   bucket ids (its block histograms give the counts).
//   Bound: bytes: nk words of 8 bytes read and 4 bytes of bucket id written
//   per row, then the partition pass's ids.  The compares, ~8 nk per row,
//   are far below the card's integer rate.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 16;
constexpr int kTile = kThreads * kChunks;  // 4096 rows a tile
constexpr int kMaxBits = 8;
constexpr int kMaxBuckets = 1 << kMaxBits;
constexpr int kMaxNullCols = 16;

// key kinds (kernels/sort.py _KIND)
constexpr int kInt32 = 0;   // int, date
constexpr int kInt64 = 1;   // long, Decimal64
constexpr int kF64 = 2;     // double
constexpr int kBool = 3;    // bool
constexpr int kRawU32 = 4;  // a ready order-preserving uint32 key
constexpr int kRawU64 = 5;  // a ready order-preserving uint64 key
constexpr int kDec128Hi = 6;  // a two-limb decimal's high limb, signed
constexpr int kDec128Lo = 7;  // its low limb, unsigned
constexpr int kInt8 = 8;    // byte
constexpr int kInt16 = 9;   // short
constexpr int kMaxStagedBoundaryBytes = 48 * 1024;

template <typename K>
__device__ __forceinline__ uint32_t digit_of(K key, int shift, uint32_t mask) {
  return static_cast<uint32_t>(key >> shift) & mask;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const K* __restrict__ keys, int64_t n, int shift,
                  uint32_t mask, int64_t ntiles, int32_t* __restrict__ hist) {
  __shared__ int counts[kMaxBuckets];
  const int nb = static_cast<int>(mask) + 1;
  for (int d = threadIdx.x; d < nb; d += kThreads) counts[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int c = 0; c < kChunks; ++c) {
    const int64_t i = tile0 + static_cast<int64_t>(c) * kThreads + threadIdx.x;
    const bool in = i < n;
    const uint32_t d = in ? digit_of(keys[i], shift, mask) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (in && lane == __ffs(peers) - 1) atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < nb; d += kThreads) {
    hist[static_cast<int64_t>(d) * ntiles + blockIdx.x] = counts[d];
  }
}

// Block d: exclusive scan, in place, of digit d's tile counts (row d of
// hist, tile-minor), and the digit's total into totals[d].
__global__ void __launch_bounds__(kThreads)
radix_scan_kernel(int32_t* __restrict__ hist, int64_t ntiles,
                  int32_t* __restrict__ totals) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int carry;
  int32_t* row = hist + static_cast<int64_t>(blockIdx.x) * ntiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t start = 0; start < ntiles; start += kThreads) {
    const int64_t i = start + threadIdx.x;
    const int v = i < ntiles ? row[i] : 0;
    int excl, total;
    Scan(tmp).ExclusiveSum(v, excl, total);
    if (i < ntiles) row[i] = carry + excl;
    __syncthreads();  // every thread has read carry and released tmp
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// ids_in == nullptr means the identity (row i has id i); keys_out may be
// nullptr when the next pass does not need the keys.
template <typename K>
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const K* __restrict__ keys_in,
                     const int32_t* __restrict__ ids_in, int64_t n, int shift,
                     uint32_t mask, int64_t ntiles,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ totals,
                     K* __restrict__ keys_out, int32_t* __restrict__ ids_out) {
  static_assert(kThreads >= kMaxBuckets, "one thread per digit");
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int base[kMaxBuckets];
  __shared__ int wcnt[kWarps][kMaxBuckets];
  const int nb = static_cast<int>(mask) + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  // the digit's first output row (a scan of the digit totals), plus the
  // rows of its digit in earlier tiles
  const int own = threadIdx.x;
  int first;
  Scan(tmp).ExclusiveSum(own < nb ? totals[own] : 0, first);
  if (own < nb) {
    base[own] = first + offsets[static_cast<int64_t>(own) * ntiles + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) wcnt[w][own] = 0;
  }
  __syncthreads();
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int c = 0; c < kChunks; ++c) {
    const int64_t chunk0 = tile0 + static_cast<int64_t>(c) * kThreads;
    if (chunk0 >= n) break;  // uniform across the block
    const int64_t i = chunk0 + threadIdx.x;
    const bool in = i < n;
    const K key = in ? keys_in[i] : K(0);
    const uint32_t d = in ? digit_of(key, shift, mask) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (in && lane == __ffs(peers) - 1) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    if (in) {
      int pos = base[d] + __popc(peers & lower);
      for (int w = 0; w < warp; ++w) pos += wcnt[w][d];
      if (keys_out != nullptr) keys_out[pos] = key;
      ids_out[pos] = ids_in != nullptr ? ids_in[i] : static_cast<int32_t>(i);
    }
    __syncthreads();  // every rank is taken before the counts move on
    for (int dd = threadIdx.x; dd < nb; dd += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        s += wcnt[w][dd];
        wcnt[w][dd] = 0;
      }
      base[dd] += s;
    }
    __syncthreads();
  }
}

template <typename K>
int radix_pass(const K* keys_in, K* keys_out, const int32_t* ids_in,
               int32_t* ids_out, int64_t n, int shift, int nbits,
               int32_t* hist, int32_t* totals, cudaStream_t stream) {
  if (nbits < 1 || nbits > kMaxBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const uint32_t mask = (1u << nbits) - 1u;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(ntiles);
  radix_hist_kernel<K><<<grid, kThreads, 0, stream>>>(keys_in, n, shift, mask,
                                                      ntiles, hist);
  radix_scan_kernel<<<mask + 1, kThreads, 0, stream>>>(hist, ntiles, totals);
  radix_scatter_kernel<K><<<grid, kThreads, 0, stream>>>(
      keys_in, ids_in, n, shift, mask, ntiles, hist, totals, keys_out,
      ids_out);
  return static_cast<int>(cudaGetLastError());
}

// The order-preserving unsigned key of row r of a key plane (ascending, the
// row taken as valid).
__device__ __forceinline__ uint64_t data_key(const void* data, int kind,
                                             int64_t r) {
  switch (kind) {
    case kInt32:
      return static_cast<uint32_t>(static_cast<const int32_t*>(data)[r]) ^
             0x80000000u;
    case kInt64:
      return static_cast<uint64_t>(static_cast<const int64_t*>(data)[r]) ^
             (1ull << 63);
    case kF64: {
      const uint64_t bits = static_cast<uint64_t>(
          __double_as_longlong(static_cast<const double*>(data)[r]));
      return (bits >> 63) ? ~bits : (bits | (1ull << 63));
    }
    case kRawU32:
      return static_cast<const uint32_t*>(data)[r];
    case kRawU64:
      return static_cast<const uint64_t*>(data)[r];
    case kDec128Hi:
      return static_cast<uint64_t>(static_cast<const int64_t*>(data)[2 * r + 1]) ^
             (1ull << 63);
    case kDec128Lo:
      return static_cast<uint64_t>(static_cast<const int64_t*>(data)[2 * r]);
    case kInt8:
      return static_cast<uint8_t>(static_cast<const int8_t*>(data)[r]) ^
             0x80u;
    case kInt16:
      return static_cast<uint16_t>(static_cast<const int16_t*>(data)[r]) ^
             0x8000u;
    default:
      return static_cast<const uint8_t*>(data)[r] != 0;
  }
}

// Order-preserving unsigned key of row ids[i] (or i), in the current order.
template <typename K>
__global__ void __launch_bounds__(kThreads)
sort_key_kernel(const void* __restrict__ data, const uint8_t* __restrict__ valid,
                int kind, int descending, const int32_t* __restrict__ ids,
                int64_t n, K* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = ids != nullptr ? ids[i] : i;
  K k = K(0);                    // a null row's data key is a constant
  if (valid[r] != 0) {
    k = static_cast<K>(data_key(data, kind, r));
    if (descending) k = static_cast<K>(~k);
  }
  out[i] = k;
}

// 1 sorts after 0: nulls first gives a null row 0, nulls last gives it 1.
__global__ void __launch_bounds__(kThreads)
null_key_kernel(const uint8_t* __restrict__ valid, int nulls_first,
                const int32_t* __restrict__ ids, int64_t n,
                uint8_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = ids != nullptr ? ids[i] : i;
  const uint8_t v = valid[r] != 0;
  out[i] = nulls_first ? v : static_cast<uint8_t>(1 - v);
}

__device__ __forceinline__ int64_t lower_bound_u32(const uint32_t* sorted,
                                                  int64_t n, uint32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (sorted[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// counts[q] = the rows of partition q in the sorted partition ids
__global__ void __launch_bounds__(kThreads)
partition_counts_kernel(const uint32_t* __restrict__ sorted, int64_t n,
                        int num_partitions, int32_t* __restrict__ counts) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= num_partitions) return;
  const uint32_t p = static_cast<uint32_t>(q);
  counts[q] = static_cast<int32_t>(lower_bound_u32(sorted, n, p + 1) -
                                   lower_bound_u32(sorted, n, p));
}

struct NullCols {
  const uint8_t* valid[kMaxNullCols];
};

// grid (tiles, ncols): counts[c] += nulls of column c in the tile
__global__ void __launch_bounds__(kThreads)
null_count_kernel(NullCols cols, int64_t n,
                  unsigned long long* __restrict__ counts) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const uint8_t* valid = cols.valid[blockIdx.y];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  int c = 0;
  for (int k = 0; k < kChunks; ++k) {
    const int64_t i = tile0 + static_cast<int64_t>(k) * kThreads + threadIdx.x;
    if (i < n) c += valid[i] == 0;
  }
  const int total = Reduce(tmp).Sum(c);
  if (threadIdx.x == 0 && total > 0) {
    atomicAdd(&counts[blockIdx.y], static_cast<unsigned long long>(total));
  }
}

unsigned grid_rows(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// R1: the integers in [0, x) whose residue mod nparts is below rem, for
// 0 <= x < 2 * nparts (so no division)
__device__ __forceinline__ int64_t rr_below(int64_t x, int64_t nparts,
                                           int64_t rem) {
  return x >= nparts ? rem + min(x - nparts, rem) : min(x, rem);
}

// R1: the first output row of partition p (see the comment at the top)
__device__ __forceinline__ int64_t rr_start_of(int64_t p, int64_t nparts,
                                              int64_t q, int64_t rem,
                                              int64_t s) {
  return p * q + rr_below(s + p, nparts, rem) - min(s, rem);
}

__global__ void __launch_bounds__(kThreads)
round_robin_order_kernel(int64_t n, int nparts, int64_t s, int64_t q,
                         int64_t rem, int32_t* __restrict__ order) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  int lo = 0, hi = nparts - 1;   // the last partition starting at or before j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rr_start_of(mid, nparts, q, rem, s) <= j) lo = mid; else hi = mid - 1;
  }
  const int64_t r0 = lo + s >= nparts ? lo + s - nparts : lo + s;
  order[j] = static_cast<int32_t>(
      r0 + (j - rr_start_of(lo, nparts, q, rem, s)) * nparts);
}

// The data passes of one key column (its low key_bytes bytes; 0: all), then
// its null pass; the row ids end in ids_out.  The passes alternate between
// ids_out and ids_tmp so that the last one writes ids_out; ids_in
// (nullptr: the identity) aliases neither.
template <typename K>
int sort_column(int kind, const void* data, const uint8_t* valid,
                int descending, int nulls_first, int has_nulls,
                int key_bytes, const int32_t* ids_in, int64_t n, void* key_a,
                void* key_b, int32_t* ids_out, int32_t* ids_tmp, int32_t* hist,
                int32_t* totals, cudaStream_t stream) {
  const int data_passes = key_bytes > 0 && key_bytes < static_cast<int>(sizeof(K))
                              ? key_bytes : static_cast<int>(sizeof(K));
  const int passes = data_passes + (has_nulls ? 1 : 0);
  K* ka = static_cast<K*>(key_a);
  K* kb = static_cast<K*>(key_b);
  sort_key_kernel<K><<<grid_rows(n), kThreads, 0, stream>>>(
      data, valid, kind, descending, ids_in, n, ka);
  int err = static_cast<int>(cudaGetLastError());
  const int32_t* src = ids_in;
  int32_t* dst = (passes % 2 == 1) ? ids_out : ids_tmp;
  for (int p = 0; p < data_passes && err == 0; ++p) {
    const bool last_data = p == data_passes - 1;
    err = radix_pass<K>(ka, last_data ? nullptr : kb, src, dst, n, 8 * p, 8,
                        hist, totals, stream);
    K* t = ka; ka = kb; kb = t;
    src = dst;
    dst = (dst == ids_out) ? ids_tmp : ids_out;
  }
  if (has_nulls && err == 0) {
    uint8_t* nk = static_cast<uint8_t*>(key_a);  // the data keys are dead
    null_key_kernel<<<grid_rows(n), kThreads, 0, stream>>>(valid, nulls_first,
                                                           src, n, nk);
    err = static_cast<int>(cudaGetLastError());
    if (err == 0) {
      err = radix_pass<uint8_t>(nk, nullptr, src, dst, n, 0, 1, hist, totals,
                                stream);
    }
  }
  return err;
}

// One row's null word (if null_out) and data word of one key plane.
__global__ void __launch_bounds__(kThreads)
order_word_kernel(const void* __restrict__ data,
                  const uint8_t* __restrict__ valid, int kind, int descending,
                  int nulls_first, int64_t n, uint64_t* __restrict__ null_out,
                  uint64_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const bool v = valid[r] != 0;
  if (null_out != nullptr) null_out[r] = nulls_first ? v : !v;
  uint64_t k = 0;
  if (v) {
    k = data_key(data, kind, r);
    if (descending) k = ~k;
  }
  out[r] = k;
}

// K3: one FNV-1a word per row over nchunks 9-bit-lane chunks of 7 bytes.
__global__ void __launch_bounds__(kThreads)
string_hash_key_kernel(const int32_t* __restrict__ offsets,
                       const uint8_t* __restrict__ bytes,
                       const uint8_t* __restrict__ valid, int64_t n,
                       int nchunks, uint64_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  if (valid[r] == 0) {
    out[r] = 0ull;
    return;
  }
  const int32_t b = offsets[r];
  const int32_t len = offsets[r + 1] - b;
  const uint8_t* p = bytes + b;
  uint64_t h = 14695981039346656037ull;
  for (int c = 0; c < nchunks; ++c) {
    // only the row's own bytes are read: the loop runs over the bytes the
    // chunk holds (csrc/strings.cuh), then the empty lanes shift in
    const int32_t c0 = 7 * c;
    const int32_t left = len - c0;
    const int m = left <= 0 ? 0 : (left < 7 ? static_cast<int>(left) : 7);
    uint64_t chunk = 0;
    for (int j = 0; j < m; ++j) {
      chunk = (chunk << 9) | (static_cast<uint64_t>(p[c0 + j]) + 1ull);
    }
    chunk <<= 9 * (7 - m);
    h = (h ^ chunk) * 1099511628211ull;
  }
  out[r] = h;
}

// dest[r] = the boundaries (nb rows of nk words, sorted) whose words are
// lexicographically <= row r's words[j * n + r]; kStaged: the boundaries
// are first copied into dynamic shared memory.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
range_route_kernel(const uint64_t* __restrict__ words, int64_t n, int nk,
                   const uint64_t* __restrict__ bounds, int nb,
                   int32_t* __restrict__ dest) {
  extern __shared__ uint64_t staged[];
  const uint64_t* sb = bounds;
  if (kStaged) {
    const int64_t total = static_cast<int64_t>(nb) * nk;
    for (int64_t i = threadIdx.x; i < total; i += kThreads) {
      staged[i] = bounds[i];
    }
    __syncthreads();
    sb = staged;
  }
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const uint64_t k0 = words[r];
  int lo = 0, hi = nb;             // the first boundary above the key
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint64_t* b = sb + static_cast<int64_t>(mid) * nk;
    bool at_or_below = b[0] < k0;  // the boundary <= the key
    if (b[0] == k0) {
      int j = 1;
      uint64_t kj = 0;
      for (; j < nk; ++j) {
        kj = words[static_cast<int64_t>(j) * n + r];
        if (b[j] != kj) break;
      }
      at_or_below = j == nk || b[j] < kj;
    }
    if (at_or_below) lo = mid + 1; else hi = mid;
  }
  dest[r] = lo;
}

}  // namespace

extern "C" {

// out[n] (uint64) receives one key plane's words (the kinds above;
// DESC complemented, 0 on a null row) and, if null_out is not null, the
// null words (nulls_first: a valid row 1, a null row 0; else reversed).
int srt_order_words(int kind, const void* data, const uint8_t* valid,
                    int descending, int nulls_first, int64_t n,
                    uint64_t* null_out, uint64_t* out, cudaStream_t stream) {
  if (kind < kInt32 || kind > kInt16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    order_word_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        data, valid, kind, descending, nulls_first, n, null_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// dest[n] (int32): each row's range bucket in [0, nb] against nb sorted
// boundary rows bounds[nb * nk] (row major) over the rows' words[nk * n]
// (plane major).
int srt_range_route(const uint64_t* words, int64_t n, int nk,
                    const uint64_t* bounds, int nb, int32_t* dest,
                    cudaStream_t stream) {
  if (nk < 1 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t staged = static_cast<int64_t>(nb) * nk * sizeof(uint64_t);
  if (n > 0 && staged <= kMaxStagedBoundaryBytes) {
    range_route_kernel<true><<<grid_rows(n), kThreads, staged, stream>>>(
        words, n, nk, bounds, nb, dest);
  } else if (n > 0) {
    range_route_kernel<false><<<grid_rows(n), kThreads, 0, stream>>>(
        words, n, nk, bounds, nb, dest);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_sort_tile() { return kTile; }

// out[n] (uint64): K3, each string row's hash key over nchunks (>= 1)
// chunks of 7 bytes, 0 on a null row.
int srt_string_hash_key(const int32_t* offsets, const uint8_t* bytes,
                        const uint8_t* valid, int64_t n, int nchunks,
                        uint64_t* out, cudaStream_t stream) {
  if (nchunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    string_hash_key_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        offsets, bytes, valid, n, nchunks, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_max_radix_bits() { return kMaxBits; }

// R1: order[n] (int32), the stable order of n rows by round-robin
// partition (i + start) % num_partitions; 0 <= start < num_partitions.
int srt_round_robin_order(int64_t n, int num_partitions, int start,
                          int32_t* order, cudaStream_t stream) {
  if (num_partitions < 1 || start < 0 || start >= num_partitions ||
      n >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int64_t s = (num_partitions - start) % num_partitions;
    round_robin_order_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        n, num_partitions, s, n / num_partitions, n % num_partitions, order);
  }
  return static_cast<int>(cudaGetLastError());
}

// The stable order of n rows by their partition ids part[n], in
// [0, num_partitions), and counts[num_partitions], the rows of each
// partition.  hist holds 256 * ntiles int32, ntiles = ceil(n /
// srt_sort_tile()), and totals 256.  More than 256 partitions take more
// than one pass: key_a and key_b then hold n uint32 and ids_tmp n int32
// (with one pass they may be null).
int srt_partition(const int32_t* part, int64_t n, int num_partitions,
                  int32_t* order, int32_t* counts, uint32_t* key_a,
                  uint32_t* key_b, int32_t* ids_tmp, int32_t* hist,
                  int32_t* totals, cudaStream_t stream) {
  if (num_partitions < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) {
    return static_cast<int>(cudaMemsetAsync(
        counts, 0, sizeof(int32_t) * num_partitions, stream));
  }
  int nbits = 1;
  while (nbits < 31 && (1ll << nbits) < num_partitions) ++nbits;
  const uint32_t* keys = reinterpret_cast<const uint32_t*>(part);
  if (nbits <= kMaxBits) {
    int err = radix_pass<uint32_t>(keys, nullptr, nullptr, order, n, 0, nbits,
                                   hist, totals, stream);
    if (err != 0) return err;
    return static_cast<int>(cudaMemcpyAsync(
        counts, totals, sizeof(int32_t) * num_partitions,
        cudaMemcpyDeviceToDevice, stream));
  }
  if (key_a == nullptr || key_b == nullptr || ids_tmp == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (nbits + kMaxBits - 1) / kMaxBits;
  const int32_t* src = nullptr;  // the identity
  int32_t* dst = (passes % 2 == 1) ? order : ids_tmp;
  uint32_t* kout = key_a;
  int err = 0;
  for (int p = 0; p < passes && err == 0; ++p) {
    const int bits = nbits - kMaxBits * p < kMaxBits ? nbits - kMaxBits * p
                                                     : kMaxBits;
    err = radix_pass<uint32_t>(keys, kout, src, dst, n, kMaxBits * p, bits,
                               hist, totals, stream);
    keys = kout;
    kout = (kout == key_a) ? key_b : key_a;
    src = dst;
    dst = (dst == order) ? ids_tmp : order;
  }
  if (err != 0) return err;
  partition_counts_kernel<<<grid_rows(num_partitions), kThreads, 0, stream>>>(
      keys, n, num_partitions, counts);
  return static_cast<int>(cudaGetLastError());
}

// counts[ncols] (uint64) receives the null count of each validity plane.
int srt_null_counts(int ncols, const uint8_t* const* valid, int64_t n,
                    unsigned long long* counts, cudaStream_t stream) {
  if (ncols < 1 || ncols > kMaxNullCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NullCols cols{};
  for (int c = 0; c < ncols; ++c) cols.valid[c] = valid[c];
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(unsigned long long) * ncols,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
              static_cast<unsigned>(ncols));
    null_count_kernel<<<grid, kThreads, 0, stream>>>(cols, n, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// One key column of an LSD argsort (see sort_column).  key_a and key_b hold
// n keys of the column's width; hist and totals are sized for 8-bit passes.
// key_bytes (0: the key's width) bounds the data passes to the low bytes:
// the caller knows the high bytes are equal in every valid row.
int srt_sort_column(int kind, const void* data, const uint8_t* valid,
                    int descending, int nulls_first, int has_nulls,
                    int key_bytes, const int32_t* ids_in, int64_t n,
                    void* key_a, void* key_b, int32_t* ids_out,
                    int32_t* ids_tmp, int32_t* hist, int32_t* totals,
                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (kind) {
    case kInt32:
    case kRawU32:
      return sort_column<uint32_t>(kind, data, valid, descending, nulls_first,
                                   has_nulls, key_bytes, ids_in, n, key_a,
                                   key_b, ids_out, ids_tmp, hist, totals,
                                   stream);
    case kInt64:
    case kF64:
    case kRawU64:
    case kDec128Hi:
    case kDec128Lo:
      return sort_column<uint64_t>(kind, data, valid, descending, nulls_first,
                                   has_nulls, key_bytes, ids_in, n, key_a,
                                   key_b, ids_out, ids_tmp, hist, totals,
                                   stream);
    case kBool:
    case kInt8:
      return sort_column<uint8_t>(kind, data, valid, descending, nulls_first,
                                  has_nulls, key_bytes, ids_in, n, key_a,
                                  key_b, ids_out, ids_tmp, hist, totals,
                                  stream);
    case kInt16:
      return sort_column<uint16_t>(kind, data, valid, descending, nulls_first,
                                   has_nulls, key_bytes, ids_in, n, key_a,
                                   key_b, ids_out, ids_tmp, hist, totals,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
