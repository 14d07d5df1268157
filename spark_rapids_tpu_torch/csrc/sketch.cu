// The sketch kernels of the port: the runtime bloom filter's build and
// probe, and HyperLogLog++'s register update and merge.  Built for sm_90a
// by kernels/_lib.py and called through ctypes from kernels/bloom.py and
// kernels/hll.py.  Every entry point launches on the caller's stream,
// allocates nothing (the wrapper passes scratch), and returns the
// cudaError_t of its launches.  The hashes are csrc/hash.cuh's, the same
// code as csrc/hash.cu's row hashes.
//
// B1 bloom_put   <- spark_rapids_tpu/kernels/bloom.py:71 build_bits (with
//                   _bit_positions :56)
//   Spark's BloomFilterImpl.putLong: h1 = murmur3(v, 0), h2 = murmur3(v,
//   h1); for i in 1..k, combined = h1 + i * h2 in int32 (the wrap done in
//   uint32, then reinterpreted: signed overflow is undefined in C++), ~ if
//   negative, % numBits; each bit set.  One thread per LONG row; a null
//   row sets nothing.  The bits live as Spark's BitArray, packed uint64
//   words (bit b in word b / 64 at b % 64), set with atomicOr, so that
//   later batches OR into the same words; the reference's bool[numBits]
//   is unpacked on the host once, when build_bloom returns.
//   Bound: bytes: 8 bytes of value and a validity byte read per row (the
//   words, 912,312 bytes at 7,298,496 bits, stay in the 50 MB L2); k
//   atomics a row, ~30 integer operations a hash.
//
// B2 bloom_probe <- spark_rapids_tpu/kernels/bloom.py:87 might_contain,
//                   spark_rapids_tpu/expressions/hashing.py:104
//                   BloomFilterMightContain
//   One thread per row: the same k positions, k word loads (L2-resident),
//   then an AND.  The result is false on a null row (its validity, the
//   input's, is the caller's).
//   Bound: bytes: 9 bytes read and 1 written per row.
//
// L1 hll_update  <- spark_rapids_tpu/kernels/hll.py:28 row_idx_rho, :96
//                   global_update, :106 seg_update
//   Per valid row: h = xxhash64(v, 42) (Spark's XXH64.hashLong), register
//   index h >> (64 - p), rho = min(clz(h << p) + 1, 64 - p + 1) (__clzll;
//   clz of 0 is 64); each register keeps its max, an empty register 0.
//   Global: blocks stride over the rows with the m registers as int32 in
//   shared memory (atomicMax), then atomicMax into m int32 registers in
//   global memory, narrowed to int8 by a last small launch.  Grouped: the
//   rows are already sorted into segments (kernels/groupby.py
//   group_rows), so a block per segment keeps that segment's registers in
//   shared memory and writes them once, as int8, to out[seg * m + idx]:
//   no global atomics and no int32 plane of groups * m registers.
//   Bound: bytes: 8 bytes of value and a validity byte read per row, m
//   bytes written per group; ~25 integer operations for the hash.  A
//   segment is one block's work, so a skewed group is a long block.
//
// L2 hll_merge   <- spark_rapids_tpu/kernels/hll.py:119 merge_rows,
//                   spark_rapids_tpu/plan/execs/aggregate.py:591-598 and
//                   :663-675
//   The elementwise max of a segment's register rows ([rows, m] int8),
//   a null row read as 0.  A block per segment, its threads across the m
//   registers, so that the byte reads of a row coalesce; the global merge
//   is one segment.
//   Bound: bytes: each register row and its validity byte read once, m
//   bytes written per segment.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGlobalBlocks = 132 * 2;   // few blocks: fewer global atomics
// registers a block holds in shared memory as int32 (48 KB, no opt-in)
constexpr int kMaxSharedRegisters = 12 * 1024;

// Spark's combined-hash walk: the i-th bit (1 <= i <= k) of a LONG value
__device__ __forceinline__ int64_t bloom_bit(uint32_t h1, uint32_t h2, int i,
                                             int64_t num_bits) {
  int32_t combined = static_cast<int32_t>(h1 + static_cast<uint32_t>(i) * h2);
  if (combined < 0) combined = ~combined;
  return static_cast<int64_t>(combined) % num_bits;
}

__global__ void __launch_bounds__(kThreads)
bloom_put_kernel(const int64_t* __restrict__ values,
                 const uint8_t* __restrict__ valid, int64_t n,
                 int64_t num_bits, int k,
                 unsigned long long* __restrict__ words) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n || valid[r] == 0) return;
  const uint64_t v = static_cast<uint64_t>(values[r]);
  const uint32_t h1 = hash_long(v, 0u);
  const uint32_t h2 = hash_long(v, h1);
  for (int i = 1; i <= k; ++i) {
    const int64_t b = bloom_bit(h1, h2, i, num_bits);
    atomicOr(words + (b >> 6), 1ull << (b & 63));
  }
}

__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const int64_t* __restrict__ values,
                   const uint8_t* __restrict__ valid, int64_t n,
                   int64_t num_bits, int k,
                   const unsigned long long* __restrict__ words,
                   uint8_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const uint64_t v = static_cast<uint64_t>(values[r]);
  const uint32_t h1 = hash_long(v, 0u);
  const uint32_t h2 = hash_long(v, h1);
  bool hit = valid[r] != 0;
  for (int i = 1; i <= k; ++i) {
    const int64_t b = bloom_bit(h1, h2, i, num_bits);
    hit &= ((words[b >> 6] >> (b & 63)) & 1ull) != 0;
  }
  out[r] = hit;
}

// (register index, rho) of a LONG value, Spark's HLL++ with seed 42
__device__ __forceinline__ void hll_slot(int64_t value, int p, int* idx,
                                         int* rho) {
  const uint64_t h = xx_hash_long(static_cast<uint64_t>(value), 42ull);
  *idx = static_cast<int>(h >> (64 - p));
  const uint64_t rest = h << p;
  const int nz = rest == 0 ? 64 : __clzll(static_cast<long long>(rest));
  *rho = min(nz + 1, 64 - p + 1);
}

__global__ void __launch_bounds__(kThreads)
hll_global_kernel(const int64_t* __restrict__ values,
                  const uint8_t* __restrict__ valid, int64_t n, int p,
                  int* __restrict__ regs) {
  extern __shared__ int s[];
  const int m = 1 << p;
  for (int j = threadIdx.x; j < m; j += kThreads) s[j] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    if (valid[r] == 0) continue;
    int idx, rho;
    hll_slot(values[r], p, &idx, &rho);
    if (s[idx] < rho) atomicMax(s + idx, rho);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
    if (s[j] > 0) atomicMax(regs + j, s[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
narrow_kernel(const int* __restrict__ regs, int m, int8_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < m) out[j] = static_cast<int8_t>(regs[j]);
}

// grid: one block per segment; segment g is rows [starts[g], starts[g + 1])
// (the last one ends at n)
__device__ __forceinline__ void segment_rows(const int32_t* starts,
                                             int64_t groups, int64_t n,
                                             int64_t* lo, int64_t* hi) {
  const int64_t g = blockIdx.x;
  *lo = starts[g];
  *hi = g + 1 < groups ? starts[g + 1] : n;
}

__global__ void __launch_bounds__(kThreads)
hll_grouped_kernel(const int64_t* __restrict__ values,
                   const uint8_t* __restrict__ valid, int64_t n,
                   const int32_t* __restrict__ starts, int64_t groups, int p,
                   int8_t* __restrict__ out) {
  extern __shared__ int s[];
  const int m = 1 << p;
  for (int j = threadIdx.x; j < m; j += kThreads) s[j] = 0;
  __syncthreads();
  int64_t lo, hi;
  segment_rows(starts, groups, n, &lo, &hi);
  for (int64_t r = lo + threadIdx.x; r < hi; r += kThreads) {
    if (valid[r] == 0) continue;
    int idx, rho;
    hll_slot(values[r], p, &idx, &rho);
    if (s[idx] < rho) atomicMax(s + idx, rho);
  }
  __syncthreads();
  int8_t* dst = out + static_cast<int64_t>(blockIdx.x) * m;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    dst[j] = static_cast<int8_t>(s[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
hll_merge_kernel(const int8_t* __restrict__ regs,
                 const uint8_t* __restrict__ valid, int64_t rows,
                 const int32_t* __restrict__ starts, int64_t groups, int m,
                 int8_t* __restrict__ out) {
  int64_t lo, hi;
  segment_rows(starts, groups, rows, &lo, &hi);
  int8_t* dst = out + static_cast<int64_t>(blockIdx.x) * m;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    int8_t v = 0;   // registers are >= 0: a null row reads as 0
    for (int64_t r = lo; r < hi; ++r) {
      const int8_t x = regs[r * m + j];
      if (valid[r] != 0 && x > v) v = x;
    }
    dst[j] = v;
  }
}

bool hll_p_ok(int p) {
  return p >= 4 && p <= 30 && (1 << p) <= kMaxSharedRegisters;
}

}  // namespace

extern "C" {

// B1: OR the k bits of each valid row of values[n] into words[num_bits /
// 64] (num_bits a positive multiple of 64; k >= 1).
int srt_bloom_put(const int64_t* values, const uint8_t* valid, int64_t n,
                  int64_t num_bits, int k, unsigned long long* words,
                  cudaStream_t stream) {
  if (num_bits < 64 || num_bits % 64 != 0 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    bloom_put_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(values, valid, n, num_bits, k,
                                              words);
  }
  return static_cast<int>(cudaGetLastError());
}

// B2: out[n] (bool) = the row is valid and all k of its bits are set.
int srt_bloom_probe(const int64_t* values, const uint8_t* valid, int64_t n,
                    int64_t num_bits, int k, const unsigned long long* words,
                    uint8_t* out, cudaStream_t stream) {
  if (num_bits < 64 || num_bits % 64 != 0 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    bloom_probe_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(values, valid, n, num_bits, k,
                                                words, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int srt_hll_max_registers() { return kMaxSharedRegisters; }

// L1, global: out[m] (int8, m = 2^p) the registers of every valid row of
// values[n]; regs[m] int32 scratch.
int srt_hll_global(const int64_t* values, const uint8_t* valid, int64_t n,
                   int p, int* regs, int8_t* out, cudaStream_t stream) {
  if (!hll_p_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  const int m = 1 << p;
  cudaError_t err = cudaMemsetAsync(regs, 0, sizeof(int) * m, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int64_t need = (n + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(
        need < kMaxGlobalBlocks ? need : kMaxGlobalBlocks);
    hll_global_kernel<<<blocks, kThreads, sizeof(int) * m, stream>>>(
        values, valid, n, p, regs);
  }
  narrow_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      regs, m, out);
  return static_cast<int>(cudaGetLastError());
}

// L1, grouped: out[groups * m] (int8) the registers of each segment of
// values[n]; starts[groups] the first row of each segment, ascending,
// starts[0] = 0.
int srt_hll_grouped(const int64_t* values, const uint8_t* valid, int64_t n,
                    const int32_t* starts, int64_t groups, int p, int8_t* out,
                    cudaStream_t stream) {
  if (!hll_p_ok(p) || groups < 0 || groups > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups > 0) {
    hll_grouped_kernel<<<static_cast<unsigned>(groups), kThreads,
                         sizeof(int) << p, stream>>>(values, valid, n, starts,
                                                     groups, p, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// L2: out[groups * m] (int8) the elementwise max of each segment's valid
// rows of regs[rows * m]; starts as srt_hll_grouped's.
int srt_hll_merge(const int8_t* regs, const uint8_t* valid, int64_t rows,
                  const int32_t* starts, int64_t groups, int m, int8_t* out,
                  cudaStream_t stream) {
  if (m < 1 || groups < 0 || groups > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups > 0) {
    hll_merge_kernel<<<static_cast<unsigned>(groups), kThreads, 0, stream>>>(
        regs, valid, rows, starts, groups, m, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
