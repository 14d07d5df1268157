// Spark-exact Murmur3_x86_32 row hash of the port, with the partition id
// (pmod) fused as an optional second output.  Built for sm_90a by
// kernels/_lib.py and called through ctypes from kernels/hash.py.  The entry
// point launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of its launch.
//
// murmur3     <- spark_rapids_tpu/kernels/hash.py:99 hash_fixed_width,
//                :237 murmur3_hash, :258 pmod
//   Bound: bytes.  Per row it reads each key column once (4 or 8 bytes plus
//   a validity byte) and writes 4 bytes of hash and, with pmod, 4 more; the
//   ~20 integer operations per 4-byte block are far below the card's
//   integer rate.  Design: one thread per row, all key columns (up to
//   kMaxHashCols, passed by value in a parameter struct like the gather's)
//   chained left to right in registers, so the running hash never goes to
//   memory between columns.  Spark's rules: int/date/bool take hashInt;
//   long and Decimal64 (its unscaled long) take hashLong, low word then
//   high word, length 8; doubles turn -0.0 into 0.0 and every NaN into
//   0x7FF8000000000000 before taking their bits; a null row passes the
//   running seed through.  All arithmetic is uint32_t.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHashCols = 16;
constexpr int kThreads = 256;

// column kinds (kernels/hash.py _KIND)
constexpr int kInt32 = 0;   // int, date: hashInt of the value
constexpr int kInt64 = 1;   // long, Decimal64: hashLong
constexpr int kF64 = 2;     // double: hashLong of the normalized bits
constexpr int kBool = 3;    // bool (one byte): hashInt of 0 or 1

struct HashCols {
  const void* data[kMaxHashCols];
  const uint8_t* valid[kMaxHashCols];
  int kind[kMaxHashCols];
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  h1 ^= h1 >> 16;
  return h1;
}

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t seed) {
  return fmix(mix_h1(seed, v), 4u);
}

__device__ __forceinline__ uint32_t hash_long(uint64_t v, uint32_t seed) {
  uint32_t h1 = mix_h1(seed, static_cast<uint32_t>(v));
  h1 = mix_h1(h1, static_cast<uint32_t>(v >> 32));
  return fmix(h1, 8u);
}

__global__ void __launch_bounds__(kThreads)
murmur3_kernel(HashCols cols, int ncols, int64_t n, uint32_t seed,
               int32_t* __restrict__ hashes, int32_t num_partitions,
               int32_t* __restrict__ part) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  uint32_t h = seed;
  for (int c = 0; c < ncols; ++c) {
    if (cols.valid[c][r] == 0) continue;  // null: the seed passes through
    switch (cols.kind[c]) {
      case kInt32:
        h = hash_int(static_cast<const uint32_t*>(cols.data[c])[r], h);
        break;
      case kInt64:
        h = hash_long(static_cast<const uint64_t*>(cols.data[c])[r], h);
        break;
      case kF64: {
        double d = static_cast<const double*>(cols.data[c])[r];
        uint64_t bits;
        if (d != d) {
          bits = 0x7FF8000000000000ull;      // canonical NaN
        } else {
          if (d == 0.0) d = 0.0;             // -0.0 -> 0.0
          bits = static_cast<uint64_t>(__double_as_longlong(d));
        }
        h = hash_long(bits, h);
        break;
      }
      default:
        h = hash_int(static_cast<const uint8_t*>(cols.data[c])[r] != 0, h);
        break;
    }
  }
  const int32_t hi = static_cast<int32_t>(h);
  hashes[r] = hi;
  if (part != nullptr) {
    const int32_t m = hi % num_partitions;   // C++: sign of the dividend
    part[r] = m < 0 ? m + num_partitions : m;
  }
}

}  // namespace

extern "C" {

int srt_max_hash_cols() { return kMaxHashCols; }

// Host arrays of ncols (1..kMaxHashCols) column data pointers, validity
// pointers and kinds.  part may be null (no pmod); else num_partitions > 0.
int srt_murmur3(int ncols, const void* const* data,
                const uint8_t* const* valid, const int* kinds, int64_t n,
                uint32_t seed, int32_t* hashes, int32_t num_partitions,
                int32_t* part, cudaStream_t stream) {
  if (ncols < 1 || ncols > kMaxHashCols ||
      (part != nullptr && num_partitions < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HashCols cols{};
  for (int c = 0; c < ncols; ++c) {
    cols.data[c] = data[c];
    cols.valid[c] = valid[c];
    cols.kind[c] = kinds[c];
  }
  if (n > 0) {
    murmur3_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(cols, ncols, n, seed, hashes,
                                            num_partitions, part);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
