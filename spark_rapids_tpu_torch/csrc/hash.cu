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
//   running seed through.  All arithmetic is uint32_t.  BYTE and SHORT
//   (kinds kInt8, kInt16) take hashInt of the value sign-extended to int,
//   as Spark and the reference's hash_fixed_width :99 do.
//
// string columns <- spark_rapids_tpu/kernels/hash.py:187 hash_string
//   One more column kind in the same chain: Spark's hashUnsafeBytes over
//   the row's bytes data[offsets[r]:offsets[r + 1]] (the offsets need not
//   start at 0): each 4-byte little-endian word is mixed, then each tail
//   byte as a sign-extended int, then fmix with the byte length.  The row
//   reads its bytes itself, one at a time (the strings of the q3 path are
//   8-9 bytes), so no byte tile is built: the reference pads every row to
//   a power-of-two bucket of bytes because XLA needs static shapes.
//   Bound: bytes: 8 bytes of offsets and each string byte read once.
//
// Decimal128 columns <- spark_rapids_tpu/kernels/hash.py:141
//                       _hash_decimal128_bytes
//   One more kind: Spark hashes a decimal of precision above 18 as
//   hashUnsafeBytes of BigInteger.toByteArray(), the minimal big-endian
//   two's-complement bytes of the unscaled value.  The row builds the 16
//   big-endian bytes of (high limb, low limb) in registers, strips the
//   leading bytes that equal the sign fill while the next byte's top bit
//   still equals the sign (at least one byte stays), mixes the aligned
//   4-byte little-endian words, then each tail byte sign-extended, and
//   takes fmix with the length.
//   Bound: bytes: 16 bytes of limbs and a validity byte read, 4 bytes of
//   hash written per row; ~60 integer operations per row.
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
constexpr int kString = 4;  // string: hashUnsafeBytes of the row's bytes
constexpr int kDec128 = 5;  // two-limb decimal: hashUnsafeBytes of its
                            // minimal big-endian bytes
constexpr int kInt8 = 6;    // byte: hashInt of the value sign-extended
constexpr int kInt16 = 7;   // short: hashInt of the value sign-extended

struct HashCols {
  const void* data[kMaxHashCols];
  const uint8_t* valid[kMaxHashCols];
  const int32_t* offsets[kMaxHashCols];   // strings only
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

// Spark Murmur3_x86_32.hashUnsafeBytes
__device__ __forceinline__ uint32_t hash_bytes(const uint8_t* p, int32_t len,
                                               uint32_t seed) {
  uint32_t h1 = seed;
  const int32_t aligned = len & ~3;
  for (int32_t i = 0; i < aligned; i += 4) {
    const uint32_t w = static_cast<uint32_t>(p[i]) |
                       (static_cast<uint32_t>(p[i + 1]) << 8) |
                       (static_cast<uint32_t>(p[i + 2]) << 16) |
                       (static_cast<uint32_t>(p[i + 3]) << 24);
    h1 = mix_h1(h1, w);
  }
  for (int32_t i = aligned; i < len; ++i) {
    const int32_t sb = static_cast<int8_t>(p[i]);   // sign-extended byte
    h1 = mix_h1(h1, static_cast<uint32_t>(sb));
  }
  return fmix(h1, static_cast<uint32_t>(len));
}

// Spark's hash of a two-limb decimal (lo, hi): BigInteger.toByteArray()
__device__ __forceinline__ uint32_t hash_decimal128(int64_t lo, int64_t hi,
                                                    uint32_t seed) {
  uint8_t be[16];
  for (int j = 0; j < 8; ++j) {
    be[j] = static_cast<uint8_t>(static_cast<uint64_t>(hi) >> (8 * (7 - j)));
    be[8 + j] =
        static_cast<uint8_t>(static_cast<uint64_t>(lo) >> (8 * (7 - j)));
  }
  const bool neg = hi < 0;
  const uint8_t fill = neg ? 0xFF : 0x00;
  int strip = 0;
  while (strip < 15 && be[strip] == fill &&
         ((be[strip + 1] & 0x80) != 0) == neg) {
    ++strip;
  }
  return hash_bytes(be + strip, 16 - strip, seed);
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
      case kInt8:
        h = hash_int(static_cast<uint32_t>(static_cast<int32_t>(
                         static_cast<const int8_t*>(cols.data[c])[r])), h);
        break;
      case kInt16:
        h = hash_int(static_cast<uint32_t>(static_cast<int32_t>(
                         static_cast<const int16_t*>(cols.data[c])[r])), h);
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
      case kDec128: {
        const int64_t* limbs = static_cast<const int64_t*>(cols.data[c]);
        h = hash_decimal128(limbs[2 * r], limbs[2 * r + 1], h);
        break;
      }
      case kString: {
        const int32_t b = cols.offsets[c][r];
        h = hash_bytes(static_cast<const uint8_t*>(cols.data[c]) + b,
                       cols.offsets[c][r + 1] - b, h);
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
// pointers, offsets pointers (null for a fixed-width column) and kinds.
// part may be null (no pmod); else num_partitions > 0.
int srt_murmur3(int ncols, const void* const* data,
                const uint8_t* const* valid, const int32_t* const* offsets,
                const int* kinds, int64_t n, uint32_t seed, int32_t* hashes,
                int32_t num_partitions, int32_t* part, cudaStream_t stream) {
  if (ncols < 1 || ncols > kMaxHashCols ||
      (part != nullptr && num_partitions < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HashCols cols{};
  for (int c = 0; c < ncols; ++c) {
    cols.data[c] = data[c];
    cols.valid[c] = valid[c];
    cols.offsets[c] = offsets[c];
    cols.kind[c] = kinds[c];
    if (kinds[c] == kString && offsets[c] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n > 0) {
    murmur3_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(cols, ncols, n, seed, hashes,
                                            num_partitions, part);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
