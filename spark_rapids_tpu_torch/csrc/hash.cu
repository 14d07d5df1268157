// Spark-exact Murmur3_x86_32 row hash of the port, with the partition id
// (pmod) fused as an optional second output.  Built for sm_90a by
// kernels/_lib.py and called through ctypes from kernels/hash.py.  The entry
// point launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of its launch.
// The hashes of one value (hash_int, hash_long, xx_hash_int, xx_hash_long)
// are in csrc/hash.cuh, shared with csrc/sketch.cu.
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
//
// FLOAT columns <- spark_rapids_tpu/kernels/hash.py:77 _f32_bits
//   One more kind (kF32), for the three hashes: the float's bits with
//   -0.0 taken as 0.0 and every NaN as 0x7FC00000 (Java's
//   floatToIntBits), hashed as an int.
//
// H1 xxhash64 <- spark_rapids_tpu/kernels/hash.py:409 xxhash64_fixed_width,
//                :433 xxhash64_string, :529 xxhash64
//   Spark's XxHash64 (XXH64 with seed 42), chained over the columns as
//   murmur3 is: each valid value hashes with the running uint64 hash as
//   its seed, a null passes it through.  BOOL, BYTE, SHORT, INT, DATE and
//   FLOAT take hashInt (4 bytes), LONG, TIMESTAMP, DOUBLE and Decimal64
//   hashLong (8 bytes), a string hashUnsafeBytes: 32-byte stripes into
//   four accumulators while 32 bytes remain, their merge, the length, then
//   8-byte words, one 4-byte word and single bytes.  The reference pads
//   every row to a bucket of 32-byte stripes and masks; here a thread
//   walks its row's bytes, read one at a time (a row starts at any byte,
//   so no 8-byte load may assume alignment).  A Decimal128 is refused
//   (the reference's :429).
//   Bound: bytes: each column read once (a string's offsets and bytes),
//   8 bytes of hash written a row; a 64-bit multiply every 8 bytes.
//
// H2 hive_hash <- spark_rapids_tpu/kernels/hash.py:696 hive_hash,
//                 :668 _hive_col_hash
//   Hive's bucketing hash: h = 31 * h + col_hash over the columns in
//   int32 (uint32 arithmetic here, wrapping as Java's int does), a null
//   adding 0.  INT, BYTE, SHORT and DATE hash as their value, BOOL as 1 /
//   0, FLOAT as its normalized bits, LONG and TIMESTAMP as the low word of
//   v ^ (v >>> 32), DOUBLE the same of its normalized bits, a string as
//   the 31-polynomial over its bytes taken as SIGNED (a byte >= 0x80
//   counts negative).  A decimal is refused (the reference's :692).
//   Bound: bytes: each column read once, 4 bytes of hash written a row.
#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

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
constexpr int kF32 = 8;     // float: hashInt of the normalized bits

struct HashCols {
  const void* data[kMaxHashCols];
  const uint8_t* valid[kMaxHashCols];
  const int32_t* offsets[kMaxHashCols];   // strings only
  int kind[kMaxHashCols];
};

// Java's floatToIntBits with -0.0 as 0.0
__device__ __forceinline__ uint32_t f32_bits(float f) {
  if (f != f) return 0x7FC00000u;        // canonical NaN
  if (f == 0.0f) f = 0.0f;               // -0.0 -> 0.0
  return __float_as_uint(f);
}

// Java's doubleToLongBits with -0.0 as 0.0
__device__ __forceinline__ uint64_t f64_bits(double d) {
  if (d != d) return 0x7FF8000000000000ull;
  if (d == 0.0) d = 0.0;
  return static_cast<uint64_t>(__double_as_longlong(d));
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
      case kF64:
        h = hash_long(f64_bits(static_cast<const double*>(cols.data[c])[r]),
                      h);
        break;
      case kF32:
        h = hash_int(f32_bits(static_cast<const float*>(cols.data[c])[r]),
                     h);
        break;
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

// -- H1: XXH64 -----------------------------------------------------------

// little-endian loads a byte at a time: a string row starts at any byte
__device__ __forceinline__ uint64_t le64(const uint8_t* p) {
  uint64_t w = 0;
#pragma unroll
  for (int b = 7; b >= 0; --b) w = (w << 8) | p[b];
  return w;
}

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// Spark XXH64.hashUnsafeBytes
__device__ uint64_t xx_hash_bytes(const uint8_t* p, int32_t len,
                                  uint64_t seed) {
  int32_t off = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
             v4 = seed - kP1;
    for (; off + 32 <= len; off += 32) {
      v1 = xx_round(v1, le64(p + off));
      v2 = xx_round(v2, le64(p + off + 8));
      v3 = xx_round(v3, le64(p + off + 16));
      v4 = xx_round(v4, le64(p + off + 24));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    const uint64_t vs[4] = {v1, v2, v3, v4};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h ^= xx_round(0, vs[i]);
      h = h * kP1 + kP4;
    }
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(len);
  for (; off + 8 <= len; off += 8) {
    h = rotl64(h ^ xx_round(0, le64(p + off)), 27) * kP1 + kP4;
  }
  if (off + 4 <= len) {
    h = rotl64(h ^ (static_cast<uint64_t>(le32(p + off)) * kP1), 23) * kP2 +
        kP3;
    off += 4;
  }
  for (; off < len; ++off) {
    h = rotl64(h ^ (static_cast<uint64_t>(p[off]) * kP5), 11) * kP1;
  }
  return xx_fmix(h);
}

__global__ void __launch_bounds__(kThreads)
xxhash64_kernel(HashCols cols, int ncols, int64_t n, uint64_t seed,
                int64_t* __restrict__ hashes) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  uint64_t h = seed;
  for (int c = 0; c < ncols; ++c) {
    if (cols.valid[c][r] == 0) continue;  // null: the seed passes through
    const void* d = cols.data[c];
    switch (cols.kind[c]) {
      case kInt32:
        h = xx_hash_int(static_cast<const uint32_t*>(d)[r], h);
        break;
      case kInt64:
        h = xx_hash_long(static_cast<const uint64_t*>(d)[r], h);
        break;
      case kInt8:
        h = xx_hash_int(static_cast<uint32_t>(static_cast<int32_t>(
                            static_cast<const int8_t*>(d)[r])), h);
        break;
      case kInt16:
        h = xx_hash_int(static_cast<uint32_t>(static_cast<int32_t>(
                            static_cast<const int16_t*>(d)[r])), h);
        break;
      case kF64:
        h = xx_hash_long(f64_bits(static_cast<const double*>(d)[r]), h);
        break;
      case kF32:
        h = xx_hash_int(f32_bits(static_cast<const float*>(d)[r]), h);
        break;
      case kString: {
        const int32_t b = cols.offsets[c][r];
        h = xx_hash_bytes(static_cast<const uint8_t*>(d) + b,
                          cols.offsets[c][r + 1] - b, h);
        break;
      }
      default:   // kBool
        h = xx_hash_int(static_cast<const uint8_t*>(d)[r] != 0, h);
        break;
    }
  }
  hashes[r] = static_cast<int64_t>(h);
}

// -- H2: Hive ------------------------------------------------------------

__device__ __forceinline__ uint32_t fold64(uint64_t v) {
  return static_cast<uint32_t>(v ^ (v >> 32));
}

__global__ void __launch_bounds__(kThreads)
hive_hash_kernel(HashCols cols, int ncols, int64_t n,
                 int32_t* __restrict__ hashes) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  uint32_t h = 0;
  for (int c = 0; c < ncols; ++c) {
    uint32_t ch = 0;   // a null adds 0
    if (cols.valid[c][r] != 0) {
      const void* d = cols.data[c];
      switch (cols.kind[c]) {
        case kInt32:
          ch = static_cast<const uint32_t*>(d)[r];
          break;
        case kInt64:
          ch = fold64(static_cast<const uint64_t*>(d)[r]);
          break;
        case kInt8:
          ch = static_cast<uint32_t>(static_cast<int32_t>(
              static_cast<const int8_t*>(d)[r]));
          break;
        case kInt16:
          ch = static_cast<uint32_t>(static_cast<int32_t>(
              static_cast<const int16_t*>(d)[r]));
          break;
        case kF64:
          ch = fold64(f64_bits(static_cast<const double*>(d)[r]));
          break;
        case kF32:
          ch = f32_bits(static_cast<const float*>(d)[r]);
          break;
        case kString: {
          const uint8_t* p =
              static_cast<const uint8_t*>(d) + cols.offsets[c][r];
          const int32_t len = cols.offsets[c][r + 1] - cols.offsets[c][r];
          for (int32_t i = 0; i < len; ++i) {
            ch = ch * 31u + static_cast<uint32_t>(
                                static_cast<int32_t>(
                                    static_cast<int8_t>(p[i])));
          }
          break;
        }
        default:   // kBool
          ch = static_cast<const uint8_t*>(d)[r] != 0;
          break;
      }
    }
    h = h * 31u + ch;
  }
  hashes[r] = static_cast<int32_t>(h);
}

// the column table of an H1 / H2 launch; false on a kind it does not take
// (Hive also refuses a Decimal64, which is kInt64 here: its wrapper does)
bool fill_cols(HashCols* cols, int ncols, const void* const* data,
               const uint8_t* const* valid, const int32_t* const* offsets,
               const int* kinds) {
  if (ncols < 1 || ncols > kMaxHashCols) return false;
  for (int c = 0; c < ncols; ++c) {
    cols->data[c] = data[c];
    cols->valid[c] = valid[c];
    cols->offsets[c] = offsets[c];
    cols->kind[c] = kinds[c];
    if (kinds[c] == kDec128 || kinds[c] < 0 || kinds[c] > kF32 ||
        (kinds[c] == kString && offsets[c] == nullptr)) {
      return false;
    }
  }
  return true;
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

// H1.  The column arrays as srt_murmur3's; kinds other than kDec128.
// hashes[n] int64 receives Spark's xxhash64 with the given seed.
int srt_xxhash64(int ncols, const void* const* data,
                 const uint8_t* const* valid, const int32_t* const* offsets,
                 const int* kinds, int64_t n, uint64_t seed, int64_t* hashes,
                 cudaStream_t stream) {
  HashCols cols{};
  if (!fill_cols(&cols, ncols, data, valid, offsets, kinds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    xxhash64_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(cols, ncols, n, seed, hashes);
  }
  return static_cast<int>(cudaGetLastError());
}

// H2.  As srt_xxhash64; hashes[n] int32 receives Hive's hash.
int srt_hive_hash(int ncols, const void* const* data,
                  const uint8_t* const* valid, const int32_t* const* offsets,
                  const int* kinds, int64_t n, int32_t* hashes,
                  cudaStream_t stream) {
  HashCols cols{};
  if (!fill_cols(&cols, ncols, data, valid, offsets, kinds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    hive_hash_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(cols, ncols, n, hashes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
