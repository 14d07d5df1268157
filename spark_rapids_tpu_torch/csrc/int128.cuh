// Signed and unsigned 128-bit integers on the card (nvcc's __int128) for
// the Decimal128 kernels of csrc/decimal.cu and csrc/reduction.cu: a
// column's row is int64 [2] (low, high limbs; Arrow's decimal128 slot) or
// a Decimal64's int64, widened as it is read; 10**k for k <= 38; the exact
// 128 x 128 -> 256-bit product; Spark's overflow test |v| >= 10**p.
#pragma once

#include <cstdint>

namespace i128 {

using u128 = unsigned __int128;
using s128 = __int128;

constexpr int kMaxPrecision = 38;

// 10**k, k = 0..38, as (low, high) 64-bit words (static: one copy in each
// source that includes this header)
static __constant__ unsigned long long kPow10Lo[kMaxPrecision + 1] = {
    0x0000000000000001ull, 0x000000000000000aull, 0x0000000000000064ull,
    0x00000000000003e8ull, 0x0000000000002710ull, 0x00000000000186a0ull,
    0x00000000000f4240ull, 0x0000000000989680ull, 0x0000000005f5e100ull,
    0x000000003b9aca00ull, 0x00000002540be400ull, 0x000000174876e800ull,
    0x000000e8d4a51000ull, 0x000009184e72a000ull, 0x00005af3107a4000ull,
    0x00038d7ea4c68000ull, 0x002386f26fc10000ull, 0x016345785d8a0000ull,
    0x0de0b6b3a7640000ull, 0x8ac7230489e80000ull, 0x6bc75e2d63100000ull,
    0x35c9adc5dea00000ull, 0x19e0c9bab2400000ull, 0x02c7e14af6800000ull,
    0x1bcecceda1000000ull, 0x161401484a000000ull, 0xdcc80cd2e4000000ull,
    0x9fd0803ce8000000ull, 0x3e25026110000000ull, 0x6d7217caa0000000ull,
    0x4674edea40000000ull, 0xc0914b2680000000ull, 0x85acef8100000000ull,
    0x38c15b0a00000000ull, 0x378d8e6400000000ull, 0x2b878fe800000000ull,
    0xb34b9f1000000000ull, 0x00f436a000000000ull, 0x098a224000000000ull};
static __constant__ unsigned long long kPow10Hi[kMaxPrecision + 1] = {
    0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull,
    0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull,
    0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull,
    0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull,
    0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull,
    0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000000ull,
    0x0000000000000000ull, 0x0000000000000000ull, 0x0000000000000005ull,
    0x0000000000000036ull, 0x000000000000021eull, 0x000000000000152dull,
    0x000000000000d3c2ull, 0x0000000000084595ull, 0x000000000052b7d2ull,
    0x00000000033b2e3cull, 0x00000000204fce5eull, 0x00000001431e0faeull,
    0x0000000c9f2c9cd0ull, 0x0000007e37be2022ull, 0x000004ee2d6d415bull,
    0x0000314dc6448d93ull, 0x0001ed09bead87c0ull, 0x0013426172c74d82ull,
    0x00c097ce7bc90715ull, 0x0785ee10d5da46d9ull, 0x4b3b4ca85a86c47aull};

__device__ __forceinline__ u128 ten_to(int k) {
  return (static_cast<u128>(kPow10Hi[k]) << 64) | kPow10Lo[k];
}

__device__ __forceinline__ u128 make(uint64_t lo, uint64_t hi) {
  return (static_cast<u128>(hi) << 64) | lo;
}

// row i of a Decimal128 [n, 2] plane (two) or of an int64 [n] plane
__device__ __forceinline__ s128 load(const int64_t* p, bool two, int64_t i) {
  if (two) {
    return static_cast<s128>(make(static_cast<uint64_t>(p[2 * i]),
                                  static_cast<uint64_t>(p[2 * i + 1])));
  }
  return static_cast<s128>(p[i]);
}

// row i of an [n, 2] plane (two) or its low limb into an int64 [n] plane
__device__ __forceinline__ void store(int64_t* p, bool two, int64_t i,
                                      s128 v) {
  const u128 u = static_cast<u128>(v);
  if (two) {
    p[2 * i] = static_cast<int64_t>(static_cast<uint64_t>(u));
    p[2 * i + 1] = static_cast<int64_t>(static_cast<uint64_t>(u >> 64));
  } else {
    p[i] = static_cast<int64_t>(static_cast<uint64_t>(u));
  }
}

// |v| unsigned: |-2**127| is 2**127
__device__ __forceinline__ u128 magnitude(s128 v) {
  return v < 0 ? u128(0) - static_cast<u128>(v) : static_cast<u128>(v);
}

struct U256 {
  uint64_t w[4];   // little-endian 64-bit words
};

__device__ __forceinline__ U256 mul_full(u128 a, u128 b) {
  const uint64_t a0 = static_cast<uint64_t>(a);
  const uint64_t a1 = static_cast<uint64_t>(a >> 64);
  const uint64_t b0 = static_cast<uint64_t>(b);
  const uint64_t b1 = static_cast<uint64_t>(b >> 64);
  const u128 p00 = static_cast<u128>(a0) * b0;
  const u128 p01 = static_cast<u128>(a0) * b1;
  const u128 p10 = static_cast<u128>(a1) * b0;
  const u128 p11 = static_cast<u128>(a1) * b1;
  const u128 mid = (p00 >> 64) + static_cast<uint64_t>(p01) +
                   static_cast<uint64_t>(p10);
  // the product is < 2**256, so its high half fits 128 bits
  const u128 high = (mid >> 64) + (p01 >> 64) + (p10 >> 64) + p11;
  return U256{{static_cast<uint64_t>(p00), static_cast<uint64_t>(mid),
               static_cast<uint64_t>(high),
               static_cast<uint64_t>(high >> 64)}};
}

__device__ __forceinline__ u128 low(const U256& p) {
  return make(p.w[0], p.w[1]);
}

// the 256-bit magnitude p is >= 2**127: it leaves int128
__device__ __forceinline__ bool past_int128(const U256& p) {
  return (p.w[3] | p.w[2] | (p.w[1] >> 63)) != 0;
}

// Spark's non-ANSI overflow at precision p > 0: |v| >= 10**p (-2**127
// counts: its magnitude is 2**127 > 10**38)
__device__ __forceinline__ bool too_wide(s128 v, int precision) {
  return magnitude(v) >= ten_to(precision);
}

}  // namespace i128
