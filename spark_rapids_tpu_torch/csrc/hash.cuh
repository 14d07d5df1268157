// Spark's device hashes of one value, shared by csrc/hash.cu (the row
// hashes) and csrc/sketch.cu (the bloom filter's and HyperLogLog's hash of
// a LONG), so that no hash is written twice.  All arithmetic is unsigned,
// wrapping as Java's int and long do.
//   Murmur3_x86_32: hash_int (hashInt), hash_long (hashLong: the low word,
//   then the high word, length 8), with their mix_h1 and fmix.
//   XXH64: xx_hash_int (hashInt), xx_hash_long (hashLong), with the primes,
//   xx_round and xx_fmix.
// In an anonymous namespace, so each source that includes this header has
// its own copy.
#pragma once

#include <cstdint>

namespace {

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

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xx_fmix(uint64_t h) {
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

__device__ __forceinline__ uint64_t xx_round(uint64_t acc, uint64_t w) {
  return rotl64(acc + w * kP2, 31) * kP1;
}

__device__ __forceinline__ uint64_t xx_hash_int(uint32_t v, uint64_t seed) {
  uint64_t h = seed + kP5 + 4u;
  h ^= static_cast<uint64_t>(v) * kP1;
  h = rotl64(h, 23) * kP2 + kP3;
  return xx_fmix(h);
}

__device__ __forceinline__ uint64_t xx_hash_long(uint64_t v, uint64_t seed) {
  uint64_t h = seed + kP5 + 8u;
  h ^= rotl64(v * kP2, 31) * kP1;
  h = rotl64(h, 27) * kP1 + kP4;
  return xx_fmix(h);
}

}  // namespace
