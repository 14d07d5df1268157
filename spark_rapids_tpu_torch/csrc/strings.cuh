// Big-endian 8-byte chunks of a string, shared by the sort keys
// (csrc/strings.cu) and the join's order words (csrc/join.cu).  Chunk c of
// a row of len bytes at p holds bytes [8c, 8c + 8), the first in the most
// significant byte, zero past the end.  Only the row's own bytes are read:
// the loop runs over the bytes the chunk holds, with no load under a
// select (a select on the loaded byte gave a wrong top byte on the card).
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint64_t string_chunk(const uint8_t* p,
                                                 int32_t len, int c) {
  const int32_t c0 = 8 * c;
  const int32_t m = len - c0 < 8 ? len - c0 : 8;
  uint64_t k = 0;
  for (int32_t j = 0; j < m; ++j) {
    k |= static_cast<uint64_t>(p[c0 + j]) << (56 - 8 * j);
  }
  return k;
}

}  // namespace
