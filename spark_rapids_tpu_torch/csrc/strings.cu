// String kernels of the port: for sorting and grouping, the sort keys of a
// string column and the adjacent-row equality of a sorted one; and SUBSTRING
// over UTF-8 characters.  Built for sm_90a by kernels/_lib.py and called
// through ctypes from kernels/sort.py, kernels/groupby.py and
// kernels/strings.py.  Every entry point launches on the caller's
// stream, allocates nothing, and returns the cudaError_t of its launches.
// Row i of a string column is data[offsets[i]:offsets[i + 1]] (the offsets
// need not start at 0), and a null row has length 0.
//
// sort keys  <- spark_rapids_tpu/kernels/sort.py:160 _string_data_keys
//   The reference packs 7 bytes into 9-bit lanes of a uint64 (byte + 1, 0
//   past the end) because XLA sorts fixed shapes; here one thread per row
//   writes its nchunks big-endian 8-byte chunks (zero past the end) and
//   its length, and csrc/sort.cu's LSD passes sort on the length first
//   (least significant), then the chunks from last to first.  Equal
//   chunks with zero padding leave only the case "one string is the
//   other plus zero bytes", which the length decides, so the order is
//   Spark's UTF8String.binaryCompare ("ab" before "ab\0").  nchunks is
//   ceil(longest live length / 8), read back once per sort (string_max_
//   length, with the null counts of the same sort).  A null row's keys
//   are 0; a descending key is inverted by the sort's key pass.
//   Bound: bytes: each string byte read once, 8 bytes per chunk and 4 of
//   length written per row.
//
// rows equal <- spark_rapids_tpu/kernels/groupby.py:74
//               _string_rows_equal_prev
//   One thread per row i >= 1 compares row i with row i - 1: null equals
//   null, a null never equals a value, else equal lengths and bytes (the
//   first differing byte ends the loop).
//   Bound: bytes: per row its offsets and validity, and its bytes read
//   twice (as row i and as row i + 1's predecessor, mostly from L1/L2).
//
// substring  <- spark_rapids_tpu/kernels/strings.py:161 substring_chars
//               (with char_length :101, _compact_bytes :141, _row_of_byte
//               :88, _live_byte_mask :95)
//   Spark SUBSTRING over UTF-8 characters: 1-based pos (0 counts as 1, a
//   negative pos counts from the end), len < 0 gives the empty string.  The
//   reference attributes every byte to its row by a searchsorted over the
//   offsets, ranks the characters by a cumulative sum of lead bytes and
//   compacts the kept bytes (fixed shapes for XLA).  Here the output is
//   count-then-allocate, as the string gather's: (1) substring_rows_kernel,
//   one thread per row, counts the row's character starts (a byte with
//   (b & 0xC0) != 0x80, byte by byte as the reference counts them, a
//   malformed sequence included), computes s0 and e0 as the reference does
//   (e0 = s0 + max(len, 0) wraps in 32 bits: the sum is taken in uint32, so
//   len = 2**31 - 1 with pos >= 2 gives the empty string, as the reference
//   does and Spark does not), clamps both to [0, chars], then walks the row
//   again for the byte positions of characters s0c and e0c, and writes the
//   kept range's source start and byte length (0 for a null row, as the
//   gather keeps a null row); (2) csrc/scan.cuh's scan turns the lengths
//   into the new offsets and the byte total, which the wrapper reads back
//   once to allocate the bytes; (3) the string gather's byte copy
//   (csrc/selection.cu srt_gather_bytes, with no index: row r's bytes
//   start at the row pass's starts[r]) copies each row's kept bytes.  A
//   byte before a row's first character start (a lone continuation byte)
//   has rank -1 in the reference and is never kept; the kept bytes are
//   those from character s0c's start to character e0c's.
//   pos and len are per-row int32 columns or one literal (stride 0).
//   Bound: bytes: the offsets, the input bytes and the validity read once,
//   the output offsets and bytes written once (pos and len as columns: 4
//   bytes a row each).
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>

#include "scan.cuh"
#include "strings.cuh"

namespace {

constexpr int kThreads = 256;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

__global__ void __launch_bounds__(kThreads)
string_sort_keys_kernel(const int32_t* __restrict__ offsets,
                        const uint8_t* __restrict__ data,
                        const uint8_t* __restrict__ valid, int64_t n,
                        int nchunks, uint64_t* __restrict__ chunks,
                        uint32_t* __restrict__ lengths) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const bool v = valid[r] != 0;
  const int32_t b = offsets[r];
  const int32_t len = v ? offsets[r + 1] - b : 0;
  const uint8_t* p = data + b;
  for (int c = 0; c < nchunks; ++c) {
    chunks[static_cast<int64_t>(c) * n + r] = string_chunk(p, len, c);
  }
  lengths[r] = static_cast<uint32_t>(len);
}

__global__ void __launch_bounds__(kThreads)
string_max_length_kernel(const int32_t* __restrict__ offsets,
                         const uint8_t* __restrict__ valid, int64_t n,
                         unsigned long long* __restrict__ out) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  int m = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    if (valid[i] != 0) m = max(m, offsets[i + 1] - offsets[i]);
  }
  const int block_max = Reduce(tmp).Reduce(m, MaxOp());
  if (threadIdx.x == 0 && block_max > 0) {
    atomicMax(out, static_cast<unsigned long long>(block_max));
  }
}

__global__ void __launch_bounds__(kThreads)
string_rows_equal_prev_kernel(const int32_t* __restrict__ offsets,
                              const uint8_t* __restrict__ data,
                              const uint8_t* __restrict__ valid, int64_t n,
                              uint8_t* __restrict__ eq) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x + 1;
  if (i >= n) return;
  const bool vi = valid[i] != 0, vp = valid[i - 1] != 0;
  bool same = vi == vp;
  if (same && vi) {
    const int32_t bi = offsets[i], bp = offsets[i - 1];
    const int32_t len = offsets[i + 1] - bi;
    same = len == bi - bp;
    for (int32_t j = 0; same && j < len; ++j) same = data[bi + j] == data[bp + j];
  }
  eq[i - 1] = same;
}

__device__ __forceinline__ bool char_start(uint8_t b) {
  return (b & 0xC0) != 0x80;
}

__global__ void __launch_bounds__(kThreads)
substring_rows_kernel(const int32_t* __restrict__ offsets,
                      const uint8_t* __restrict__ data,
                      const uint8_t* __restrict__ valid, int64_t n,
                      const int32_t* __restrict__ pos, int pos_stride,
                      const int32_t* __restrict__ len, int len_stride,
                      int32_t* __restrict__ starts,
                      int32_t* __restrict__ lengths) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t b = offsets[r];
  starts[r] = b;
  if (valid[r] == 0) {
    lengths[r] = 0;
    return;
  }
  const int32_t bytes = offsets[r + 1] - b;
  const uint8_t* p = data + b;
  int32_t chars = 0;
  for (int32_t j = 0; j < bytes; ++j) chars += char_start(p[j]);
  const int32_t s = pos[r * pos_stride];
  const int32_t l = len[r * len_stride];
  const int32_t s0 = s > 0 ? s - 1 : (s < 0 ? chars + s : 0);
  // the reference's int32 sum wraps: take it in uint32
  const int32_t e0 = static_cast<int32_t>(static_cast<uint32_t>(s0) +
                                          static_cast<uint32_t>(l > 0 ? l : 0));
  const int32_t s0c = min(max(s0, 0), chars);
  const int32_t e0c = min(max(e0, 0), chars);
  int32_t bs = 0, be = 0;
  if (s0c < e0c) {   // then character s0c exists
    bs = bytes;
    be = bytes;      // e0c == chars: to the row's end
    int32_t k = 0;   // character starts seen
    for (int32_t j = 0; j < bytes; ++j) {
      if (!char_start(p[j])) continue;
      if (k == s0c) bs = j;
      if (k == e0c) {
        be = j;
        break;
      }
      ++k;
    }
  }
  starts[r] = b + bs;
  lengths[r] = be - bs;
}

unsigned grid_rows(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// chunks[nchunks * n] (chunk c of row r at c * n + r) and lengths[n].
int srt_string_sort_keys(const int32_t* offsets, const uint8_t* data,
                         const uint8_t* valid, int64_t n, int nchunks,
                         uint64_t* chunks, uint32_t* lengths,
                         cudaStream_t stream) {
  if (nchunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    string_sort_keys_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        offsets, data, valid, n, nchunks, chunks, lengths);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0] (uint64) receives the longest length of a valid row (0 if none).
int srt_string_max_length(const int32_t* offsets, const uint8_t* valid,
                          int64_t n, unsigned long long* out,
                          cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    string_max_length_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks
                                                                   : 1024),
                               kThreads, 0, stream>>>(offsets, valid, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// eq[n - 1] (bool): row i + 1 equals row i.
int srt_string_rows_equal_prev(const int32_t* offsets, const uint8_t* data,
                               const uint8_t* valid, int64_t n, uint8_t* eq,
                               cudaStream_t stream) {
  if (n > 1) {
    string_rows_equal_prev_kernel<<<grid_rows(n - 1), kThreads, 0, stream>>>(
        offsets, data, valid, n, eq);
  }
  return static_cast<int>(cudaGetLastError());
}

// Steps (1) and (2) of a substring: starts[n] (int32) receives each row's
// first kept source byte (for step (3), srt_gather_bytes with no index);
// out_offsets[n + 1] (int32) the new offsets and totals[0] (int64) the
// byte total, which the caller reads back; pos and len hold n values
// (stride 1) or one (stride 0).  tile_sums holds
// ceil(n / srt_scan_tile()) int64, at least one.
int srt_substring_rows(const int32_t* offsets, const uint8_t* data,
                       const uint8_t* valid, int64_t n, const int32_t* pos,
                       int pos_stride, const int32_t* len, int len_stride,
                       int32_t* starts, int32_t* out_offsets,
                       int64_t* tile_sums, int64_t* totals,
                       cudaStream_t stream) {
  if ((pos_stride != 0 && pos_stride != 1) ||
      (len_stride != 0 && len_stride != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    substring_rows_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        offsets, data, valid, n, pos, pos_stride, len, len_stride, starts,
        out_offsets);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan::ScanCols cols{};
  cols.v[0] = out_offsets;
  return scan::scan_columns(cols, 1, n, tile_sums, totals, stream);
}

}  // extern "C"
