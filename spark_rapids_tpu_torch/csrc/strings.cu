// String kernels of the port for sorting and grouping: the sort keys of a
// string column and the adjacent-row equality of a sorted one.  Built for
// sm_90a by kernels/_lib.py and called through ctypes from kernels/sort.py
// and kernels/groupby.py.  Every entry point launches on the caller's
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
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>

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

}  // extern "C"
