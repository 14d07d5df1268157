// The time-zone shifts of the port: two hand-written kernels that move
// TIMESTAMP microseconds between UTC and a zone's wall clock.  Built for
// sm_90a by kernels/_lib.py and called through ctypes from
// kernels/timezone.py.  Every entry point launches on the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// A zone is the host's transition table (kernels/timezone.py zone_table,
// the reference's :30, sampled from zoneinfo over 1900-2100): n sorted
// int64 UTC instants in seconds, the first the sentinel INT64_MIN / 2, and
// the int32 offset in seconds that applies from each one on.  Rows past
// the last transition take its offset, as the reference's device path
// does.  Tables hold 6 (Asia/Kolkata) to 309 (America/Los_Angeles)
// entries, so each block copies its zone's whole table into shared memory
// once, and walks the rows grid-stride: the search never leaves the SM.
//
// T1 utc_to_local  <- spark_rapids_tpu/kernels/timezone.py:74
//                     utc_to_local_micros
//   local = ts + offsets[upper_bound(transitions, floor(ts / 1e6)) - 1]
//   * 1e6, the index clipped to [0, n - 1].  C++ '/' truncates toward
//   zero, so the seconds are floored by hand: -1 us is second -1.
// T2 local_to_utc  <- spark_rapids_tpu/kernels/timezone.py:84
//                     local_to_utc_micros
//   The inverse with java.time's rules: the search runs over wall_old_end
//   (transitions + the previous offset: the wall clock at which the old
//   offset stops), utc = local - offsets[idx] * 1e6; where that instant
//   falls before transitions[idx] the wall time was skipped by a gap and
//   takes the previous offset (shifted forward); an overlap takes the
//   earlier offset by the search itself.  The host derives wall_old_end
//   and prev_off (int32) with the table.
//
// Bound: bytes: 8 bytes read and 8 written a row (16 bytes a row, ~5 us for
// 1,048,576 rows at 3.35 TB/s); the table (<= 8 KB) is read from shared
// memory, ~9 probes a row for 309 entries.  Null rows are shifted like any
// other (their slot holds 0): the caller keeps their validity.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxBlocks = 132 * kBlocksPerSm;
constexpr int64_t kMicrosPerSecond = 1000000;
constexpr int kUtcToLocal = 0;
constexpr int kLocalToUtc = 1;
// shared memory a table may take: 24 bytes an entry (key, transition,
// offset, previous offset) within the 48 KB a block has without opting in
constexpr int kMaxEntries = 2048;

__device__ __forceinline__ int64_t floor_seconds(int64_t micros) {
  int64_t q = micros / kMicrosPerSecond;
  if (micros % kMicrosPerSecond < 0) --q;
  return q;
}

// the last index whose key is <= secs (upper_bound - 1), clipped at 0
__device__ __forceinline__ int find_interval(const int64_t* keys, int n,
                                             int64_t secs) {
  int lo = 0, hi = n;   // first key > secs lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= secs) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo > 0 ? lo - 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
tz_shift_kernel(int mode, const int64_t* __restrict__ in, int64_t n,
                const int64_t* __restrict__ keys,
                const int64_t* __restrict__ transitions,
                const int32_t* __restrict__ offsets,
                const int32_t* __restrict__ prev_off, int entries,
                int64_t* __restrict__ out) {
  extern __shared__ int64_t smem[];
  int64_t* s_keys = smem;
  int64_t* s_trans = smem + entries;
  int32_t* s_off = reinterpret_cast<int32_t*>(smem + 2 * entries);
  int32_t* s_prev = s_off + entries;
  for (int i = threadIdx.x; i < entries; i += kThreads) {
    s_keys[i] = keys[i];
    s_trans[i] = transitions[i];
    s_off[i] = offsets[i];
    s_prev[i] = prev_off[i];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    const int64_t v = in[r];
    const int idx = find_interval(s_keys, entries, floor_seconds(v));
    if (mode == kUtcToLocal) {
      out[r] = v + static_cast<int64_t>(s_off[idx]) * kMicrosPerSecond;
    } else {
      const int64_t utc = v - static_cast<int64_t>(s_off[idx]) *
                                  kMicrosPerSecond;
      out[r] = floor_seconds(utc) < s_trans[idx]
                   ? v - static_cast<int64_t>(s_prev[idx]) * kMicrosPerSecond
                   : utc;
    }
  }
}

}  // namespace

extern "C" {

int srt_tz_max_entries() { return kMaxEntries; }

// mode 0 (T1): keys = transitions; mode 1 (T2): keys = wall_old_end.  Each
// table array holds `entries` (1..srt_tz_max_entries()) values; in[n] and
// out[n] int64 microseconds (out may not alias in).
int srt_tz_shift(int mode, const int64_t* in, int64_t n, const int64_t* keys,
                 const int64_t* transitions, const int32_t* offsets,
                 const int32_t* prev_off, int entries, int64_t* out,
                 cudaStream_t stream) {
  if ((mode != kUtcToLocal && mode != kLocalToUtc) || entries < 1 ||
      entries > kMaxEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int64_t want = (n + kThreads - 1) / kThreads;
    const unsigned grid =
        static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
    const size_t shared = static_cast<size_t>(entries) * 24;
    tz_shift_kernel<<<grid, kThreads, shared, stream>>>(
        mode, in, n, keys, transitions, offsets, prev_off, entries, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
