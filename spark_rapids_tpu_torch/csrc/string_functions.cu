// The string functions of the port: four hand-written kernels behind
// LENGTH, CONTAINS / STARTSWITH / ENDSWITH / LIKE, INSTR / LOCATE, TRIM,
// RLIKE and general LIKE, CONCAT, CONCAT_WS, IF / CASE WHEN over strings,
// LPAD / RPAD, REPEAT, REPLACE, REVERSE, TRANSLATE, UPPER, LOWER and
// INITCAP.  Built for sm_90a by kernels/_lib.py and called through ctypes
// from kernels/strings.py.  Every entry point launches on the caller's
// stream, allocates nothing, and returns the cudaError_t of its launches.
// Row i of a string column is data[offsets[i]:offsets[i + 1]] (the offsets
// need not start at 0), and a null row has length 0.
//
// The reference (spark_rapids_tpu/kernels/strings.py) computes each
// function per byte over fixed shapes for XLA: every byte's row by a
// searchsorted over the offsets, character ranks by cumulative sums of
// lead bytes, segment reductions back to rows, and outputs sized by a
// string bucket or a byte capacity.  Here each kernel gives one thread a
// row, which walks the row's bytes in order; an output that changes
// lengths is count-then-allocate (a pass for each row's length, the scan
// of csrc/scan.cuh, one read of the byte total by the caller, a pass that
// writes).  One thread a row is the simple first design: the longest row
// sets a warp's time, and a thread's loads are not coalesced with its
// neighbours'.  UTF-8: a character starts at every byte with
// (b & 0xC0) != 0x80, counted byte by byte, a malformed sequence included.
//
// K1 string_row_scan  <- char_length :101, contains_literal :229 with
//                        _pattern_hits :214, startswith_literal :241,
//                        endswith_literal :254, first_occurrence_char :405,
//                        trim_ws :268, ltrim_ws :328, rtrim_ws :340
//   One pass over each row's bytes, writing one value a row: its
//   characters (int32), a literal's presence at any byte / at the start /
//   at the end (bool; an empty literal is always present), or the 1-based
//   character index of the literal's first occurrence that starts at a
//   lead byte at or after character start0 (0 if none; an empty literal
//   gives start0 + 1 where start0 <= the row's characters).  TRIM / LTRIM
//   / RTRIM write the kept range (0x20 only is stripped) as a source start
//   and a length; the scan makes the new offsets, and the string gather's
//   byte copy (csrc/selection.cu srt_gather_bytes, no index) moves the
//   bytes, as SUBSTRING does.
//   Bound: bytes: offsets and bytes read once, 4 (or 1) bytes a row
//   written; TRIM also the kept bytes and new offsets.
//
// K2 string_dfa_match <- dfa_match :302 (RLIKE, general LIKE)
//   The host compiles the pattern to a [S, 256] DFA (regex/automata.py,
//   S <= 192) narrowed to uint8, with accept[S]: S * 257 <= 49,344 bytes,
//   above the 48 KB static limit, so they sit in dynamic shared memory
//   (cudaFuncAttributeMaxDynamicSharedMemorySize).  The grid is at most
//   four blocks an SM (the shared memory a block takes) and strides over
//   the rows, so each block loads the table once.  A thread walks its
//   row's bytes through the table from the start state and writes
//   accept[state].  The reference runs all rows in lockstep for a bucket
//   of steps; here the longest row of a warp sets its time.
//   Bound: bytes: offsets and bytes read once, 1 byte a row written.
//
// K3 string_assemble  <- concat_strings :191, concat_ws :570,
//                        select_strings :617, pad_chars :460,
//                        repeat_string :435, replace_literal :513,
//                        reverse_chars :351, _compact_bytes :141 under
//                        Translate (expressions/strings.py:888)
//   Count-then-allocate over k input columns (a device array of their
//   offsets, bytes and validity pointers) and literal bytes: pass 1
//   (string_assemble_count) gives each row's output length and validity,
//   the scan makes the offsets and the byte total, which the caller reads
//   back; pass 2 (string_assemble_write) writes each row's bytes.  Both
//   passes run one function (assemble_row<kWrite>), so a row's length and
//   its bytes cannot disagree.  A null row, or a dead branch of a select,
//   has length 0.  CONCAT: null if any input is; CONCAT_WS: the valid
//   inputs joined by the separator, never null; SELECT: choice[r] in
//   [0, k) picks an input (k: null), so IF and a whole CASE WHEN take one
//   launch; PAD: truncate to the target characters, pad with the ASCII
//   pattern (an empty pattern only truncates, a negative target counts
//   as 0); REPEAT: n copies (n <= 0: empty); REPLACE: greedy
//   non-overlapping hits from the left (the reference's countdown scan,
//   :533-541: "aa" -> "b" over "aaa" gives "ba"); REVERSE: characters
//   reversed, bytes inside a character kept in order, a row's leading
//   continuation bytes one character anchored at the row's start;
//   TRANSLATE: a byte map and a delete flag a byte value.  A row's length
//   saturates at 2**31 - 1, and the caller raises at that total.
//   Bound: bytes: the inputs' offsets, validity and bytes read once, the
//   new offsets, validity and bytes written once.
//
// K4 string_case_map  <- upper_ascii :114, lower_ascii :129,
//                        initcap_ascii :388; TRANSLATE without deletions
//   Length-preserving byte maps: the offsets stay, and out has the size of
//   data, the bytes of the rows written at their own positions.  UPPER /
//   LOWER map ASCII letters and Latin-1 letters (the second byte of a
//   C3 xx pair, except U+00F7 / U+00D7), reading the byte before in the
//   buffer as the reference does (jnp.roll(d, 1).at[0].set(0)): a row
//   whose first byte follows a 0xC3 that ended the row before maps it as
//   Latin-1; the column's first live byte (offsets[0]) reads 0.  INITCAP
//   uppercases an ASCII letter after 0x20 or at a row's start and
//   lowercases the other ASCII capitals.
//   Bound: bytes: offsets and bytes read once, the bytes written once.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;     // K2: 4 x 49,344 bytes of shared memory
constexpr int32_t kMaxLen = 0x7fffffff;

enum ScanMode {
  kCharLength = 0,
  kContains = 1,
  kStartsWith = 2,
  kEndsWith = 3,
  kLocate = 4,
  kTrim = 5,
  kLTrim = 6,
  kRTrim = 7,
};

enum AssembleOp {
  kConcat = 0,
  kConcatWs = 1,
  kSelect = 2,
  kPad = 3,
  kRepeat = 4,
  kReplace = 5,
  kReverse = 6,
  kTranslate = 7,
};

enum CaseMode { kUpper = 0, kLower = 1, kInitCap = 2, kByteMap = 3 };

__device__ __forceinline__ bool lead_byte(uint8_t b) {
  return (b & 0xC0) != 0x80;
}

__device__ __forceinline__ bool match_at(const uint8_t* p,
                                         const uint8_t* pat, int m) {
  for (int i = 0; i < m; ++i) {
    if (p[i] != pat[i]) return false;
  }
  return true;
}

unsigned grid_rows(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// -- K1 -----------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
row_scan_kernel(int mode, const int32_t* __restrict__ offsets,
                const uint8_t* __restrict__ data,
                const uint8_t* __restrict__ valid, int64_t n,
                const uint8_t* __restrict__ pat, int m, int start0,
                int32_t* __restrict__ out_i32, uint8_t* __restrict__ out_b,
                int32_t* __restrict__ starts) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t b = offsets[r];
  const int32_t len = offsets[r + 1] - b;
  const uint8_t* p = data + b;
  switch (mode) {
    case kCharLength: {
      int32_t chars = 0;
      for (int32_t j = 0; j < len; ++j) chars += lead_byte(p[j]);
      out_i32[r] = chars;
      return;
    }
    case kContains: {
      bool hit = m == 0;
      for (int32_t j = 0; !hit && j + m <= len; ++j) hit = match_at(p + j, pat, m);
      out_b[r] = hit;
      return;
    }
    case kStartsWith:
      out_b[r] = len >= m && match_at(p, pat, m);
      return;
    case kEndsWith:
      out_b[r] = len >= m && match_at(p + len - m, pat, m);
      return;
    case kLocate: {
      int32_t k = 0;   // lead bytes before j: byte j's character rank
      int32_t found = 0;
      for (int32_t j = 0; j < len; ++j) {
        if (!lead_byte(p[j])) continue;
        if (m > 0 && k >= start0 && j + m <= len && match_at(p + j, pat, m)) {
          found = k + 1;
          break;
        }
        ++k;
      }
      if (m == 0) found = start0 <= k ? start0 + 1 : 0;
      out_i32[r] = found;
      return;
    }
    default: {       // kTrim, kLTrim, kRTrim: the kept range
      int32_t s = 0, e = valid[r] != 0 ? len : 0;
      if (mode != kRTrim) {
        while (s < e && p[s] == 0x20) ++s;
      }
      if (mode != kLTrim) {
        while (e > s && p[e - 1] == 0x20) --e;
      }
      starts[r] = b + s;
      out_i32[r] = e - s;
      return;
    }
  }
}

// -- K2 -----------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
dfa_match_kernel(const int32_t* __restrict__ offsets,
                 const uint8_t* __restrict__ data, int64_t n,
                 const uint8_t* __restrict__ table,
                 const uint8_t* __restrict__ accept, int states, int start,
                 uint8_t* __restrict__ out) {
  extern __shared__ uint8_t smem[];   // table[states][256], accept[states]
  const int tbytes = states * 256;
  for (int i = threadIdx.x; i < tbytes + states; i += kThreads) {
    smem[i] = i < tbytes ? table[i] : accept[i - tbytes];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    const int32_t b = offsets[r];
    const int32_t len = offsets[r + 1] - b;
    const uint8_t* p = data + b;
    unsigned s = static_cast<unsigned>(start);
    for (int32_t j = 0; j < len; ++j) s = smem[s * 256u + p[j]];
    out[r] = smem[tbytes + s];
  }
}

// -- K3 -----------------------------------------------------------------------

struct Assemble {
  int op;
  int k;                      // input columns
  const int64_t* desc;        // [k][3]: offsets, data, validity pointers
  const int32_t* choice;      // kSelect: the input of each row (k: null)
  const uint8_t* lit;         // separator, pad, search + replacement, or
                              // kTranslate's map[256] and delete[256]
  int lit_len;                // kReplace: the search's length
  int lit2_len;               // kReplace: the replacement's length
  int64_t arg;                // kPad: target characters; kRepeat: copies
  int left;                   // kPad: pad on the left
};

struct Row {
  const uint8_t* p;
  int32_t len;
  bool valid;
};

__device__ __forceinline__ Row row_of(const Assemble& a, int c, int64_t r) {
  const int32_t* off = reinterpret_cast<const int32_t*>(a.desc[3 * c]);
  const uint8_t* data = reinterpret_cast<const uint8_t*>(a.desc[3 * c + 1]);
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(a.desc[3 * c + 2]);
  const int32_t b = off[r];
  return {data + b, off[r + 1] - b, valid[r] != 0};
}

// Appends len bytes at dst + o (when kWrite) and advances o.
template <bool kWrite>
__device__ __forceinline__ void put(uint8_t* dst, int64_t& o,
                                    const uint8_t* src, int64_t len) {
  if (kWrite) {
    for (int64_t i = 0; i < len; ++i) dst[o + i] = src[i];
  }
  o += len;
}

// Row r's output: returns its length (and writes its bytes at dst when
// kWrite); *valid receives its validity.
template <bool kWrite>
__device__ int64_t assemble_row(const Assemble& a, int64_t r, uint8_t* dst,
                                bool* valid) {
  int64_t o = 0;
  switch (a.op) {
    case kConcat: {
      bool ok = true;
      for (int c = 0; c < a.k; ++c) ok = ok && row_of(a, c, r).valid;
      *valid = ok;
      if (!ok) return 0;
      for (int c = 0; c < a.k; ++c) {
        const Row x = row_of(a, c, r);
        put<kWrite>(dst, o, x.p, x.len);
      }
      return o;
    }
    case kConcatWs: {
      *valid = true;
      bool first = true;
      for (int c = 0; c < a.k; ++c) {
        const Row x = row_of(a, c, r);
        if (!x.valid) continue;
        if (!first) put<kWrite>(dst, o, a.lit, a.lit_len);
        put<kWrite>(dst, o, x.p, x.len);
        first = false;
      }
      return o;
    }
    case kSelect: {
      const int c = a.choice[r];
      if (c < 0 || c >= a.k) {
        *valid = false;
        return 0;
      }
      const Row x = row_of(a, c, r);
      *valid = x.valid;
      if (x.valid) put<kWrite>(dst, o, x.p, x.len);
      return o;
    }
    default:
      break;
  }
  const Row x = row_of(a, 0, r);
  *valid = x.valid;
  if (!x.valid) return 0;
  switch (a.op) {
    case kPad: {
      int64_t chars = 0;
      for (int32_t j = 0; j < x.len; ++j) chars += lead_byte(x.p[j]);
      const int64_t target = a.arg > 0 ? a.arg : 0;
      const int64_t keep_chars = chars < target ? chars : target;
      const int64_t pad = a.lit_len > 0 && target > chars ? target - chars : 0;
      // the kept prefix ends at the start of character keep_chars (bytes
      // before the first lead byte have rank -1 and are always kept)
      int32_t keep = x.len;
      int64_t k = 0;
      for (int32_t j = 0; j < x.len; ++j) {
        if (!lead_byte(x.p[j])) continue;
        if (k == keep_chars) {
          keep = j;
          break;
        }
        ++k;
      }
      if (!a.left) put<kWrite>(dst, o, x.p, keep);
      if (kWrite) {
        for (int64_t i = 0; i < pad; ++i) dst[o + i] = a.lit[i % a.lit_len];
      }
      o += pad;
      if (a.left) put<kWrite>(dst, o, x.p, keep);
      return o;
    }
    case kRepeat: {
      if (!kWrite) {
        const int64_t copies = a.arg < kMaxLen ? a.arg : kMaxLen;
        return copies > 0 ? x.len * copies : 0;
      }
      for (int64_t i = 0; i < a.arg; ++i) put<kWrite>(dst, o, x.p, x.len);
      return o;
    }
    case kReplace: {
      const int m = a.lit_len;
      const uint8_t* repl = a.lit + m;
      int32_t j = 0;
      while (j < x.len) {
        if (j + m <= x.len && match_at(x.p + j, a.lit, m)) {
          put<kWrite>(dst, o, repl, a.lit2_len);
          j += m;
        } else {
          put<kWrite>(dst, o, x.p + j, 1);
          ++j;
        }
      }
      return o;
    }
    case kReverse: {
      if (kWrite) {
        // characters [cs, e): one starts at the row's start and at every
        // later lead byte; each lands at len - e, its bytes in order
        int32_t cs = 0;
        for (int32_t j = 1; j <= x.len; ++j) {
          if (j < x.len && !lead_byte(x.p[j])) continue;
          for (int32_t q = cs; q < j; ++q) dst[x.len - j + (q - cs)] = x.p[q];
          cs = j;
        }
      }
      return x.len;
    }
    default: {       // kTranslate
      const uint8_t* map = a.lit;
      const uint8_t* drop = a.lit + 256;
      for (int32_t j = 0; j < x.len; ++j) {
        const uint8_t byte = x.p[j];
        if (drop[byte]) continue;
        if (kWrite) dst[o] = map[byte];
        ++o;
      }
      return o;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
assemble_count_kernel(Assemble a, int64_t n, int32_t* __restrict__ lengths,
                      uint8_t* __restrict__ out_valid) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  bool valid;
  const int64_t len = assemble_row<false>(a, r, nullptr, &valid);
  lengths[r] = static_cast<int32_t>(len < kMaxLen ? len : kMaxLen);
  out_valid[r] = valid;
}

__global__ void __launch_bounds__(kThreads)
assemble_write_kernel(Assemble a, int64_t n,
                      const int32_t* __restrict__ out_offsets,
                      uint8_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  if (out_offsets[r + 1] == out_offsets[r]) return;
  bool valid;
  assemble_row<true>(a, r, out + out_offsets[r], &valid);
}

// -- K4 -----------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
case_map_kernel(int mode, const int32_t* __restrict__ offsets,
                const uint8_t* __restrict__ data, int64_t n,
                const uint8_t* __restrict__ lut, uint8_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t s = offsets[r];
  const int32_t e = offsets[r + 1];
  // the byte before, as the reference's buffer holds it
  uint8_t prev = s == offsets[0] ? 0 : data[s - 1];
  for (int32_t q = s; q < e; ++q) {
    const uint8_t b = data[q];
    uint8_t y = b;
    switch (mode) {
      case kUpper:
        if ((b >= 'a' && b <= 'z') ||
            (prev == 0xC3 && b >= 0xA0 && b <= 0xBE && b != 0xB7)) {
          y = b - 32;
        }
        break;
      case kLower:
        if ((b >= 'A' && b <= 'Z') ||
            (prev == 0xC3 && b >= 0x80 && b <= 0x9E && b != 0x97)) {
          y = b + 32;
        }
        break;
      case kInitCap: {
        const bool after_space = q == s || prev == 0x20;
        if (b >= 'a' && b <= 'z' && after_space) y = b - 32;
        if (b >= 'A' && b <= 'Z' && !after_space) y = b + 32;
        break;
      }
      default:
        y = lut[b];
        break;
    }
    out[q] = y;
    prev = b;
  }
}

}  // namespace

extern "C" {

// K1.  mode: ScanMode.  out_i32[n]: kCharLength and kLocate's values, the
// trims' kept lengths, which become the new offsets (n + 1 slots, scanned
// in place; totals[0] the byte total, which the caller reads back);
// out_b[n]: the literal tests' flags; starts[n]: the trims' kept source
// starts, for srt_gather_bytes.  pat[m] on the device; start0 >= 0.
// tile_sums holds ceil(n / srt_scan_tile()) int64 (at least one), for the
// trims.
int srt_string_row_scan(int mode, const int32_t* offsets, const uint8_t* data,
                        const uint8_t* valid, int64_t n, const uint8_t* pat,
                        int m, int start0, int32_t* out_i32, uint8_t* out_b,
                        int32_t* starts, int64_t* tile_sums, int64_t* totals,
                        cudaStream_t stream) {
  if (mode < kCharLength || mode > kRTrim || m < 0 || start0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    row_scan_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        mode, offsets, data, valid, n, pat, m, start0, out_i32, out_b, starts);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || mode < kTrim) return err;
  scan::ScanCols cols{};
  cols.v[0] = out_i32;
  return scan::scan_columns(cols, 1, n, tile_sums, totals, stream);
}

// K2.  table[states * 256] and accept[states] (uint8) on the device;
// out[n] (bool) receives accept[the state after the row's bytes].
int srt_string_dfa_match(const int32_t* offsets, const uint8_t* data,
                         int64_t n, const uint8_t* table,
                         const uint8_t* accept, int states, int start,
                         uint8_t* out, cudaStream_t stream) {
  if (states < 1 || states > 255 || start < 0 || start >= states) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = states * 257;
  cudaError_t err = cudaFuncSetAttribute(
      dfa_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t want = grid_rows(n);
    const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
    dfa_match_kernel<<<static_cast<unsigned>(want < cap ? want : cap),
                       kThreads, smem, stream>>>(offsets, data, n, table,
                                                 accept, states, start, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3, pass 1.  desc[k * 3] (int64, on the device): each input's offsets,
// bytes and validity pointers; choice[n] (int32, kSelect only); lit on
// the device.  out_offsets[n + 1] (int32) receives each row's length,
// scanned in place into the new offsets, out_valid[n] each row's
// validity, totals[0] (int64) the byte total (a row's length saturates at
// 2**31 - 1).  tile_sums holds ceil(n / srt_scan_tile()) int64, at least
// one.
int srt_string_assemble_count(int op, int k, const int64_t* desc, int64_t n,
                              const int32_t* choice, const uint8_t* lit,
                              int lit_len, int lit2_len, int64_t arg,
                              int left, int32_t* out_offsets,
                              uint8_t* out_valid, int64_t* tile_sums,
                              int64_t* totals, cudaStream_t stream) {
  if (op < kConcat || op > kTranslate || k < 1 || lit_len < 0 ||
      lit2_len < 0 || (op == kReplace && lit_len < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Assemble a{op, k, desc, choice, lit, lit_len, lit2_len, arg, left};
  if (n > 0) {
    assemble_count_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        a, n, out_offsets, out_valid);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan::ScanCols cols{};
  cols.v[0] = out_offsets;
  return scan::scan_columns(cols, 1, n, tile_sums, totals, stream);
}

// K3, pass 2: the same arguments, the scanned out_offsets, and out[total].
int srt_string_assemble_write(int op, int k, const int64_t* desc, int64_t n,
                              const int32_t* choice, const uint8_t* lit,
                              int lit_len, int lit2_len, int64_t arg,
                              int left, const int32_t* out_offsets,
                              uint8_t* out, cudaStream_t stream) {
  if (op < kConcat || op > kTranslate || k < 1 || lit_len < 0 ||
      lit2_len < 0 || (op == kReplace && lit_len < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Assemble a{op, k, desc, choice, lit, lit_len, lit2_len, arg, left};
  if (n > 0) {
    assemble_write_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        a, n, out_offsets, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4.  mode: CaseMode; lut[256] on the device (kByteMap only); out has
// data's size and receives the rows' bytes at their own positions.
int srt_string_case_map(int mode, const int32_t* offsets, const uint8_t* data,
                        int64_t n, const uint8_t* lut, uint8_t* out,
                        cudaStream_t stream) {
  if (mode < kUpper || mode > kByteMap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    case_map_kernel<<<grid_rows(n), kThreads, 0, stream>>>(mode, offsets, data,
                                                           n, lut, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
