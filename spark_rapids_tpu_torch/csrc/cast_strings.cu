// The string casts of the port: two hand-written kernels behind CAST of a
// string to INT, LONG, SHORT, BYTE, DOUBLE, FLOAT, DATE and BOOLEAN, and of
// an integral, a DATE or a BOOLEAN to a string.  Built for sm_90a by
// kernels/_lib.py and called through ctypes from kernels/cast_strings.py.
// Every entry point launches on the caller's stream, allocates nothing,
// and returns the cudaError_t of its launches.  Row i of a string column is
// data[offsets[i]:offsets[i + 1]] (the offsets need not start at 0).
//
// The reference (spark_rapids_tpu/kernels/cast_strings.py) parses over a
// [capacity, max_len] byte window for XLA: each row's token bounds by
// min / max reductions over the window, the digits by a scan across it,
// and a formatted column built from a [capacity, W] character matrix.
// Here one thread a row walks its row's bytes once, so a row of any length
// parses: the simple first design, in which the longest row sets a warp's
// time and a thread's loads are not coalesced with its neighbours'.
// Spark's non-ANSI legacy cast: an invalid text is NULL, never an error.
//
// C1 string_parse  <- parse_integral :52, parse_double :116 with
//                     _token_matches :102, parse_date :214, parse_bool :269
//   One thread a row trims the bytes <= 0x20 at both ends and parses the
//   token, writing the value (int64, f64, int32 epoch days or bool) and an
//   ok byte; the caller applies the target width's range and the validity.
//   INTEGRAL: an optional sign, digits, an optional fraction that
//   truncates toward zero (".5" and "3." are valid, "." is not); the
//   magnitude accumulates as a negative int64 with Java's Long.parseLong
//   checks, so LONG_MIN parses and an overflow is NULL with no uint64.
//   DOUBLE: the reference's rule, at most 15 significant digits (leading
//   zeros skipped, each further integer digit raises the exponent, each
//   fraction digit taken or skipped as a leading zero lowers it), one
//   'e' / 'E' and 1-9 exponent digits; inf / infinity with an optional
//   sign and nan without one, in any case.  The value is the mantissa
//   times 10**e from kPow10, the correctly rounded doubles float(f"1e{k}")
//   for k in [-400, 400] (0.0 and inf at the ends) in constant memory,
//   which srt_cast_pow10_load fills from the wrapper's table: the
//   reference's jnp.power is not correctly rounded, nor is CUDA's pow().
//   DATE: yyyy[-m[m][-d[d]]], the year exactly 4 digits and >= 1, the day
//   checked against the month and leap years.  BOOL: t / true / y / yes /
//   1 and f / false / n / no / 0, ASCII case-insensitive.
//   Bound: bytes: offsets and bytes read once, the value and ok written.
//
// C2 string_format <- long_to_string :305, date_to_string :323,
//                     bool_to_string :344 (build_string_column :285)
//   Count-then-allocate: pass 1 (srt_string_format_count) writes each
//   row's length and validity (LONG: its digits and a '-', LONG_MIN
//   through its uint64 magnitude; DATE: 10 bytes, NULL outside years
//   [1, 9999]; BOOL: 4 or 5 bytes; a null row 0), the scan of
//   csrc/scan.cuh makes the offsets and the byte total, which the caller
//   reads back; pass 2 (srt_string_format_write) writes each row's bytes.
//   Bound: bytes: the values and validity read once, the offsets,
//   validity and bytes written once.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPowSpan = 400;
constexpr int kSigDigits = 15;
constexpr int kMaxExpDigits = 9;
constexpr int64_t kLongMax = 0x7fffffffffffffffLL;
constexpr int64_t kLongMin = -kLongMax - 1;

enum ParseMode {
  kParseIntegral = 0,
  kParseDouble = 1,
  kParseDate = 2,
  kParseBool = 3,
};

enum FormatMode { kFormatLong = 0, kFormatDate = 1, kFormatBool = 2 };

__constant__ double kPow10[2 * kPowSpan + 1];

unsigned grid_rows(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ bool is_digit(uint8_t c) {
  return c >= '0' && c <= '9';
}

// p[0..len) is word (lower-case ASCII), ASCII case-insensitively
__device__ bool token_is(const uint8_t* p, int64_t len, const char* word,
                         int m) {
  if (len != m) return false;
  for (int i = 0; i < m; ++i) {
    const uint8_t c = p[i] >= 'A' && p[i] <= 'Z' ? p[i] + 32 : p[i];
    if (c != static_cast<uint8_t>(word[i])) return false;
  }
  return true;
}

// -- C1 -----------------------------------------------------------------------

// [p, e) is a token of at least one byte
__device__ bool parse_integral(const uint8_t* p, const uint8_t* e,
                               int64_t* out) {
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = *p == '-';
    ++p;
  }
  const int64_t limit = neg ? kLongMin : -kLongMax;
  const int64_t multmin = limit / 10;
  int64_t acc = 0;       // minus the magnitude
  int64_t digits = 0;
  bool ovf = false;
  for (; p < e && is_digit(*p); ++p, ++digits) {
    const int d = *p - '0';
    if (ovf) continue;
    if (acc < multmin) {
      ovf = true;
      continue;
    }
    acc *= 10;
    if (acc < limit + d) {
      ovf = true;
      continue;
    }
    acc -= d;
  }
  if (p < e && *p == '.') {
    for (++p; p < e && is_digit(*p); ++p) ++digits;
  }
  if (p != e || digits == 0 || ovf) return false;
  *out = neg ? acc : -acc;
  return true;
}

__device__ bool parse_double(const uint8_t* s, const uint8_t* e,
                             double* out) {
  const uint8_t* p = s;
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = *p == '-';
    ++p;
  }
  if (token_is(p, e - p, "inf", 3) || token_is(p, e - p, "infinity", 8)) {
    const double inf = __longlong_as_double(0x7ff0000000000000LL);
    *out = neg ? -inf : inf;
    return true;
  }
  if (token_is(s, e - s, "nan", 3)) {
    *out = __longlong_as_double(0x7ff8000000000000LL);
    return true;
  }
  int64_t mant = 0;
  int64_t e_adj = 0;
  int64_t n_mant = 0;
  int nsig = 0;
  int ndots = 0;
  bool after_dot = false;
  for (; p < e && *p != 'e' && *p != 'E'; ++p) {
    if (*p == '.') {
      ++ndots;
      after_dot = true;
      continue;
    }
    if (!is_digit(*p)) return false;
    ++n_mant;
    const int d = *p - '0';
    if (mant == 0 && d == 0) {          // a leading zero
      if (after_dot) --e_adj;
    } else if (nsig < kSigDigits) {
      mant = mant * 10 + d;
      ++nsig;
      if (after_dot) --e_adj;
    } else if (!after_dot) {
      ++e_adj;
    }
  }
  if (ndots > 1 || n_mant == 0) return false;
  int64_t exp_val = 0;
  if (p < e) {                          // *p is 'e' or 'E'
    ++p;
    bool e_neg = false;
    if (p < e && (*p == '-' || *p == '+')) {
      e_neg = *p == '-';
      ++p;
    }
    int n_exp = 0;
    for (; p < e; ++p) {
      if (!is_digit(*p) || ++n_exp > kMaxExpDigits) return false;
      exp_val = exp_val * 10 + (*p - '0');
    }
    if (n_exp == 0) return false;
    if (e_neg) exp_val = -exp_val;
  }
  int64_t k = exp_val + e_adj;
  k = k < -kPowSpan ? -kPowSpan : (k > kPowSpan ? kPowSpan : k);
  const double v =
      mant == 0 ? 0.0 : static_cast<double>(mant) * kPow10[k + kPowSpan];
  *out = neg ? -v : v;
  return true;
}

// [lo, hi) is min_n to max_n digits; *v their value
__device__ bool digits_value(const uint8_t* lo, const uint8_t* hi, int min_n,
                             int max_n, int64_t* v) {
  if (hi - lo < min_n || hi - lo > max_n) return false;
  int64_t x = 0;
  for (; lo < hi; ++lo) {
    if (!is_digit(*lo)) return false;
    x = x * 10 + (*lo - '0');
  }
  *v = x;
  return true;
}

// expressions/datetime.py _days_from_civil
__device__ int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const int64_t yoe = y - era * 400;
  const int64_t mp = m > 2 ? m - 3 : m + 9;
  const int64_t doy = (153 * mp + 2) / 5 + d - 1;
  const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

__device__ bool parse_date(const uint8_t* p, const uint8_t* e,
                           int32_t* out) {
  const uint8_t* dash[2] = {e, e};
  int nd = 0;
  for (const uint8_t* q = p; q < e; ++q) {
    if (*q != '-') continue;
    if (nd == 2) return false;
    dash[nd++] = q;
  }
  int64_t y, m = 1, d = 1;
  if (!digits_value(p, dash[0], 4, 4, &y) || y < 1) return false;
  if (nd >= 1 && !digits_value(dash[0] + 1, dash[1], 1, 2, &m)) return false;
  if (nd == 2 && !digits_value(dash[1] + 1, e, 1, 2, &d)) return false;
  if (m < 1 || m > 12 || d < 1) return false;
  const bool leap = (y % 4 == 0 && y % 100 != 0) || y % 400 == 0;
  const int dim = m == 2 ? (leap ? 29 : 28)
                         : (m == 4 || m == 6 || m == 9 || m == 11 ? 30 : 31);
  if (d > dim) return false;
  *out = static_cast<int32_t>(days_from_civil(y, m, d));
  return true;
}

__device__ bool parse_bool(const uint8_t* p, const uint8_t* e, bool* t) {
  const int64_t len = e - p;
  *t = token_is(p, len, "t", 1) || token_is(p, len, "true", 4) ||
       token_is(p, len, "y", 1) || token_is(p, len, "yes", 3) ||
       token_is(p, len, "1", 1);
  return *t || token_is(p, len, "f", 1) || token_is(p, len, "false", 5) ||
         token_is(p, len, "n", 1) || token_is(p, len, "no", 2) ||
         token_is(p, len, "0", 1);
}

__global__ void __launch_bounds__(kThreads)
parse_kernel(int mode, const int32_t* __restrict__ offsets,
             const uint8_t* __restrict__ data, int64_t n,
             void* __restrict__ out, uint8_t* __restrict__ ok) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const uint8_t* s = data + offsets[r];
  const uint8_t* e = data + offsets[r + 1];
  while (s < e && *s <= 0x20) ++s;
  while (e > s && e[-1] <= 0x20) --e;
  const bool has = s < e;
  bool good = false;
  switch (mode) {
    case kParseIntegral: {
      int64_t v = 0;
      good = has && parse_integral(s, e, &v);
      static_cast<int64_t*>(out)[r] = good ? v : 0;
      break;
    }
    case kParseDouble: {
      double v = 0.0;
      good = has && parse_double(s, e, &v);
      static_cast<double*>(out)[r] = good ? v : 0.0;
      break;
    }
    case kParseDate: {
      int32_t v = 0;
      good = has && parse_date(s, e, &v);
      static_cast<int32_t*>(out)[r] = good ? v : 0;
      break;
    }
    default: {
      bool t = false;
      good = has && parse_bool(s, e, &t);
      static_cast<uint8_t*>(out)[r] = t;
      break;
    }
  }
  ok[r] = good;
}

// -- C2 -----------------------------------------------------------------------

// expressions/datetime.py _civil_from_days
__device__ void civil_from_days(int64_t z, int64_t* y, int64_t* m,
                                int64_t* d) {
  z += 719468;
  const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  const int64_t doe = z - era * 146097;
  const int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const int64_t mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 400 + (*m <= 2);
}

__device__ __forceinline__ uint64_t magnitude(int64_t v) {
  return v < 0 ? 0ull - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
}

__device__ int long_length(int64_t v) {
  uint64_t mag = magnitude(v);
  int nd = 1;
  for (; mag >= 10; mag /= 10) ++nd;
  return nd + (v < 0);
}

__global__ void __launch_bounds__(kThreads)
format_count_kernel(int mode, const void* __restrict__ vals,
                    const uint8_t* __restrict__ valid, int64_t n,
                    int32_t* __restrict__ lengths,
                    uint8_t* __restrict__ out_valid) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  bool ok = valid[r];
  int len;
  switch (mode) {
    case kFormatLong:
      len = long_length(static_cast<const int64_t*>(vals)[r]);
      break;
    case kFormatDate: {
      int64_t y, m, d;
      civil_from_days(static_cast<const int32_t*>(vals)[r], &y, &m, &d);
      ok = ok && y >= 1 && y <= 9999;
      len = 10;
      break;
    }
    default:
      len = static_cast<const uint8_t*>(vals)[r] ? 4 : 5;
      break;
  }
  lengths[r] = ok ? len : 0;
  out_valid[r] = ok;
}

__global__ void __launch_bounds__(kThreads)
format_write_kernel(int mode, const void* __restrict__ vals, int64_t n,
                    const int32_t* __restrict__ out_offsets,
                    uint8_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int32_t len = out_offsets[r + 1] - out_offsets[r];
  if (len == 0) return;
  uint8_t* dst = out + out_offsets[r];
  switch (mode) {
    case kFormatLong: {
      const int64_t v = static_cast<const int64_t*>(vals)[r];
      uint64_t mag = magnitude(v);
      for (int i = len - 1; i >= (v < 0 ? 1 : 0); --i, mag /= 10) {
        dst[i] = static_cast<uint8_t>('0' + mag % 10);
      }
      if (v < 0) dst[0] = '-';
      break;
    }
    case kFormatDate: {
      int64_t y, m, d;
      civil_from_days(static_cast<const int32_t*>(vals)[r], &y, &m, &d);
      const int64_t digits[8] = {y / 1000, y / 100 % 10, y / 10 % 10, y % 10,
                                 m / 10,   m % 10,       d / 10,      d % 10};
      const int at[8] = {0, 1, 2, 3, 5, 6, 8, 9};
      for (int i = 0; i < 8; ++i) {
        dst[at[i]] = static_cast<uint8_t>('0' + digits[i]);
      }
      dst[4] = '-';
      dst[7] = '-';
      break;
    }
    default: {
      const char* word = len == 4 ? "true" : "false";
      for (int i = 0; i < len; ++i) dst[i] = static_cast<uint8_t>(word[i]);
      break;
    }
  }
}

}  // namespace

extern "C" {

// C1's power table: table[801] (host memory) holds float(f"1e{k}") for k in
// [-400, 400]; copied into the current device's constant memory.
int srt_cast_pow10_load(const double* table) {
  return static_cast<int>(cudaMemcpyToSymbol(kPow10, table, sizeof(kPow10)));
}

// C1.  mode: ParseMode.  out[n] receives int64 (INTEGRAL), f64 (DOUBLE),
// int32 epoch days (DATE) or bool (BOOL) values, 0 where not ok; ok[n]
// whether the row's text parses.  DOUBLE needs srt_cast_pow10_load first.
int srt_string_parse(int mode, const int32_t* offsets, const uint8_t* data,
                     int64_t n, void* out, uint8_t* ok,
                     cudaStream_t stream) {
  if (mode < kParseIntegral || mode > kParseBool) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    parse_kernel<<<grid_rows(n), kThreads, 0, stream>>>(mode, offsets, data,
                                                        n, out, ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// C2, pass 1.  mode: FormatMode; vals[n] int64 (LONG), int32 epoch days
// (DATE) or bool (BOOL), valid[n].  out_offsets[n + 1] (int32) receives
// each row's length, scanned in place into the offsets, out_valid[n] each
// row's validity, totals[0] (int64) the byte total.  tile_sums holds
// ceil(n / srt_scan_tile()) int64, at least one.
int srt_string_format_count(int mode, const void* vals, const uint8_t* valid,
                            int64_t n, int32_t* out_offsets,
                            uint8_t* out_valid, int64_t* tile_sums,
                            int64_t* totals, cudaStream_t stream) {
  if (mode < kFormatLong || mode > kFormatBool) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    format_count_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        mode, vals, valid, n, out_offsets, out_valid);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan::ScanCols cols{};
  cols.v[0] = out_offsets;
  return scan::scan_columns(cols, 1, n, tile_sums, totals, stream);
}

// C2, pass 2: the values, the scanned out_offsets, and out[total].
int srt_string_format_write(int mode, const void* vals, int64_t n,
                            const int32_t* out_offsets, uint8_t* out,
                            cudaStream_t stream) {
  if (mode < kFormatLong || mode > kFormatBool) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    format_write_kernel<<<grid_rows(n), kThreads, 0, stream>>>(
        mode, vals, n, out_offsets, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
