// One row of the Decimal128 kernels of csrc/decimal.cu: the elementwise
// add, subtract, multiply, rescale and cast to double, and the exact
// divide.  The functions are plain __device__ code over csrc/int128.cuh's
// 128-bit integers, kept apart from the launches.
#pragma once

#include <cstdint>

#include "int128.cuh"

namespace dec {

using i128::s128;
using i128::u128;
using i128::U256;

// decimal128_binary's op codes (kernels/decimal.py ADD ...)
enum : int { kAdd = 0, kSub = 1, kMul = 2, kRescale = 3, kToDouble = 4 };

// precision modes below 1 (kernels/decimal.py INT128, WRAP)
constexpr int kInt128 = 0;
constexpr int kWrap = -1;

struct Result {
  s128 v;       // the exact result modulo 2**128
  bool over;    // its exact magnitude is >= 2**127
};

__device__ __forceinline__ Result signed_low(const U256& mag, bool neg) {
  const u128 lo = i128::low(mag);
  return Result{static_cast<s128>(neg ? u128(0) - lo : lo),
                i128::past_int128(mag)};
}

// v * 10**k, exactly (a 256-bit magnitude product)
__device__ __forceinline__ Result scale_up(s128 v, int k) {
  if (k == 0) return Result{v, false};
  return signed_low(i128::mul_full(i128::magnitude(v), i128::ten_to(k)),
                    v < 0);
}

// whether `precision`'s rule nulls the result
__device__ __forceinline__ bool nulls(const Result& r, int precision) {
  if (precision < 0) return false;
  if (precision == kInt128) return r.over;
  return r.over || i128::too_wide(r.v, precision);
}

// add / subtract at the operands' rescales, multiply, or rescale
__device__ __forceinline__ Result binary_row(int op, s128 a, s128 b, int ka,
                                             int kb) {
  if (op == kRescale) return scale_up(a, ka);
  if (op == kMul) {
    return signed_low(i128::mul_full(i128::magnitude(a), i128::magnitude(b)),
                      (a < 0) != (b < 0));
  }
  const Result x = scale_up(a, ka);
  const Result y = scale_up(b, kb);
  const u128 ux = static_cast<u128>(x.v), uy = static_cast<u128>(y.v);
  const s128 s = static_cast<s128>(op == kAdd ? ux + uy : ux - uy);
  const bool sx = x.v < 0, sy = y.v < 0;
  // two's complement overflow of the wrapped add / subtract
  const bool flip = op == kAdd ? sx == sy : sx != sy;
  return Result{s, x.over || y.over || (flip && (s < 0) != sx)};
}

// the reference's to_double(v) / 10**scale: |v|'s high word times 2**64
// plus its low word, each word rounded to double, one rounding in the sum,
// the sign, then an IEEE division (no contraction into an FMA)
__device__ __forceinline__ double to_double_row(s128 v, double divisor) {
  const u128 m = i128::magnitude(v);
  const double high = __ull2double_rn(static_cast<uint64_t>(m >> 64));
  double f = __dadd_rn(__dmul_rn(high, 18446744073709551616.0),
                       __ull2double_rn(static_cast<uint64_t>(m)));
  if (v < 0) f = -f;
  return __ddiv_rn(f, divisor);
}

__device__ __forceinline__ int bit_length(const U256& x) {
  for (int w = 3; w >= 0; --w) {
    if (x.w[w] != 0) {
      return 64 * w + 64 - __clzll(static_cast<long long>(x.w[w]));
    }
  }
  return 0;
}

struct Quotient {
  Result q;
  bool zero_divisor;
};

// (a * 10**shift) / d with one rounding (HALF_UP, or toward zero): the
// numerator's magnitude exact in 256 bits (past shift 38 through a checked
// 128-bit product first, as div128_by_128 :427-433 does), then binary long
// division by |d| from the numerator's top bit; the remainder stays below
// |d| <= 2**127, so shifting it never leaves 128 bits
__device__ __forceinline__ Quotient divide_row(s128 a, s128 d, int shift,
                                               bool half_up) {
  const bool zero = d == 0;
  const bool neg = (a < 0) != (d < 0);
  u128 m = i128::magnitude(a);
  const u128 md = zero ? u128(1) : i128::magnitude(d);
  bool over = false;
  if (shift > i128::kMaxPrecision) {
    const U256 p =
        i128::mul_full(m, i128::ten_to(shift - i128::kMaxPrecision));
    over = i128::past_int128(p);
    m = i128::low(p);
    shift = i128::kMaxPrecision;
  }
  const U256 num = i128::mul_full(m, i128::ten_to(shift));
  U256 q{{0, 0, 0, 0}};
  u128 r = 0;
  for (int j = bit_length(num) - 1; j >= 0; --j) {
    r = (r << 1) | ((num.w[j >> 6] >> (j & 63)) & 1u);
    if (r >= md) {
      r -= md;
      q.w[j >> 6] |= 1ull << (j & 63);
    }
  }
  if (half_up && (r << 1) >= md) {
    for (int w = 0; w < 4; ++w) {
      if (++q.w[w] != 0) break;
    }
  }
  Result res = signed_low(q, neg);
  res.over = res.over || over;
  return Quotient{res, zero};
}

}  // namespace dec
