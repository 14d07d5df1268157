// Decimal128 elementwise kernels of the port: two-limb add, subtract,
// multiply, rescale and the cast to double, and the exact divide.  Built
// for sm_90a by kernels/_lib.py and called through ctypes from
// kernels/decimal.py.  Every entry point launches on the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// A Decimal128 row is int64 [2], its (low, high) limbs; an operand may be a
// Decimal64's int64 instead, widened as it is read (csrc/int128.cuh).  The
// per-row arithmetic is in csrc/decimal.cuh.
//
// decimal128_binary <- spark_rapids_tpu/kernels/decimal.py:64 add128, :77
//                      sub128, :71 neg128, :119 mul128, :237 mul128_checked,
//                      :139 overflow, :189 rescale (scale up), :209 to_double
//   The reference spells 128-bit arithmetic out over two int64 limb planes
//   with 32-bit halves, one XLA op a step.  Here one thread takes one row
//   and nvcc's __int128 does the limb work in registers: an op code picks
//   add or subtract (each operand first rescaled by its 10**k), the checked
//   multiply (the exact 256-bit magnitude product, so the overflow test is
//   exact, as mul128_checked's is), a rescale by 10**k (k <= 38; the same
//   exact product, where the reference multiplies in wrapping steps of
//   10**18), or the cast to double.  The result's validity is the inputs'
//   less Spark's non-ANSI overflow at the result precision (|v| >=
//   10**p, or past int128); a null row's limbs are zero.
//   Bound: bytes: 8 or 16 bytes of each operand and 1 byte of each
//   validity read, 8 or 16 bytes and 1 byte written per row; a multiply
//   is four 64 x 64 products a row, far below the card's rate.
//
// decimal128_divide <- spark_rapids_tpu/kernels/decimal.py:409
//                      div128_by_128, :174 div128_small, :189 rescale
//                      (scale down, HALF_UP)
//   (a * 10**shift) / b with one rounding: the numerator exact in 256
//   bits, binary long division by the 128-bit |b|, HALF_UP (or toward
//   zero: the cast to an integral type); a zero divisor gives null, as a
//   quotient past int128 or 10**p does.  One thread a row.  The divisor
//   is a column (a decimal, or avg's per-group count) or one constant
//   (10**k of a rescale down).  The reference's divide runs 256 steps
//   under a fori_loop for every row; here a thread starts at its
//   numerator's top bit, so a rescale of small values takes few steps.
//   Bound: bytes, as decimal128_binary's, where the steps stay few (a
//   rescale, avg's finalize); a / c over whole batches takes ~100-200
//   steps a row of a few 128-bit operations each, and is bound by the
//   card's integer rate instead.
#include <cstdint>
#include <cuda_runtime.h>

#include "decimal.cuh"

namespace {

using i128::s128;

constexpr int kThreads = 256;

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

__global__ void __launch_bounds__(kThreads)
binary_kernel(int op, const int64_t* __restrict__ a, bool a_two,
              const uint8_t* __restrict__ a_valid,
              const int64_t* __restrict__ b, bool b_two,
              const uint8_t* __restrict__ b_valid, int64_t n, int ka, int kb,
              int precision, bool out_two, double divisor,
              void* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  bool valid = a_valid[i] != 0 && (b_valid == nullptr || b_valid[i] != 0);
  const s128 x = i128::load(a, a_two, i);
  if (op == dec::kToDouble) {
    static_cast<double*>(out)[i] = valid ? dec::to_double_row(x, divisor)
                                         : 0.0;
    out_valid[i] = valid;
    return;
  }
  const s128 y = b != nullptr ? i128::load(b, b_two, i) : s128(0);
  const dec::Result r = dec::binary_row(op, x, y, ka, kb);
  valid = valid && !dec::nulls(r, precision);
  i128::store(static_cast<int64_t*>(out), out_two, i, valid ? r.v : s128(0));
  out_valid[i] = valid;
}

__global__ void __launch_bounds__(kThreads)
divide_kernel(const int64_t* __restrict__ a, bool a_two,
              const uint8_t* __restrict__ a_valid,
              const int64_t* __restrict__ b, bool b_two,
              const uint8_t* __restrict__ b_valid, uint64_t b_lo,
              uint64_t b_hi, int64_t n,
              int shift, int precision, bool half_up, bool out_two,
              int64_t* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  bool valid = a_valid[i] != 0 && (b_valid == nullptr || b_valid[i] != 0);
  const s128 d = b != nullptr ? i128::load(b, b_two, i)
                              : static_cast<s128>(i128::make(b_lo, b_hi));
  const dec::Quotient q =
      dec::divide_row(i128::load(a, a_two, i), d, shift, half_up);
  valid = valid && !q.zero_divisor && !dec::nulls(q.q, precision);
  i128::store(out, out_two, i, valid ? q.q.v : s128(0));
  out_valid[i] = valid;
}

bool bad_precision(int precision, int lowest) {
  return precision < lowest || precision > i128::kMaxPrecision;
}

}  // namespace

extern "C" {

// op: kernels/decimal.py ADD ... TO_DOUBLE; a, b: int64 [n] (two = 0) or
// [n, 2] (two = 1); b and b_valid null for RESCALE and TO_DOUBLE (and
// any pointer of an empty tensor may be null when n = 0); ka, kb:
// the operands' rescales (TO_DOUBLE: ka is the scale and divisor is
// 10.0**ka); precision: > 0, INT128 (0) or WRAP (-1); out: int64 [n, 2]
// (out_two) or [n], float64 [n] for TO_DOUBLE.
int srt_decimal128_binary(int op, const int64_t* a, int a_two,
                          const uint8_t* a_valid, const int64_t* b, int b_two,
                          const uint8_t* b_valid, int64_t n, int ka, int kb,
                          int precision, int out_two, double divisor,
                          void* out, uint8_t* out_valid,
                          cudaStream_t stream) {
  if (op < dec::kAdd || op > dec::kToDouble ||
      ka < 0 || ka > i128::kMaxPrecision || kb < 0 ||
      kb > i128::kMaxPrecision || bad_precision(precision, dec::kWrap) ||
      ((op == dec::kAdd || op == dec::kSub || op == dec::kMul) && n > 0 &&
       (b == nullptr || b_valid == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    binary_kernel<<<static_cast<unsigned>(cdiv(n, kThreads)), kThreads, 0,
                    stream>>>(op, a, a_two != 0, a_valid, b, b_two != 0,
                              b_valid, n, ka, kb, precision, out_two != 0,
                              divisor, out, out_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// b: int64 [n] or [n, 2] with b_valid, or null for the constant
// (b_lo, b_hi) in every row; shift <= 76; precision > 0 or INT128.
int srt_decimal128_divide(const int64_t* a, int a_two, const uint8_t* a_valid,
                          const int64_t* b, int b_two, const uint8_t* b_valid,
                          int64_t b_lo, int64_t b_hi, int64_t n, int shift,
                          int precision, int half_up, int out_two,
                          int64_t* out, uint8_t* out_valid,
                          cudaStream_t stream) {
  if (shift < 0 || shift > 2 * i128::kMaxPrecision ||
      bad_precision(precision, dec::kInt128) ||
      (b != nullptr && b_valid == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    divide_kernel<<<static_cast<unsigned>(cdiv(n, kThreads)), kThreads, 0,
                    stream>>>(a, a_two != 0, a_valid, b, b_two != 0, b_valid,
                              static_cast<uint64_t>(b_lo),
                              static_cast<uint64_t>(b_hi), n, shift,
                              precision, half_up != 0,
                              out_two != 0, out, out_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
