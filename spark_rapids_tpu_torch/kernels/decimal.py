"""Decimal128 arithmetic: two-limb add, subtract, multiply, rescale, the
cast to double, and the exact divide.

Counterpart of ``spark_rapids_tpu/kernels/decimal.py``: ``add128`` :64,
``sub128`` :77, ``neg128`` :71, ``mul128`` :119, ``mul128_checked``
:237, ``overflow`` :139, ``rescale`` :189 and ``to_double`` :209 are
``decimal128_binary``; ``div128_by_128`` :409, ``div128_small`` :174 and
the scale-down branch of ``rescale`` are ``decimal128_divide``.  The
elementwise helpers ``widen64`` :52, ``narrow64`` :58, ``lt128`` /
``eq128`` :92-98 and ``const_col128`` :462 are plain PyTorch here.

A Decimal128 column holds int64 ``[n, 2]``: each row's (low, high) limbs
of its 128-bit two's complement unscaled value (``columnar/column.py``).
An operand may also be a Decimal64's int64 ``[n]``, which the kernels
widen as they read it.  Overflow is Spark's non-ANSI rule: a result whose
magnitude reaches 10**precision is null.  ``precision`` selects it:

  * p > 0: null where the exact result is >= 2**127 in magnitude or
    |result| >= 10**p;
  * ``INT128`` (0): null only where the exact result leaves int128 (a
    product that a rescale down brings back in range afterwards);
  * ``WRAP`` (-1): never null; the result is the exact value modulo
    2**128, as the reference's wrapping ``mul128`` gives it (the
    comparison's rescale to the common scale).

A null result's limbs are zero.

On CUDA tensors each wrapper launches its kernel of ``csrc/decimal.cu``
and counts the launch under its own name; on CPU tensors it runs the
plain version beside it: the reference's algorithms over int64 tensors
holding 16-bit digits (torch has no int128, and on the CPU no uint64
add, shift or remainder), which ``chip_smoke.py`` holds the kernels to
bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch.columnar.column import const128
from spark_rapids_tpu_torch.kernels import _lib

#: op codes of decimal128_binary (csrc/decimal.cu kAdd ...)
ADD, SUB, MUL, RESCALE, TO_DOUBLE = range(5)
_OPS = {ADD: "add", SUB: "sub", MUL: "mul", RESCALE: "rescale",
        TO_DOUBLE: "to_double"}
INT128, WRAP = 0, -1
MAX_PRECISION = 38
POW10 = [10 ** k for k in range(2 * MAX_PRECISION + 1)]

_BITS = 16
_MASK = (1 << _BITS) - 1
_LIMB_DIGITS = 4            # 16-bit digits in a 64-bit limb

# ---------------------------------------------------------------------------
# elementwise helpers (plain PyTorch on every device)


def limbs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) int64 limbs of a Decimal128 ``[n, 2]`` or a widened
    Decimal64 ``[n]`` (``widen64``: the high limb is the sign)."""
    if x.dim() == 2:
        return x[:, 0], x[:, 1]
    x = x.to(torch.int64)
    return x, x >> 63


def widen64(x: torch.Tensor) -> torch.Tensor:
    """int64 [n] -> the Decimal128 [n, 2] of the same value."""
    lo, hi = limbs(x)
    return torch.stack([lo, hi], 1)


def narrow64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decimal128 [n, 2] -> (its low limb, whether the value fits int64)."""
    lo, hi = x[:, 0], x[:, 1]
    return lo, hi == (lo >> 63)


def const_col128(value: int, n: int, device) -> torch.Tensor:
    """A Python int in every row of an [n, 2] Decimal128 plane."""
    return torch.tensor(const128(value), dtype=torch.int64,
                        device=device).repeat(n, 1)


def _unsigned_key(lo: torch.Tensor) -> torch.Tensor:
    """int64 keys in the unsigned order of the low limbs."""
    return lo ^ torch.iinfo(torch.int64).min


def lt128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed a < b over two [n, 2] planes (high limb signed, low
    unsigned)."""
    return (a[:, 1] < b[:, 1]) | ((a[:, 1] == b[:, 1]) & (
        _unsigned_key(a[:, 0]) < _unsigned_key(b[:, 0])))


def eq128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[:, 0] == b[:, 0]) & (a[:, 1] == b[:, 1])

# ---------------------------------------------------------------------------
# multi-word integers over 16-bit digits (int64 tensors, little-endian)


def _digits(lo: torch.Tensor, hi: torch.Tensor) -> List[torch.Tensor]:
    """The 128 bits of (lo, hi) as eight unsigned 16-bit digits."""
    return [(w >> (_BITS * j)) & _MASK for w in (lo, hi)
            for j in range(_LIMB_DIGITS)]


def _join(d: Sequence[torch.Tensor]) -> torch.Tensor:
    """The low eight digits as an [n, 2] pair of int64 limbs (wrapping)."""
    out = []
    for w in range(2):
        v = d[_LIMB_DIGITS * w]
        for j in range(1, _LIMB_DIGITS):
            v = v | (d[_LIMB_DIGITS * w + j] << (_BITS * j))
        out.append(v)
    return torch.stack(out, 1)


def _normalize(cols: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Carry columns of non-negative sums into digits (the last carry is
    dropped: the caller sized the columns)."""
    out, carry = [], None
    for c in cols:
        t = c if carry is None else c + carry
        out.append(t & _MASK)
        carry = t >> _BITS
    return out


def _negate(d: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Two's complement negation modulo 2**(16 * len(d))."""
    cols = [_MASK - x for x in d]
    cols[0] = cols[0] + 1
    return _normalize(cols)


def _negate_where(d: Sequence[torch.Tensor], neg: torch.Tensor
                  ) -> List[torch.Tensor]:
    """The digits negated (two's complement) where ``neg`` holds: the
    magnitude of a signed vector whose sign is ``neg`` (|-2**127| is
    2**127, unsigned), or a magnitude given the sign ``neg``."""
    nd = _negate(d)
    return [torch.where(neg, b, a) for a, b in zip(d, nd)]


def _const_digits(value: int, count: int) -> List[int]:
    return [(value >> (_BITS * j)) & _MASK for j in range(count)]


def _mul(a: Sequence, b: Sequence) -> List[torch.Tensor]:
    """Full product of two digit vectors (tensors or Python ints):
    len(a) + len(b) digits.  A column sums at most eight 32-bit products,
    well inside int64."""
    cols: List = [0] * (len(a) + len(b))
    for j, bj in enumerate(b):
        if isinstance(bj, int) and bj == 0:
            continue
        for i, ai in enumerate(a):
            cols[i + j] = cols[i + j] + ai * bj
    like = next(x for x in list(a) + list(b) if isinstance(x, torch.Tensor))
    cols = [c if isinstance(c, torch.Tensor) else torch.full_like(like, c)
            for c in cols]
    return _normalize(cols)


def _any_nonzero(d: Sequence[torch.Tensor]) -> torch.Tensor:
    out = d[0] != 0
    for x in d[1:]:
        out = out | (x != 0)
    return out


def _ge_const(d: Sequence[torch.Tensor], value: int) -> torch.Tensor:
    """Unsigned d >= value: no borrow out of d - value."""
    borrow = torch.zeros_like(d[0])
    for x, c in zip(d, _const_digits(value, len(d))):
        borrow = ((x - c - borrow) < 0).to(torch.int64)
    return borrow == 0


def _high_bit(d: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bit 127 of an eight-digit vector."""
    return (d[7] >> (_BITS - 1)) != 0


def _scaled(d: Sequence[torch.Tensor], neg: torch.Tensor, k: int
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(v * 10**k modulo 2**128 as digits, |v * 10**k| >= 2**127)."""
    if k == 0:
        return list(d), torch.zeros_like(neg)
    p = _mul(_negate_where(d, neg), _const_digits(POW10[k], 8))
    over = _any_nonzero(p[8:]) | _high_bit(p)
    return _negate_where(p[:8], neg), over


def _too_wide(d: Sequence[torch.Tensor], neg: torch.Tensor,
              precision: int) -> torch.Tensor:
    """|v| >= 10**precision, for a signed eight-digit v (precision > 0;
    -2**127 counts, its magnitude is 2**127)."""
    return _ge_const(_negate_where(d, neg), POW10[precision])


def _null_rule(over: torch.Tensor, d: Sequence[torch.Tensor],
               neg: torch.Tensor, precision: int) -> torch.Tensor:
    """Where the result is null by ``precision``'s rule."""
    if precision < 0:
        return torch.zeros_like(over)
    if precision == 0:
        return over
    return over | _too_wide(d, neg, precision)


def _output(d: Sequence[torch.Tensor], valid: torch.Tensor,
            out_two: bool) -> torch.Tensor:
    out = _join(d)
    out = torch.where(valid[:, None], out, torch.zeros((), dtype=torch.int64,
                                                       device=out.device))
    return out if out_two else out[:, 0].contiguous()

# ---------------------------------------------------------------------------
# decimal128_binary


def _u64_to_double(x: torch.Tensor) -> torch.Tensor:
    """int64 bits read unsigned -> the nearest double (the high 32 bits
    times 2**32 is exact, so the one addition is the one rounding)."""
    hi = ((x >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (x & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + lo


def _ten_to(k: int) -> float:
    """10**k as the reference divides by it (``10.0 ** scale``)."""
    return 10.0 ** k


def decimal128_binary_plain(op: int, a: torch.Tensor, a_valid: torch.Tensor,
                            b: Optional[torch.Tensor] = None,
                            b_valid: Optional[torch.Tensor] = None,
                            ka: int = 0, kb: int = 0,
                            precision: int = MAX_PRECISION,
                            out_two: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    valid = a_valid if b_valid is None else a_valid & b_valid
    alo, ahi = limbs(a)
    ad = _digits(alo, ahi)
    aneg = ahi < 0
    if op == TO_DOUBLE:
        mag = _join(_negate_where(ad, aneg))
        f = _u64_to_double(mag[:, 1]) * 18446744073709551616.0 + \
            _u64_to_double(mag[:, 0])
        f = torch.where(aneg, -f, f)
        f = f / torch.full((), _ten_to(ka), dtype=torch.float64,
                           device=f.device)
        return torch.where(valid, f, torch.zeros((), dtype=torch.float64,
                                                 device=f.device)), valid
    if op == RESCALE:
        d, over = _scaled(ad, aneg, ka)
    else:
        blo, bhi = limbs(b)
        bd = _digits(blo, bhi)
        bneg = bhi < 0
        if op == MUL:
            p = _mul(_negate_where(ad, aneg), _negate_where(bd, bneg))
            over = _any_nonzero(p[8:]) | _high_bit(p)
            d = _negate_where(p[:8], aneg ^ bneg)
        else:
            ad, ova = _scaled(ad, aneg, ka)
            bd, ovb = _scaled(bd, bneg, kb)
            sa, sb = _high_bit(ad), _high_bit(bd)
            if op == SUB:
                bd = _negate(bd)
            d = _normalize([x + y for x, y in zip(ad, bd)])
            s = _high_bit(d)
            flip = (sa == sb) if op == ADD else (sa != sb)
            over = ova | ovb | (flip & (s != sa))
    null = _null_rule(over, d, _high_bit(d), precision)
    valid = valid & ~null
    return _output(d, valid, out_two), valid


def _check_operand(name: str, x: torch.Tensor, valid: torch.Tensor) -> None:
    if x.dtype != torch.int64 or not (
            x.dim() == 1 or (x.dim() == 2 and x.shape[1] == 2)):
        raise TypeError(f"{name}: an operand is int64 [n] or [n, 2], got "
                        f"{x.dtype} {tuple(x.shape)}")
    if valid.dtype != torch.bool or valid.shape != x.shape[:1]:
        raise ValueError(f"{name}: validity must be bool [{x.shape[0]}]")


def _check_k(name: str, k: int) -> None:
    if not 0 <= k <= MAX_PRECISION:
        raise ValueError(f"{name}: a rescale is by 10**k, 0 <= k <= 38, "
                         f"not {k}")


def decimal128_binary(op: int, a: torch.Tensor, a_valid: torch.Tensor,
                      b: Optional[torch.Tensor] = None,
                      b_valid: Optional[torch.Tensor] = None,
                      ka: int = 0, kb: int = 0,
                      precision: int = MAX_PRECISION,
                      out_two: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One elementwise Decimal128 op -> (result, validity).

    ``op`` ADD / SUB: (a * 10**ka) +/- (b * 10**kb); MUL: a * b (exact
    256-bit product); RESCALE: a * 10**ka; TO_DOUBLE: the float64 nearest
    the reference's ``to_double(a) / 10**ka`` (an IEEE division by an
    exact double, not a multiply by its reciprocal).  Operands are int64
    [n] (one limb) or [n, 2]; the result is [n, 2], or with ``out_two``
    False its low limb [n] (a result of precision <= 18), or float64 [n]
    for TO_DOUBLE.  Validity: the operands', less the rows that
    ``precision`` nulls (see the module's docstring)."""
    if op not in _OPS:
        raise ValueError(f"decimal128_binary: unknown op {op}")
    _check_operand("decimal128_binary", a, a_valid)
    _check_k("decimal128_binary", ka)
    _check_k("decimal128_binary", kb)
    binary = op in (ADD, SUB, MUL)
    if binary:
        if b is None or b_valid is None:
            raise ValueError(f"decimal128_binary: {_OPS[op]} takes b")
        _check_operand("decimal128_binary", b, b_valid)
        if b.shape[0] != a.shape[0]:
            raise ValueError("decimal128_binary: operands differ in length")
    elif b is not None:
        raise ValueError(f"decimal128_binary: {_OPS[op]} takes one operand")
    if precision > MAX_PRECISION or precision < WRAP:
        raise ValueError(f"decimal128_binary: precision {precision}")
    if a.device.type == "cpu":
        return decimal128_binary_plain(op, a, a_valid, b, b_valid, ka, kb,
                                       precision, out_two)
    ts = [a, a_valid] + ([b, b_valid] if binary else [])
    _lib.require_cuda("decimal128_binary", *ts)
    n, dev = a.shape[0], a.device
    if op == TO_DOUBLE:
        out = torch.empty(n, dtype=torch.float64, device=dev)
    else:
        out = torch.empty((n, 2) if out_two else n, dtype=torch.int64,
                          device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    _lib.check(_lib.lib().srt_decimal128_binary(
        op, _lib.ptr(a), int(a.dim() == 2), _lib.ptr(a_valid),
        _lib.ptr(b) if binary else None, int(binary and b.dim() == 2),
        _lib.ptr(b_valid) if binary else None, n, ka, kb, precision,
        int(out_two), _ten_to(ka), _lib.ptr(out), _lib.ptr(valid),
        _lib.stream(dev)),
        "decimal128_binary")
    if n:
        _lib.LAUNCHES["decimal128_binary"] += 1
    return out, valid

# ---------------------------------------------------------------------------
# decimal128_divide

_L48 = 48
_M48 = (1 << _L48) - 1


def _to48(d: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Eight 16-bit digits -> three 48-bit limbs."""
    return [d[i] | (d[i + 1] << 16) | (d[i + 2] << 32) if i + 2 < 8
            else d[i] | (d[i + 1] << 16) for i in (0, 3, 6)]


def _bit_length(d: Sequence[torch.Tensor]) -> int:
    """The largest bit length of the digit vectors' values over all rows
    (one device read)."""
    if d[0].numel() == 0:
        return 0
    tops = torch.stack([x.amax() for x in d]).tolist()
    for j in range(len(tops) - 1, -1, -1):
        if tops[j]:
            return j * _BITS + int(tops[j]).bit_length()
    return 0


def _divmod_256(num: Sequence[torch.Tensor], den: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Unsigned (16-digit) // (8-digit, nonzero, < 2**128) by binary long
    division from the numerator's top bit: (quotient digits, remainder as
    three 48-bit limbs).  The remainder stays below 2 * den < 2**129."""
    d0, d1, d2 = _to48(den)
    zero = torch.zeros_like(num[0])
    r0, r1, r2 = zero, zero, zero
    q = [zero] * len(num)
    for i in range(_bit_length(num) - 1, -1, -1):
        bit = (num[i // _BITS] >> (i % _BITS)) & 1
        r2 = (r2 << 1) | (r1 >> (_L48 - 1))
        r1 = ((r1 << 1) & _M48) | (r0 >> (_L48 - 1))
        r0 = ((r0 << 1) & _M48) | bit
        s0 = r0 - d0
        b0 = (s0 < 0).to(torch.int64)
        s1 = r1 - d1 - b0
        b1 = (s1 < 0).to(torch.int64)
        s2 = r2 - d2 - b1
        ge = s2 >= 0
        r0 = torch.where(ge, s0 + (b0 << _L48), r0)
        r1 = torch.where(ge, s1 + (b1 << _L48), r1)
        r2 = torch.where(ge, s2, r2)
        q[i // _BITS] = q[i // _BITS] | (ge.to(torch.int64) << (i % _BITS))
    return q, [r0, r1, r2]


def _twice_ge(r: Sequence[torch.Tensor], den: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """2 * r >= den, r as three 48-bit limbs, den as eight digits."""
    t0 = r[0] << 1
    t1 = (r[1] << 1) + (t0 >> _L48)
    t2 = (r[2] << 1) + (t1 >> _L48)
    t0, t1 = t0 & _M48, t1 & _M48
    borrow = torch.zeros_like(t0)
    for t, dd in zip((t0, t1, t2), _to48(den)):
        borrow = ((t - dd - borrow) < 0).to(torch.int64)
    return borrow == 0


def _divisor(b: Union[torch.Tensor, int], n: int, dev
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The divisor's digits and sign per row."""
    if isinstance(b, int):
        lo, hi = const128(b)
        lo = torch.full((n,), lo, dtype=torch.int64, device=dev)
        hi = torch.full((n,), hi, dtype=torch.int64, device=dev)
    else:
        lo, hi = limbs(b)
    return _digits(lo, hi), hi < 0


def decimal128_divide_plain(a: torch.Tensor, a_valid: torch.Tensor,
                            b: Union[torch.Tensor, int],
                            b_valid: Optional[torch.Tensor] = None,
                            shift: int = 0,
                            precision: int = MAX_PRECISION,
                            half_up: bool = True, out_two: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, dev = a.shape[0], a.device
    valid = a_valid if b_valid is None else a_valid & b_valid
    alo, ahi = limbs(a)
    aneg = ahi < 0
    bd, bneg = _divisor(b, n, dev)
    zero_div = ~_any_nonzero(bd)
    mag = _negate_where(_digits(alo, ahi), aneg)
    over = torch.zeros_like(zero_div)
    if shift > MAX_PRECISION:
        p = _mul(mag, _const_digits(POW10[shift - MAX_PRECISION], 8))
        over = _any_nonzero(p[8:]) | _high_bit(p)
        mag = p[:8]
        shift = MAX_PRECISION
    num = _mul(mag, _const_digits(POW10[shift], 8))
    den = _negate_where(bd, bneg)
    one = torch.ones_like(den[0])
    den = [torch.where(zero_div, one if j == 0 else torch.zeros_like(x), x)
           for j, x in enumerate(den)]
    q, r = _divmod_256(num, den)
    if half_up:
        q[0] = q[0] + _twice_ge(r, den).to(torch.int64)
        q = _normalize(q)
    over = over | _any_nonzero(q[8:]) | _high_bit(q)
    d = _negate_where(q[:8], aneg ^ bneg)
    null = zero_div | _null_rule(over, d, aneg ^ bneg, precision)
    valid = valid & ~null
    return _output(d, valid, out_two), valid


def decimal128_divide(a: torch.Tensor, a_valid: torch.Tensor,
                      b: Union[torch.Tensor, int],
                      b_valid: Optional[torch.Tensor] = None,
                      shift: int = 0, precision: int = MAX_PRECISION,
                      half_up: bool = True, out_two: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a * 10**shift) / b per row with one rounding -> (quotient,
    validity): the numerator exact in 256 bits (past shift 38 through a
    checked product, as ``div128_by_128`` :427-433 does), then HALF_UP
    (``half_up``) or toward zero.  ``b``: an operand column (int64 [n], a
    Decimal64 or a count, or [n, 2]) or a Python int in every row (10**k
    of a rescale down).  Null where an input is, where b is 0, where the
    quotient leaves int128 and by ``precision`` (see the module's
    docstring, WRAP excepted).  Out: [n, 2], or its low limb [n] with
    ``out_two`` False."""
    _check_operand("decimal128_divide", a, a_valid)
    if not 0 <= shift <= 2 * MAX_PRECISION:
        raise ValueError(f"decimal128_divide: shift {shift}")
    if not INT128 <= precision <= MAX_PRECISION:
        raise ValueError(f"decimal128_divide: precision {precision}")
    column = isinstance(b, torch.Tensor)
    if column:
        if b_valid is None:
            raise ValueError("decimal128_divide: a divisor column needs its "
                             "validity")
        _check_operand("decimal128_divide", b, b_valid)
        if b.shape[0] != a.shape[0]:
            raise ValueError("decimal128_divide: operands differ in length")
    elif not -(1 << 127) <= int(b) < 1 << 127 or b_valid is not None:
        raise ValueError("decimal128_divide: a constant divisor is an int128 "
                         "without validity")
    if a.device.type == "cpu":
        return decimal128_divide_plain(a, a_valid, b, b_valid, shift,
                                       precision, half_up, out_two)
    ts = [a, a_valid] + ([b, b_valid] if column else [])
    _lib.require_cuda("decimal128_divide", *ts)
    n, dev = a.shape[0], a.device
    blo, bhi = const128(0 if column else int(b))
    out = torch.empty((n, 2) if out_two else n, dtype=torch.int64,
                      device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    _lib.check(_lib.lib().srt_decimal128_divide(
        _lib.ptr(a), int(a.dim() == 2), _lib.ptr(a_valid),
        _lib.ptr(b) if column else None, int(column and b.dim() == 2),
        _lib.ptr(b_valid) if column else None, blo, bhi, n, shift,
        precision, int(half_up), int(out_two), _lib.ptr(out),
        _lib.ptr(valid), _lib.stream(dev)), "decimal128_divide")
    if n:
        _lib.LAUNCHES["decimal128_divide"] += 1
    return out, valid
