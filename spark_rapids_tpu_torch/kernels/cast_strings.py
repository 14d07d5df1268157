"""String cast kernels: text -> number, date or bool, and back.

Counterpart of ``spark_rapids_tpu/kernels/cast_strings.py``: Spark's
non-ANSI legacy cast (an invalid text is NULL, never an error).  Every
parse trims the bytes <= 0x20 at both ends of a row (UTF8String.trimAll).

- ``parse_integral`` (:52): an optional sign, digits, an optional
  fraction that truncates toward zero (``"3."``, ``".5"`` and ``"-.5"``
  are valid; ``"."``, ``"+"`` and ``"1e3"`` are not); past LONG's range
  NULL.  The caller applies the target width's range.
- ``parse_double`` (:116, with ``_token_matches`` :102): the reference's
  own rule, at most 15 significant digits (leading zeros skipped, each
  further integer digit raises the exponent, each fraction digit taken or
  skipped as a leading zero lowers it), at most 9 exponent digits and one
  ``e`` / ``E``; ``inf`` / ``infinity`` with an optional sign and ``nan``
  without one, in any case; a zero mantissa is 0.0 with its sign.  The
  value is the mantissa times 10**e from a table of the correctly rounded
  doubles ``float(f"1e{k}")``, k in [-400, 400] (0.0 and inf at the
  ends), where the reference calls ``jnp.power``: XLA's power is one ulp
  off at some exponents and flushes every subnormal power to 0.0
  (ROADMAP queue 3 pins both).
- ``parse_date`` (:214): ``yyyy[-m[m][-d[d]]]``, the year exactly four
  digits and >= 1, the day checked against the month and leap years.
- ``parse_bool`` (:269): t / true / y / yes / 1 and f / false / n / no /
  0, ASCII case-insensitive.
- ``long_to_string`` (:305), ``date_to_string`` (:323; a year outside
  [1, 9999] is NULL), ``bool_to_string`` (:344): the port's string
  layout, offsets from 0, a null row of length 0.

Each function is a wrapper: on CUDA tensors it launches a hand-written
kernel of ``csrc/cast_strings.cu`` and counts the launch, C1
``string_parse`` for the four parses and C2 ``string_format`` for the
three formats; on CPU tensors it runs the plain PyTorch version beside it
(``*_plain``), which computes each byte's row and place over the whole
buffer, so that no row length is too long for it.  There is no fallback
from one to the other.  The reference's ``[capacity, max_len]`` byte
window (``string_byte_matrix``, the string bucket) and
``build_string_column`` (:285) are XLA machinery and are not ported: a
format counts each row's length, scans, reads the byte total once and
then writes, as ``string_assemble`` does.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.datetime import (_civil_from_days,
                                                         _days_from_civil)
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.strings import _Bytes, _offsets_of

PARSE = "string_parse"
FORMAT = "string_format"

# C1's modes and C2's: csrc/cast_strings.cu has the same numbers
PARSE_INTEGRAL, PARSE_DOUBLE, PARSE_DATE, PARSE_BOOL = range(4)
FORMAT_LONG, FORMAT_DATE, FORMAT_BOOL = range(3)

_PARSE_DTYPES = {PARSE_INTEGRAL: torch.int64, PARSE_DOUBLE: torch.float64,
                 PARSE_DATE: torch.int32, PARSE_BOOL: torch.bool}
_FORMAT_DTYPES = {FORMAT_LONG: torch.int64, FORMAT_DATE: torch.int32,
                  FORMAT_BOOL: torch.bool}

#: the exponents of the power table: 10**k for k in [-POW10_SPAN, POW10_SPAN]
POW10_SPAN = 400
#: at most this many significant mantissa digits (the reference's SIG)
SIG_DIGITS = 15
_BIG = 2**62
_MAXL = 2**63 - 1
_E18 = 10**18

_BOOL_TRUE = [b"t", b"true", b"y", b"yes", b"1"]
_BOOL_FALSE = [b"f", b"false", b"n", b"no", b"0"]


@functools.lru_cache(maxsize=None)
def pow10_table(device) -> torch.Tensor:
    """float64 [801]: ``float(f"1e{k}")``, k in [-400, 400], correctly
    rounded by Python's parser (0.0 and inf at the ends)."""
    return torch.tensor(
        [float(f"1e{k}") for k in range(-POW10_SPAN, POW10_SPAN + 1)],
        dtype=torch.float64, device=device)


def _int_pow10(device) -> torch.Tensor:
    """int64 [19]: 10**0 .. 10**18."""
    return torch.tensor([10**k for k in range(19)], dtype=torch.int64,
                        device=device)


# -- the plain versions -------------------------------------------------------

class _Token:
    """A column's rows for the plain parses: each byte's row ``r`` and
    place ``pos`` in its row, and each row's trimmed token
    [``first``, ``last``] (``has``: not empty)."""

    def __init__(self, col: DeviceColumn):
        b = _Bytes(col)
        self.b = b
        self.r = b.row
        self.pos = b.pos
        self.data = b.data.to(torch.int64)
        self.digit = (self.data >= 0x30) & (self.data <= 0x39)
        self.d = self.data - 0x30
        nonws = self.data > 0x20
        self.first = b.row_min(torch.where(nonws, self.pos, _BIG), _BIG)
        self.last = b.row_max(torch.where(nonws, self.pos, -1), -1)
        self.has = self.last >= self.first

    def at(self, pos: torch.Tensor) -> torch.Tensor:
        """int64 [n]: each row's byte at ``pos`` inside the row, else 0."""
        b = self.b
        inside = (pos >= 0) & (pos < b.lengths)
        if b.total == 0:
            return torch.zeros_like(pos)
        idx = (b.off[:-1] + pos.clamp(0, _BIG)).clamp(max=b.total - 1)
        return torch.where(inside, self.data[idx], 0)

    def span(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """bool per byte: its place is in its row's [lo, hi]."""
        return (self.pos >= lo[self.r]) & (self.pos <= hi[self.r])

    def count(self, flags: torch.Tensor) -> torch.Tensor:
        return self.b.per_row(flags)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """int64 [n]: the values summed over each row's bytes."""
        out = torch.zeros(self.b.n, dtype=torch.int64, device=values.device)
        return out.index_add_(0, self.r, values)

    def first_where(self, flags: torch.Tensor) -> torch.Tensor:
        return self.b.row_min(torch.where(flags, self.pos, _BIG), _BIG)

    def last_where(self, flags: torch.Tensor) -> torch.Tensor:
        return self.b.row_max(torch.where(flags, self.pos, -1), -1)

    def sign(self):
        """(negative, the first place after the sign) per row."""
        sb = self.at(self.first)
        signed = self.has & ((sb == 0x2D) | (sb == 0x2B))
        return self.has & (sb == 0x2D), self.first + signed.to(torch.int64)

    def matches(self, lo: torch.Tensor, hi: torch.Tensor,
                word: bytes) -> torch.Tensor:
        """``_token_matches`` (:102): row[lo..hi] is ``word`` (lower-case
        ASCII), ASCII case-insensitively."""
        hit = (hi - lo + 1) == len(word)
        for i, wb in enumerate(word):
            c = self.at(lo + i)
            c = torch.where((c >= 0x41) & (c <= 0x5A), c + 32, c)
            hit = hit & (c == wb)
        return hit


def _place_values(tok: _Token, flags: torch.Tensor, end: torch.Tensor,
                  pow10: torch.Tensor) -> torch.Tensor:
    """Each flagged digit times 10**(end - pos), the place capped at 9,
    summed per row (the reference's weighted digit sums)."""
    place = (end[tok.r] - tok.pos).clamp(0, 9)
    return tok.sum(torch.where(flags, tok.d * pow10[place], 0))


def parse_integral_plain(col: DeviceColumn
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int64 values truncated toward zero, ok).  The magnitude's
    significant digits split at 10**18: a top digit and the 18 below, so
    that LONG_MIN's magnitude is checked without uint64."""
    tok = _Token(col)
    p10 = _int_pow10(col.device)
    neg, dstart = tok.sign()
    in_tok = tok.span(dstart, tok.last)
    is_dot = in_tok & (tok.data == 0x2E)
    ndots = tok.count(is_dot)
    dotpos = tok.first_where(is_dot)
    int_end = torch.where(ndots > 0, dotpos - 1, tok.last)
    int_part = in_tok & (tok.pos <= int_end[tok.r])
    frac_part = in_tok & (tok.pos > dotpos[tok.r])
    bad = tok.count((int_part | frac_part) & ~tok.digit)
    digits = tok.count(int_part) + tok.count(frac_part)
    ok = tok.has & (ndots <= 1) & (bad == 0) & (digits > 0)
    fnz = tok.first_where(int_part & tok.digit & (tok.data != 0x30))
    n_sig = torch.where(fnz < _BIG, int_end - fnz + 1, 0)
    place = int_end[tok.r] - tok.pos
    sig = int_part & (tok.pos >= fnz[tok.r])
    low = tok.sum(torch.where(sig & (place <= 17),
                              tok.d * p10[place.clamp(0, 17)], 0))
    top = tok.sum(torch.where(sig & (place == 18), tok.d, 0))
    negi = neg.to(torch.int64)
    fits = (n_sig <= 19) & (low - negi <= _MAXL - top * _E18)
    ok = ok & fits
    val = torch.where(neg, -(top * _E18) - low, top * _E18 + low)
    return torch.where(ok, val, 0), ok


def parse_double_plain(col: DeviceColumn
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (float64 values, ok)."""
    tok = _Token(col)
    dev = col.device
    p10 = _int_pow10(dev)
    r, pos = tok.r, tok.pos
    neg, dstart = tok.sign()
    inf_hit = tok.matches(dstart, tok.last, b"inf") | \
        tok.matches(dstart, tok.last, b"infinity")
    nan_hit = tok.matches(tok.first, tok.last, b"nan")
    in_tok = tok.span(dstart, tok.last)
    is_e = in_tok & ((tok.data == 0x65) | (tok.data == 0x45))
    n_e = tok.count(is_e)
    epos = tok.first_where(is_e)
    mant_end = torch.where(n_e > 0, epos - 1, tok.last)
    mant_span = in_tok & (pos <= mant_end[r])
    dot = mant_span & (tok.data == 0x2E)
    ndots = tok.count(dot)
    dotpos = tok.first_where(dot)
    mant_digit = mant_span & tok.digit
    mant_ok = (ndots <= 1) & (tok.count(mant_digit) > 0) & \
        (tok.count(mant_span & ~(tok.digit | dot)) == 0)
    # the exponent: an optional sign, then 1-9 digits to the token's end
    es = epos + 1
    esb = torch.where(es <= tok.last, tok.at(es.clamp(max=_BIG)), 0)
    e_neg = esb == 0x2D
    eds = es + ((esb == 0x2D) | (esb == 0x2B)).to(torch.int64)
    exp_span = tok.span(eds, tok.last)
    n_exp = tok.count(exp_span & tok.digit)
    exp_ok = torch.where(
        n_e > 0, (n_exp > 0) & (n_exp <= 9) & (eds <= tok.last)
        & (tok.count(exp_span & ~tok.digit) == 0), True)
    exp_val = _place_values(tok, exp_span & tok.digit, tok.last, p10)
    exp_val = torch.where(n_e > 0, torch.where(e_neg, -exp_val, exp_val), 0)
    # the mantissa: its first 15 significant digits, the exponent moved
    # by the integer digits past them and the fraction digits before them
    after_dot = (ndots[r] > 0) & (pos > dotpos[r])
    fnz = tok.first_where(mant_digit & (tok.data != 0x30))
    lead_zero = mant_digit & (pos < fnz[r])
    sig = mant_digit & (pos >= fnz[r])
    before = torch.cumsum(sig.to(torch.int64), 0) - sig.to(torch.int64)
    start = torch.zeros(tok.b.n, dtype=torch.int64, device=dev)
    start.scatter_reduce_(0, r, before, "amin", include_self=False)
    rank = before - start[r]
    take = sig & (rank < SIG_DIGITS)
    ntake = tok.count(take)
    mant = tok.sum(torch.where(take, tok.d * p10[(ntake[r] - 1 - rank)
                                                  .clamp(0, 18)], 0))
    e_adj = tok.count(sig & ~take & ~after_dot) - \
        tok.count((take | lead_zero) & after_dot)
    e = (exp_val + e_adj).clamp(-POW10_SPAN, POW10_SPAN)
    value = mant.to(torch.float64) * pow10_table(dev)[e + POW10_SPAN]
    value = torch.where(mant == 0, 0.0, value)
    value = torch.where(neg, -value, value)
    num_ok = tok.has & mant_ok & exp_ok & (n_e <= 1)
    ok = tok.has & (num_ok | inf_hit | nan_hit)
    inf = torch.full_like(value, float("inf"))
    value = torch.where(inf_hit, torch.where(neg, -inf, inf), value)
    value = torch.where(nan_hit, float("nan"), value)
    return torch.where(ok, value, 0.0), ok


def parse_date_plain(col: DeviceColumn
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int32 epoch days, ok)."""
    tok = _Token(col)
    p10 = _int_pow10(col.device)
    in_tok = tok.span(tok.first, tok.last)
    is_dash = in_tok & (tok.data == 0x2D)
    ndash = tok.count(is_dash)
    d1 = tok.first_where(is_dash)
    d2 = tok.last_where(is_dash)

    def seg(lo, hi):
        """(digits value, bytes, all digits) of row[lo..hi]."""
        span = in_tok & tok.span(lo, hi)
        return (_place_values(tok, span & tok.digit, hi, p10),
                tok.count(span), tok.count(span & ~tok.digit) == 0)

    y, yn, yok = seg(tok.first, torch.where(ndash >= 1, d1 - 1, tok.last))
    m, mn, mok = seg(d1 + 1, torch.where(ndash >= 2, d2 - 1, tok.last))
    d, dn, dok = seg(d2 + 1, tok.last)
    m = torch.where(ndash >= 1, m, 1)
    d = torch.where(ndash >= 2, d, 1)
    mn_ok = torch.where(ndash >= 1, (mn >= 1) & (mn <= 2) & mok, True)
    dn_ok = torch.where(ndash >= 2, (dn >= 1) & (dn <= 2) & dok, True)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    dim = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       dtype=torch.int64, device=col.device)[
                           (m - 1).clamp(0, 11)]
    dim = torch.where((m == 2) & leap, 29, dim)
    ok = (tok.has & (ndash <= 2) & (yn == 4) & yok & (y >= 1) & mn_ok
          & dn_ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= dim))
    days = _days_from_civil(y, m, d)
    return torch.where(ok, days, 0).to(torch.int32), ok


def parse_bool_plain(col: DeviceColumn
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (bool values, ok)."""
    tok = _Token(col)
    t = torch.zeros_like(tok.has)
    f = torch.zeros_like(tok.has)
    for w in _BOOL_TRUE:
        t = t | tok.matches(tok.first, tok.last, w)
    for w in _BOOL_FALSE:
        f = f | tok.matches(tok.first, tok.last, w)
    return t, tok.has & (t | f)


def _rows_of_chars(chars: torch.Tensor, lengths: torch.Tensor,
                   validity: torch.Tensor) -> DeviceColumn:
    """uint8 [n, W] characters, each row's first ``lengths`` of them ->
    a STRING column of that validity (a null row empty)."""
    lengths = torch.where(validity, lengths, 0)
    offsets, _ = _offsets_of(lengths)
    keep = torch.arange(chars.shape[1], device=chars.device) < \
        lengths[:, None]
    return DeviceColumn(chars[keep], validity, T.STRING,
                        offsets.to(torch.int32))


def long_to_string_plain(vals: torch.Tensor,
                         validity: torch.Tensor) -> DeviceColumn:
    """int64 -> its decimal digits, a '-' first where negative.  The
    digits come from the value's non-positive twin, which LONG_MIN has."""
    nm = torch.where(vals < 0, vals, -vals)
    p10 = _int_pow10(vals.device)
    nd = 1 + (nm[:, None] <= -p10[1:]).sum(1)
    neg = (vals < 0).to(torch.int64)
    length = nd + neg
    j = torch.arange(20, device=vals.device)
    place = (length[:, None] - 1 - j).clamp(0, 18)
    digit = -torch.fmod(torch.div(nm[:, None], p10[place],
                                  rounding_mode="trunc"), 10)
    chars = torch.where((j == 0) & (neg[:, None] == 1), 0x2D, 0x30 + digit)
    return _rows_of_chars(chars.to(torch.uint8), length, validity)


def date_to_string_plain(days: torch.Tensor,
                         validity: torch.Tensor) -> DeviceColumn:
    """Epoch days -> 'yyyy-MM-dd'; a year outside [1, 9999] is NULL."""
    y, m, d = _civil_from_days(days)
    validity = validity & (y >= 1) & (y <= 9999)
    y = y.clamp(1, 9999)
    dash = torch.full_like(y, -0x30 + 0x2D)
    digits = torch.stack([y // 1000 % 10, y // 100 % 10, y // 10 % 10,
                          y % 10, dash, m // 10, m % 10, dash, d // 10,
                          d % 10], 1)
    return _rows_of_chars((0x30 + digits).to(torch.uint8),
                          torch.full_like(y, 10), validity)


def bool_to_string_plain(vals: torch.Tensor,
                         validity: torch.Tensor) -> DeviceColumn:
    dev = vals.device
    true_b = torch.tensor(list(b"true\x00"), dtype=torch.uint8, device=dev)
    false_b = torch.tensor(list(b"false"), dtype=torch.uint8, device=dev)
    chars = torch.where(vals[:, None], true_b, false_b)
    return _rows_of_chars(chars, torch.where(vals, 4, 5).to(torch.int64),
                          validity)


# -- the wrappers -------------------------------------------------------------

_PARSE_PLAIN = {PARSE_INTEGRAL: parse_integral_plain,
                PARSE_DOUBLE: parse_double_plain,
                PARSE_DATE: parse_date_plain, PARSE_BOOL: parse_bool_plain}
_FORMAT_PLAIN = {FORMAT_LONG: long_to_string_plain,
                 FORMAT_DATE: date_to_string_plain,
                 FORMAT_BOOL: bool_to_string_plain}

#: the devices whose constant memory holds the power table
_pow10_loaded: set = set()


def _parse_cuda(col: DeviceColumn, mode: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda(PARSE, col.offsets, col.data)
    lib = _lib.lib()
    n, dev = col.num_rows, col.device
    if mode == PARSE_DOUBLE and dev not in _pow10_loaded:
        table = pow10_table("cpu")
        with torch.cuda.device(dev):
            _lib.check(lib.srt_cast_pow10_load(_lib.ptr(table)), PARSE)
        _pow10_loaded.add(dev)
    out = torch.empty(n, dtype=_PARSE_DTYPES[mode], device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    _lib.check(lib.srt_string_parse(
        mode, _lib.ptr(col.offsets), _lib.ptr(col.data), n, _lib.ptr(out),
        _lib.ptr(ok), _lib.stream(dev)), PARSE)
    if n:
        _lib.LAUNCHES[PARSE] += 1
    return out, ok


def _format_cuda(mode: int, vals: torch.Tensor,
                 validity: torch.Tensor) -> DeviceColumn:
    _lib.require_cuda(FORMAT, vals, validity)
    lib = _lib.lib()
    n, dev = vals.shape[0], vals.device
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    totals = torch.empty(1, dtype=torch.int64, device=dev)
    s = _lib.stream(dev)
    _lib.check(lib.srt_string_format_count(
        mode, _lib.ptr(vals), _lib.ptr(validity), n, _lib.ptr(offsets),
        _lib.ptr(valid), _lib.ptr(tile_sums), _lib.ptr(totals), s), FORMAT)
    if n:
        _lib.LAUNCHES[FORMAT] += 1
    # the one device->host read of a format: its byte total
    total = int(totals.item())
    data = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        _lib.check(lib.srt_string_format_write(
            mode, _lib.ptr(vals), n, _lib.ptr(offsets), _lib.ptr(data), s),
            FORMAT)
    return DeviceColumn(data, valid, T.STRING, offsets)


def _parse(mode: int, col: DeviceColumn
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not col.is_string:
        raise TypeError(f"a string parse takes a string column, got "
                        f"{col.dtype!r}")
    if col.device.type == "cpu":
        return _PARSE_PLAIN[mode](col)
    return _parse_cuda(col, mode)


def _format(mode: int, vals: torch.Tensor,
            validity: torch.Tensor) -> DeviceColumn:
    if vals.dtype != _FORMAT_DTYPES[mode] or vals.dim() != 1 or \
            validity.dtype != torch.bool or validity.shape != vals.shape:
        raise TypeError(f"{FORMAT}: values must be {_FORMAT_DTYPES[mode]} "
                        f"[n] with bool validity [n], got {vals.dtype} "
                        f"{tuple(vals.shape)} and {validity.dtype} "
                        f"{tuple(validity.shape)}")
    if vals.device.type == "cpu":
        return _FORMAT_PLAIN[mode](vals, validity)
    return _format_cuda(mode, vals, validity)


def parse_integral(col: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 values truncated toward zero, ok): NULL past LONG."""
    return _parse(PARSE_INTEGRAL, col)


def parse_double(col: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float64 values, ok)."""
    return _parse(PARSE_DOUBLE, col)


def parse_date(col: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 epoch days, ok)."""
    return _parse(PARSE_DATE, col)


def parse_bool(col: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bool values, ok)."""
    return _parse(PARSE_BOOL, col)


def long_to_string(vals: torch.Tensor,
                   validity: torch.Tensor) -> DeviceColumn:
    """int64 -> decimal text (INT, SHORT and BYTE widen first)."""
    return _format(FORMAT_LONG, vals, validity)


def date_to_string(days: torch.Tensor,
                   validity: torch.Tensor) -> DeviceColumn:
    """int32 epoch days -> 'yyyy-MM-dd', NULL outside years [1, 9999]."""
    return _format(FORMAT_DATE, days, validity)


def bool_to_string(vals: torch.Tensor,
                   validity: torch.Tensor) -> DeviceColumn:
    """bool -> 'true' / 'false'."""
    return _format(FORMAT_BOOL, vals, validity)
