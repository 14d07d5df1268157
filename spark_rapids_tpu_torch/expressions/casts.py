"""Cast expression.

Counterpart of ``spark_rapids_tpu/expressions/casts.py`` (``Cast`` :41,
``Cast.supported`` :67-97, ``Cast.eval`` :99-143), Spark's non-ANSI
legacy cast:

- BOOLEAN to and from every number: a number is TRUE where it is not 0
  (NaN too), a BOOLEAN is 0 / 1;
- among BYTE, SHORT, INT and LONG: widening, or narrowing that wraps as
  the JVM does; any integral type -> FLOAT or DOUBLE, FLOAT <-> DOUBLE
  (round to nearest);
- FLOAT or DOUBLE -> integral: truncated toward zero, NaN -> 0,
  saturated at the type's bounds (:123-134).  The value is clipped first
  (to ``hi - 1024`` for LONG: ``float(2**63 - 1)`` is 2**63) and only
  then converted, then saturated with ``where``: a float -> int
  conversion out of range is not defined on the card.  The work is in
  double, which holds every float exactly;
- the decimal casts: a rescale up is exact, a rescale down rounds HALF_UP
  once, a value past the target precision is NULL; decimal -> integral
  truncates toward zero and is NULL outside the type's range where the
  source is two limbs (``_decimal128_cast_eval`` :404; a Decimal64 source
  truncates and wraps, as ``_decimal_cast`` :447 does); decimal -> DOUBLE
  divides the unscaled value by 10**scale (:467-469: a multiply by 0.01
  would round differently), -> FLOAT rounds that double; BOOLEAN and
  integral -> decimal.  Where both sides are Decimal64 the casts are
  int64 PyTorch; where either is two limbs, ``kernels/decimal.py``'s
  ``decimal128_binary`` rescales up and converts to double and
  ``decimal128_divide`` rescales down;
- STRING -> INT, LONG, SHORT, BYTE, DOUBLE, FLOAT, DATE and BOOLEAN
  (``_eval_from_string`` :145) through ``kernels/cast_strings.py``'s
  parses (C1 ``string_parse``): an invalid text, or a number outside the
  target's range (``_int_key`` :227), is NULL; FLOAT is the parsed double
  rounded;
- INT, LONG, SHORT, BYTE, DATE and BOOLEAN -> STRING (``_eval_to_string``
  :170) through its formats (C2 ``string_format``), integral types
  widened to LONG first.

- DATE -> TIMESTAMP multiplies the days by the microseconds of a day:
  midnight UTC, whatever the session zone, as both of the reference's
  paths do (:116-117, :195-196; Spark takes the session zone's midnight,
  ROADMAP queue 3 pins the difference); TIMESTAMP -> DATE floors the
  session zone's wall clock (T1, ``kernels/timezone.py``) to its day
  (:118-122).

Everything else raises NotImplementedError with the reference's reason,
at plan time (``planner/overrides.py``) and here: FLOAT or DOUBLE ->
STRING (the reference keeps it off the device: Java's Double.toString
formats otherwise), and any other cast to or from TIMESTAMP.  All but the
string casts and the session zone's shift are plain PyTorch elementwise
code.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)

_INT_RANGE = {torch.int8: (-2**7, 2**7 - 1),
              torch.int16: (-2**15, 2**15 - 1),
              torch.int32: (-2**31, 2**31 - 1),
              torch.int64: (-2**63, 2**63 - 1)}


def decimal_divisor(scale: int, device) -> torch.Tensor:
    """10**scale as a 0-d double tensor on the device.  Dividing by it is an
    IEEE division on the CPU and the card alike; a Python number would not
    do: PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal (7 * 0.01 is not 7 / 100.0)."""
    return torch.full((), 10.0 ** scale, dtype=torch.float64, device=device)


def _fixed(dt: T.DataType) -> bool:
    """A number that is not a decimal, or a BOOLEAN."""
    return (isinstance(dt, T.NumericType) and not isinstance(
        dt, T.DecimalType)) or isinstance(dt, T.BooleanType)


def not_supported(src: T.DataType, dst: T.DataType) -> NotImplementedError:
    """The reference's reason (``planner/overrides.py:354-356``)."""
    return NotImplementedError(f"cast {src!r} -> {dst!r} is not supported")


class Cast(Expression):
    def __init__(self, child: Expression, dtype: T.DataType):
        self.child = child
        self.children = (child,)
        self._dtype = dtype

    def with_children(self, children):
        return Cast(children[0], self._dtype)

    @property
    def dtype(self):
        return self._dtype

    def __repr__(self):
        return f"cast({self.child!r} AS {self._dtype!r})"

    @staticmethod
    def supported(src: T.DataType, dst: T.DataType) -> bool:
        """The reference's lattice (:67-97)."""
        if src == dst:
            return True
        if {type(src), type(dst)} == {T.DateType, T.TimestampType}:
            return True
        dec = (isinstance(src, T.DecimalType), isinstance(dst, T.DecimalType))
        if (_fixed(src) and _fixed(dst)) or all(dec):
            return True
        if dec[0] and (dst.is_integral or dst.is_floating):
            return True
        if (src.is_integral or isinstance(src, T.BooleanType)) and dec[1]:
            return True
        if isinstance(src, T.StringType):
            return dst.is_integral or dst.is_floating or isinstance(
                dst, (T.DateType, T.BooleanType))
        if isinstance(dst, T.StringType):
            return src.is_integral or isinstance(src, (T.DateType,
                                                       T.BooleanType))
        return False

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        src, dst = c.dtype, self._dtype
        if src == dst:
            return c
        if not Cast.supported(src, dst):
            raise not_supported(src, dst)
        if isinstance(src, T.StringType):
            return _from_string(c, dst)
        if isinstance(dst, T.StringType):
            return _to_string(c, src)
        if isinstance(dst, T.TimestampType):    # from a DATE
            from spark_rapids_tpu_torch.expressions.datetime import (
                MICROS_PER_DAY)
            return make_column(c.data.to(torch.int64) * MICROS_PER_DAY,
                               c.validity, dst)
        if isinstance(src, T.TimestampType):    # to a DATE
            from spark_rapids_tpu_torch.expressions.datetime import (
                timestamp_days)
            return make_column(timestamp_days(c.data).to(torch.int32),
                               c.validity, dst)
        src_dec = isinstance(src, T.DecimalType)
        dst_dec = isinstance(dst, T.DecimalType)
        if src_dec and dst.is_floating:
            if c.is_two_limb:
                from spark_rapids_tpu_torch.kernels import decimal as DK
                vals, valid = DK.decimal128_binary(
                    DK.TO_DOUBLE, c.data, c.validity, ka=src.scale)
            else:
                vals = c.data.to(torch.float64) / decimal_divisor(src.scale,
                                                                  c.device)
                valid = c.validity
            return make_column(vals.to(dst.torch_dtype), valid, dst)
        if src_dec and dst_dec:
            return _rescale(c, src.scale, dst)
        if src_dec:
            return _to_integral(c, dst)
        if dst_dec:
            return _rescale(c, 0, dst)
        data = c.data
        if isinstance(dst, T.BooleanType):
            out = data != 0
        elif src.is_floating and dst.is_integral:
            out = _saturate(data, dst)
        else:
            out = data.to(dst.torch_dtype)
        return make_column(out, c.validity, dst)


def _saturate(data: torch.Tensor, dst: T.DataType) -> torch.Tensor:
    """FLOAT / DOUBLE -> integral: truncate, NaN -> 0, clip to a bound
    that converts exactly, convert, then saturate at the bounds."""
    lo, hi = _INT_RANGE[dst.torch_dtype]
    x = torch.trunc(torch.nan_to_num(data.to(torch.float64), nan=0.0,
                                     posinf=float("inf"),
                                     neginf=float("-inf")))
    mid = x.clamp(float(lo), float(hi - 1024) if hi > 2**53 else float(hi))
    out = mid.to(dst.torch_dtype)
    out = torch.where(x >= float(hi), hi, out)
    return torch.where(x <= float(lo), lo, out).to(dst.torch_dtype)


def _from_string(c, dst: T.DataType):
    """The parses of C1; NULL where the text does not parse, or where the
    number is outside the target's range."""
    from spark_rapids_tpu_torch.kernels import cast_strings as CS
    if dst.is_integral:
        vals, ok = CS.parse_integral(c)
        lo, hi = _INT_RANGE[dst.torch_dtype]
        ok = ok & (vals >= lo) & (vals <= hi)
        vals = vals.to(dst.torch_dtype)
    elif dst.is_floating:
        vals, ok = CS.parse_double(c)
        vals = vals.to(dst.torch_dtype)
    elif isinstance(dst, T.DateType):
        vals, ok = CS.parse_date(c)
    else:
        vals, ok = CS.parse_bool(c)
    return make_column(vals, c.validity & ok, dst)


def _to_string(c, src: T.DataType):
    """The formats of C2; integral types widen to LONG first."""
    from spark_rapids_tpu_torch.kernels import cast_strings as CS
    if isinstance(src, T.BooleanType):
        return CS.bool_to_string(c.data, c.validity)
    if isinstance(src, T.DateType):
        return CS.date_to_string(c.data, c.validity)
    return CS.long_to_string(c.data.to(torch.int64), c.validity)


def _rescale(c, from_scale: int, dst: T.DecimalType):
    """A decimal (or an integral value at scale 0) to decimal ``dst``."""
    k = dst.scale - from_scale
    if not (T.two_limbs(dst) or c.is_two_limb):
        return _rescale64(c.data.to(torch.int64), c.validity, k, dst)
    from spark_rapids_tpu_torch.kernels import decimal as DK
    data = c.data.to(torch.int64) if c.data.dim() == 1 else c.data
    if k >= 0:
        vals, valid = DK.decimal128_binary(
            DK.RESCALE, data, c.validity, ka=k, precision=dst.precision,
            out_two=dst.uses_two_limbs)
    else:
        vals, valid = DK.decimal128_divide(
            data, c.validity, DK.POW10[-k], precision=dst.precision,
            out_two=dst.uses_two_limbs)
    return make_column(vals, valid, dst)


def _rescale64(data: torch.Tensor, validity: torch.Tensor, k: int,
               dst: T.DecimalType):
    """Decimal64 -> Decimal64 (``_decimal_cast`` :447): scale up checked
    before the multiply (a wrapped product could land back in range),
    scale down HALF_UP away from zero; null past the precision."""
    bound = 10 ** dst.precision
    if k >= 0:
        pre = (bound - 1) // 10 ** k
        validity = validity & (data <= pre) & (data >= -pre)
        out = data * 10 ** k
    else:
        f = 10 ** -k
        out = torch.sign(data) * ((data.abs() + f // 2) // f)
    validity = validity & (out < bound) & (out > -bound)
    return make_column(out, validity, dst)


def _to_integral(c, dst: T.DataType):
    """Decimal -> an integral type, truncating toward zero."""
    src = c.dtype
    f = 10 ** src.scale
    if not c.is_two_limb:
        d = c.data
        q = torch.where(d >= 0, d // f, -((-d) // f))
        return make_column(q.to(dst.torch_dtype), c.validity, dst)
    from spark_rapids_tpu_torch.kernels import decimal as DK
    vals, valid = c.data, c.validity
    if src.scale:
        vals, valid = DK.decimal128_divide(vals, valid, f, half_up=False,
                                           precision=DK.INT128)
    v64, fits = DK.narrow64(vals)
    lo, hi = _INT_RANGE[dst.torch_dtype]
    ok = valid & fits & (v64 >= lo) & (v64 <= hi)
    return make_column(v64.to(dst.torch_dtype), ok, dst)
