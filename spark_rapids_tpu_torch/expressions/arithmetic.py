"""Arithmetic with Spark (non-ANSI) semantics.

Counterpart of ``spark_rapids_tpu/expressions/arithmetic.py`` (``Add``
:231, ``Subtract`` :239, ``Multiply`` :247 over ``BinaryArithmetic`` :82,
``Divide`` :255): inputs promote to the wider type, integral results
wrap, double results follow IEEE-754, and nulls propagate.  Division of
non-decimals is always DOUBLE and NULL on a zero divisor.

Decimals follow Spark's ``DecimalPrecision`` result types
(``decimal_add_result``, ``decimal_mul_result``, ``decimal_div_result``,
:39-66) and its non-ANSI overflow: a result of |v| >= 10**precision is
NULL.  Where the operands and the result are all Decimal64, the operands
are int64 values rescaled to the result's scale (``_decimal_operands``
:114, ``_overflow_null`` :75), in plain PyTorch.  Where any of them is
two limbs (``_eval_decimal128`` :130), ``kernels/decimal.py``'s
``decimal128_binary`` adds, subtracts or multiplies exactly, a product
past the result's scale then rounded HALF_UP by ``decimal128_divide``.
The decimal ``Divide`` (:281-335) is ``decimal128_divide``: the 256-bit
quotient with one HALF_UP rounding, NULL on a zero divisor.  Decimal and
non-decimal operands do not mix: cast first, as the reference requires.

``IntegralDivide`` (``div``, :350; always LONG), ``Remainder`` (``%``,
:389; the operands' promotion), ``UnaryMinus`` (:432) and ``Abs`` (:448)
follow Java: a zero divisor gives NULL, the quotient truncates toward
zero, the remainder takes the dividend's sign, and ``MIN div -1``,
``-MIN`` and ``abs(MIN)`` wrap to MIN (INT and LONG).  A divisor of -1 is
taken as a wrapping negation (quotient) or 0 (remainder), never handed to
an integer division: ``MIN / -1`` traps on the CPU (SIGFPE) and is
undefined on the card.  Where the reference's ``sign * (|a| op |b|)``
overflows (a dividend or divisor of MIN), it differs from Java and the
port gives Java's answer (ROADMAP queue 3 pins it).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    BinaryExpression, EvalContext, Literal, UnaryExpression, make_column,
    null_propagating)

MAX_PRECISION = T.DecimalType.MAX_PRECISION
MAX_LONG_DIGITS = T.DecimalType.MAX_LONG_DIGITS


def decimal_add_result(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    """Spark's DecimalPrecision: the type of a + b and a - b."""
    scale = max(a.scale, b.scale)
    precision = max(a.precision - a.scale, b.precision - b.scale) + scale + 1
    return T.DecimalType(min(precision, MAX_PRECISION), scale)


def decimal_mul_result(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    return T.DecimalType(min(a.precision + b.precision + 1, MAX_PRECISION),
                         min(a.scale + b.scale, MAX_PRECISION))


def decimal_div_result(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    """Spark's divide result with adjustPrecisionScale (allowPrecisionLoss,
    the default): p = p1 - s1 + s2 + scale, scale = max(6, s1 + p2 + 1),
    squeezed into precision 38 keeping the integral digits, down to a
    scale of 6."""
    scale = max(6, a.scale + b.precision + 1)
    precision = a.precision - a.scale + b.scale + scale
    if precision <= MAX_PRECISION:
        return T.DecimalType(precision, scale)
    int_digits = precision - scale
    adj_scale = max(MAX_PRECISION - int_digits, min(scale, 6))
    return T.DecimalType(MAX_PRECISION, adj_scale)


def _decimal_pair(op: str, l: T.DataType, r: T.DataType) -> bool:
    """Whether the operands are decimals; mixing raises."""
    ld, rd = isinstance(l, T.DecimalType), isinstance(r, T.DecimalType)
    if ld != rd:
        raise NotImplementedError(
            f"decimal {op} of {l!r} and {r!r}: cast the non-decimal first")
    return ld


def _overflow_null(vals: torch.Tensor, validity: torch.Tensor,
                   precision: int) -> torch.Tensor:
    """Spark's non-ANSI decimal overflow -> null (int64 values)."""
    bound = 10 ** precision
    return validity & (vals < bound) & (vals > -bound)


class BinaryArithmetic(BinaryExpression):
    @property
    def dtype(self) -> T.DataType:
        l, r = self.left.dtype, self.right.dtype
        if _decimal_pair(type(self).__name__, l, r):
            if isinstance(self, Multiply):
                return decimal_mul_result(l, r)
            return decimal_add_result(l, r)
        return T.numeric_promote(l, r)

    def _op(self, lhs, rhs):
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        validity = null_propagating([lc.validity, rc.validity])
        if not isinstance(out_dt, T.DecimalType):
            vals = self._op(lc.data.to(out_dt.torch_dtype),
                            rc.data.to(out_dt.torch_dtype))
            return make_column(vals, validity, out_dt)
        if out_dt.uses_two_limbs or lc.is_two_limb or rc.is_two_limb:
            return self._eval_decimal128(lc, rc, validity, out_dt)
        if isinstance(self, Multiply):
            lhs, rhs = lc.data, rc.data
        else:
            lhs = lc.data * 10 ** (out_dt.scale - lc.dtype.scale)
            rhs = rc.data * 10 ** (out_dt.scale - rc.dtype.scale)
        vals = self._op(lhs, rhs)
        return make_column(vals, _overflow_null(vals, validity,
                                                out_dt.precision), out_dt)

    def _eval_decimal128(self, lc, rc, validity, out_dt):
        """Two limbs: an exact add / subtract at the result's scale, or an
        exact product rounded HALF_UP to the result's scale where that is
        capped below the operands' scales' sum; null past its precision."""
        from spark_rapids_tpu_torch.kernels import decimal as DK
        lv, rv = lc.validity, rc.validity
        if isinstance(self, Multiply):
            drop = lc.dtype.scale + rc.dtype.scale - out_dt.scale
            vals, valid = DK.decimal128_binary(
                DK.MUL, lc.data, lv, rc.data, rv,
                precision=out_dt.precision if drop == 0 else DK.INT128,
                out_two=out_dt.uses_two_limbs or drop > 0)
            if drop:
                vals, valid = DK.decimal128_divide(
                    vals, valid, DK.POW10[drop], precision=out_dt.precision,
                    out_two=out_dt.uses_two_limbs)
        else:
            vals, valid = DK.decimal128_binary(
                DK.ADD if isinstance(self, Add) else DK.SUB, lc.data, lv,
                rc.data, rv, ka=out_dt.scale - lc.dtype.scale,
                kb=out_dt.scale - rc.dtype.scale,
                precision=out_dt.precision, out_two=out_dt.uses_two_limbs)
        return make_column(vals, valid, out_dt)


class Add(BinaryArithmetic):
    symbol = "+"

    def _op(self, lhs, rhs):
        return lhs + rhs


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _op(self, lhs, rhs):
        return lhs - rhs


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _op(self, lhs, rhs):
        return lhs * rhs


class Divide(BinaryExpression):
    """Spark's Divide.  Non-decimals: a DOUBLE, NULL where the divisor is
    0.  Every such division is tensor by tensor, which is IEEE's on the
    CPU and the card alike: a literal divisor is a 0-d tensor on the
    device, because PyTorch's CUDA division by a host number multiplies
    by its reciprocal (ROADMAP queue 3).  Decimals: ``decimal_div_result``
    through ``decimal128_divide``, (a * 10**(s - s1 + s2)) / b with one
    HALF_UP rounding, NULL on a zero divisor or past the precision."""

    symbol = "/"

    @property
    def dtype(self) -> T.DataType:
        l, r = self.left.dtype, self.right.dtype
        if _decimal_pair("Divide", l, r):
            return decimal_div_result(l, r)
        for side in (l, r):
            if not (side.is_integral or side.is_floating):
                raise NotImplementedError(f"Divide of {side!r}")
        return T.DOUBLE

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype   # raises on a type the port does not divide
        if isinstance(out_dt, T.DecimalType):
            from spark_rapids_tpu_torch.kernels import decimal as DK
            lc = self.left.eval(ctx)
            rc = self.right.eval(ctx)
            shift = out_dt.scale - lc.dtype.scale + rc.dtype.scale
            vals, valid = DK.decimal128_divide(
                lc.data, lc.validity, rc.data, rc.validity, shift,
                precision=out_dt.precision, out_two=out_dt.uses_two_limbs)
            return make_column(vals, valid, out_dt)
        lc = self.left.eval(ctx)
        lhs = lc.data.to(torch.float64)
        r = self.right
        if isinstance(r, Literal) and r.value is not None:
            rhs = torch.full((), float(r.value), dtype=torch.float64,
                             device=lhs.device)
            validity = lc.validity & (rhs != 0)
        else:
            rc = r.eval(ctx)
            rhs = rc.data.to(torch.float64)
            validity = null_propagating([lc.validity, rc.validity]) & \
                (rhs != 0)
        safe = torch.where(rhs == 0, torch.ones((), dtype=torch.float64,
                                                device=lhs.device), rhs)
        return make_column(lhs / safe, validity, out_dt)


def _java_div_rem(lhs: torch.Tensor, rhs: torch.Tensor):
    """(quotient truncated toward zero, remainder with the dividend's
    sign) of integer tensors of one dtype, 0 where ``rhs`` is 0; a divisor
    of -1 never reaches the division."""
    one = torch.ones((), dtype=rhs.dtype, device=rhs.device)
    neg1 = rhs == -1
    safe = torch.where((rhs == 0) | neg1, one, rhs)
    q = torch.div(lhs, safe, rounding_mode="trunc")
    r = torch.fmod(lhs, safe)
    q = torch.where(neg1, torch.neg(lhs), q)    # MIN wraps to MIN
    return q, torch.where(neg1, 0 * one, r)


class IntegralDivide(BinaryExpression):
    """Spark ``div``: a LONG, NULL on a zero divisor, truncated toward
    zero."""

    symbol = "div"

    @property
    def dtype(self):
        return T.LONG

    def eval(self, ctx: EvalContext):
        for side in (self.left.dtype, self.right.dtype):
            if not side.is_integral:
                raise NotImplementedError(f"div of {side!r}")
        lc, rc = self.left.eval(ctx), self.right.eval(ctx)
        rhs = rc.data.to(torch.int64)
        q, _ = _java_div_rem(lc.data.to(torch.int64), rhs)
        validity = null_propagating([lc.validity, rc.validity]) & (rhs != 0)
        return make_column(q, validity, T.LONG)


class Remainder(BinaryArithmetic):
    """Spark ``%``: Java's remainder at the operands' promotion, NULL on a
    zero divisor; doubles as the reference computes them,
    ``a - trunc(a / b) * b``."""

    symbol = "%"

    @property
    def dtype(self) -> T.DataType:
        l, r = self.left.dtype, self.right.dtype
        if isinstance(l, T.DecimalType) or isinstance(r, T.DecimalType):
            raise NotImplementedError(f"% of {l!r} and {r!r}")
        return T.numeric_promote(l, r)

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype
        lc, rc = self.left.eval(ctx), self.right.eval(ctx)
        lhs = lc.data.to(out_dt.torch_dtype)
        rhs = rc.data.to(out_dt.torch_dtype)
        validity = null_propagating([lc.validity, rc.validity]) & (rhs != 0)
        if out_dt.is_floating:
            safe = torch.where(rhs == 0, torch.ones((), dtype=rhs.dtype,
                                                    device=rhs.device), rhs)
            rem = lhs - torch.trunc(lhs / safe) * safe
        else:
            _, rem = _java_div_rem(lhs, rhs)
        return make_column(rem, validity, out_dt)


class _UnaryArithmetic(UnaryExpression):
    @property
    def dtype(self):
        dt = self.child.dtype
        if not isinstance(dt, T.NumericType) or T.two_limbs(dt):
            raise NotImplementedError(f"{type(self).__name__} of {dt!r}")
        return dt

    def _op(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype
        c = self.child.eval(ctx)
        return make_column(self._op(c.data), c.validity, out_dt)


class UnaryMinus(_UnaryArithmetic):
    """-x: integers (and a Decimal64's unscaled value) wrap, -MIN is MIN."""

    def _op(self, x):
        return torch.neg(x)

    def __repr__(self):
        return f"(-{self.child!r})"


class Abs(_UnaryArithmetic):
    """abs(x): abs(MIN) wraps to MIN."""

    def _op(self, x):
        return torch.abs(x)

    def __repr__(self):
        return f"abs({self.child!r})"
