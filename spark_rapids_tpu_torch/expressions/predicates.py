"""Comparison and boolean predicates.

Counterpart of ``spark_rapids_tpu/expressions/predicates.py``
(``EqualTo`` :160, ``LessThan`` :174, ``LessThanOrEqual`` :201,
``GreaterThanOrEqual`` :213, ``And`` :262), numeric, date and Decimal64
operands; a comparison of strings is not ported.  Spark semantics:
NaN equals NaN and is larger than every other double; a comparison with a
null operand is null; AND is three-valued (FALSE AND null = FALSE).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    BinaryExpression, EvalContext, make_column, null_propagating)


def _cmp_dtype(l: T.DataType, r: T.DataType) -> T.DataType:
    """Common comparison type: the wider decimal, or numeric promotion."""
    if l == r:
        return l
    if isinstance(l, T.DecimalType) and isinstance(r, T.DecimalType):
        scale = max(l.scale, r.scale)
        intd = max(l.precision - l.scale, r.precision - r.scale)
        return T.DecimalType(intd + scale, scale)
    return T.numeric_promote(l, r)


def _rescale(unscaled, from_scale: int, to_scale: int):
    """arithmetic.py:68 _rescale_unscaled: no work when the scales agree."""
    if to_scale == from_scale:
        return unscaled
    return unscaled * (10 ** (to_scale - from_scale))


class BinaryComparison(BinaryExpression):
    @property
    def dtype(self):
        return T.BOOLEAN

    def _compare(self, lhs, rhs, is_float):
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        if lc.is_string or rc.is_string:
            raise NotImplementedError(f"string comparison {self.symbol} is "
                                      "not ported")
        cdt = _cmp_dtype(lc.dtype, rc.dtype)
        validity = null_propagating([lc.validity, rc.validity])
        if isinstance(cdt, T.DecimalType):
            # compare unscaled int64 values at the common scale
            lhs = _rescale(lc.data, lc.dtype.scale, cdt.scale)
            rhs = _rescale(rc.data, rc.dtype.scale, cdt.scale)
            is_float = False
        else:
            lhs = lc.data.to(cdt.torch_dtype)
            rhs = rc.data.to(cdt.torch_dtype)
            is_float = cdt.is_floating
        return make_column(self._compare(lhs, rhs, is_float), validity,
                           T.BOOLEAN)


def _lt(lhs, rhs, is_float):
    lt = lhs < rhs
    if is_float:
        # NaN is greater than everything: l < NaN iff l is not NaN
        lt = torch.where(torch.isnan(rhs), ~torch.isnan(lhs), lt)
    return lt


def _eq(lhs, rhs, is_float):
    eq = lhs == rhs
    if is_float:
        eq = eq | (torch.isnan(lhs) & torch.isnan(rhs))
    return eq


class EqualTo(BinaryComparison):
    symbol = "="

    def _compare(self, lhs, rhs, is_float):
        return _eq(lhs, rhs, is_float)


class LessThan(BinaryComparison):
    symbol = "<"

    def _compare(self, lhs, rhs, is_float):
        return _lt(lhs, rhs, is_float)


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _compare(self, lhs, rhs, is_float):
        return _lt(lhs, rhs, is_float) | _eq(lhs, rhs, is_float)


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _compare(self, lhs, rhs, is_float):
        return _lt(rhs, lhs, is_float) | _eq(lhs, rhs, is_float)


class And(BinaryExpression):
    symbol = "AND"

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        lt = lc.data & lc.validity    # true-and-valid
        rt = rc.data & rc.validity
        lf = ~lc.data & lc.validity   # false-and-valid
        rf = ~rc.data & rc.validity
        validity = (lc.validity & rc.validity) | lf | rf
        return make_column(lt & rt, validity, T.BOOLEAN)
