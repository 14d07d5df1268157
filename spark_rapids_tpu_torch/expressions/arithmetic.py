"""Arithmetic with Spark (non-ANSI) semantics.

Counterpart of ``spark_rapids_tpu/expressions/arithmetic.py`` (``Add``
:231, ``Subtract`` :239, ``Multiply`` :247 over ``BinaryArithmetic`` :82),
non-decimal numeric operands only: inputs promote to the wider type,
integral results wrap, double results follow IEEE-754, and nulls
propagate.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    BinaryExpression, EvalContext, make_column, null_propagating)


class BinaryArithmetic(BinaryExpression):
    @property
    def dtype(self) -> T.DataType:
        l, r = self.left.dtype, self.right.dtype
        if isinstance(l, T.DecimalType) or isinstance(r, T.DecimalType):
            raise NotImplementedError(
                f"decimal {type(self).__name__} is not ported; cast to "
                "double first")
        return T.numeric_promote(l, r)

    def _op(self, lhs, rhs):
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        vals = self._op(lc.data.to(out_dt.torch_dtype),
                        rc.data.to(out_dt.torch_dtype))
        return make_column(vals, null_propagating([lc.validity, rc.validity]),
                           out_dt)


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
