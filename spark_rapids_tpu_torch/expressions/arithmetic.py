"""Arithmetic with Spark (non-ANSI) semantics.

Counterpart of ``spark_rapids_tpu/expressions/arithmetic.py`` (``Add``
:231, ``Subtract`` :239, ``Multiply`` :247 over ``BinaryArithmetic`` :82,
``Divide`` :255), non-decimal numeric operands only: inputs promote to the
wider type, integral results wrap, double results follow IEEE-754, and
nulls propagate.  Division is always DOUBLE and NULL on a zero divisor.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    BinaryExpression, EvalContext, Literal, make_column, null_propagating)


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


class Divide(BinaryExpression):
    """Spark's Divide over non-decimal numbers: a DOUBLE, NULL where the
    divisor is 0.  Every division is tensor by tensor, which is IEEE's on
    the CPU and the card alike: a literal divisor is a 0-d tensor on the
    device, because PyTorch's CUDA division by a host number multiplies
    by its reciprocal (ROADMAP queue 3).  The reference's decimal path
    (the 256-bit quotient) is not ported and raises."""

    symbol = "/"

    @property
    def dtype(self) -> T.DataType:
        for side in (self.left.dtype, self.right.dtype):
            if isinstance(side, T.DecimalType):
                raise NotImplementedError(
                    "decimal Divide is not ported; cast to double first")
            if not (side.is_integral or side.is_floating):
                raise NotImplementedError(f"Divide of {side!r}")
        return T.DOUBLE

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype   # raises on a type the port does not divide
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
