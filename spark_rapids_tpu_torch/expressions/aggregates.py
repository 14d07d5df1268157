"""Declarative aggregate functions: SUM, COUNT, AVG, MIN, MAX, the
variances and standard deviations, BOOL_AND and BOOL_OR.

Counterpart of ``spark_rapids_tpu/expressions/aggregates.py`` (``Sum`` :91,
``Count`` :134, ``Min`` :172, ``Max`` :204, ``Average`` :236,
``VarianceBase`` :382 with ``_finish`` :413, ``VarianceSamp``,
``VariancePop``, ``StddevSamp``, ``StddevPop`` :434-454, ``BoolAnd`` /
``BoolOr`` :476-490; non-decimal inputs, and Decimal64 for MIN / MAX).
Each function declares its buffer slots: the slot's type, how raw rows
fold into it (``update_op``) and how partial buffers fold together
(``merge_op``; counts update by counting and merge by summing), plus a
finalize step over the merged buffers.  The exec layer
(plan/execs/aggregate.py) lowers the ops onto the masked kernels (no
keys) or the segmented kernels (grouped) of ``kernels/reduction.py``.

Type rules follow Spark: sum(integral) -> LONG, sum(floating) -> DOUBLE,
count -> LONG (never null), avg(numeric) -> DOUBLE (null over no valid
row), min / max keep the input type (null over no valid row), the
variances and standard deviations are DOUBLE over the buffers (SUM
DOUBLE, M2 merged by Chan's formula, COUNT_VALID), null where the
divisor would be 0.  MIN / MAX over STRING and over two-limb decimals
raise: their kernels are still to port (ROADMAP queue 2).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import Expression, col

SUM = "sum"
M2 = "m2"                    # sum of squared deviations from the group mean
M2_MERGE = "m2_merge"        # Chan's parallel merge of partial M2 buffers
COUNT_VALID = "count_valid"  # counts non-null inputs
COUNT_STAR = "count_star"    # counts rows
MIN = "min"
MAX = "max"


@dataclasses.dataclass(frozen=True)
class BufferSlot:
    """One aggregation buffer column."""

    dtype: T.DataType
    update_op: str
    merge_op: str


class AggregateFunction(Expression):
    """Base: children[0] (if any) is the input value expression."""

    name = "agg"

    @property
    def input(self) -> Optional[Expression]:
        return self.children[0] if self.children else None

    def with_children(self, children):
        return type(self)(children[0]) if children else type(self)()

    @property
    def buffers(self) -> Tuple[BufferSlot, ...]:
        raise NotImplementedError

    def finalize(self, bufs: List[Tuple[torch.Tensor, torch.Tensor]]):
        """(values, validity) per merged buffer -> (values, validity)."""
        raise NotImplementedError

    def __repr__(self):
        inner = repr(self.input) if self.input is not None else "*"
        return f"{self.name}({inner})"


class Sum(AggregateFunction):
    name = "sum"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        cdt = self.input.dtype
        if cdt.is_integral or isinstance(cdt, T.BooleanType):
            return T.LONG
        if cdt.is_floating:
            return T.DOUBLE
        raise NotImplementedError(f"sum({cdt!r}) is not ported")

    @property
    def buffers(self):
        return (BufferSlot(self.dtype, SUM, SUM),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        (s, s_valid), (n, _) = bufs
        return s, (n > 0) & s_valid


class Count(AggregateFunction):
    """count(expr) counts non-null rows; Count(None) counts rows."""

    name = "count"

    def __init__(self, child: Optional[Expression] = None):
        self.children = (child,) if child is not None else ()

    @property
    def dtype(self):
        return T.LONG

    @property
    def buffers(self):
        op = COUNT_STAR if self.input is None else COUNT_VALID
        return (BufferSlot(T.LONG, op, SUM),)

    def finalize(self, bufs):
        (n, _), = bufs
        return n, torch.ones(n.shape, dtype=torch.bool, device=n.device)


class Average(AggregateFunction):
    """avg over a non-decimal numeric input: buffers (DOUBLE SUM, LONG
    COUNT_VALID merged by SUM), result sum / count, null when the count is
    0.  Decimal avg (the reference's two-limb SUM128 buffer) is not
    ported."""

    name = "avg"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        cdt = self.input.dtype
        if cdt.is_integral or cdt.is_floating:
            return T.DOUBLE
        raise NotImplementedError(f"avg({cdt!r}) is not ported")

    @property
    def buffers(self):
        return (BufferSlot(self.dtype, SUM, SUM),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        (s, _), (n, _) = bufs
        valid = n > 0
        return s / torch.where(valid, n, 1).to(s.dtype), valid


class _Extreme(AggregateFunction):
    """MIN / MAX: buffers (the extreme at the input's type, LONG
    COUNT_VALID merged by SUM), valid where the count is > 0.  Floats
    follow Spark's order: NaN above everything (MIN skips NaN unless the
    group holds nothing else, any NaN makes MAX NaN), and -0.0 below 0.0,
    as the reference's extremes give it on the CPU.  A two-limb decimal
    (the reference's MIN128 / MAX128 buffers) cannot reach here: the
    port's ``DecimalType`` refuses a precision above 18."""

    op = MIN

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        dt = self.input.dtype
        if dt.variable_width:
            raise NotImplementedError(
                f"{self.name}({dt!r}) is not ported: string MIN / MAX "
                "(string_order_rank, seg_extreme_string, "
                "global_extreme_string) is ROADMAP queue 2")
        return dt

    @property
    def buffers(self):
        return (BufferSlot(self.dtype, self.op, self.op),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        (v, _), (n, _) = bufs
        return v, n > 0


class Min(_Extreme):
    name = "min"
    op = MIN


class Max(_Extreme):
    name = "max"
    op = MAX


class BoolAnd(Min):
    """bool_and / every: true iff every non-null value is true, which is
    MIN over BOOLEAN."""

    name = "bool_and"


class BoolOr(Max):
    """bool_or / any / some: MAX over BOOLEAN."""

    name = "bool_or"


class VarianceBase(AggregateFunction):
    """The shared (SUM DOUBLE, M2, COUNT_VALID) buffer plan.  M2 is the
    sum of squared deviations from the group mean, taken in two passes
    over a batch and merged with Chan's formula (M2 = sum_i M2_i +
    n_i (mean_i - mean)^2), which does not cancel when mean >> stddev as
    the sum-of-squares identity does."""

    name = "var"
    _sample = True    # divide by n - 1 (sample) or n (population)
    _sqrt = False     # a standard deviation

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        cdt = self.input.dtype
        if not (cdt.is_integral or cdt.is_floating):
            raise NotImplementedError(f"{self.name}({cdt!r}) is not ported")
        return T.DOUBLE

    @property
    def buffers(self):
        return (BufferSlot(T.DOUBLE, SUM, SUM),
                BufferSlot(T.DOUBLE, M2, M2_MERGE),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        """The reference's ``_finish``: max(M2, 0) over n - 1 or n, null
        where that divisor is not positive; NaN stays NaN."""
        _, (m2, _), (n, _) = bufs
        ok = n > (1 if self._sample else 0)
        nf = torch.where(n > 0, n, 1).to(m2.dtype)
        div = nf - 1 if self._sample else nf
        var = torch.maximum(m2, torch.zeros((), dtype=m2.dtype,
                                            device=m2.device))
        var = var / torch.where(ok, div, torch.ones((), dtype=div.dtype,
                                                    device=div.device))
        if self._sqrt:
            var = torch.sqrt(var)
        return var, ok


class VarianceSamp(VarianceBase):
    name = "var_samp"
    _sample = True


class VariancePop(VarianceBase):
    name = "var_pop"
    _sample = False


class StddevSamp(VarianceBase):
    name = "stddev_samp"
    _sample = True
    _sqrt = True


class StddevPop(VarianceBase):
    name = "stddev_pop"
    _sample = False
    _sqrt = True


def find_aggregates(e: Expression) -> List[AggregateFunction]:
    """All aggregate calls inside an output expression tree."""
    if isinstance(e, AggregateFunction):
        return [e]
    out: List[AggregateFunction] = []
    for c in e.children:
        out += find_aggregates(c)
    return out


def sum_(e) -> Sum:
    return Sum(col(e) if isinstance(e, str) else e)


def count(e=None) -> Count:
    if e is None:
        return Count()
    return Count(col(e) if isinstance(e, str) else e)


def avg(e) -> Average:
    return Average(col(e) if isinstance(e, str) else e)


def _arg(e) -> Expression:
    return col(e) if isinstance(e, str) else e


def min_(e) -> Min:
    return Min(_arg(e))


def max_(e) -> Max:
    return Max(_arg(e))


def var_samp(e) -> VarianceSamp:
    return VarianceSamp(_arg(e))


def var_pop(e) -> VariancePop:
    return VariancePop(_arg(e))


def stddev(e) -> StddevSamp:
    return StddevSamp(_arg(e))


def stddev_pop(e) -> StddevPop:
    return StddevPop(_arg(e))
