"""Declarative aggregate functions: SUM, COUNT and AVG.

Counterpart of ``spark_rapids_tpu/expressions/aggregates.py`` (``Sum`` :91,
``Count`` :134, ``Average`` :236, non-decimal inputs).  Each function declares its buffer slots: the slot's
type, how raw rows fold into it (``update_op``) and how partial buffers
fold together (``merge_op``; counts update by counting and merge by
summing), plus a finalize step over the merged buffers.  The exec layer
(plan/execs/aggregate.py) lowers the ops onto the masked-sum kernel (no
keys) or the segmented-sum kernel (grouped).

Type rules follow Spark: sum(integral) -> LONG, sum(double) -> DOUBLE,
count -> LONG (never null), avg(numeric) -> DOUBLE (null over no valid
row).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import Expression, col

SUM = "sum"
COUNT_VALID = "count_valid"  # counts non-null inputs
COUNT_STAR = "count_star"    # counts rows


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
        if isinstance(cdt, T.DoubleType):
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
        if cdt.is_integral or isinstance(cdt, T.DoubleType):
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
