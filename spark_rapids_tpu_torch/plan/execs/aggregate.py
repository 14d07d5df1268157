"""Hash-aggregate exec, global (no-key) aggregation.

Counterpart of ``spark_rapids_tpu/plan/execs/aggregate.py``
(``TpuHashAggregateExec`` :783, ``_global_update`` :274) in the three
modes Spark plans:
  * partial:  raw rows -> one partial row of buffer slots per batch;
  * final:    partial rows -> concat (aggregate.py:845-862) -> merge ->
              finalize, one output row per partition;
  * complete: both, for a single-partition child.
A partition with no input yields the identity partial (counts 0, sums
null; aggregate.py:881), so a global aggregate over no rows still gives
one row, and SUM over no valid row is NULL (the ``nvalid > 0`` flag,
aggregate.py:283-286).  Grouped aggregation is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.aggregates import (
    COUNT_STAR, COUNT_VALID, SUM, AggregateFunction)
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)
from spark_rapids_tpu_torch.kernels.reduction import masked_sum
from spark_rapids_tpu_torch.kernels.selection import concat_batches_device
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed

class _Sums:
    """masked_sum results of one step, one per input column, so that the
    SUM and COUNT_VALID slots of one aggregate share one launch.  Doubles
    sum as doubles, every other type as int64 (Sum.dtype's rule)."""

    def __init__(self):
        self._by_col: Dict[int, tuple] = {}

    def of(self, col: DeviceColumn):
        if id(col) not in self._by_col:
            data = col.data if col.data.dtype == torch.float64 \
                else col.data.to(torch.int64)
            # keep `col` alive beside its result: the key is its id()
            self._by_col[id(col)] = (col, masked_sum(data, col.validity))
        return self._by_col[id(col)][1]


def _global_update(op: str, col: DeviceColumn, num_rows: int,
                   out_dtype: T.DataType, device,
                   sums: _Sums = None) -> DeviceColumn:
    """Whole-batch reduction of one slot to a one-row column."""
    ones = torch.ones(1, dtype=torch.bool, device=device)
    if op == COUNT_STAR:
        # exact-size columns: the row count is already a host int
        return DeviceColumn(torch.full((1,), num_rows, dtype=torch.int64,
                                       device=device), ones, T.LONG)
    value, ok, nvalid = (sums or _Sums()).of(col)
    if op == COUNT_VALID:
        return DeviceColumn(nvalid, ones, T.LONG)
    if op == SUM:
        return DeviceColumn(value, ok, out_dtype)
    raise NotImplementedError(f"aggregate op {op!r} is not ported")


class _DeviceAggResult(Expression):
    """Leaf standing for a finalized aggregate inside an output expression."""

    def __init__(self, column: DeviceColumn):
        self.column = column

    @property
    def dtype(self):
        return self.column.dtype

    def eval(self, ctx):
        return self.column


def _substitute(e: Expression, mapping) -> Expression:
    if isinstance(e, AggregateFunction):
        return mapping[id(e)]
    if not e.children:
        return e
    return e.with_children(tuple(_substitute(c, mapping) for c in e.children))


class GpuHashAggregateExec(GpuExec):
    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Expression],
                 aggregates: List[AggregateFunction], child: GpuExec,
                 schema: Schema, device: torch.device,
                 mode: str = "complete"):
        if group_exprs:
            raise NotImplementedError("grouped aggregation is not ported")
        if mode not in ("partial", "final", "complete"):
            raise ValueError(f"unknown aggregate mode {mode!r}")
        self.agg_exprs = tuple(agg_exprs)
        self.aggregates = list(aggregates)
        self.mode = mode
        self.device = device   # where an identity partial is made
        self.slot_specs = [(ai, slot) for ai, agg in enumerate(self.aggregates)
                           for slot in agg.buffers]
        self.partial_schema = Schema(
            tuple(f"_buf{i}" for i in range(len(self.slot_specs))),
            tuple(s.dtype for _, s in self.slot_specs))
        super().__init__((child,),
                         self.partial_schema if mode == "partial" else schema)

    # -- device steps ---------------------------------------------------------

    def _partial_step(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Raw rows -> one partial row."""
        ctx = EvalContext(batch)
        inputs: Dict[int, DeviceColumn] = {}
        sums = _Sums()
        cols = []
        for ai, slot in self.slot_specs:
            agg = self.aggregates[ai]
            col = None
            if agg.input is not None:
                if ai not in inputs:
                    inputs[ai] = agg.input.eval(ctx)
                col = inputs[ai]
            cols.append(_global_update(slot.update_op, col, batch.num_rows,
                                       slot.dtype, batch.device, sums))
        return ColumnarBatch(tuple(cols), 1, self.partial_schema)

    def _merge_step(self, partial: ColumnarBatch) -> ColumnarBatch:
        """Concatenated partial rows -> one merged partial row."""
        sums = _Sums()
        cols = tuple(_global_update(slot.merge_op, partial.columns[si],
                                    partial.num_rows, slot.dtype,
                                    partial.device, sums)
                     for si, (_, slot) in enumerate(self.slot_specs))
        return ColumnarBatch(cols, 1, self.partial_schema)

    def _finalize(self, merged: ColumnarBatch) -> ColumnarBatch:
        """Merged partial row -> output row."""
        mapping = {}
        si = 0
        for agg in self.aggregates:
            bufs = []
            for _ in agg.buffers:
                c = merged.columns[si]
                bufs.append((c.data, c.validity))
                si += 1
            v, valid = agg.finalize(bufs)
            mapping[id(agg)] = _DeviceAggResult(
                make_column(v.to(agg.dtype.torch_dtype), valid, agg.dtype))
        ctx = EvalContext(merged)
        cols = tuple(_substitute(e, mapping).eval(ctx) for e in self.agg_exprs)
        return ColumnarBatch(cols, 1, self.schema)

    def _identity_partial(self) -> ColumnarBatch:
        """Counts 0 and valid; value slots null."""
        device = self.device
        cols = []
        for _, slot in self.slot_specs:
            is_count = slot.update_op in (COUNT_STAR, COUNT_VALID)
            cols.append(DeviceColumn(
                torch.zeros(1, dtype=slot.dtype.torch_dtype, device=device),
                torch.full((1,), is_count, dtype=torch.bool, device=device),
                slot.dtype))
        return ColumnarBatch(tuple(cols), 1, self.partial_schema)

    # -- host orchestration ---------------------------------------------------

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        with timed(self.op_time):
            partials = []
            for batch in self.children[0].execute_partition(idx):
                partials.append(batch if self.mode == "final"
                                else self._partial_step(batch))
            if not partials:
                partials = [self._identity_partial()]
            if self.mode == "partial":
                out = partials
            else:
                merged_in = (partials[0] if len(partials) == 1
                             else concat_batches_device(partials))
                out = [self._finalize(self._merge_step(merged_in))]
        for b in out:
            yield self._count_out(b)

    def describe(self):
        return (f"GpuHashAggregate[{self.mode}, "
                f"{', '.join(map(repr, self.agg_exprs))}]")
