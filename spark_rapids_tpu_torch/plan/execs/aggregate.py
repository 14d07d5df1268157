"""Hash-aggregate exec, global and grouped.

Counterpart of ``spark_rapids_tpu/plan/execs/aggregate.py``
(``TpuHashAggregateExec`` :783; ``_partial_step`` :505-580, ``_merge_step``
:657-735, ``_finalize`` :736; ``_global_update`` :274) in the three modes
Spark plans:
  * partial:  raw rows -> one partial batch per input batch: with no keys
              one row of buffer slots, grouped the keys of each group then
              its buffer slots;
  * final:    partial batches -> concat (aggregate.py:845-862) -> merge ->
              finalize;
  * complete: both, for a single-partition child.
A global aggregate over a partition with no input yields the identity
partial (counts 0, sums null; aggregate.py:881), so it still gives one
row, and SUM over no valid row is NULL (the ``nvalid > 0`` flag,
aggregate.py:283-286).  A grouped partition with no input yields no rows.

Grouped steps are sort-based (kernels/groupby.py): the keys and every
aggregate input form one work batch, which is sorted by the keys and cut
into groups; each buffer slot is then a segmented reduction over it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.aggregates import (
    COUNT_STAR, COUNT_VALID, SUM, AggregateFunction)
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels.reduction import masked_sum
from spark_rapids_tpu_torch.kernels.selection import coalesce_to_one
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed


class _Sums(G.ReductionCache):
    """masked_sum results of one step (see ReductionCache)."""

    def _reduce(self, data: torch.Tensor, validity: torch.Tensor):
        return masked_sum(data, validity)


def _global_update(op: str, col: DeviceColumn, num_rows: int,
                   out_dtype: T.DataType, device,
                   sums: Optional[_Sums] = None) -> DeviceColumn:
    """Whole-batch reduction of one slot to a one-row column."""
    sums = _Sums() if sums is None else sums
    ones = torch.ones(1, dtype=torch.bool, device=device)
    if op == COUNT_STAR:
        # exact-size columns: the row count is already a host int
        return DeviceColumn(torch.full((1,), num_rows, dtype=torch.int64,
                                       device=device), ones, T.LONG)
    if op == COUNT_VALID:
        return DeviceColumn(sums.count_of(col)[2], ones, T.LONG)
    if op == SUM:
        value, ok, _ = sums.of(col, out_dtype.torch_dtype)
        return DeviceColumn(value, ok, out_dtype)
    raise NotImplementedError(f"aggregate op {op!r} is not ported")


def _seg_update(op: str, col: DeviceColumn, out_dtype: T.DataType,
                sums: G.SegmentSums) -> DeviceColumn:
    """Segmented reduction of one slot to a [num_groups] column."""
    if op == COUNT_STAR:
        v, valid = G.seg_count_star(sums)
    elif op == COUNT_VALID:
        v, valid = G.seg_count_valid(col, sums)
    elif op == SUM:
        v, valid = G.seg_sum(col, sums, out_dtype.torch_dtype)
    else:
        raise NotImplementedError(f"aggregate op {op!r} is not ported")
    return G.finalize_agg_column(v, valid, out_dtype)


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
        if mode not in ("partial", "final", "complete"):
            raise ValueError(f"unknown aggregate mode {mode!r}")
        self.group_exprs = tuple(group_exprs)
        self.agg_exprs = tuple(agg_exprs)
        self.aggregates = list(aggregates)
        self.mode = mode
        self.device = device   # where an identity partial is made
        self.slot_specs = [(ai, slot) for ai, agg in enumerate(self.aggregates)
                           for slot in agg.buffers]
        nkeys = len(self.group_exprs)
        self.partial_schema = Schema(
            tuple(f"_k{i}" for i in range(nkeys))
            + tuple(f"_buf{i}" for i in range(len(self.slot_specs))),
            tuple(e.dtype for e in self.group_exprs)
            + tuple(s.dtype for _, s in self.slot_specs))
        super().__init__((child,),
                         self.partial_schema if mode == "partial" else schema)

    # -- device steps ---------------------------------------------------------

    def _partial_step(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Raw rows -> one partial batch."""
        ctx = EvalContext(batch)
        nkeys = len(self.group_exprs)
        inputs: Dict[int, DeviceColumn] = {
            ai: agg.input.eval(ctx) for ai, agg in enumerate(self.aggregates)
            if agg.input is not None}
        if nkeys == 0:
            sums = _Sums()
            cols = tuple(_global_update(slot.update_op, inputs.get(ai),
                                        batch.num_rows, slot.dtype,
                                        batch.device, sums)
                         for ai, slot in self.slot_specs)
            return ColumnarBatch(cols, 1, self.partial_schema)
        # grouped: keys + inputs in one work batch, sorted and grouped once
        work_cols = [e.eval(ctx) for e in self.group_exprs]
        col_of_agg = {}
        for ai, c in inputs.items():
            col_of_agg[ai] = len(work_cols)
            work_cols.append(c)
        work = ColumnarBatch(tuple(work_cols), batch.num_rows, Schema(
            tuple(f"c{i}" for i in range(len(work_cols))),
            tuple(c.dtype for c in work_cols)))
        return self._grouped_step(
            work, [col_of_agg.get(ai) for ai, _ in self.slot_specs],
            [slot.update_op for _, slot in self.slot_specs])

    def _merge_step(self, partial: ColumnarBatch) -> ColumnarBatch:
        """Concatenated partial batches -> one merged partial batch."""
        nkeys = len(self.group_exprs)
        if nkeys == 0:
            sums = _Sums()
            cols = tuple(_global_update(slot.merge_op, partial.columns[si],
                                        partial.num_rows, slot.dtype,
                                        partial.device, sums)
                         for si, (_, slot) in enumerate(self.slot_specs))
            return ColumnarBatch(cols, 1, self.partial_schema)
        return self._grouped_step(
            partial, [nkeys + si for si in range(len(self.slot_specs))],
            [slot.merge_op for _, slot in self.slot_specs])

    def _grouped_step(self, work: ColumnarBatch,
                      inputs: List[Optional[int]], ops: List[str]
                      ) -> ColumnarBatch:
        """Group ``work`` by its leading key columns, then reduce slot i's
        work column ``inputs[i]`` (None: no input) with ``ops[i]``."""
        nkeys = len(self.group_exprs)
        layout = G.group_rows(work, list(range(nkeys)))
        sums = G.SegmentSums(layout)
        cols = G.group_keys_output(layout, list(range(nkeys)))
        for ci, op, (_, slot) in zip(inputs, ops, self.slot_specs):
            col = layout.sorted_batch.columns[ci] if ci is not None else None
            cols.append(_seg_update(op, col, slot.dtype, sums))
        return ColumnarBatch(tuple(cols), layout.num_groups,
                             self.partial_schema)

    def _finalize(self, merged: ColumnarBatch) -> ColumnarBatch:
        """Merged partials -> output rows (keys, then output exprs)."""
        nkeys = len(self.group_exprs)
        mapping = {}
        si = nkeys
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
        cols = tuple(merged.columns[:nkeys]) + tuple(
            _substitute(e, mapping).eval(ctx) for e in self.agg_exprs)
        return ColumnarBatch(cols, merged.num_rows, self.schema)

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
                if self.group_exprs:
                    return
                partials = [self._identity_partial()]
            if self.mode == "partial":
                out = partials
            else:
                merged_in = coalesce_to_one(partials)
                out = [self._finalize(self._merge_step(merged_in))]
        for b in out:
            yield self._count_out(b)

    def describe(self):
        keys = ", ".join(map(repr, self.group_exprs))
        return (f"GpuHashAggregate[{self.mode}, keys=[{keys}], "
                f"{', '.join(map(repr, self.agg_exprs))}]")
