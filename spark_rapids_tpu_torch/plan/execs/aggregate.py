"""Hash-aggregate exec, global and grouped.

Counterpart of ``spark_rapids_tpu/plan/execs/aggregate.py``
(``TpuHashAggregateExec`` :783; ``_partial_step`` :505-580, ``_merge_step``
:657-735 with its M2_MERGE dispatch :644 and :724, ``_finalize`` :736;
``_seg_update`` :91, ``_global_update`` :274, ``_global_m2_merge`` :318,
``_m2_companions`` :374, ``_identity_partial`` :881) in the three modes
Spark plans:
  * partial:  raw rows -> one partial batch per input batch: with no keys
              one row of buffer slots, grouped the keys of each group then
              its buffer slots;
  * final:    partial batches -> concat (aggregate.py:845-862) -> merge ->
              finalize;
  * complete: both, for a single-partition child.
A global aggregate over a partition with no input yields the identity
partial (counts 0, sums null; aggregate.py:881), so it still gives one
row, and SUM, MIN, MAX and M2 over no valid row are NULL (the
``nvalid > 0`` flag, aggregate.py:283-286).  A grouped partition with no
input yields no rows.

Grouped steps are sort-based (kernels/groupby.py): the keys and every
aggregate input form one work batch, which is sorted by the keys and cut
into groups; each buffer slot is then a segmented reduction over it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.aggregates import (
    COUNT_STAR, COUNT_VALID, M2, M2_MERGE, MAX, MIN, SUM, AggregateFunction)
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels.reduction import (masked_extreme,
                                                      masked_m2, masked_sum)
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
    if op == M2:
        # two passes: the mean from the sum the SUM slot shares
        total, ok, nvalid = sums.of(col, torch.float64)
        return DeviceColumn(masked_m2("update", col.data, col.validity,
                                      total, nvalid), ok, out_dtype)
    if op in (MIN, MAX):
        value, ok, _ = masked_extreme(col.data, col.validity, op == MIN)
        return DeviceColumn(value, ok, out_dtype)
    raise NotImplementedError(f"aggregate op {op!r} is not ported")


def _global_m2_merge(m2col: DeviceColumn, scol: DeviceColumn,
                     ncol: DeviceColumn, sums: _Sums) -> DeviceColumn:
    """Chan's merge over all partial rows to one group (see
    ``groupby.seg_m2_merge``)."""
    total = sums.of(scol, torch.float64)[0]
    n = sums.of(ncol, torch.int64)[0]
    m2 = masked_m2("merge", m2col.data, m2col.validity, total, n, scol.data,
                   ncol.data)
    return DeviceColumn(m2, n > 0, T.DOUBLE)


def _seg_update(op: str, col: DeviceColumn, out_dtype: T.DataType,
                sums: G.SegmentSums) -> DeviceColumn:
    """Segmented reduction of one slot to a [num_groups] column."""
    if op == COUNT_STAR:
        v, valid = G.seg_count_star(sums)
    elif op == COUNT_VALID:
        v, valid = G.seg_count_valid(col, sums)
    elif op == SUM:
        v, valid = G.seg_sum(col, sums, out_dtype.torch_dtype)
    elif op == M2:
        v, valid = G.seg_m2_update(col, sums)
    elif op == MIN:
        v, valid = G.seg_min(col, sums)
    elif op == MAX:
        v, valid = G.seg_max(col, sums)
    else:
        raise NotImplementedError(f"aggregate op {op!r} is not ported")
    return G.finalize_agg_column(v, valid, out_dtype)


def work_batch(cols: Sequence[DeviceColumn], num_rows: int) -> ColumnarBatch:
    """A grouped partial step's work batch of these columns."""
    return ColumnarBatch(tuple(cols), num_rows, Schema(
        tuple(f"c{i}" for i in range(len(cols))),
        tuple(c.dtype for c in cols)))


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
        #: aggregate index -> the indices of its slots
        self.slot_pos: Dict[int, List[int]] = {}
        for si, (ai, _) in enumerate(self.slot_specs):
            self.slot_pos.setdefault(ai, []).append(si)
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
        work = work_batch(tuple(e.eval(ctx) for e in self.work_exprs()),
                          batch.num_rows)
        if not self.group_exprs:
            return self.global_work_partial(work, batch.device)
        # grouped: keys + inputs in one work batch, sorted and grouped once
        return self.grouped_partial(work)

    def work_exprs(self) -> List[Expression]:
        """The columns of a partial step's work batch: the keys, then the
        input of each aggregate that has one."""
        return list(self.group_exprs) + [agg.input for agg in self.aggregates
                                         if agg.input is not None]

    def _work_inputs(self) -> List[Optional[int]]:
        """Each slot's column in the work batch (None: no input)."""
        col_of_agg = {}
        for ai, agg in enumerate(self.aggregates):
            if agg.input is not None:
                col_of_agg[ai] = len(self.group_exprs) + len(col_of_agg)
        return [col_of_agg.get(ai) for ai, _ in self.slot_specs]

    def grouped_partial(self, work: ColumnarBatch) -> ColumnarBatch:
        """A work batch (``work_exprs``' columns, evaluated here or by a
        fused segment's kernel) -> its partial batch."""
        return self._grouped_step(
            work, self._work_inputs(),
            [slot.update_op for _, slot in self.slot_specs])

    def global_work_partial(self, work: ColumnarBatch,
                            device: torch.device) -> ColumnarBatch:
        """A global aggregate's work batch (the inputs of ``work_exprs``,
        evaluated here or by a fused segment's kernel; no column at all
        for count(*)) -> its one-row partial on ``device``: each slot a
        whole-batch reduction (``_global_update``), the reductions of one
        input shared."""
        sums = _Sums()
        cols = tuple(_global_update(
            slot.update_op, work.columns[ci] if ci is not None else None,
            work.num_rows, slot.dtype, device, sums)
            for ci, (_, slot) in zip(self._work_inputs(), self.slot_specs))
        return ColumnarBatch(cols, 1, self.partial_schema)

    def m2_companions(self, ai: int) -> Tuple[int, int]:
        """The slot indices of aggregate ai's SUM and COUNT_VALID buffers,
        the companions of its M2: found by their ops, not their places, so
        that a change of the buffer plan fails here instead of merging the
        wrong columns."""
        s_si = n_si = None
        for si in self.slot_pos[ai]:
            op = self.slot_specs[si][1].update_op
            if op == SUM:
                s_si = si
            elif op == COUNT_VALID:
                n_si = si
        if s_si is None or n_si is None:
            raise AssertionError(
                f"M2_MERGE needs SUM and COUNT_VALID companion buffers on "
                f"{self.aggregates[ai]!r}")
        return s_si, n_si

    def global_partial(self, sums: Dict[int, tuple], rows: torch.Tensor,
                       one: torch.Tensor) -> ColumnarBatch:
        """The one-row partial of a batch from reductions taken elsewhere
        (a fused segment's kernel): ``sums[ai]`` is (sum at the SUM slot's
        type, nvalid > 0, nvalid) of aggregate ai's input, ``rows`` the
        batch's row count, ``one`` a true flag (each [1] on the device)."""
        cols = []
        for ai, slot in self.slot_specs:
            if slot.update_op == COUNT_STAR:
                cols.append(DeviceColumn(rows, one, T.LONG))
            elif slot.update_op == COUNT_VALID:
                cols.append(DeviceColumn(sums[ai][2], one, T.LONG))
            elif slot.update_op == SUM:
                cols.append(DeviceColumn(sums[ai][0], sums[ai][1],
                                         slot.dtype))
            else:
                raise NotImplementedError(
                    f"aggregate op {slot.update_op!r} is not ported")
        return ColumnarBatch(tuple(cols), 1, self.partial_schema)

    def _merge_step(self, partial: ColumnarBatch) -> ColumnarBatch:
        """Concatenated partial batches -> one merged partial batch."""
        nkeys = len(self.group_exprs)
        if nkeys == 0:
            sums = _Sums()
            cols = []
            for si, (ai, slot) in enumerate(self.slot_specs):
                col = partial.columns[si]
                if slot.merge_op == M2_MERGE:
                    s_si, n_si = self.m2_companions(ai)
                    cols.append(_global_m2_merge(
                        col, partial.columns[s_si], partial.columns[n_si],
                        sums))
                else:
                    cols.append(_global_update(
                        slot.merge_op, col, partial.num_rows, slot.dtype,
                        partial.device, sums))
            return ColumnarBatch(tuple(cols), 1, self.partial_schema)
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
        sorted_cols = layout.sorted_batch.columns
        for ci, op, (ai, slot) in zip(inputs, ops, self.slot_specs):
            col = sorted_cols[ci] if ci is not None else None
            if op == M2_MERGE:
                s_si, n_si = self.m2_companions(ai)
                v, valid = G.seg_m2_merge(col, sorted_cols[inputs[s_si]],
                                          sorted_cols[inputs[n_si]], sums)
                cols.append(G.finalize_agg_column(v, valid, slot.dtype))
            else:
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
        """Counts 0 and valid; the SUM, MIN, MAX and M2 slots null."""
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
