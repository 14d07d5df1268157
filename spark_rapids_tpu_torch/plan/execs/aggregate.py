"""Hash-aggregate exec, global and grouped.

Counterpart of ``spark_rapids_tpu/plan/execs/aggregate.py``
(``TpuHashAggregateExec`` :783; ``_partial_step`` :505-580 with its pick,
pick-by, string-extreme and bitwise branches (global :476-497, grouped
:553-575), ``_merge_step`` :657-735 with the same branches (global
:622-643, grouped :701-722) and its M2_MERGE dispatch :644 and :724,
``_finalize`` :736 (its HLL registers :745-747); ``_seg_update`` :91,
``_global_update`` :274, the HLL slots of the partial (global :452-456,
grouped :529-533) and of the merge (:591-598, :663-675),
``_global_m2_merge`` :318, ``_m2_companions`` :374, ``_by_companion``
:412, ``_identity_partial`` :881) in the three modes Spark plans:
  * partial:  raw rows -> one partial batch per input batch: with no keys
              one row of buffer slots, grouped the keys of each group then
              its buffer slots;
  * final:    partial batches -> concat (aggregate.py:845-862) -> merge ->
              finalize;
  * complete: both, for a single-partition child.
A global aggregate's partial of no input rows has no rows: its merge
over the partials' rows still gives one row, SUM, MIN, MAX and M2 over no
valid row are NULL (the ``nvalid > 0`` flag, aggregate.py:283-286) and
counts 0.  The reference makes a one-row identity partial instead
(:881): its fixed shapes need one, and FIRST / LAST at its merge then pick
that row's null over a later partition's first row; here a batch with no
rows offers FIRST / LAST no candidate, as Spark's and the reference's CPU
oracle's answers have it.  A grouped partition with no input yields no
rows.

The final and complete modes merge a partition's partials in one batch
when they hold at most ``batchSizeRows`` rows (``target_rows``), the
concat inside the retry body: over a hash exchange, read through its
shuffle pieces under ``retry_over_stream_pieces`` (the reference's
``_execute_final_fused`` :906-952).  A larger partial set takes the
reference's out-of-core branch (``_execute_out_of_core`` :1009): grouped,
the partials are hash-sub-partitioned on the keys into spillable buckets,
and each bucket is merged and finalized alone (equal keys share a bucket,
and a bucket keeps its rows' order, so FIRST / LAST still see them in
order); global, the partials merge in runs of at most ``target_rows``
rows until one is left.  Each partial step runs under retry,
split-capable (``coalesce.retry_per_batch``): a split-and-retry OOM halves
its batch, whose halves' partials stand for the batch's.

Grouped steps are sort-based (kernels/groupby.py): the keys and every
aggregate input form one work batch, which is sorted by the keys and cut
into groups (the partial step lets a string key sort by its hash word and
a group come out split, as the reference's :506-522 does; the merge,
final and complete steps group by the exact bytes); each buffer slot is
then a segmented reduction over it, or
a pick (FIRST / LAST, MAX_BY / MIN_BY, string MIN / MAX) whose rows the
gather moves.  A MAX_BY / MIN_BY value slot picks by the column of its
second input when it updates, and by its ordering-key buffer
(``by_companion``) when it merges.  An APPROX_COUNT_DISTINCT slot is a
group's HyperLogLog++ registers, a fixed-length array row ([groups, m]
int8): L1 (``kernels/hll.py`` ``hll_update``) over the whole batch or
per group of the sorted work batch, L2 (``hll_merge``) over the partial
rows (one segment for a global merge); the rows ride the gather, the
concat, the exchange and spill as any fixed-width row.
"""
from __future__ import annotations

import collections
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.aggregates import (
    BIT_OPS, BY_OPS, COUNT_STAR, COUNT_VALID, HLL_MERGE, HLL_UPDATE, M2,
    M2_MERGE, MAX, MAX128, MIN, MIN128, MINBY_VAL, PICK_OPS, SUM, SUM128,
    AggregateFunction)
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels.hll import hll_merge, hll_update
from spark_rapids_tpu_torch.kernels.reduction import (
    masked_extreme, masked_extreme128, masked_m2, masked_sum, masked_sum128,
    segmented_extreme128, segmented_sum128)
from spark_rapids_tpu_torch.kernels.selection import coalesce_to_one
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
from spark_rapids_tpu_torch.memory.spill import make_spillable
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.plan.execs.coalesce import (
    retry_over_spillable, retry_over_stream_pieces, retry_per_batch)
from spark_rapids_tpu_torch.plan.execs.out_of_core import (
    close_all, drain, num_sub_buckets, sub_partition_spillable)
from spark_rapids_tpu_torch.plan.execs.join import empty_batch


class _Sums(G.ReductionCache):
    """masked_sum results of one step (see ReductionCache)."""

    def _reduce(self, data: torch.Tensor, validity: torch.Tensor):
        return masked_sum(data, validity)


def _global_tail_op(op: str, col: DeviceColumn,
                 ycol: Optional[DeviceColumn]) -> Optional[DeviceColumn]:
    """A slot of the aggregate tail (a pick, a string MIN / MAX, a bitwise
    reduction) over the whole batch, or None for the other ops; ``ycol``:
    a MAX_BY / MIN_BY slot's ordering column."""
    if op in PICK_OPS:
        return G.global_pick(col, op.endswith("_valid"),
                             op.startswith("last"))
    if op in BY_OPS:
        return G.global_pick_by(col, ycol, op == MINBY_VAL)
    if op in (MIN, MAX) and col.is_string:
        return G.global_extreme_string(col, op == MIN)
    if op in BIT_OPS:
        return DeviceColumn(*G.global_bitwise(col, op), col.dtype)
    return None


def _seg_tail_op(op: str, col: DeviceColumn, ycol: Optional[DeviceColumn],
              layout: G.GroupedLayout) -> Optional[DeviceColumn]:
    """``_global_tail_op`` per group."""
    if op in PICK_OPS:
        return G.seg_pick(col, layout, op.endswith("_valid"),
                          op.startswith("last"))
    if op in BY_OPS:
        return G.seg_pick_by(col, ycol, layout, op == MINBY_VAL)
    if op in (MIN, MAX) and col.is_string:
        return G.seg_extreme_string(col, layout, op == MIN)
    if op in BIT_OPS:
        return DeviceColumn(*G.seg_bitwise(col, layout, op), col.dtype)
    return None


def _hll_slot(op: str, col: DeviceColumn, out_dtype: T.DataType,
              starts: Optional[torch.Tensor]) -> DeviceColumn:
    """An HLL_UPDATE / HLL_MERGE slot over the segments that ``starts``
    opens (None: the whole batch, one sketch); the buffer's length is
    m = 2^p."""
    if op == HLL_UPDATE:
        regs = hll_update(col, out_dtype.length.bit_length() - 1, starts)
    else:
        if starts is None:       # the global merge: one segment
            starts = torch.zeros(1, dtype=torch.int32, device=col.device)
        regs = hll_merge(col.data, col.validity, starts)
    return DeviceColumn(regs, torch.ones(regs.shape[0], dtype=torch.bool,
                                         device=regs.device), out_dtype)


def _global_update(op: str, col: DeviceColumn, num_rows: int,
                   out_dtype: T.DataType, device,
                   sums: Optional[_Sums] = None,
                   ycol: Optional[DeviceColumn] = None,
                   ncol: Optional[DeviceColumn] = None) -> DeviceColumn:
    """Whole-batch reduction of one slot to a one-row column; ``ncol``: a
    SUM128 merge's COUNT_VALID partials."""
    picked = _global_tail_op(op, col, ycol) if col is not None else None
    if picked is not None:
        return picked
    if op in (HLL_UPDATE, HLL_MERGE):
        return _hll_slot(op, col, out_dtype, None)
    if op == SUM128:     # _global_sum128, aggregate.py:160
        out, ok, _ = masked_sum128(col.data, col.validity,
                                   out_dtype.precision,
                                   ncol.data if ncol is not None else None)
        return DeviceColumn(out, ok, out_dtype)
    if op in (MIN128, MAX128):    # _global_extreme128, aggregate.py:147
        return DeviceColumn(*masked_extreme128(col.data, col.validity,
                                               op == MIN128), out_dtype)
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
                sums: G.SegmentSums,
                ncol: Optional[DeviceColumn] = None) -> DeviceColumn:
    """Segmented reduction of one slot to a [num_groups] column; ``ncol``:
    a SUM128 merge's COUNT_VALID partials."""
    starts = sums.layout.starts
    if op in (HLL_UPDATE, HLL_MERGE):
        return _hll_slot(op, col, out_dtype, starts)
    if op == SUM128:     # _seg_sum128, aggregate.py:108
        out, ok, _ = segmented_sum128(col.data, col.validity, starts,
                                      out_dtype.precision,
                                      ncol.data if ncol is not None else None)
        return DeviceColumn(out, ok, out_dtype)
    if op in (MIN128, MAX128):    # _seg_extreme128, aggregate.py:136
        return DeviceColumn(*segmented_extreme128(
            col.data, col.validity, starts, op == MIN128), out_dtype)
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
                 mode: str = "complete", target_rows: int = 1 << 20):
        if mode not in ("partial", "final", "complete"):
            raise ValueError(f"unknown aggregate mode {mode!r}")
        self.group_exprs = tuple(group_exprs)
        self.agg_exprs = tuple(agg_exprs)
        self.aggregates = list(aggregates)
        self.mode = mode
        self.device = device   # where an identity partial is made
        self.target_rows = max(int(target_rows), 1)
        #: partitions that took each branch ("in_core", "out_of_core")
        self.branches: "collections.Counter[str]" = collections.Counter()
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
        inputs of each aggregate."""
        return list(self.group_exprs) + [e for agg in self.aggregates
                                         for e in agg.inputs]

    def _work_inputs(self) -> Tuple[List[Optional[int]],
                                    List[Optional[int]]]:
        """Each slot's column in the work batch (None: no input), and a
        MAX_BY / MIN_BY value slot's ordering column (else None)."""
        col_of = {}
        for ai, agg in enumerate(self.aggregates):
            for ii in range(len(agg.inputs)):
                col_of[(ai, ii)] = len(self.group_exprs) + len(col_of)
        inputs = [col_of.get((ai, slot.input_index))
                  for ai, slot in self.slot_specs]
        by = [col_of[(ai, 1)] if slot.update_op in BY_OPS else None
              for ai, slot in self.slot_specs]
        return inputs, by

    def grouped_partial(self, work: ColumnarBatch) -> ColumnarBatch:
        """A work batch (``work_exprs``' columns, evaluated here or by a
        fused segment's kernel) -> its partial batch.  It groups with split
        groups allowed (the reference's :506-522): its rows meet the merge
        step, which groups exactly, as partials of other batches do, so a
        string key sorts by its one hash word."""
        return self._grouped_step(
            work, *self._work_inputs(),
            [slot.update_op for _, slot in self.slot_specs],
            allow_split_groups=True)

    def global_work_partial(self, work: ColumnarBatch,
                            device: torch.device) -> ColumnarBatch:
        """A global aggregate's work batch (the inputs of ``work_exprs``,
        evaluated here or by a fused segment's kernel; no column at all
        for count(*)) -> its one-row partial on ``device``: each slot a
        whole-batch reduction (``_global_update``), the reductions of one
        input shared; a batch of no rows -> the partial of no rows."""
        if work.num_rows == 0:
            return self._identity_partial()
        sums = _Sums()
        cols = tuple(_global_update(
            slot.update_op, work.columns[ci] if ci is not None else None,
            work.num_rows, slot.dtype, device, sums,
            work.columns[bi] if bi is not None else None)
            for ci, bi, (_, slot) in zip(*self._work_inputs(),
                                         self.slot_specs))
        return ColumnarBatch(cols, 1, self.partial_schema)

    def by_companion(self, ai: int) -> int:
        """The slot index of MAX_BY / MIN_BY ``ai``'s ordering-key buffer,
        which its value buffer picks by at the merge."""
        for si in self.slot_pos[ai]:
            slot = self.slot_specs[si][1]
            if slot.input_index == 1 and slot.update_op in (MIN, MAX):
                return si
        raise AssertionError(
            f"max_by / min_by needs a MIN / MAX ordering companion buffer on "
            f"{self.aggregates[ai]!r}")

    def count_companion(self, ai: int) -> int:
        """The slot index of aggregate ai's COUNT_VALID buffer, which a
        SUM128 merge reads to tell an overflowed partial from an empty
        one."""
        for si in self.slot_pos[ai]:
            if self.slot_specs[si][1].update_op == COUNT_VALID:
                return si
        raise AssertionError(
            f"SUM128 needs a COUNT_VALID companion buffer on "
            f"{self.aggregates[ai]!r}")

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
        by = [nkeys + self.by_companion(ai) if slot.merge_op in BY_OPS
              else None for ai, slot in self.slot_specs]
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
                        partial.device, sums,
                        partial.columns[by[si]] if by[si] is not None
                        else None,
                        partial.columns[self.count_companion(ai)]
                        if slot.merge_op == SUM128 else None))
            return ColumnarBatch(tuple(cols), 1, self.partial_schema)
        return self._grouped_step(
            partial, [nkeys + si for si in range(len(self.slot_specs))], by,
            [slot.merge_op for _, slot in self.slot_specs], merge=True)

    def _grouped_step(self, work: ColumnarBatch,
                      inputs: List[Optional[int]],
                      by: List[Optional[int]], ops: List[str],
                      merge: bool = False,
                      allow_split_groups: bool = False) -> ColumnarBatch:
        """Group ``work`` by its leading key columns, then reduce slot i's
        work column ``inputs[i]`` (None: no input) with ``ops[i]``, a
        MAX_BY / MIN_BY value slot by the ordering column ``by[i]``;
        ``merge``: ``work`` holds partials (a SUM128 slot then reads its
        COUNT_VALID companion); ``allow_split_groups``: see
        ``kernels/groupby.py`` ``group_rows``."""
        nkeys = len(self.group_exprs)
        layout = G.group_rows(work, list(range(nkeys)), allow_split_groups)
        sums = G.SegmentSums(layout)
        cols = G.group_keys_output(layout, list(range(nkeys)))
        sorted_cols = layout.sorted_batch.columns
        for ci, bi, op, (ai, slot) in zip(inputs, by, ops, self.slot_specs):
            col = sorted_cols[ci] if ci is not None else None
            picked = (_seg_tail_op(op, col, sorted_cols[bi]
                                   if bi is not None else None, layout)
                      if col is not None else None)
            if picked is not None:
                cols.append(picked)
            elif op == M2_MERGE:
                s_si, n_si = self.m2_companions(ai)
                v, valid = G.seg_m2_merge(col, sorted_cols[inputs[s_si]],
                                          sorted_cols[inputs[n_si]], sums)
                cols.append(G.finalize_agg_column(v, valid, slot.dtype))
            else:
                cols.append(_seg_update(
                    op, col, slot.dtype, sums,
                    sorted_cols[inputs[self.count_companion(ai)]]
                    if merge and op == SUM128 else None))
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
                bufs.append((c if c.is_string else c.data, c.validity))
                si += 1
            v, valid = agg.finalize(bufs)
            mapping[id(agg)] = _DeviceAggResult(
                v if isinstance(v, DeviceColumn) else
                make_column(v.to(agg.dtype.torch_dtype), valid, agg.dtype))
        ctx = EvalContext(merged)
        cols = tuple(merged.columns[:nkeys]) + tuple(
            _substitute(e, mapping).eval(ctx) for e in self.agg_exprs)
        return ColumnarBatch(cols, merged.num_rows, self.schema)

    def _identity_partial(self) -> ColumnarBatch:
        """The partial of no rows: a batch of no rows (see the module's
        docstring for why it is not the reference's one-row identity)."""
        return empty_batch(self.partial_schema, self.device)

    # -- host orchestration ---------------------------------------------------

    def _combine(self, partials: List[ColumnarBatch]) -> ColumnarBatch:
        """Concatenated partials merged and finalized."""
        return self._finalize(self._merge_step(coalesce_to_one(partials)))

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        child = self.children[0]
        if self.mode == "final" and hasattr(child, "stream_pieces"):
            pieces = child.stream_pieces(idx)
            if pieces and sum(p.count for p in pieces) <= self.target_rows:
                self.branches["in_core"] += 1
                with timed(self.op_time):
                    out = retry_over_stream_pieces(
                        [pieces], lambda mats: self._combine(mats[0]))
                yield self._count_out(out)
                return
            total = sum(p.count for p in pieces)
            if total > self.target_rows and self.group_exprs:
                # out of core straight from the store: its blocks read in
                # runs of at most target_rows rows, none held past its run
                self.branches["out_of_core"] += 1
                yield from self._merge_buckets(child.execute_partition(idx),
                                               total)
                return
        with timed(self.op_time):
            partials = []
            for batch in child.execute_partition(idx):
                partials.extend([batch] if self.mode == "final" else
                                retry_per_batch(batch, self._partial_step))
            if not partials:
                if self.group_exprs:
                    return
                partials = [self._identity_partial()]
        if self.mode == "partial":
            for b in partials:
                yield self._count_out(b)
            return
        total = sum(p.num_rows for p in partials)
        if total > self.target_rows:
            self.branches["out_of_core"] += 1
            yield from self._execute_out_of_core(partials, total)
            return
        self.branches["in_core"] += 1
        with timed(self.op_time):
            out = with_retry_no_split(lambda: self._combine(partials))
        yield self._count_out(out)

    def _execute_out_of_core(self, partials: List[ColumnarBatch],
                             total: int) -> Iterator[ColumnarBatch]:
        """Merge a partial set above ``target_rows`` rows; the list is
        emptied, so that its rows live in the handles alone."""
        nkeys = len(self.group_exprs)
        if nkeys == 0:
            # runs of at most target_rows rows (two partials at least, so
            # that each round shrinks), merged until one is left
            while len(partials) > 1:
                merged, group, acc = [], [], 0
                for p in partials + [None]:
                    if p is not None and (
                            len(group) < 2
                            or acc + p.num_rows <= self.target_rows):
                        group.append(p)
                        acc += p.num_rows
                        continue
                    with timed(self.op_time):
                        merged.append(with_retry_no_split(
                            lambda: self._merge_step(coalesce_to_one(group))))
                    if p is not None:
                        group, acc = [p], p.num_rows
                partials = merged
            with timed(self.op_time):
                out = with_retry_no_split(
                    lambda: self._finalize(partials[0]))
            yield self._count_out(out)
            return
        with timed(self.op_time):
            handles = [make_spillable(p) for p in drain(partials)]
        yield from self._merge_buckets(
            (h.release_device_copy() for h in handles), total)

    def _merge_buckets(self, partials: Iterable[ColumnarBatch],
                       total: int) -> Iterator[ColumnarBatch]:
        """Grouped partials hash-sub-partitioned on the keys into spillable
        buckets, each merged and finalized alone."""
        n_b = num_sub_buckets(total, self.target_rows)
        with timed(self.op_time):
            buckets = sub_partition_spillable(
                partials, list(range(len(self.group_exprs))), n_b,
                self.target_rows)
        try:
            for q in buckets:
                if not q:
                    continue
                with timed(self.op_time):
                    out = retry_over_spillable(
                        q, lambda b: self._finalize(self._merge_step(b)))
                    close_all([q])
                yield self._count_out(out)
        finally:
            close_all(buckets)

    def describe(self):
        keys = ", ".join(map(repr, self.group_exprs))
        return (f"GpuHashAggregate[{self.mode}, keys=[{keys}], "
                f"{', '.join(map(repr, self.agg_exprs))}]")
