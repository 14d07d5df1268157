"""Window exec: each partition sorted by (partition keys, order keys), laid
out, and every window column computed over the layout.

Counterpart of ``spark_rapids_tpu/plan/execs/window.py``
(``_WindowDeviceSpec._step`` :49, ``_positional_value`` :97,
``_window_column`` :129, ``TpuWindowExec`` :363).  The planner
co-locates each window partition (a hash exchange on the partition keys,
or one partition without keys), so a task sees whole partitions.  Per
task partition the exec

  * evaluates the keys and normalizes them (``normalize_key_column``:
    -0.0 and NaN partition keys merge), sorts the rows by (partition keys
    ascending with nulls first, order keys) with the ported stable radix
    ``sort_indices`` and gathers every column by that order, so the
    output comes in sorted order, as the reference's does;
  * finds the partition and peer boundaries with ``_rows_equal_prev``
    (``string_rows_equal_prev`` for a string key) and lays them out with
    ``window_layout`` (K1);
  * computes each window column: the ranks elementwise over the layout;
    LEAD / LAG and FIRST / LAST / NTH_VALUE as a row index per row moved
    by the null-extending gather; SUM / COUNT / AVG through
    ``frame_sum_count`` (K2) and MIN / MAX through ``frame_extreme`` (K4)
    with K2's count for their validity, over each frame's bounds: the
    whole partition [seg_start, seg_end - 1], the default RANGE frame
    [seg_start, run_last], ``frame_bounds_rows`` for ROWS, and
    ``range_frame_bounds`` (K3) for a bounded RANGE frame.  COUNT(*) is
    the frame's length.

A task partition is coalesced into one batch, as ``GpuSortExec`` does.
The reference's two-pass unbounded path (:486) and its key-batched
out-of-core path (:710), which it takes for a partition past
``batchSizeRows``, need the spill framework: they come with the memory
runtime (ROADMAP queue 1 item 7).  Their inputs give the same rows through
this path.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Max, Min, Sum)
from spark_rapids_tpu_torch.expressions.core import (Alias, EvalContext,
                                                     Expression, make_column)
from spark_rapids_tpu_torch.expressions.window import (
    CumeDist, DenseRank, FirstValue, Lag, LastValue, Lead, NthValue, Ntile,
    PercentRank, Rank, RowNumber, WindowExpression, WindowFrame)
from spark_rapids_tpu_torch.kernels import window as WK
from spark_rapids_tpu_torch.kernels.groupby import (_rows_equal_prev,
                                                    normalize_key_column)
from spark_rapids_tpu_torch.kernels.selection import (coalesce_to_one,
                                                      gather_batch,
                                                      gather_columns)
from spark_rapids_tpu_torch.kernels.sort import SortOrder, sort_indices
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed

Bounds = Tuple[torch.Tensor, torch.Tensor]


def unwrap(e: Expression) -> WindowExpression:
    return e.child if isinstance(e, Alias) else e


def _offsets(frame: WindowFrame) -> Tuple[Optional[int], Optional[int]]:
    """(preceding, following) of a frame: None where unbounded."""
    return (None if frame.start is None else -frame.start), frame.end


class GpuWindowExec(GpuExec):
    def __init__(self, window_exprs: Sequence[Expression], child: GpuExec,
                 schema: Schema):
        super().__init__((child,), schema)
        self.window_exprs = tuple(window_exprs)
        self.spec = unwrap(self.window_exprs[0]).spec

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        batch = coalesce_to_one(list(self.children[0].execute_partition(idx)))
        if batch is None or batch.num_rows == 0:
            return
        with timed(self.op_time):
            out = self.step(batch)
        yield self._count_out(out)

    def step(self, batch: ColumnarBatch) -> ColumnarBatch:
        """One partition-complete batch: its rows in sorted order with the
        window columns appended."""
        spec = self.spec
        ctx = EvalContext(batch)
        keys = [normalize_key_column(e.eval(ctx)) for e in spec.partition_by]
        nparts = len(keys)
        keys += [normalize_key_column(e.eval(ctx)) for e, _ in spec.order_by]
        nbase = len(batch.schema)
        n = batch.num_rows
        if keys:
            work = ColumnarBatch(
                tuple(batch.columns) + tuple(keys), n,
                Schema(tuple(batch.schema.names)
                       + tuple(f"_wk{i}" for i in range(len(keys))),
                       tuple(batch.schema.dtypes)
                       + tuple(c.dtype for c in keys)))
            orders = ([SortOrder(True, True)] * nparts
                      + [o for _, o in spec.order_by])
            idx = sort_indices(work, list(range(nbase, nbase + len(keys))),
                               orders)
            work = gather_batch(work, idx)
            keys = list(work.columns[nbase:])
            columns = work.columns[:nbase]
        else:
            columns = batch.columns
        dev = batch.device
        part = torch.zeros(n, dtype=torch.bool, device=dev)
        part[0] = True
        peer = part.clone()
        if n > 1:
            same = torch.ones(n - 1, dtype=torch.bool, device=dev)
            for k in keys[:nparts]:
                same = same & _rows_equal_prev(k)
            part[1:] = ~same
            for k in keys[nparts:]:
                same = same & _rows_equal_prev(k)
            peer[1:] = ~same
        layout = WK.window_layout(part, peer)
        sorted_batch = ColumnarBatch(tuple(columns), n, batch.schema)
        sctx = EvalContext(sorted_batch)
        out: List[DeviceColumn] = list(columns)
        for e in self.window_exprs:
            out.append(self._column(unwrap(e), layout, sctx))
        return ColumnarBatch(tuple(out), n, self.schema)

    # -- frames -------------------------------------------------------------

    def _frame(self, we: WindowExpression, layout: WK.WindowLayout,
               sctx: EvalContext) -> Bounds:
        """Inclusive position bounds of the expression's frame."""
        frame = we.spec.frame
        if frame.is_unbounded_both():
            return layout.seg_start, layout.seg_end - 1
        if frame.kind == "range" and frame.is_unbounded_to_current():
            return layout.seg_start, layout.run_last
        preceding, following = _offsets(frame)
        if frame.kind == "rows":
            return WK.frame_bounds_rows(layout, preceding, following)
        key = we.spec.order_by[0][0].eval(sctx)
        return WK.range_frame_bounds(key.data, layout.seg_start,
                                     layout.seg_end, preceding, following)

    @staticmethod
    def _max_len(frame: WindowFrame) -> Optional[int]:
        """The longest a ROWS frame with both sides bounded can be (the
        sparse table's depth), else None."""
        if frame.kind == "rows" and frame.start is not None \
                and frame.end is not None:
            return max(frame.end - frame.start + 1, 1)
        return None

    # -- columns ------------------------------------------------------------

    def _column(self, we: WindowExpression, layout: WK.WindowLayout,
                sctx: EvalContext) -> DeviceColumn:
        fn = we.function
        n = layout.n
        ones = torch.ones(n, dtype=torch.bool, device=layout.seg_start.device)
        if isinstance(fn, RowNumber):
            return DeviceColumn(WK.row_number(layout), ones, T.INT)
        if isinstance(fn, DenseRank):
            return DeviceColumn(WK.dense_rank(layout), ones, T.INT)
        if isinstance(fn, Rank):
            return DeviceColumn(WK.rank(layout), ones, T.INT)
        if isinstance(fn, PercentRank):
            return DeviceColumn(WK.percent_rank(layout), ones, T.DOUBLE)
        if isinstance(fn, CumeDist):
            return DeviceColumn(WK.cume_dist(layout), ones, T.DOUBLE)
        if isinstance(fn, Ntile):
            return DeviceColumn(WK.ntile(layout, fn.n), ones, T.INT)
        if isinstance(fn, (Lead, Lag)):
            off = -fn.offset if isinstance(fn, Lag) else fn.offset
            return gather_columns([fn.child.eval(sctx)],
                                  WK.shift_index(layout, off),
                                  null_extend=True)[0]
        if isinstance(fn, (FirstValue, LastValue, NthValue)):
            lower, upper = self._frame(we, layout, sctx)
            if isinstance(fn, NthValue):
                at = lower + (fn.k - 1)
            elif isinstance(fn, LastValue):
                at = upper
            else:
                at = lower
            at = torch.where((at >= lower) & (at <= upper), at, -1)
            return gather_columns([fn.child.eval(sctx)], at,
                                  null_extend=True)[0]
        return self._aggregate(we, layout, sctx)

    def _aggregate(self, we: WindowExpression, layout: WK.WindowLayout,
                   sctx: EvalContext) -> DeviceColumn:
        fn = we.function
        out_dt = fn.dtype
        lower, upper = self._frame(we, layout, sctx)
        if fn.input is None:      # COUNT(*): the frame's length
            length = (upper - lower + 1).clamp(min=0).to(torch.int64)
            return DeviceColumn(length, torch.ones_like(length,
                                                        dtype=torch.bool),
                                T.LONG)
        c = fn.input.eval(sctx)
        if isinstance(fn, (Count, Min, Max)):
            # the valid count alone (the sum of zeros rides along)
            _, count = WK.frame_sum_count(
                torch.zeros(layout.n, dtype=torch.int64, device=c.device),
                c.validity, layout.seg_start, lower, upper)
            if isinstance(fn, Count):
                return DeviceColumn(count, torch.ones_like(
                    count, dtype=torch.bool), T.LONG)
            value, _ = WK.frame_extreme(c.data, c.validity, lower, upper,
                                        isinstance(fn, Min),
                                        self._max_len(we.spec.frame))
            return make_column(value, count > 0, out_dt)
        to = (torch.float64 if out_dt.is_floating else torch.int64)
        total, count = WK.frame_sum_count(c.data.to(to), c.validity,
                                          layout.seg_start, lower, upper)
        ok = count > 0
        if isinstance(fn, Average):
            return make_column(total / torch.where(ok, count, 1).to(
                torch.float64), ok, T.DOUBLE)
        return make_column(total.to(out_dt.torch_dtype), ok, out_dt)

    def describe(self):
        return f"GpuWindow[{', '.join(map(repr, self.window_exprs))}]"


#: the aggregates a window runs
WINDOW_AGGREGATES = (Sum, Count, Average, Min, Max)
