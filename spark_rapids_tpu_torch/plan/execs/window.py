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

A task partition of at most ``batchSizeRows`` rows is coalesced into one
batch, the concat inside the retry body (the reference's :399).  A larger
one takes the reference's branches (:393-398):

  * the two-pass path (``_execute_two_pass`` :486), where every window
    expression is SUM / COUNT / AVG / MIN / MAX over the whole partition
    and the partition keys are plain fixed-width columns: pass 1 runs a
    grouped partial over each batch (the ported segmented reductions) and
    merges the small per-key states on the host (``_merge_slots``,
    ``_extreme_merge``, ``_finalize_slots``; float sums as double-double
    pairs, MIN / MAX in Spark's order with NaN greatest), pass 2 joins the
    values back to each batch by key (the ported left join), so one
    partition key larger than any batch needs no batch of its size.  The
    rows come out in input order with their partition's values.  Past
    65,536 distinct keys it gives way to
  * the key-batched path (``_execute_out_of_core`` :710): the rows are
    hash-sub-partitioned on the partition keys into spillable buckets,
    each windowed alone (frames never cross a partition value).
"""
from __future__ import annotations

import collections
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Max, Min, Sum)
from spark_rapids_tpu_torch.expressions.core import (Alias, BoundReference,
                                                     EvalContext, Expression,
                                                     make_column)
from spark_rapids_tpu_torch.expressions.window import (
    CumeDist, DenseRank, FirstValue, Lag, LastValue, Lead, NthValue, Ntile,
    PercentRank, Rank, RowNumber, WindowExpression, WindowFrame)
from spark_rapids_tpu_torch.kernels import window as WK
from spark_rapids_tpu_torch.kernels.groupby import (_rows_equal_prev,
                                                    normalize_key_column)
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels import join as J
from spark_rapids_tpu_torch.kernels.selection import (coalesce_to_one,
                                                      gather_batch,
                                                      gather_columns)
from spark_rapids_tpu_torch.kernels.sort import SortOrder, sort_indices
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
from spark_rapids_tpu_torch.memory.spill import make_spillable
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.plan.execs.coalesce import retry_over_spillable
from spark_rapids_tpu_torch.plan.execs.out_of_core import (
    close_all, drain, num_sub_buckets, sub_partition_spillable)

Bounds = Tuple[torch.Tensor, torch.Tensor]

#: past this many distinct partition keys the two-pass path's host merge
#: costs more than key batching (the reference's _TWO_PASS_MAX_KEYS)
_TWO_PASS_MAX_KEYS = 65536
_EXTREME_TYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _two_sum(a: float, b: float) -> Tuple[float, float]:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dd_add(x: Tuple[float, float], y: Tuple[float, float]
            ) -> Tuple[float, float]:
    """Double-double sum of two (hi, lo) pairs."""
    s, e = _two_sum(x[0], y[0])
    e += x[1] + y[1]
    return _two_sum(s, e)


def _extreme_merge(x, y, is_min: bool):
    """Merge two (value, valid) extremes in Spark's order (NaN greatest:
    MIN prefers a number, MAX the NaN)."""
    (vx, okx), (vy, oky) = x, y
    if not okx:
        return y
    if not oky:
        return x
    x_nan = isinstance(vx, float) and math.isnan(vx)
    y_nan = isinstance(vy, float) and math.isnan(vy)
    if x_nan or y_nan:
        return (y if x_nan else x) if is_min else (x if x_nan else y)
    if is_min:
        return x if vx <= vy else y
    return x if vx >= vy else y


def _merge_slots(a: list, b: list, specs) -> list:
    """Combine two per-key partial states: count (n,), sum and average
    ((hi, lo), valid) then (n,), min / max (value, valid)."""
    out = []
    i = 0
    for kind, _inp, _dt in specs:
        if kind == "count":
            out.append((a[i][0] + b[i][0],))
            i += 1
        elif kind in ("sum", "average"):
            (sa, va), (sb, vb) = a[i], b[i]
            if isinstance(sa, tuple):
                s = _dd_add(sa, sb) if va and vb else (sa if va else sb)
            else:
                s = sa + sb if va and vb else (sa if va else sb)
            out.append((s, va or vb))
            out.append((a[i + 1][0] + b[i + 1][0],))
            i += 2
        else:
            out.append(_extreme_merge(a[i], b[i], kind == "min"))
            i += 1
    return out


def _wrap64(v: int) -> int:
    return ((v + 2**63) % 2**64) - 2**63


def _finalize_slots(slots: list, specs) -> list:
    """A key's merged state -> (value, valid) per window expression."""
    out = []
    i = 0
    for kind, _inp, _dt in specs:
        if kind == "count":
            out.append((slots[i][0], True))
            i += 1
        elif kind in ("sum", "average"):
            (s, valid), (n,) = slots[i], slots[i + 1]
            ok = bool(n > 0 and valid)
            if isinstance(s, tuple):
                s = s[0] + s[1]
            elif kind == "sum":
                s = _wrap64(s)
            if kind == "average" and ok:
                s = s / n
            out.append((s if ok else None, ok))
            i += 2
        else:
            out.append(slots[i])
            i += 1
    return out


def _host_column(vals: list, dtype: T.DataType,
                 device: torch.device) -> DeviceColumn:
    """A column of host values (None: null) of a fixed-width type."""
    data = torch.tensor([0 if v is None else v for v in vals],
                        dtype=dtype.torch_dtype)
    valid = torch.tensor([v is not None for v in vals], dtype=torch.bool)
    return DeviceColumn(data.to(device), valid.to(device), dtype)


def _canon(v):
    """Spark's group identity of a host key value: NaN is one key, -0.0
    is 0.0."""
    if isinstance(v, float):
        if math.isnan(v):
            return "\0nan"
        if v == 0.0:
            return 0.0
    return v


def unwrap(e: Expression) -> WindowExpression:
    return e.child if isinstance(e, Alias) else e


def _offsets(frame: WindowFrame) -> Tuple[Optional[int], Optional[int]]:
    """(preceding, following) of a frame: None where unbounded."""
    return (None if frame.start is None else -frame.start), frame.end


class GpuWindowExec(GpuExec):
    def __init__(self, window_exprs: Sequence[Expression], child: GpuExec,
                 schema: Schema, target_rows: int = 1 << 20):
        super().__init__((child,), schema)
        self.window_exprs = tuple(window_exprs)
        self.spec = unwrap(self.window_exprs[0]).spec
        self.target_rows = max(int(target_rows), 1)
        #: partitions that took each branch ("in_core", "two_pass",
        #: "out_of_core")
        self.branches: "collections.Counter[str]" = collections.Counter()

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        batches = [b for b in self.children[0].execute_partition(idx)
                   if b.num_rows]
        if not batches:
            return
        total = sum(b.num_rows for b in batches)
        if total > self.target_rows:
            if self._two_pass_capable():
                self.branches["two_pass"] += 1
                yield from self._execute_two_pass(batches)
                return
            if self._partition_ordinals() is not None:
                self.branches["out_of_core"] += 1
                yield from self._execute_out_of_core(batches, total)
                return
        self.branches["in_core"] += 1
        with timed(self.op_time):
            # the concat inside the retry body
            out = with_retry_no_split(
                lambda: self.step(coalesce_to_one(batches)))
        yield self._count_out(out)

    # -- big partitions -----------------------------------------------------

    def _partition_ordinals(self) -> Optional[List[int]]:
        """The partition keys' column ordinals, or None where there is no
        key or one is not a plain column."""
        if not self.spec.partition_by:
            return None
        out = []
        for e in self.spec.partition_by:
            while isinstance(e, Alias):
                e = e.child
            if not isinstance(e, BoundReference):
                return None
            out.append(e.ordinal)
        return out

    def _two_pass_capable(self) -> bool:
        ords = self._partition_ordinals()
        if self.spec.partition_by and ords is None:
            return False
        dtypes = self.children[0].schema.dtypes
        if any(dtypes[o].variable_width or T.two_limbs(dtypes[o])
               for o in ords or []):
            return False
        for e in self.window_exprs:
            we = unwrap(e)
            fn = we.function
            if not we.spec.frame.is_unbounded_both() or \
                    not isinstance(fn, (Sum, Count, Min, Max, Average)):
                return False
            if fn.input is None:
                continue
            dt = fn.input.dtype
            if dt.variable_width or isinstance(dt, T.DecimalType):
                return False
            if isinstance(fn, (Min, Max)) and \
                    dt.torch_dtype not in _EXTREME_TYPES:
                return False
        return True

    def _fn_specs(self):
        """(kind, input expression, output type) per window expression."""
        return [(type(unwrap(e).function).__name__.lower(),
                 unwrap(e).function.input, unwrap(e).function.dtype)
                for e in self.window_exprs]

    def _batch_states(self, batch: ColumnarBatch, key_ords, specs):
        """Pass 1 over one batch: (host key tuples, host slot lists) of its
        groups, from one grouped partial on the device."""
        ctx = EvalContext(batch)
        n, dev = batch.num_rows, batch.device
        keys = ([normalize_key_column(batch.columns[o]) for o in key_ords]
                or [DeviceColumn(torch.zeros(n, dtype=torch.int32,
                                             device=dev),
                                 torch.ones(n, dtype=torch.bool, device=dev),
                                 T.INT)])
        inputs = [inp.eval(ctx) if inp is not None else None
                  for _k, inp, _dt in specs]
        work = ColumnarBatch(
            tuple(keys) + tuple(c for c in inputs if c is not None), n,
            Schema(tuple(f"_c{i}" for i in range(
                len(keys) + sum(c is not None for c in inputs))),
                tuple(c.dtype for c in keys)
                + tuple(c.dtype for c in inputs if c is not None)))
        layout = G.group_rows(work, list(range(len(keys))))
        sums = G.SegmentSums(layout)
        sorted_cols = layout.sorted_batch.columns
        cols: List[Tuple[torch.Tensor, torch.Tensor]] = []
        ci = len(keys)
        for (kind, inp, out_dt), c in zip(specs, inputs):
            col = None
            if c is not None:
                col = sorted_cols[ci]
                ci += 1
            if col is None:
                cols.append(G.seg_count_star(sums))
            elif kind == "count":
                cols.append(G.seg_count_valid(col, sums))
            elif kind in ("sum", "average"):
                floating = out_dt.is_floating or kind == "average"
                cols.append(G.seg_sum(col, sums, torch.float64 if floating
                                      else torch.int64))
                cols.append(G.seg_count_valid(col, sums))
            else:
                cols.append(G.seg_min(col, sums) if kind == "min"
                            else G.seg_max(col, sums))
        host_keys = [(c.data.tolist(), c.validity.tolist())
                     for c in G.group_keys_output(layout,
                                                  list(range(len(keys))))]
        host = [(v.tolist(), ok.tolist()) for v, ok in cols]
        groups = []
        host_keys = host_keys[:len(key_ords)]   # no stand-in key
        for g in range(layout.num_groups):
            raw = tuple(d[g] if ok[g] else None for d, ok in host_keys)
            slots = []
            j = 0
            for kind, _i, out_dt in specs:
                if kind == "count":
                    slots.append((host[j][0][g],))
                    j += 1
                elif kind in ("sum", "average"):
                    v, ok = host[j][0][g], host[j][1][g]
                    floating = out_dt.is_floating or kind == "average"
                    slots.append(((v, 0.0) if floating else v, ok))
                    slots.append((host[j + 1][0][g],))
                    j += 2
                else:
                    slots.append((host[j][0][g], host[j][1][g]))
                    j += 1
            groups.append((raw, slots))
        return groups

    def _execute_two_pass(self, batches: List[ColumnarBatch]
                          ) -> Iterator[ColumnarBatch]:
        key_ords = self._partition_ordinals() or []
        specs = self._fn_specs()
        dev = batches[0].device
        handles = [make_spillable(b) for b in drain(batches)]
        state = {}        # canonical key -> merged slots
        originals = {}    # canonical key -> a raw key
        try:
            for h in handles:
                with timed(self.op_time):
                    groups = retry_over_spillable(
                        [h], lambda b: self._batch_states(b, key_ords,
                                                          specs))
                for raw, slots in groups:
                    key = tuple(_canon(v) for v in raw)
                    cur = state.get(key)
                    if cur is None:
                        originals[key] = raw
                        state[key] = slots
                    else:
                        state[key] = _merge_slots(cur, slots, specs)
                if len(state) > _TWO_PASS_MAX_KEYS:
                    # the host merge would dominate: key-batch instead
                    rebatched = [hh.release_device_copy() for hh in handles]
                    handles = []
                    yield from self._execute_out_of_core(
                        rebatched, sum(b.num_rows for b in rebatched))
                    return
            values = {originals[k]: _finalize_slots(sl, specs)
                      for k, sl in state.items()}
            build = (self._values_build(key_ords, values, dev)
                     if key_ords else None)
            for h in handles:
                with timed(self.op_time):
                    out = retry_over_spillable(
                        [h], lambda b: self._attach_values(
                            b, key_ords, build, values))
                h.close()
                yield self._count_out(out)
        finally:
            for h in handles:
                h.close()

    def _values_build(self, key_ords, values, dev) -> J.JoinBuild:
        """The build side of pass 2: each key (nulls as 0 with a null
        flag, so that a null key matches), then its window values."""
        child_schema = self.children[0].schema
        keys = list(values)
        cols = []
        for i, o in enumerate(key_ords):
            cols.append(_host_column([0 if k[i] is None else k[i]
                                      for k in keys],
                                     child_schema.dtypes[o], dev))
            cols.append(_host_column([k[i] is None for k in keys],
                                     T.BOOLEAN, dev))
        for j, (_k, _i, out_dt) in enumerate(self._fn_specs()):
            cols.append(_host_column(
                [values[k][j][0] if values[k][j][1] else None for k in keys],
                out_dt, dev))
        batch = ColumnarBatch(tuple(cols), len(keys), Schema(
            tuple(f"_b{i}" for i in range(len(cols))),
            tuple(c.dtype for c in cols)))
        return J.build_side(batch, list(range(2 * len(key_ords))))

    def _attach_values(self, b: ColumnarBatch, key_ords, build, values
                       ) -> ColumnarBatch:
        """Pass 2 over one batch: its rows in order with their
        partition's window values appended."""
        n, dev = b.num_rows, b.device
        if build is None:       # no partition keys: one partition
            vals = values.get((), [(None, False)] * len(self.window_exprs))
            extra = [_host_column([v if ok else None] * n, dt, dev)
                     for (v, ok), (_k, _i, dt) in zip(vals,
                                                      self._fn_specs())]
            return ColumnarBatch(tuple(b.columns) + tuple(extra), n,
                                 self.schema)
        probe = []
        for o in key_ords:
            c = normalize_key_column(b.columns[o])
            zero = torch.zeros((), dtype=c.data.dtype, device=dev)
            probe.append(DeviceColumn(torch.where(c.validity, c.data, zero),
                                      torch.ones_like(c.validity), c.dtype))
            probe.append(DeviceColumn(~c.validity,
                                      torch.ones_like(c.validity), T.BOOLEAN))
        pb = ColumnarBatch(tuple(probe), n, Schema(
            tuple(f"_p{i}" for i in range(len(probe))),
            tuple(c.dtype for c in probe)))
        keys = list(range(len(probe)))
        lo, offsets, total = J.join_probe(pb, keys, build, "left")
        _li, ri = J.join_expand(lo, offsets, total, build, "left")
        nk = 2 * len(key_ords)
        extra = gather_columns(build.batch.columns[nk:], ri,
                               null_extend=True)
        return ColumnarBatch(tuple(b.columns) + tuple(extra), n, self.schema)

    def _execute_out_of_core(self, batches: List[ColumnarBatch],
                             total: int) -> Iterator[ColumnarBatch]:
        """Key-batched windows: spillable key-disjoint buckets, each
        windowed alone; the list is emptied."""
        n_b = num_sub_buckets(total, self.target_rows)
        with timed(self.op_time):
            buckets = sub_partition_spillable(
                drain(batches), self._partition_ordinals(), n_b,
                self.target_rows)
        try:
            for q in buckets:
                if not q:
                    continue
                with timed(self.op_time):
                    out = retry_over_spillable(q, self.step)
                    close_all([q])
                yield self._count_out(out)
        finally:
            close_all(buckets)

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
