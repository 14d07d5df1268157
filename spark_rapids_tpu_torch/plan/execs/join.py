"""Join execs: broadcast, shuffled and adaptive hash joins.

Counterpart of ``spark_rapids_tpu/plan/execs/join.py``
(``_JoinKernel`` :52 with its conditional program ``_call_conditional``
:244-323, ``TpuShuffledHashJoinExec`` :387 with ``_join_pair`` :430 and its
streamed probe :449-528, ``TpuBroadcastHashJoinExec`` :627,
``TpuAdaptiveJoinExec`` :713) for the inner, left, right, full, left semi
and left anti joins on one or several keys, strings among them, each with
an optional residual condition, and for the cross join and the keyless
(nested-loop) joins.

- A join without a condition probes, expands and gathers (the left join
  null-extends a stream row with no match; the semi and anti joins keep
  a stream row once where it has a match or none, and gather the left
  columns alone).  A join with one runs the
  reference's conditional program: the inner probe and expand give the
  candidate pairs at their exact count (no capacity retry), only the
  condition's input columns are gathered for them, the condition is
  evaluated over that pair batch, and ``conditional_join_maps`` turns the
  candidates and the pass mask into the join type's maps, which the
  gather then applies to every column.
- A right or full join (the shuffled exec only: it never broadcasts)
  keeps one ``matched`` flag per build row across every stream group of a
  partition or an out-of-core bucket: the expand (K1) flags each pair's
  build row, and with a condition ``conditional_join_maps`` ORs the
  passing pairs' right rows into the same flags and leaves the right rows
  out.  After the last group the unmatched build rows are appended once,
  their left columns null: so a build row that passes only in a later
  group is not null-extended in an earlier one, and the rows come in the
  reference's order (the left-driven pairs, then the unmatched right rows
  in right-row order).
- A cross join (no keys, no condition: the planner puts a condition in a
  Filter over it) gathers K2's pairs; a keyless join with a condition takes
  K2's pairs as its candidates and runs the conditional program.  Its
  stream goes in chunks of at most max(1, batchSizeRows // build rows)
  rows, so that a chunk's pairs stay near the batch target and under
  2**31.
- Empty sides follow the reference (``_join_pair`` :430-447, the
  broadcast exec's :672-680): an inner, right, cross or semi join with an
  empty or missing build emits nothing (its stream is still drained); a
  left or full join emits its stream rows null-extended against an empty
  build, and an anti join every stream row, null keys included; a right or
  full join with no stream row emits every build row null-extended.

- The broadcast join materializes its build (right) side whole once per
  query, under a lock: every right partition's batches are concatenated
  and sorted by key (``kernels/join.py`` ``build_side``).  Each stream
  (left) partition is joined against it a chunk at a time: consecutive
  stream batches are concatenated while their rows stay within
  ``spark.rapids.sql.batchSizeRows``, then probed, expanded into gather
  maps (one blocking read of the pair count per chunk) and gathered on
  both sides.  ``cleanup`` drops the build when the query ends.
- The shuffled join joins co-partitioned sides partition by partition.
  Where a partition's build side holds at most ``batchSizeRows`` rows it
  is built whole once and the probe side streams against it in groups of
  at most ``batchSizeRows`` rows.  A larger build partition takes the
  reference's out-of-core branch (``_execute_out_of_core`` :530; a keyless
  join never takes it): both
  sides are hash-sub-partitioned on their keys into spillable co-buckets
  (``plan/execs/out_of_core.py``) of about ``batchSizeRows`` rows, and
  each pair is joined alone, its build whole and its stream in groups of
  at most ``batchSizeRows`` rows (a bucket's hot key then still joins in
  bounded pieces, the reference's skew split :604).  Equal keys share a
  bucket, so the buckets' outputs are the partition's join, for every
  ported type and with a residual condition.
- Every build and every stream group is joined under
  ``with_retry_no_split``, the concat inside the retry body (the
  reference's :257-369 and :474-509).
- The adaptive join materializes its build side first and counts its rows:
  at most ``spark.rapids.sql.join.broadcastRowThreshold`` rows make a
  broadcast join over an in-memory scan of them; more make two hash
  exchanges read through coalesced readers that share one spec, under a
  shuffled join.  The reference's cluster-stats branch is not ported.

The existence join raises NotImplementedError.
"""
from __future__ import annotations

import collections
import threading
from typing import Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.core import (BoundReference,
                                                     EvalContext, Expression)
from spark_rapids_tpu_torch.kernels import join as J
from spark_rapids_tpu_torch.kernels.selection import (coalesce_to_one,
                                                      gather_columns)
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuCoalescedShuffleReaderExec, GpuShuffleExchangeExec,
    SharedCoalesceSpec)
from spark_rapids_tpu_torch.plan.execs.out_of_core import (
    close_all, drain, num_sub_buckets, sub_partition_spillable)
from spark_rapids_tpu_torch.plan.execs.scan import GpuInMemoryScanExec
from spark_rapids_tpu_torch.shuffle.transport import slice_batch

# the join types that emit nothing where the build side has no row
_NOTHING_WITHOUT_BUILD = ("inner", "left_semi", "right", "cross")


def _split_rows(batch: ColumnarBatch, rows: int) -> Iterator[ColumnarBatch]:
    """A batch in views of at most ``rows`` rows."""
    for start in range(0, batch.num_rows, rows):
        yield slice_batch(batch, start, min(rows, batch.num_rows - start))


def _ordinal(key: Expression) -> int:
    if not isinstance(key, BoundReference):
        raise NotImplementedError(f"a join key that is an expression ({key!r}) "
                                  "is not ported; project it first")
    return key.ordinal


def _bound_ordinals(e: Expression) -> set:
    out = {e.ordinal} if isinstance(e, BoundReference) else set()
    for c in e.children:
        out |= _bound_ordinals(c)
    return out


def _remap_ordinals(e: Expression, mapping: dict) -> Expression:
    if isinstance(e, BoundReference):
        return BoundReference(mapping[e.ordinal], e.dtype, e.name)
    if not e.children:
        return e
    return e.with_children(tuple(_remap_ordinals(c, mapping)
                                 for c in e.children))


def empty_batch(schema: Schema, device: torch.device) -> ColumnarBatch:
    """A batch of no rows (``ColumnarBatch.empty`` of the reference)."""
    cols = []
    for dt in schema.dtypes:
        valid = torch.empty(0, dtype=torch.bool, device=device)
        data = torch.empty((0,) + T.row_shape(dt), dtype=dt.torch_dtype,
                           device=device)
        offsets = (torch.zeros(1, dtype=torch.int32, device=device)
                   if dt.variable_width else None)
        cols.append(DeviceColumn(data, valid, dt, offsets))
    return ColumnarBatch(tuple(cols), 0, schema)


class _HashJoin(GpuExec):
    """What the broadcast and the shuffled join share: the key ordinals,
    their type check, the condition's inputs, the join of one stream
    chunk against a build, and the appended build rows of a right or full
    join."""

    def __init__(self, left: GpuExec, right: GpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 schema: Schema, target_rows: int,
                 condition: Optional[Expression] = None):
        if join_type != "cross":
            J.require_probe_type(join_type)
        if len(left_keys) != len(right_keys):
            raise NotImplementedError(
                "a hash join needs as many left keys as right keys")
        if join_type == "cross" and (left_keys or condition is not None):
            raise NotImplementedError(
                "a cross join takes no keys and no condition (the planner "
                "filters its product)")
        if not left_keys and join_type != "cross" and condition is None:
            raise NotImplementedError(
                f"keyless {join_type} join without a condition (use cross "
                "join)")
        super().__init__((left, right), schema)
        self.join_type = join_type
        #: no keys: the cross join, or a nested-loop join with a condition
        self.keyless = not left_keys
        self.left_schema = left.schema
        self.left_keys = [_ordinal(k) for k in left_keys]
        self.right_keys = [_ordinal(k) for k in right_keys]
        for lk, rk in zip(self.left_keys, self.right_keys):
            J._check_key_types(left.schema.dtypes[lk], right.schema.dtypes[rk])
        self.target_rows = max(int(target_rows), 1)
        self.condition = condition
        if condition is not None:
            # the condition binds against (left columns, right columns);
            # its inputs are gathered for the candidate pairs, in pair
            # ordinal order, and it is evaluated over them
            nl = len(left.schema)
            ords = sorted(_bound_ordinals(condition))
            if not ords:
                raise NotImplementedError(
                    "a join condition that reads no column is not ported")
            self.cond_inputs = [(0, o) if o < nl else (1, o - nl)
                                for o in ords]
            names = left.schema.names + right.schema.names
            dtypes = left.schema.dtypes + right.schema.dtypes
            self.cond_schema = Schema(tuple(names[o] for o in ords),
                                      tuple(dtypes[o] for o in ords))
            self.cond_remapped = _remap_ordinals(
                condition, {o: j for j, o in enumerate(ords)})

    def num_partitions(self) -> int:
        return self.children[0].num_partitions()

    def _stream_rows(self, build: Optional[J.JoinBuild]) -> int:
        """The most stream rows of one chunk: ``target_rows``, or for a
        keyless join as many as keep its pairs within it (at least one)."""
        if not self.keyless:
            return self.target_rows
        return max(1, self.target_rows
                   // max(build.num_rows if build is not None else 0, 1))

    def _chunks(self, stream, rows_limit: int
                ) -> Iterator[List[ColumnarBatch]]:
        """Consecutive stream batches grouped while their rows stay within
        ``rows_limit`` (a larger batch is a group of its own; a keyless
        join's is cut into views of at most ``rows_limit`` rows first)."""
        group: List[ColumnarBatch] = []
        rows = 0
        for b in stream:
            for piece in (_split_rows(b, rows_limit) if self.keyless
                          else (b,)):
                if group and rows + piece.num_rows > rows_limit:
                    yield group
                    group, rows = [], 0
                group.append(piece)
                rows += piece.num_rows
        if group:
            yield group

    def _join(self, group: List[ColumnarBatch], build: J.JoinBuild,
              matched: Optional[torch.Tensor] = None) -> ColumnarBatch:
        with timed(self.op_time):
            out = with_retry_no_split(
                lambda: self._join_step(group, build, matched))
        return self._count_out(out)

    def _join_step(self, group: List[ColumnarBatch], build: J.JoinBuild,
                   matched: Optional[torch.Tensor]) -> ColumnarBatch:
        """One stream chunk's rows.  A retry repeats the flags' stores,
        which set the same bits again."""
        left = coalesce_to_one(group)
        if self.condition is not None:
            li, ri = self._conditional_maps(left, build, matched)
        elif self.keyless:
            li, ri = J.cross_join_maps(left.num_rows, build.num_rows,
                                       left.device)
        else:
            lo, offsets, total = J.join_probe(left, self.left_keys, build,
                                              self.join_type)
            li, ri = J.join_expand(lo, offsets, total, build, self.join_type,
                                   matched)
        return J.apply_gather_maps(left, build.batch, li, ri, self.schema,
                                   self.join_type)

    def _build_of(self, batches: List[ColumnarBatch],
                  keep_empty: bool = False) -> Optional[J.JoinBuild]:
        """The build of these right batches, under retry (None: no batch,
        or, without ``keep_empty``, no row); a keyless join's is the
        batch, unsorted."""
        def step():
            whole = coalesce_to_one(batches)
            if whole is None or not (whole.num_rows or keep_empty):
                return None
            if self.keyless:
                return J.keyless_build(whole)
            return J.build_side(whole, self.right_keys)
        with timed(self.op_time):
            return with_retry_no_split(step)

    def _join_stream(self, stream, build: Optional[J.JoinBuild]
                     ) -> Iterator[ColumnarBatch]:
        """Join a stream of left batches against a build, in chunks; an
        empty build still drains the stream, as the reference's does; a
        left or full join emits the stream null-extended against it, an
        anti join every stream row.  A right or full join flags its build
        rows through every chunk and then appends the unmatched ones."""
        outer = self.join_type in J.OUTER
        matched = None
        for group in self._chunks(stream, self._stream_rows(build)):
            if build is None:
                if self.join_type in _NOTHING_WITHOUT_BUILD:
                    continue
                build = self._empty_build(group[0].device)
            if outer and matched is None:
                matched = J.new_matched(build.num_rows, build.batch.device)
            yield self._join(group, build, matched)
        if outer and build is not None and build.num_rows:
            out = self._unmatched(build, matched)
            if out is not None:
                yield out

    def _unmatched(self, build: J.JoinBuild,
                   matched: Optional[torch.Tensor]
                   ) -> Optional[ColumnarBatch]:
        """The build rows no chunk matched (every one where no stream row
        came), their left columns null; None where there is none."""
        dev = build.batch.device

        def step():
            flags = (matched if matched is not None
                     else J.new_matched(build.num_rows, dev))
            li, ri = J.unmatched_build_rows(flags)
            if not li.shape[0]:
                return None
            return J.apply_gather_maps(empty_batch(self.left_schema, dev),
                                       build.batch, li, ri, self.schema,
                                       self.join_type)
        with timed(self.op_time):
            out = with_retry_no_split(step)
        return None if out is None else self._count_out(out)

    def _conditional_maps(self, left: ColumnarBatch, build: J.JoinBuild,
                          matched: Optional[torch.Tensor]):
        """The reference's conditional program: candidates from the inner
        probe and expand (a keyless join's: every pair, K2), the
        condition's inputs gathered for them, the condition evaluated,
        then ``conditional_join_maps`` (a right or full join ORs its passing
        right rows into ``matched`` and leaves the unmatched ones for
        ``_unmatched``)."""
        right = build.batch
        if self.keyless:
            li, ri = J.cross_join_maps(left.num_rows, right.num_rows,
                                       left.device)
            total = li.shape[0]
        else:
            lo, offsets, total = J.join_probe(left, self.left_keys, build)
            li, ri = J.join_expand(lo, offsets, total, build)
        gathered = {}
        for side, batch, idx in ((0, left, li), (1, right, ri)):
            ords = [o for s, o in self.cond_inputs if s == side]
            if ords:
                cols = gather_columns([batch.columns[o] for o in ords], idx)
                gathered.update({(side, o): c for o, c in zip(ords, cols)})
        pairs = ColumnarBatch(tuple(gathered[k] for k in self.cond_inputs),
                              total, self.cond_schema)
        cond = self.cond_remapped.eval(EvalContext(pairs))
        passed = cond.data & cond.validity
        dev = li.device
        li2, ri2, _ = J.conditional_join_maps(
            li, ri, passed,
            torch.ones(left.num_rows, dtype=torch.bool, device=dev),
            torch.ones(right.num_rows, dtype=torch.bool, device=dev),
            self.join_type, rmatched=matched)
        return li2, ri2

    def _empty_build(self, device: torch.device) -> J.JoinBuild:
        """The build of no rows a left, full or anti join runs against."""
        empty = empty_batch(self.children[1].schema, device)
        if self.keyless:
            return J.keyless_build(empty)
        return J.build_side(empty, self.right_keys)

    def _keys_string(self) -> str:
        cond = (f", condition={self.condition!r}"
                if self.condition is not None else "")
        return f"lkeys={self.left_keys}, rkeys={self.right_keys}{cond}"


class GpuBroadcastHashJoinExec(_HashJoin):
    """Streams the left side; the right (build) side is built whole once
    and joined against every stream partition."""

    def __init__(self, left: GpuExec, right: GpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 schema: Schema, target_rows: int = 1 << 20,
                 condition: Optional[Expression] = None):
        if join_type in J.OUTER:
            raise ValueError(f"a {join_type} join never broadcasts: its "
                             "build side is the side it null-extends")
        super().__init__(left, right, left_keys, right_keys, join_type,
                         schema, target_rows, condition)
        self._lock = threading.Lock()
        self._build: Optional[J.JoinBuild] = None
        self._build_done = False

    def _build_side(self) -> Optional[J.JoinBuild]:
        with self._lock:
            if not self._build_done:
                right = self.children[1]
                batches = [b for p in range(right.num_partitions())
                           for b in right.execute_partition(p)]
                self._build = self._build_of(batches, keep_empty=True)
                self._build_done = True
            return self._build

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        build = self._build_side()
        stream = list(self.children[0].execute_partition(idx))
        if not stream:
            return
        if build is None:
            if self.join_type in _NOTHING_WITHOUT_BUILD:
                return    # no build row: no output row
            build = self._empty_build(stream[0].device)
        for group in self._chunks(stream, self._stream_rows(build)):
            yield self._join(group, build)

    def cleanup(self) -> None:
        with self._lock:
            self._build = None
            self._build_done = False
        super().cleanup()

    def describe(self):
        return f"GpuBroadcastHashJoin[{self.join_type}, {self._keys_string()}]"


class GpuShuffledHashJoinExec(_HashJoin):
    """Joins co-partitioned sides partition by partition; the build (right)
    partition is built whole and the probe (left) side streams against it
    in groups of at most ``target_rows`` rows."""

    def __init__(self, left: GpuExec, right: GpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 schema: Schema, target_rows: int = 1 << 20,
                 condition: Optional[Expression] = None):
        super().__init__(left, right, left_keys, right_keys, join_type,
                         schema, target_rows, condition)
        for lk, rk in zip(self.left_keys, self.right_keys):
            lt, rt = left.schema.dtypes[lk], right.schema.dtypes[rk]
            if lt != rt:
                # each side's exchange hashes its keys as their own type
                raise NotImplementedError(
                    f"a shuffled join of a {lt!r} key with a {rt!r} key is "
                    "not ported: the sides would hash apart")
        #: partitions that took each branch ("streamed", "out_of_core"),
        #: each partition's build rows (the largest of them), and the most
        #: sub-buckets an out-of-core partition took
        self.branches: "collections.Counter[str]" = collections.Counter()
        self.build_rows: List[int] = []
        self.largest_build_rows = 0
        self.sub_buckets = 0

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        right_batches = [b for b in self.children[1].execute_partition(idx)
                         if b.num_rows]
        right_rows = sum(b.num_rows for b in right_batches)
        self.build_rows.append(right_rows)
        self.largest_build_rows = max(self.largest_build_rows, right_rows)
        if right_rows > self.target_rows and not self.keyless:
            self.branches["out_of_core"] += 1
            left_batches = [b for b in
                            self.children[0].execute_partition(idx)
                            if b.num_rows]
            total = right_rows + sum(b.num_rows for b in left_batches)
            yield from self._execute_out_of_core(left_batches, right_batches,
                                                 total)
            return
        self.branches["streamed"] += 1
        build = self._build_of(right_batches)
        right_batches.clear()
        yield from self._join_stream(
            self.children[0].execute_partition(idx), build)

    def _execute_out_of_core(self, left_batches: List[ColumnarBatch],
                             right_batches: List[ColumnarBatch],
                             total: int) -> Iterator[ColumnarBatch]:
        """Both sides sub-partitioned on their keys into spillable
        co-buckets, each pair joined alone; the lists are emptied, so
        that the queued rows live in the handles alone."""
        n_b = num_sub_buckets(total, self.target_rows)
        self.sub_buckets = max(self.sub_buckets, n_b)
        with timed(self.op_time):
            lbuckets = sub_partition_spillable(
                drain(left_batches), self.left_keys, n_b, self.target_rows)
            rbuckets = sub_partition_spillable(
                drain(right_batches), self.right_keys, n_b,
                self.target_rows)
        try:
            for lq, rq in zip(lbuckets, rbuckets):
                if not lq and self.join_type not in J.OUTER:
                    continue    # no stream row: no output but build rows
                # the bucket's handles stay pinned through its join
                pinned = []
                try:
                    rmats = []
                    for h in rq:
                        rmats.append(h.materialize())
                        pinned.append(h)
                    build = self._build_of(rmats)
                    del rmats
                    lmats = []
                    for h in lq:
                        lmats.append(h.materialize())
                        pinned.append(h)
                    yield from self._join_stream(
                        (piece for b in lmats
                         for piece in _split_rows(b, self.target_rows)),
                        build)
                finally:
                    for h in pinned:
                        h.unpin()
                    close_all([lq, rq])
        finally:
            close_all(lbuckets)
            close_all(rbuckets)

    def describe(self):
        return f"GpuShuffledHashJoin[{self.join_type}, {self._keys_string()}]"


class GpuAdaptiveJoinExec(GpuExec):
    """Decides broadcast or shuffled at run time from the materialized
    build side's row count, then runs the chosen join."""

    def __init__(self, left: GpuExec, right: GpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 schema: Schema, broadcast_threshold: int,
                 shuffle_partitions: int, target_rows: int = 1 << 20,
                 aqe_coalesce: bool = True,
                 condition: Optional[Expression] = None):
        J.require_probe_type(join_type)
        super().__init__((left, right), schema)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition
        self.broadcast_threshold = broadcast_threshold
        self.shuffle_partitions = shuffle_partitions
        self.target_rows = target_rows
        self.aqe_coalesce = aqe_coalesce
        self._lock = threading.Lock()
        #: the decision ("broadcast" or "shuffled") and the exec it built
        #: over the materialized build side; a later run reuses both
        self.chosen: Optional[str] = None
        self.inner: Optional[GpuExec] = None

    def _decide(self) -> GpuExec:
        with self._lock:
            if self.inner is not None:
                return self.inner
            left, right = self.children
            right_parts = [list(right.execute_partition(p))
                           for p in range(right.num_partitions())]
            build_rows = sum(b.num_rows for part in right_parts
                             for b in part)
            right_scan = GpuInMemoryScanExec(right_parts, right.schema)
            if build_rows <= self.broadcast_threshold:
                self.chosen = "broadcast"
                inner: GpuExec = GpuBroadcastHashJoinExec(
                    left, right_scan, self.left_keys, self.right_keys,
                    self.join_type, self.schema,
                    target_rows=self.target_rows, condition=self.condition)
            else:
                self.chosen = "shuffled"
                jl: GpuExec = GpuShuffleExchangeExec(
                    self.shuffle_partitions, self.left_keys, left)
                jr: GpuExec = GpuShuffleExchangeExec(
                    self.shuffle_partitions, self.right_keys, right_scan)
                if self.aqe_coalesce:
                    # one spec for both sides keeps them co-partitioned
                    spec = SharedCoalesceSpec(self.target_rows)
                    jl = GpuCoalescedShuffleReaderExec(jl, spec)
                    jr = GpuCoalescedShuffleReaderExec(jr, spec)
                inner = GpuShuffledHashJoinExec(
                    jl, jr, self.left_keys, self.right_keys, self.join_type,
                    self.schema, target_rows=self.target_rows,
                    condition=self.condition)
            self.inner = inner
            return inner

    def num_partitions(self) -> int:
        return self._decide().num_partitions()

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for batch in self._decide().execute_partition(idx):
            yield self._count_out(batch)

    def cleanup(self) -> None:
        with self._lock:
            if self.inner is not None:
                self.inner.cleanup()
        super().cleanup()

    def describe(self):
        return (f"GpuAdaptiveJoin[{self.join_type}, "
                f"threshold={self.broadcast_threshold}"
                + (f", chosen={self.chosen}" if self.chosen else "") + "]")
