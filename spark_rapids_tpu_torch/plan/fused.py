"""Stage-segment fusion: each exchange-free chain of Project / Filter /
partial HashAggregate runs as one fused-segment kernel per batch.

Counterpart of ``spark_rapids_tpu/plan/fused.py`` (``_fusable`` :114,
``fuse_segments`` :157, ``TpuFusedSegmentExec`` :301 with
``execute_partition`` :570, ``_run`` :698 and ``describe`` /
``tree_string`` :857-873), for chains of Project, Filter and a partial
aggregate (global or grouped) on their top.  The reference
traces such a chain into one XLA program per batch; here the chain is
lowered once, at planning, to a flat program (``expressions/program.py``)
that one hand-written kernel interprets (``kernels/fused.py``,
``csrc/fused.cu``):

  * a partial aggregate with no keys whose slots are sums and counts
    (q6): global mode, two launches a batch and no host read; the
    kernel's sums become the one-row partial;
  * otherwise (q1's grouped partial, a global MIN / MAX / M2, pick or
    bitwise slot, a filter, a projection): compact mode, the computed
    columns of the kept rows written at their compacted positions after
    one count read; the columns the chain only passes through (STRING,
    BYTE and SHORT ones always: no instruction loads them, so an
    expression over one breaks the chain) go through one
    ``gather_columns`` with the kernel's map (none at all where there is
    no filter).  A grouped partial then sorts and reduces that work batch
    with the existing kernels, a global one reduces it with the
    whole-batch kernels (``global_work_partial``): the chain stays one
    segment, as the reference traces its whole partial step into one
    program (``spark_rapids_tpu/plan/fused.py:1062``).

The chain rules are the reference's: the longest fusable chain top down,
made a segment where it holds two ops or more, where its stream child is
on the far side of a shuffle, or where it sits directly under an
exchange.  A node is fusable when every expression lowers (no
Decimal128 value or buffer does: two-limb instructions are to come); a
string output is then always a plain column reference
(``_passthrough_strings_only`` :85 holds by construction: no instruction
makes a string).  Not
ported: a broadcast join inside a segment with the dim-build fold, the
shuffled join as a segment's tail and stream pieces across a shuffle, the
exchange's map-side fold into the segment (``execute_partition_sliced``),
string-producing expressions, ``might_contain`` (no instruction: it
raises ``NotLowerable``) and HyperLogLog++ slots, and a cache of programs
across plans (the
reference keys its compiled programs by ``signature`` :394): a chain is
lowered again each time its query is planned, at every ``collect``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions import program as P
from spark_rapids_tpu_torch.expressions.aggregates import (
    COUNT_STAR, COUNT_VALID, HLL_UPDATE, MAX128, MIN128, SUM, SUM128)
from spark_rapids_tpu_torch.kernels.fused import fused_compact, fused_global
from spark_rapids_tpu_torch.kernels.selection import gather_columns
from spark_rapids_tpu_torch.plan.execs.coalesce import retry_per_batch
from spark_rapids_tpu_torch.plan.execs.aggregate import (GpuHashAggregateExec,
                                                         work_batch)
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.plan.execs.basic import (GpuFilterExec,
                                                     GpuProjectExec)
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuCoalescedShuffleReaderExec, GpuShuffleExchangeExec,
    GpuSinglePartitionExec)
from spark_rapids_tpu_torch.plan.execs.join import (
    GpuAdaptiveJoinExec, GpuShuffledHashJoinExec, empty_batch)

# a stream child on the far side of a shuffle: even one op above it is a
# segment (the reference's _SHUFFLE_BOUNDARY, fused.py:209)
_SHUFFLE_BOUNDARY = (GpuShuffleExchangeExec, GpuCoalescedShuffleReaderExec,
                     GpuSinglePartitionExec, GpuShuffledHashJoinExec,
                     GpuAdaptiveJoinExec)


# Decimal128 buffers: the program has no two-limb registers, and an HLL
# slot has no instruction (ROADMAP queue 1 item 5 (rest)), so a partial
# aggregate holding one runs op by op
_UNLOWERED_OPS = (SUM128, MIN128, MAX128, HLL_UPDATE)


def _fusable(node: GpuExec) -> bool:
    if not node.children:
        return False
    dtypes = node.children[0].schema.dtypes
    if isinstance(node, GpuProjectExec):
        return all(P.lowerable(e, dtypes) for e in node.exprs)
    if isinstance(node, GpuFilterExec):
        return P.lowerable(node.condition, dtypes, value=True)
    if isinstance(node, GpuHashAggregateExec) and node.mode == "partial":
        if any(slot.update_op in _UNLOWERED_OPS
               for _, slot in node.slot_specs):
            return False     # see _UNLOWERED_OPS
        if _global_sums(node):
            return all(P.lowerable(agg.input, dtypes, value=True)
                       for agg in node.aggregates if agg.input is not None)
        return all(P.lowerable(e, dtypes) for e in node.work_exprs())
    return False


def _global_sums(node: GpuHashAggregateExec) -> bool:
    """A partial aggregate with no keys whose slots the global-mode kernel
    reduces itself: sums and counts only."""
    return not node.group_exprs and all(
        slot.update_op in (SUM, COUNT_VALID, COUNT_STAR)
        for _, slot in node.slot_specs)


def _sum_kind(agg) -> int:
    """How a global slot reduces an aggregate's input: at its SUM buffer's
    type, or only counted."""
    for slot in agg.buffers:
        if slot.update_op == SUM:
            return P.SUM_F64 if slot.dtype == T.DOUBLE else P.SUM_I64
    return P.SUM_NONE


class Segment:
    """A chain lowered to one program: what the kernel computes, and where
    each output column comes from."""

    def __init__(self, chain: List[GpuExec], stream_schema: Schema):
        b = P.ProgramBuilder(stream_schema.dtypes)
        cols = [P.Column(dt, ordinal=i)
                for i, dt in enumerate(stream_schema.dtypes)]
        keep = None
        top = chain[0]
        #: global mode: aggregate index -> the kernel's slot
        self.agg_slot: Dict[int, int] = {}
        slots: List[Tuple[int, int]] = []
        for node in reversed(chain):
            if isinstance(node, GpuProjectExec):
                cols = [b.column(e, cols) for e in node.exprs]
            elif isinstance(node, GpuFilterExec):
                keep = b.and_keep(keep, b.value(node.condition, cols))
            elif not _global_sums(node):
                cols = [b.column(e, cols) for e in node.work_exprs()]
            else:
                for ai, agg in enumerate(node.aggregates):
                    if agg.input is None:
                        continue
                    slot = (b.value(agg.input, cols), _sum_kind(agg))
                    if slot not in slots:
                        slots.append(slot)
                    self.agg_slot[ai] = slots.index(slot)
                cols = []
        self.is_global = (isinstance(top, GpuHashAggregateExec)
                          and not top.group_exprs)
        #: global mode: the kernel reduces the partial's sums itself
        self.global_sums = self.is_global and _global_sums(top)
        self.has_filter = keep is not None
        #: each output column: (True, stream ordinal) passed through, or
        #: (False, the kernel output it is) computed
        self.layout: List[Tuple[bool, int]] = []
        self.dtypes = [c.dtype for c in cols]
        outputs: List[int] = []
        for c in cols:
            if c.value is None:
                self.layout.append((True, c.ordinal))
                continue
            if c.value not in outputs:
                outputs.append(c.value)
            self.layout.append((False, outputs.index(c.value)))
        self.program = b.finish(keep, outputs, slots)
        self.passthrough = sorted({o for through, o in self.layout
                                   if through})


class GpuFusedSegmentExec(GpuExec):
    """Runs a chain (top-down list) as one fused-segment kernel per batch.

    ``children`` is the stream child alone, so the engine's partition
    model and cleanup see the real tree; the chain is detached from it."""

    def __init__(self, chain: List[GpuExec], stream_child: GpuExec,
                 segment: Segment):
        super().__init__((stream_child,), chain[0].schema)
        self.chain = chain
        self.segment = segment
        # the program goes to each device once, under a lock: partitions
        # may run on threads
        self._lock = threading.Lock()
        self._words: Dict[torch.device, torch.Tensor] = {}
        for n in chain:
            n.children = ()

    def _device_words(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            if device not in self._words:
                self._words[device] = self.segment.program.words().to(device)
            return self._words[device]

    def execute_partition(self, idx: int):
        top = self.chain[0]
        empty = True
        for batch in self.children[0].execute_partition(idx):
            with timed(self.op_time):
                outs = retry_per_batch(batch, self._run)
            empty = False
            for out in outs:
                yield self._count_out(out)
        if empty and self.segment.is_global:
            # a partition with no input gives the partial of no rows
            # (the reference's identity partial, aggregate.py:881)
            yield self._count_out(top._identity_partial())

    def _run(self, batch: ColumnarBatch) -> ColumnarBatch:
        seg = self.segment
        prog = seg.program
        top = self.chain[0]
        n = batch.num_rows
        if seg.global_sums:
            res = fused_global(prog, self._device_words(batch.device),
                               batch.columns, n)
            return top.global_partial(
                {ai: res.slots[k] for ai, k in seg.agg_slot.items()},
                res.kept, res.one)
        if prog.outputs or seg.has_filter:
            need_map = seg.has_filter and bool(seg.passthrough)
            outs, idx, count = fused_compact(
                prog, self._device_words(batch.device), batch.columns, n,
                need_map)
        else:   # nothing to compute: every column passes through
            outs, idx, count = [], None, n
        through: Dict[int, DeviceColumn] = {
            o: batch.columns[o] for o in seg.passthrough}
        if idx is not None and count:
            through = dict(zip(seg.passthrough, gather_columns(
                [batch.columns[o] for o in seg.passthrough], idx)))
        is_agg = isinstance(top, GpuHashAggregateExec)
        if count == 0 and seg.is_global:
            # nothing kept: the partial of no rows
            return top._identity_partial()
        if count == 0 and (seg.has_filter or is_agg):
            # nothing kept: no gather, and no grouping over no rows
            return empty_batch(top.partial_schema if is_agg
                               else self.schema, batch.device)
        # one column per kernel output, so that the slots over one input
        # share their reductions
        computed = {i: DeviceColumn(*outs[i], dt)
                    for (is_through, i), dt in zip(seg.layout, seg.dtypes)
                    if not is_through}
        cols = tuple(through[i] if is_through else computed[i]
                     for is_through, i in seg.layout)
        if seg.is_global:
            return top.global_work_partial(work_batch(cols, count),
                                           batch.device)
        if is_agg:
            return top.grouped_partial(work_batch(cols, count))
        return ColumnarBatch(cols, count, self.schema)

    def describe(self) -> str:
        inner = " <- ".join(type(n).__name__.replace("Gpu", "")
                            .replace("Exec", "") for n in self.chain)
        return f"GpuFusedSegment[{inner}]"

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for n in self.chain:
            lines.append("  " * (indent + 1) + "* " + n.describe())
        lines.append(self.children[0].tree_string(indent + 1))
        return "\n".join(lines)


def _segment(chain: List[GpuExec], under_exchange: bool
             ) -> Optional[Tuple[List[GpuExec], Segment]]:
    """The longest prefix of ``chain`` that the rules make a segment and
    whose program fits the kernel, or None."""
    chain = list(chain)
    while chain:
        cur = chain[-1]
        crosses = isinstance(cur.children[0], _SHUFFLE_BOUNDARY)
        if not (len(chain) >= 2 or crosses or under_exchange):
            return None
        try:
            return chain, Segment(chain, cur.children[0].schema)
        except P.NotLowerable:
            chain.pop()   # over the kernel's limits: a shorter chain
    return None


def fuse_segments(root: GpuExec) -> GpuExec:
    """Planner post-pass: wrap each maximal fusable chain (top-down)."""

    def visit(node: GpuExec, under_exchange: bool = False) -> GpuExec:
        if _fusable(node):
            chain = [node]
            cur = node
            # only a chain's top may be an aggregate
            while (_fusable(cur.children[0]) and not isinstance(
                    cur.children[0], GpuHashAggregateExec)):
                cur = cur.children[0]
                chain.append(cur)
            found = _segment(chain, under_exchange)
            if found is not None:
                chain, segment = found
                stream = visit(chain[-1].children[0])
                return GpuFusedSegmentExec(chain, stream, segment)
        is_exchange = isinstance(node, GpuShuffleExchangeExec)
        node.children = tuple(visit(c, is_exchange) for c in node.children)
        return node

    return visit(root)
