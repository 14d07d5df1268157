"""Project, Filter and Union execs.

Counterpart of ``spark_rapids_tpu/plan/execs/basic.py`` (``TpuProjectExec``
:32, ``TpuFilterExec`` :66, ``TpuUnionExec`` :107-130).  A filter evaluates
its predicate, compacts the rows where it is true (a null predicate drops
the row) and gathers them: the compaction reads its count back to the host
once, so the gather writes columns of exactly that many rows.  A union's
partitions are its children's, one child after another; its batches take
the first child's column names.  Each step of a project or a filter
runs under retry (the reference's :58 and :96), split-capable
(``coalesce.retry_per_batch``): a split-and-retry OOM halves the batch.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.kernels.selection import (compaction_map,
                                                      gather_batch)
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.plan.execs.coalesce import retry_per_batch


class GpuProjectExec(GpuExec):
    def __init__(self, exprs: Sequence[Expression], child: GpuExec,
                 schema: Schema):
        super().__init__((child,), schema)
        self.exprs = tuple(exprs)

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute_partition(idx):
            with timed(self.op_time):
                outs = retry_per_batch(batch, self._step)
            for out in outs:
                yield self._count_out(out)

    def _step(self, batch: ColumnarBatch) -> ColumnarBatch:
        ctx = EvalContext(batch)
        return ColumnarBatch(tuple(e.eval(ctx) for e in self.exprs),
                             batch.num_rows, self.schema)

    def describe(self):
        return f"GpuProject[{', '.join(map(repr, self.exprs))}]"


class GpuFilterExec(GpuExec):
    def __init__(self, condition: Expression, child: GpuExec):
        super().__init__((child,), child.schema)
        self.condition = condition

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute_partition(idx):
            with timed(self.op_time):
                outs = retry_per_batch(batch, self._step)
            for out in outs:
                yield self._count_out(out)

    def _step(self, batch: ColumnarBatch) -> ColumnarBatch:
        pred = self.condition.eval(EvalContext(batch))
        indices, _ = compaction_map(pred.data & pred.validity)
        return gather_batch(batch, indices)

    def describe(self):
        return f"GpuFilter[{self.condition!r}]"


class GpuUnionExec(GpuExec):
    """The children's partitions concatenated: partition ``idx`` is the
    child's partition it falls on, counting the children in order."""

    def __init__(self, children: Tuple[GpuExec, ...], schema: Schema):
        super().__init__(tuple(children), schema)

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for c in self.children:
            n = c.num_partitions()
            if idx < n:
                for batch in c.execute_partition(idx):
                    yield self._count_out(ColumnarBatch(
                        batch.columns, batch.num_rows, self.schema))
                return
            idx -= n

    def describe(self):
        return f"GpuUnion[{len(self.children)}]"
