"""Project and Filter execs.

Counterpart of ``spark_rapids_tpu/plan/execs/basic.py`` (``TpuProjectExec``
:32, ``TpuFilterExec`` :66).  A filter evaluates its predicate, compacts the
rows where it is true (a null predicate drops the row) and gathers them:
the compaction reads its count back to the host once, so the gather
writes columns of exactly that many rows.
"""
from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.kernels.selection import (compaction_map,
                                                      gather_batch)
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed


class GpuProjectExec(GpuExec):
    def __init__(self, exprs: Sequence[Expression], child: GpuExec,
                 schema: Schema):
        super().__init__((child,), schema)
        self.exprs = tuple(exprs)

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute_partition(idx):
            with timed(self.op_time):
                ctx = EvalContext(batch)
                out = ColumnarBatch(tuple(e.eval(ctx) for e in self.exprs),
                                    batch.num_rows, self.schema)
            yield self._count_out(out)

    def describe(self):
        return f"GpuProject[{', '.join(map(repr, self.exprs))}]"


class GpuFilterExec(GpuExec):
    def __init__(self, condition: Expression, child: GpuExec):
        super().__init__((child,), child.schema)
        self.condition = condition

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute_partition(idx):
            with timed(self.op_time):
                pred = self.condition.eval(EvalContext(batch))
                indices, _ = compaction_map(pred.data & pred.validity)
                out = gather_batch(batch, indices)
            yield self._count_out(out)

    def describe(self):
        return f"GpuFilter[{self.condition!r}]"
