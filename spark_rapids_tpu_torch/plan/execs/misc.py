"""Expand exec: each input batch once per projection, the substrate of
ROLLUP.

Counterpart of ``spark_rapids_tpu/plan/execs/misc.py`` (``TpuExpandExec``
:34-69 with ``_coerce`` :72-82).  Like the reference's, it emits one
projected batch per projection per input batch, in projection order; no
row interleave is needed, since the aggregate above it does not depend on
the row order.  A projection is plain expression evaluation: a typed null
literal (``Literal(None, dtype)``) is already a column of the output's
type, so nothing needs the reference's ``_coerce``.  No kernel of its own.
"""
from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed


class GpuExpandExec(GpuExec):
    def __init__(self, projections: Sequence[Sequence[Expression]],
                 child: GpuExec, schema: Schema):
        super().__init__((child,), schema)
        self.projections = tuple(tuple(p) for p in projections)

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for batch in self.children[0].execute_partition(idx):
            ctx = EvalContext(batch)
            for proj in self.projections:
                with timed(self.op_time):
                    out = ColumnarBatch(tuple(e.eval(ctx) for e in proj),
                                        batch.num_rows, self.schema)
                yield self._count_out(out)

    def describe(self):
        return f"GpuExpand[{len(self.projections)} projections]"
