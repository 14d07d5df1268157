"""Expand exec: each input batch once per projection, the substrate of
ROLLUP; and the range exec.

Counterpart of ``spark_rapids_tpu/plan/execs/misc.py`` (``TpuExpandExec``
:34-69 with ``_coerce`` :72-82).  Like the reference's, it emits one
projected batch per projection per input batch, in projection order; no
row interleave is needed, since the aggregate above it does not depend on
the row order.  A projection is plain expression evaluation: a typed null
literal (``Literal(None, dtype)``) is already a column of the output's
type, so nothing needs the reference's ``_coerce``.  No kernel of its own.

``GpuRangeExec`` is ``TpuRangeExec`` (:84): the ids split into
``num_partitions`` runs of ceil(total / num_partitions), each made in
batches of ``batchSizeRows`` by ``torch.arange`` on the device (the
reference's ``_range_kernel`` :128 pads to a power of two for XLA; it has
no kernel of its own).
"""
from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
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


class GpuRangeExec(GpuExec):
    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 schema: Schema, device: torch.device,
                 batch_rows: int = 1 << 20):
        super().__init__((), schema)
        self.start, self.end, self.step = start, end, step
        self.n_parts = num_partitions
        self.device = device
        self.batch_rows = max(int(batch_rows), 1)
        total = max(0, -(-(end - start) // step))
        per = -(-total // num_partitions)
        self._bounds = [(start + p * per * step,
                         min(per, max(0, total - p * per)))
                        for p in range(num_partitions)]

    def num_partitions(self) -> int:
        return self.n_parts

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        lo, count = self._bounds[idx]
        for done in range(0, count, self.batch_rows):
            n = min(self.batch_rows, count - done)
            with timed(self.op_time):
                ids = torch.arange(n, dtype=torch.int64, device=self.device)
                ids = ids * self.step + (lo + done * self.step)
                valid = torch.ones(n, dtype=torch.bool, device=self.device)
                batch = ColumnarBatch(
                    (DeviceColumn(ids, valid, self.schema.dtypes[0]),), n,
                    self.schema)
            yield self._count_out(batch)

    def describe(self):
        return f"GpuRange[{self.start}, {self.end}, {self.step}]"
