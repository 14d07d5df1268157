"""In-memory scan exec.

Counterpart of ``spark_rapids_tpu/plan/execs/scan.py``
(``TpuInMemoryScanExec`` :19): yields the relation's device batches.
"""
from __future__ import annotations

from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.plan.execs.base import GpuExec


class GpuInMemoryScanExec(GpuExec):
    def __init__(self, partitions: List[List[ColumnarBatch]], schema: Schema):
        super().__init__((), schema)
        self.partitions = partitions

    def num_partitions(self) -> int:
        return max(len(self.partitions), 1)

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        if idx >= len(self.partitions):
            return
        for batch in self.partitions[idx]:
            yield self._count_out(batch)

    def describe(self):
        return f"GpuInMemoryScan{self.schema!r}"
