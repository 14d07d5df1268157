"""Single-partition exchange.

Counterpart of ``spark_rapids_tpu/plan/execs/exchange.py``
(``TpuSinglePartitionExec`` :524): all child partitions, in order, become
one partition.  The batches stay where they are on the device.
"""
from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.plan.execs.base import GpuExec


class GpuSinglePartitionExec(GpuExec):
    def __init__(self, child: GpuExec):
        super().__init__((child,), child.schema)

    def num_partitions(self) -> int:
        return 1

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        child = self.children[0]
        for p in range(child.num_partitions()):
            for batch in child.execute_partition(p):
                yield self._count_out(batch)

    def describe(self):
        return "GpuSinglePartition"
