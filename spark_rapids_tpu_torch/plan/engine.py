"""Query engine: runs a physical exec tree.

Counterpart of ``spark_rapids_tpu/plan/engine.py`` (``TpuEngine.execute``
/ ``collect``).  Partitions run in order on the calling thread; the device
semaphore, tenants, cancellation and the sanitizer come with the memory
runtime.
"""
from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.plan.execs.base import GpuExec


class GpuEngine:
    def execute(self, plan: GpuExec) -> List[List[ColumnarBatch]]:
        """Materialize all partitions (list of batches per partition)."""
        return [list(plan.execute_partition(p))
                for p in range(plan.num_partitions())]

    def collect(self, plan: GpuExec) -> List[tuple]:
        return [row for part in self.execute(plan) for batch in part
                for row in batch.rows()]
