"""Query engine: runs a physical exec tree.

Counterpart of ``spark_rapids_tpu/plan/engine.py`` (``TpuEngine.execute``
/ ``collect``).  Partitions run in order on the calling thread, so the
reference's device semaphore and tenants are not needed yet (ROADMAP
queue 1 item 9, with cancellation and the sanitizer).  A plan runs under
the session zone it was planned in (``session_timezone``, set by
``plan_query``), as the reference's ``_session_tz_scope`` runs every
action (``api/session.py:831``).
"""
from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import session_timezone
from spark_rapids_tpu_torch.plan.execs.base import GpuExec


class GpuEngine:
    def execute(self, plan: GpuExec) -> List[List[ColumnarBatch]]:
        """Materialize all partitions (list of batches per partition), then
        let the execs release what they held for the query."""
        try:
            with session_timezone(getattr(plan, "session_timezone", "UTC")):
                return [list(plan.execute_partition(p))
                        for p in range(plan.num_partitions())]
        finally:
            plan.cleanup()

    def collect(self, plan: GpuExec) -> List[tuple]:
        return [row for part in self.execute(plan) for batch in part
                for row in batch.rows()]
