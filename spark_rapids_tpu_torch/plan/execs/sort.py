"""Sort and limit execs.

Counterpart of ``spark_rapids_tpu/plan/execs/sort.py`` (``sort_step``
:23-41, ``TpuSortExec`` :44, ``TpuLimitExec`` :137) for a partition that
fits on the card: its batches are concatenated into one and sorted by the
key expressions (the ported radix ``sort_indices``, strings included),
then gathered.  The planner puts a single-partition exchange under a
global sort.  The limit takes the first n rows across partitions in order;
the last batch it needs is cut as a view of its rows, so it launches
nothing.  The reference's out-of-core range-bucketed sort and
``TpuRangeSortExec`` are not ported.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.kernels.selection import (coalesce_to_one,
                                                      gather_columns)
from spark_rapids_tpu_torch.kernels.sort import SortOrder, sort_indices
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.shuffle.transport import slice_batch


def sort_step(orders: Sequence[Tuple[Expression, SortOrder]],
              batch: ColumnarBatch) -> ColumnarBatch:
    """One batch sorted by ``orders``: the keys are evaluated beside the
    columns, the rows sorted by them, and the columns gathered."""
    ctx = EvalContext(batch)
    keys = tuple(e.eval(ctx) for e, _ in orders)
    work = ColumnarBatch(keys, batch.num_rows, Schema(
        tuple(f"_sk{i}" for i in range(len(keys))),
        tuple(c.dtype for c in keys)))
    idx = sort_indices(work, list(range(len(keys))), [o for _, o in orders])
    return ColumnarBatch(tuple(gather_columns(batch.columns, idx)),
                         batch.num_rows, batch.schema)


class GpuSortExec(GpuExec):
    """Sorts each partition."""

    def __init__(self, orders: Sequence[Tuple[Expression, SortOrder]],
                 child: GpuExec):
        super().__init__((child,), child.schema)
        self.orders = tuple(orders)

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        batches = list(self.children[0].execute_partition(idx))
        if not batches:
            return
        with timed(self.op_time):
            out = sort_step(self.orders, coalesce_to_one(batches))
        yield self._count_out(out)

    def describe(self):
        keys = ", ".join(f"{e!r} {o!r}" for e, o in self.orders)
        return f"GpuSort[{keys}]"


class GpuLimitExec(GpuExec):
    """Global limit: the first n rows across partitions, in order."""

    def __init__(self, n: int, child: GpuExec):
        super().__init__((child,), child.schema)
        self.n = n

    def num_partitions(self) -> int:
        return 1

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        remaining = self.n
        child = self.children[0]
        for p in range(child.num_partitions()):
            if remaining <= 0:
                return
            for batch in child.execute_partition(p):
                if remaining <= 0:
                    return
                if batch.num_rows <= remaining:
                    remaining -= batch.num_rows
                    yield self._count_out(batch)
                else:
                    yield self._count_out(slice_batch(batch, 0, remaining))
                    return

    def describe(self):
        return f"GpuLimit[{self.n}]"
