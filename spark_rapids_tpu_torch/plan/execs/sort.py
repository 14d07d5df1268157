"""Sort and limit execs.

Counterpart of ``spark_rapids_tpu/plan/execs/sort.py`` (``sort_step``
:23-41, ``TpuSortExec`` :44 with ``_execute_out_of_core`` :99,
``TpuLimitExec`` :137).  A partition of at most ``batchSizeRows`` rows is
concatenated into one batch and sorted by the key expressions (the ported
radix ``sort_indices``, strings and Decimal128 included), then gathered,
the concat inside the retry body.  A larger one takes the reference's
out-of-core branch: it is routed into range buckets of about
``batchSizeRows`` rows (``range_sort.py`` ``range_bucket_spillable``,
sampled splitters, spillable buckets) that are sorted one at a time and
emitted in order; ties never split across buckets, so the output is a
stable sort of the partition.  A global sort over several partitions is
``range_sort.py`` ``GpuRangeSortExec``.  The limit takes the first n rows
across partitions in order; the last batch it needs is cut as a view of
its rows, so it launches nothing.
"""
from __future__ import annotations

import collections
from typing import Iterator, List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.kernels.selection import (coalesce_to_one,
                                                      gather_columns)
from spark_rapids_tpu_torch.kernels.sort import SortOrder, sort_indices
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
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
                 child: GpuExec, target_rows: int = 1 << 20):
        super().__init__((child,), child.schema)
        self.orders = tuple(orders)
        self.target_rows = max(int(target_rows), 1)
        #: partitions that took each branch ("in_core", "out_of_core")
        self.branches: "collections.Counter[str]" = collections.Counter()

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        batches = [b for b in self.children[0].execute_partition(idx)
                   if b.num_rows]
        if not batches:
            return
        total = sum(b.num_rows for b in batches)
        if total > self.target_rows:
            self.branches["out_of_core"] += 1
            yield from self._execute_out_of_core(batches, total)
            return
        self.branches["in_core"] += 1
        with timed(self.op_time):
            # the concat inside the retry body: on OOM the discarded concat
            # is made again after the spill
            out = with_retry_no_split(
                lambda: sort_step(self.orders, coalesce_to_one(batches)))
        yield self._count_out(out)

    def _execute_out_of_core(self, batches: List[ColumnarBatch],
                             total: int) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.plan.execs.coalesce import \
            retry_over_spillable
        from spark_rapids_tpu_torch.plan.execs.out_of_core import (
            close_all, num_sub_buckets)
        from spark_rapids_tpu_torch.plan.execs.range_sort import \
            range_bucket_spillable
        n_out = num_sub_buckets(total, self.target_rows)
        with timed(self.op_time):
            buckets = range_bucket_spillable(batches, self.orders, n_out)
        try:
            for q in buckets:
                if not q:
                    continue
                with timed(self.op_time):
                    out = retry_over_spillable(
                        q, lambda b: sort_step(self.orders, b))
                    close_all([q])
                yield self._count_out(out)
        finally:
            close_all(buckets)

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
