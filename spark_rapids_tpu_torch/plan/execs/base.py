"""Physical exec base of the port.

Counterpart of ``spark_rapids_tpu/plan/execs/base.py`` (``TpuExec`` :282,
``Metric`` :236, ``timed`` :330), cut to the standard metrics.  An exec has
``num_partitions()`` partitions, each produced by ``execute_partition(idx)``
as an iterator of device batches.  Row counts are host ints, so a metric
never waits on the device; ``opTime`` is host time, which on the card is
the time to enqueue the exec's work plus any device->host read it makes.
"""
from __future__ import annotations

import time
from typing import Iterator, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema


class Metric:
    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, v: int) -> None:
        self.value += v


class timed:
    """Context manager adding wall time in ns to a metric."""

    def __init__(self, metric: Metric):
        self.metric = metric

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metric.add(time.perf_counter_ns() - self.t0)
        return False


class GpuExec:
    """Base physical operator."""

    def __init__(self, children: Tuple["GpuExec", ...], schema: Schema):
        self.children = children
        self._schema = schema
        # standard metric names (GpuExec.scala:196-206 upstream)
        self.op_time = Metric("opTime")
        self.output_rows = Metric("numOutputRows")
        self.output_batches = Metric("numOutputBatches")

    @property
    def schema(self) -> Schema:
        return self._schema

    def num_partitions(self) -> int:
        if self.children:
            return self.children[0].num_partitions()
        return 1

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)

    def describe(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def _count_out(self, batch: ColumnarBatch) -> ColumnarBatch:
        self.output_rows.add(batch.num_rows)
        self.output_batches.add(1)
        return batch
