"""Device-resident shuffle store.

Counterpart of ``spark_rapids_tpu/shuffle/transport.py``
``CacheOnlyTransport`` (:362) in its range-view write shape: each map
batch is kept once, reordered by partition, with its host row counts, and
each partition's block is a plain ``(batch, start, count)`` view that is
sliced when it is read.  Slices of a 1-d tensor are views, so a read
copies nothing.  The reference's spillable handles, ``RangeView`` pytrees
and wire transports are not ported: spilling belongs to the memory
runtime.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


def slice_batch(batch: ColumnarBatch, start: int, count: int
                ) -> ColumnarBatch:
    """Rows [start, start + count) of a batch, as views of its tensors."""
    end = start + count
    return ColumnarBatch(
        tuple(DeviceColumn(c.data[start:end], c.validity[start:end], c.dtype)
              for c in batch.columns), count, batch.schema)


class DeviceShuffleStore:
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions
        #: per partition: (map batch, start row, row count), in write order
        self._blocks: List[List[Tuple[ColumnarBatch, int, int]]] = [
            [] for _ in range(num_partitions)]

    def write_partitioned(self, reordered: ColumnarBatch,
                          host_counts: Sequence[int]) -> None:
        """Store one map batch whose rows are ordered by partition, with
        ``host_counts[p]`` rows in partition p.  An empty partition gets no
        block."""
        if len(host_counts) != self.num_partitions \
                or sum(host_counts) != reordered.num_rows:
            raise ValueError(f"counts {list(host_counts)} do not cut a batch "
                             f"of {reordered.num_rows} rows into "
                             f"{self.num_partitions} partitions")
        start = 0
        for p, cnt in enumerate(host_counts):
            if cnt:
                self._blocks[p].append((reordered, start, cnt))
            start += cnt

    def read(self, partition: int) -> Iterator[ColumnarBatch]:
        """The partition's blocks in write order, sliced now."""
        for batch, start, cnt in self._blocks[partition]:
            yield slice_batch(batch, start, cnt)
