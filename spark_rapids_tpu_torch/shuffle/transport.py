"""Device-resident shuffle store, over spillable handles.

Counterpart of ``spark_rapids_tpu/shuffle/transport.py``
``CacheOnlyTransport`` (:362) in its range-view write shape (:395-413):
each map batch is kept once, reordered by partition, in a
``SpillableBatchHandle`` with its host row counts, and each partition's
block is a ``(handle, start, count)`` view that is sliced when it is
read.  The store keeps each partition's row count from the host counts it
is given, the statistics the coalesced reader reads, so they cost no
device read.  A read materializes the block's handle (from host memory or
disk where the spill framework moved it) and slices it, and keeps the
handle pinned until the reader asks for the next block; a reader that
keeps a view longer leaves the handle shared, and a shared handle does
not spill (``memory/spill.py``).  Slices of a 1-d tensor are views, so a
read copies nothing on the device:
a string column's block is ``offsets[start:end + 1]`` over the same bytes
(its offsets then do not start at 0, which every kernel allows).
``pieces`` hands out the blocks unsliced, for a reader that must hold
them across a retry (``plan/execs/coalesce.py``
``retry_over_stream_pieces``).  The reference's ``RangeView`` pytrees and
wire transports are not ported.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory.spill import (SpillableBatchHandle,
                                                 make_spillable)


def slice_batch(batch: ColumnarBatch, start: int, count: int
                ) -> ColumnarBatch:
    """Rows [start, start + count) of a batch, as views of its tensors."""
    end = start + count
    return ColumnarBatch(tuple(c.slice_rows(start, end)
                               for c in batch.columns), count, batch.schema)


class StreamPiece:
    """One block of a partition: rows [start, start + count) of a stored
    map batch.  The pieces of one map batch share its handle."""

    def __init__(self, handle: SpillableBatchHandle, start: int, count: int):
        self.handle = handle
        self.start = start
        self.count = count

    def materialize_pinned(self) -> ColumnarBatch:
        """The whole stored batch on the device, pinned until ``unpin``."""
        return self.handle.materialize()

    def unpin(self) -> None:
        self.handle.unpin()

    def as_view(self, backing: ColumnarBatch) -> ColumnarBatch:
        """This piece's rows of the materialized stored batch."""
        return slice_batch(backing, self.start, self.count)


class DeviceShuffleStore:
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions
        #: per partition: its pieces, in write order
        self._blocks: List[List[StreamPiece]] = [
            [] for _ in range(num_partitions)]
        self._handles: List[SpillableBatchHandle] = []
        self._rows = [0] * num_partitions

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
        if reordered.num_rows == 0:
            return
        handle = make_spillable(reordered)
        self._handles.append(handle)
        start = 0
        for p, cnt in enumerate(host_counts):
            if cnt:
                self._blocks[p].append(StreamPiece(handle, start, cnt))
                self._rows[p] += cnt
            start += cnt

    def partition_rows(self) -> List[int]:
        """Rows written to each partition so far."""
        return list(self._rows)

    def stored_bytes(self) -> int:
        """Device bytes of the stored map batches."""
        return sum(h.size_bytes for h in self._handles)

    def pieces(self, partition: int) -> List[StreamPiece]:
        return list(self._blocks[partition])

    def read(self, partition: int) -> Iterator[ColumnarBatch]:
        """The partition's blocks in write order, each materialized and
        sliced when it is reached, its handle pinned until the next.  The
        view is yielded out of a list, so that this frame keeps no
        reference to it (or to the stored batch) while the next block is
        materialized."""
        for piece in self._blocks[partition]:
            view = [piece.as_view(piece.handle.materialize())]
            try:
                yield view.pop()
            finally:
                piece.handle.unpin()

    def close(self) -> None:
        for h in self._handles:
            h.close()
        self._handles.clear()
        self._blocks = [[] for _ in range(self.num_partitions)]
