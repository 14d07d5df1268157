"""Exchange execs: single-partition, hash and round-robin shuffle, and the
AQE coalesced reader.

Counterpart of ``spark_rapids_tpu/plan/execs/exchange.py``
(``TpuSinglePartitionExec`` :524, ``TpuShuffleExchangeExec`` :57 with
``append_key_columns`` :42 and ``partition_row_counts`` :225,
``SharedCoalesceSpec`` :398 with ``_estimated_row_bytes`` :380,
``TpuCoalescedShuffleReaderExec`` :485). The single-partition exchange
hands every child partition, in order, to one partition; the batches stay
where they are on the device. The hash exchange runs its map side once, at
the first read: each child batch gets its key columns appended, is
reordered by ``hash_partition`` (Spark's murmur3 and pmod, so the routing
is Spark's), loses the key columns again and goes, with its host row
counts (one device->host read per map batch), into a device-resident
store whose map batches are spillable handles (``shuffle/transport.py``).
With no keys (``repartition(n)``) each batch is reordered by
``round_robin_partition`` instead: row i to partition (i + start) % n,
the start rotating per map batch as ``ordinal % n`` over every batch of
every input partition (the reference's unfused exchange, :157-166), so
that the batches' remainder rows do not all land in partition 0; its
counts are host arithmetic, so such a map batch reads nothing back.
Each map batch's step runs under ``with_retry_no_split`` (the
reference's :164). A reduce partition yields its blocks as views of the
stored batches, each materialized where the spill framework moved it;
``cleanup`` closes the store.

The coalesced reader presents an exchange's reduce partitions regrouped by
a ``SharedCoalesceSpec``: adjacent partitions merge until their combined
rows (over every exchange registered with the spec, so that the two sides
of a join stay co-partitioned) reach the target, then the group closes.
The target is ``batchSizeRows``, or fewer where ``batchSizeBytes`` over
the estimated row width is smaller.  Asking a reader for its partition
count runs the map side of its exchanges: that is the point where AQE's
statistics exist, so the planner never asks it.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.kernels.partition import (hash_partition,
                                                      round_robin_partition)
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.shuffle.transport import (DeviceShuffleStore,
                                                      StreamPiece)


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


def append_key_columns(batch: ColumnarBatch, keys: Sequence[Expression]
                       ) -> Tuple[ColumnarBatch, List[int]]:
    """Evaluate the partition keys and append them as columns; returns
    (work batch, the key columns' ordinals)."""
    ctx = EvalContext(batch)
    key_cols = tuple(k.eval(ctx) for k in keys)
    work = ColumnarBatch(
        tuple(batch.columns) + key_cols, batch.num_rows,
        Schema(tuple(batch.schema.names)
               + tuple(f"_pk{i}" for i in range(len(key_cols))),
               tuple(batch.schema.dtypes) + tuple(c.dtype for c in key_cols)))
    return work, list(range(len(batch.schema), len(work.schema)))


class GpuShuffleExchangeExec(GpuExec):
    def __init__(self, num_partitions: int, keys: Sequence[Expression],
                 child: GpuExec):
        super().__init__((child,), child.schema)
        self.out_partitions = num_partitions
        self.keys = tuple(keys)
        self._store: Optional[DeviceShuffleStore] = None

    def num_partitions(self) -> int:
        return self.out_partitions

    def _materialize(self) -> DeviceShuffleStore:
        """The map side, once: partition every child batch into the store."""
        if self._store is not None:
            return self._store
        store = DeviceShuffleStore(self.out_partitions)
        child = self.children[0]
        nfields = len(child.schema)
        ordinal = 0     # rotates the round-robin start across map batches
        for in_part in range(child.num_partitions()):
            for batch in child.execute_partition(in_part):
                start = ordinal % self.out_partitions
                with timed(self.op_time):
                    out, counts = with_retry_no_split(
                        lambda: self._map_step(batch, nfields, start))
                    store.write_partitioned(out, counts)
                ordinal += 1
        self._store = store
        return store

    def _map_step(self, batch: ColumnarBatch, nfields: int, start: int):
        if not self.keys:
            return round_robin_partition(batch, self.out_partitions, start)
        work, key_idx = append_key_columns(batch, self.keys)
        reordered, counts = hash_partition(work, key_idx, self.out_partitions)
        return (ColumnarBatch(reordered.columns[:nfields],
                              reordered.num_rows, batch.schema),
                counts.tolist())

    def partition_row_counts(self) -> List[int]:
        """Rows per reduce partition, after the map side (AQE's runtime
        statistics)."""
        return self._materialize().partition_rows()

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        store = self._materialize()
        for piece in store.read(idx):
            yield self._count_out(piece)
            # a view of a stored batch: let it go before the next read
            del piece

    def stream_pieces(self, idx: int) -> List[StreamPiece]:
        """The reduce partition's blocks, unsliced (for
        ``coalesce.retry_over_stream_pieces``)."""
        return self._materialize().pieces(idx)

    def cleanup(self) -> None:
        if self._store is not None:
            self._store.close()
        self._store = None
        super().cleanup()

    def describe(self):
        if not self.keys:
            return f"GpuShuffleExchange[round_robin, {self.out_partitions}]"
        return (f"GpuShuffleExchange[hash, {self.out_partitions}, "
                f"{', '.join(map(repr, self.keys))}]")


def _estimated_row_bytes(schema: Schema) -> int:
    """A row's bytes for the byte goal: each fixed-width column its width,
    a string 32, and one validity byte each."""
    return sum((32 if dt.variable_width else np.dtype(dt.np_dtype).itemsize)
               + 1 for dt in schema.dtypes)


class SharedCoalesceSpec:
    """One grouping of adjacent reduce partitions, from the combined row
    counts of every exchange registered with it."""

    def __init__(self, target_rows: int, target_bytes: int = 0):
        self.target_rows = max(int(target_rows), 1)
        self.target_bytes = max(int(target_bytes), 0)
        self.exchanges: List[GpuShuffleExchangeExec] = []
        #: the last grouping, kept after ``reset`` for explain
        self._groups: Optional[List[List[int]]] = None
        self._stale = True

    def register(self, exchange: GpuShuffleExchangeExec) -> None:
        self.exchanges.append(exchange)

    def target(self) -> int:
        if not self.target_bytes:
            return self.target_rows
        row_bytes = max(_estimated_row_bytes(self.exchanges[0].schema), 1)
        return min(self.target_rows, max(self.target_bytes // row_bytes, 1))

    def groups(self) -> List[List[int]]:
        """Partitions merge in order until their rows reach the target;
        the map side of every exchange runs first."""
        if not self._stale:
            return self._groups
        if not self.exchanges:
            raise ValueError("a coalesce spec with no exchange")
        counts = [sum(c) for c in zip(*(ex.partition_row_counts()
                                        for ex in self.exchanges))]
        target = self.target()
        groups: List[List[int]] = []
        cur: List[int] = []
        acc = 0
        for p, n in enumerate(counts):
            cur.append(p)
            acc += n
            if acc >= target:
                groups.append(cur)
                cur, acc = [], 0
        if cur:
            groups.append(cur)
        self._groups, self._stale = groups, False
        return groups

    def reset(self) -> None:
        """The next ``groups`` reads the statistics again."""
        self._stale = True


class GpuCoalescedShuffleReaderExec(GpuExec):
    """An exchange's reduce partitions, regrouped by a shared spec."""

    def __init__(self, exchange: GpuShuffleExchangeExec,
                 spec: SharedCoalesceSpec):
        super().__init__((exchange,), exchange.schema)
        self.spec = spec
        spec.register(exchange)

    def num_partitions(self) -> int:
        return len(self.spec.groups())

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        for p in self.spec.groups()[idx]:
            for batch in self.children[0].execute_partition(p):
                yield self._count_out(batch)
                del batch       # as the exchange's own read

    def stream_pieces(self, idx: int) -> List[StreamPiece]:
        return [piece for p in self.spec.groups()[idx]
                for piece in self.children[0].stream_pieces(p)]

    def cleanup(self) -> None:
        self.spec.reset()
        super().cleanup()

    def describe(self):
        n = len(self.spec._groups) if self.spec._groups is not None else "?"
        return (f"GpuCoalescedShuffleReader[{n} of "
                f"{self.children[0].num_partitions()} partitions]")
