"""Exchange execs: single-partition and hash shuffle.

Counterpart of ``spark_rapids_tpu/plan/execs/exchange.py``
(``TpuSinglePartitionExec`` :524, ``TpuShuffleExchangeExec`` :57 with
``append_key_columns`` :42).  The single-partition exchange hands every
child partition, in order, to one partition; the batches stay where they
are on the device.  The hash exchange runs its map side once, at the first
read: each child batch gets its key columns appended, is reordered by
``hash_partition`` (Spark's murmur3 and pmod, so the routing is Spark's),
loses the key columns again and goes, with its host row counts (one
device->host read per map batch), into a device-resident store.  A reduce
partition yields its blocks as views of the stored batches.  The AQE
coalesced reader (``TpuCoalescedShuffleReaderExec`` :485) is not ported.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.kernels.partition import hash_partition
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.shuffle.transport import DeviceShuffleStore


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
        for in_part in range(child.num_partitions()):
            for batch in child.execute_partition(in_part):
                with timed(self.op_time):
                    work, key_idx = append_key_columns(batch, self.keys)
                    reordered, counts = hash_partition(work, key_idx,
                                                       self.out_partitions)
                    out = ColumnarBatch(reordered.columns[:nfields],
                                        reordered.num_rows, child.schema)
                    store.write_partitioned(out, counts.tolist())
        self._store = store
        return store

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        store = self._materialize()
        for piece in store.read(idx):
            yield self._count_out(piece)

    def describe(self):
        return (f"GpuShuffleExchange[hash, {self.out_partitions}, "
                f"{', '.join(map(repr, self.keys))}]")
