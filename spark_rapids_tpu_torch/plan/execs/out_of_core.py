"""Out-of-core substrate: partitions larger than one batch target.

Counterpart of ``spark_rapids_tpu/plan/execs/out_of_core.py``
(``num_sub_buckets`` :46, ``slice_by_counts`` :54,
``sub_partition_spillable`` :138, ``close_all`` :175), with ``drain``
and ``queue_pieces``.  A partition above ``spark.rapids.sql.batchSizeRows``
is hash-repartitioned on its keys into sub-buckets with a seed other than
the shuffle's (rows of one shuffle partition all share hash % P, so the
shuffle's seed would put them in one bucket), one run of input batches
of at most ``batchSizeRows`` rows at a time;
each bucket's slices go into spillable handles, so that queued buckets
can leave the device.  Equal
keys always land in one bucket, so an exec that works bucket by bucket
gives the answer of the whole partition.  The port's batches hold exactly
their rows, so the bucket count and the slices come from row counts where
the reference reads static capacities.  A slice is a copy of its rows
(a string column's bytes cut to the bucket's own), as the reference's
slices are: a handle over a view would keep the whole reordered batch on
the device however many of its buckets spilled.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, TypeVar

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels.partition import hash_partition
from spark_rapids_tpu_torch.kernels.selection import coalesce_to_one
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
from spark_rapids_tpu_torch.memory.spill import (SpillableBatchHandle,
                                                 make_spillable, owned)

#: the sub-partition hash seed (the shuffle's is 42)
SUB_PARTITION_SEED = 0x5F3759DF

B = TypeVar("B")


def drain(batches: List[B]) -> Iterator[B]:
    """The list's items in order, each taken out of the list as it is
    handed on: a batch read from the shuffle store is a view that keeps
    its stored batch from spilling, so it should live no longer than its
    turn."""
    while batches:
        yield batches.pop(0)


def _round_up_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def num_sub_buckets(total_rows: int, target_rows: int, cap: int = 256) -> int:
    """A power-of-two bucket count that puts about target_rows rows in
    each bucket, at most ``cap``."""
    if target_rows <= 0:
        return 1
    need = (total_rows + target_rows - 1) // target_rows
    return min(_round_up_pow2(max(need, 1)), cap)


def slice_by_counts(reordered: ColumnarBatch, counts: Sequence[int],
                    num_buckets: int) -> List[Optional[ColumnarBatch]]:
    """A bucket-ordered batch cut into its buckets' rows, each a batch of
    its own tensors, from the host counts; an empty bucket is None."""
    if len(counts) != num_buckets or sum(counts) != reordered.num_rows:
        raise ValueError(f"counts {list(counts)} do not cut a batch of "
                         f"{reordered.num_rows} rows into {num_buckets}")
    edges = [0]
    for cnt in counts:
        edges.append(edges[-1] + cnt)
    strings = [c for c in reordered.columns if c.is_string]
    # one device->host read: each string column's byte offset at each edge
    at = torch.tensor(edges, dtype=torch.int64, device=reordered.device)
    byte_edges = (torch.stack([c.offsets[at] for c in strings]).tolist()
                  if strings else [])
    out: List[Optional[ColumnarBatch]] = []
    for p, cnt in enumerate(counts):
        if not cnt:
            out.append(None)
            continue
        lo, hi = edges[p], edges[p + 1]
        cols, si = [], 0
        for c in reordered.columns:
            valid = c.validity[lo:hi].clone()
            if c.is_string:
                b0, b1 = byte_edges[si][p], byte_edges[si][p + 1]
                si += 1
                cols.append(DeviceColumn(c.data[b0:b1].clone(), valid,
                                         c.dtype, c.offsets[lo:hi + 1] - b0))
            else:
                cols.append(DeviceColumn(c.data[lo:hi].clone(), valid,
                                         c.dtype))
        out.append(ColumnarBatch(tuple(cols), cnt, reordered.schema))
    return out


def _runs(batches: Iterable[ColumnarBatch], target_rows: int
          ) -> Iterator[List[ColumnarBatch]]:
    """Consecutive non-empty batches in runs of at most target_rows rows
    (a larger batch is a run of its own).  A batch read from the shuffle
    store is a view that keeps its stored batch on the device, and the
    next read may need that room: so a run goes out as soon as it is full,
    a batch that leaves the run open waits as a copy of its own, and
    nothing here holds a batch past its run."""
    run: List[ColumnarBatch] = []
    rows = 0
    for b in batches:
        if b.num_rows:
            if run and rows + b.num_rows > target_rows:
                yield run
                run, rows = [], 0
            rows += b.num_rows
            run.append(b if rows >= target_rows else
                       with_retry_no_split(lambda: owned(b)))
        del b
        if rows >= target_rows:
            yield run
            run, rows = [], 0
    if run:
        yield run


def sub_partition_spillable(batches: Iterable[ColumnarBatch],
                            key_idx: Sequence[int], num_buckets: int,
                            target_rows: int
                            ) -> List[List[SpillableBatchHandle]]:
    """Hash-repartition a stream of batches on the key columns into
    spillable bucket queues, one run of at most ``target_rows`` input rows
    on the device at a time (besides its reorder).  A run's batches are
    concatenated first: a reduce partition's shuffle blocks are many and
    small, and each reorder makes a piece, and a copy, per bucket."""
    key_idx = list(key_idx)
    buckets: List[List[SpillableBatchHandle]] = [
        [] for _ in range(num_buckets)]
    for run in _runs(batches, target_rows):
        def step(r=run):
            reordered, counts = hash_partition(
                coalesce_to_one(r), key_idx, num_buckets,
                seed=SUB_PARTITION_SEED)
            return slice_by_counts(reordered, counts.tolist(), num_buckets)
        pieces = with_retry_no_split(step)
        del run, step
        queue_pieces(buckets, pieces)
    return buckets


def queue_pieces(buckets: List[List[SpillableBatchHandle]],
                 pieces: List[Optional[ColumnarBatch]]) -> None:
    """Each bucket's piece into a handle at the end of its queue, taken out
    of ``pieces`` first, so that a handle that spills while the later
    pieces reserve is held nowhere else."""
    for p in range(len(pieces)):
        piece, pieces[p] = pieces[p], None
        if piece is not None:
            buckets[p].append(make_spillable(piece))


def close_all(buckets: List[List[SpillableBatchHandle]]) -> None:
    for q in buckets:
        for h in q:
            h.close()
        q.clear()
