"""Range-partitioned global sort, and the range bucketing it shares with
the out-of-core sort.

Counterpart of ``spark_rapids_tpu/plan/execs/range_sort.py``
(``make_encoder`` :70, ``make_router`` :80, ``sample_boundaries`` :127,
``range_bucket_spillable`` :166, ``TpuRangeSortExec`` :185): sample the
sort keys, pick range boundaries, route every row to the bucket whose
range holds its key, and sort each bucket alone; the buckets in order are
the global order, and no batch ever holds the whole input.

A row's key is a row of uint64 words (``kernels/sort.py`` ``order_words``):
per sort key its null word, then its data words (one for a fixed-width
key, two for a Decimal128, a string's chunks and its length), each in
Spark's order for the key's direction.  The router (``range_partition``,
K1) gives a row the number of boundaries at or below its words, so equal
keys never split, and reorders the rows stably by bucket: bucket-by-bucket
sorting is then a stable sort of the whole input.  A string key takes as
many chunks as the longest valid string of every input batch needs, one
count for all batches, so that their words compare.  The cluster path
(``ClusterRangeSortMixin`` :335) waits for the cluster slice (ROADMAP
queue 1 item 8).
"""
from __future__ import annotations

import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.core import EvalContext, Expression
from spark_rapids_tpu_torch.kernels.groupby import normalize_key_column
from spark_rapids_tpu_torch.kernels.partition import range_partition
from spark_rapids_tpu_torch.kernels.selection import gather_batch
from spark_rapids_tpu_torch.kernels.sort import (SortOrder, order_words,
                                                 string_chunks,
                                                 string_longest)
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
from spark_rapids_tpu_torch.memory.spill import (SpillableBatchHandle,
                                                 make_spillable)
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed
from spark_rapids_tpu_torch.plan.execs.coalesce import (coalesce_to_one,
                                                        retry_over_spillable)
from spark_rapids_tpu_torch.plan.execs.out_of_core import (
    close_all, drain, queue_pieces, slice_by_counts)
from spark_rapids_tpu_torch.plan.execs.sort import sort_step

SAMPLE_PER_PARTITION = 64
_SIGN64 = -2**63

Orders = Tuple[Tuple[Expression, SortOrder], ...]


def key_chunks(batches: Sequence[ColumnarBatch], orders: Orders
               ) -> Tuple[int, ...]:
    """The chunk count of each sort key (0 for a key that is no string)
    that covers its longest valid string in every batch."""
    out = [0] * len(orders)
    for b in batches:
        ctx = EvalContext(b)
        idx = [i for i, (e, _) in enumerate(orders) if e.dtype.variable_width]
        longest = string_longest([orders[i][0].eval(ctx) for i in idx])
        for i, ln in zip(idx, longest):
            out[i] = max(out[i], string_chunks(ln))
    return tuple(out)


def make_encoder(orders: Orders, chunks: Sequence[int]
                 ) -> Callable[[ColumnarBatch], torch.Tensor]:
    """fn(batch) -> int64 [nk, n]: the rows' key words, most significant
    first (uint64 bits)."""
    orders = tuple(orders)

    def encode(batch: ColumnarBatch) -> torch.Tensor:
        ctx = EvalContext(batch)
        return torch.cat([order_words(normalize_key_column(e.eval(ctx)), o,
                                      nch)
                          for (e, o), nch in zip(orders, chunks)])
    return encode


def make_router(orders: Orders, chunks: Sequence[int], n_out: int,
                boundaries: np.ndarray
                ) -> Callable[[ColumnarBatch],
                              Tuple[ColumnarBatch, List[int]]]:
    """fn(batch) -> (the batch reordered by range bucket, host counts of
    the n_out buckets) against ``boundaries`` (uint64 [nb, nk], sorted and
    distinct, nb < n_out)."""
    encode = make_encoder(orders, chunks)
    bounds_host = torch.from_numpy(boundaries.astype(np.uint64).view(
        np.int64).copy())

    def route(batch: ColumnarBatch) -> Tuple[ColumnarBatch, List[int]]:
        words = encode(batch)
        bounds = bounds_host.to(batch.device)
        if bounds.shape[0] == 0:
            bounds = bounds.reshape(0, words.shape[0])
        order, counts = range_partition(words, bounds, n_out)
        return gather_batch(batch, order), counts.tolist()
    return route


def sample_boundaries(batches: Sequence[ColumnarBatch], orders: Orders,
                      chunks: Sequence[int], n_out: int) -> np.ndarray:
    """About SAMPLE_PER_PARTITION evenly spaced rows of each batch, their
    key words sorted, and n_out - 1 splitters taken at even ranks, without
    repeats (equal splitters only leave buckets empty): uint64 [nb, nk]."""
    encode = make_encoder(orders, chunks)
    samples: List[np.ndarray] = []
    for b in batches:
        if b.num_rows == 0:
            continue
        stride = max(b.num_rows // SAMPLE_PER_PARTITION, 1)
        idx = torch.arange(0, b.num_rows, stride, device=b.device)
        words = with_retry_no_split(lambda: encode(b)[:, idx].cpu())
        samples.append(words.numpy().view(np.uint64).T)
    if not samples or n_out == 1:
        return np.zeros((0, samples[0].shape[1] if samples else 0), np.uint64)
    rows = np.concatenate(samples)
    rows = rows[np.lexsort(rows.T[::-1])]
    picks = [rows[min(len(rows) - 1, (p * len(rows)) // n_out)]
             for p in range(1, n_out)]
    uniq = [picks[0]] + [r for prev, r in zip(picks, picks[1:])
                         if not np.array_equal(prev, r)]
    return np.stack(uniq)


def range_bucket_spillable(batches: List[ColumnarBatch], orders: Orders,
                           n_out: int) -> List[List[SpillableBatchHandle]]:
    """Route a list of batches into n_out spillable range buckets: the
    boundaries and the string chunk counts come from every batch, then
    each batch leaves the list as it is routed (the list ends empty), so
    that the queued rows live in the handles alone."""
    chunks = key_chunks(batches, orders)
    boundaries = sample_boundaries(batches, orders, chunks, n_out)
    route = make_router(orders, chunks, n_out, boundaries)
    buckets: List[List[SpillableBatchHandle]] = [[] for _ in range(n_out)]
    for b in drain(batches):
        if b.num_rows == 0:
            continue
        queue_pieces(buckets, with_retry_no_split(
            lambda: slice_by_counts(*route(b), n_out)))
    return buckets


class GpuRangeSortExec(GpuExec):
    """Global sort over n output partitions: range buckets, each sorted
    alone."""

    def __init__(self, orders: Sequence[Tuple[Expression, SortOrder]],
                 child: GpuExec, num_partitions: int,
                 small_sort_rows: int = 1 << 20):
        super().__init__((child,), child.schema)
        self.orders = tuple(orders)
        self.out_partitions = max(int(num_partitions), 1)
        #: an input of at most this many rows (batchSizeRows) is sorted as
        #: one bucket, without sampling or routing
        self.small_sort_rows = max(int(small_sort_rows), 1)
        self._lock = threading.Lock()
        self._buckets: Optional[List[List[SpillableBatchHandle]]] = None
        #: "small" or "routed", once the input was seen
        self.branch: Optional[str] = None

    def num_partitions(self) -> int:
        return self.out_partitions

    def _materialize(self) -> List[List[SpillableBatchHandle]]:
        with self._lock:
            if self._buckets is not None:
                return self._buckets
            child = self.children[0]
            batches = [b for p in range(child.num_partitions())
                       for b in child.execute_partition(p) if b.num_rows]
            with timed(self.op_time):
                if not batches:
                    buckets = [[] for _ in range(self.out_partitions)]
                elif sum(b.num_rows for b in batches) <= self.small_sort_rows:
                    # one local sort is the global sort: every row in
                    # partition 0, the others empty
                    self.branch = "small"
                    merged = with_retry_no_split(
                        lambda: coalesce_to_one(batches))
                    buckets = [[make_spillable(merged)]] + \
                        [[] for _ in range(self.out_partitions - 1)]
                else:
                    self.branch = "routed"
                    buckets = range_bucket_spillable(
                        batches, self.orders, self.out_partitions)
            del batches
            self._buckets = buckets
            return buckets

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        handles = self._materialize()[idx]
        if not handles:
            return
        with timed(self.op_time):
            out = retry_over_spillable(
                handles, lambda b: sort_step(self.orders, b))
        yield self._count_out(out)

    def cleanup(self) -> None:
        with self._lock:
            if self._buckets is not None:
                close_all(self._buckets)
                self._buckets = None
        super().cleanup()

    def describe(self):
        keys = ", ".join(f"{e!r} {o!r}" for e, o in self.orders)
        return f"GpuRangeSort[{self.out_partitions}, {keys}]"
