"""Broadcast hash join exec.

Counterpart of ``spark_rapids_tpu/plan/execs/join.py``
(``TpuBroadcastHashJoinExec`` :627, ``_build_side`` :660, the stream
chunking of :672-700, ``cleanup`` :702) for the inner join on one
fixed-width key.  The build (right) side is materialized whole once per
query, under a lock: every right partition's batches are concatenated and
sorted by key (``kernels/join.py`` ``build_side``).  Each stream (left)
partition is joined against it a chunk at a time: consecutive stream
batches are concatenated while their rows stay within
``spark.rapids.sql.batchSizeRows``, then probed, expanded into gather maps
(one blocking read of the pair count per chunk) and gathered on both
sides.  ``cleanup`` drops the build when the query ends.  The other join
types, several keys, string keys and a residual condition raise
NotImplementedError.
"""
from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import BoundReference, Expression
from spark_rapids_tpu_torch.kernels import join as J
from spark_rapids_tpu_torch.kernels.selection import coalesce_to_one
from spark_rapids_tpu_torch.plan.execs.base import GpuExec, timed


def _ordinal(key: Expression) -> int:
    if not isinstance(key, BoundReference):
        raise NotImplementedError(f"a join key that is an expression ({key!r}) "
                                  "is not ported; project it first")
    return key.ordinal


class GpuBroadcastHashJoinExec(GpuExec):
    """Streams the left side; the right (build) side is built whole once
    and joined against every stream partition."""

    def __init__(self, left: GpuExec, right: GpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 schema: Schema, target_rows: int = 1 << 20):
        if join_type != "inner":
            raise NotImplementedError(
                f"the {join_type} join is not ported; only inner")
        if len(left_keys) != 1:
            raise NotImplementedError(
                "the multi-key join (_probe_multi) is not ported")
        super().__init__((left, right), schema)
        self.join_type = join_type
        self.left_key = _ordinal(left_keys[0])
        self.right_key = _ordinal(right_keys[0])
        for side, k in ((left, self.left_key), (right, self.right_key)):
            if side.schema.dtypes[k].variable_width:
                raise NotImplementedError(
                    "the string-key join (_probe_multi) is not ported")
        J._check_key_types(left.schema.dtypes[self.left_key],
                           right.schema.dtypes[self.right_key])
        self.target_rows = max(int(target_rows), 1)
        self._lock = threading.Lock()
        self._build: Optional[J.JoinBuild] = None
        self._build_done = False

    def num_partitions(self) -> int:
        return self.children[0].num_partitions()

    def _build_side(self) -> Optional[J.JoinBuild]:
        with self._lock:
            if not self._build_done:
                right = self.children[1]
                batches = [b for p in range(right.num_partitions())
                           for b in right.execute_partition(p)]
                with timed(self.op_time):
                    whole = coalesce_to_one(batches)
                    self._build = (J.build_side(whole, self.right_key)
                                   if whole is not None else None)
                self._build_done = True
            return self._build

    def _chunks(self, stream: List[ColumnarBatch]
                ) -> List[List[ColumnarBatch]]:
        chunks: List[List[ColumnarBatch]] = [[]]
        rows = 0
        for b in stream:
            if chunks[-1] and rows + b.num_rows > self.target_rows:
                chunks.append([])
                rows = 0
            chunks[-1].append(b)
            rows += b.num_rows
        return chunks

    def execute_partition(self, idx: int) -> Iterator[ColumnarBatch]:
        build = self._build_side()
        stream = list(self.children[0].execute_partition(idx))
        if build is None or not stream:
            return    # an inner join with an empty side has no rows
        for group in self._chunks(stream):
            with timed(self.op_time):
                left = coalesce_to_one(group)
                lo, offsets, total = J.join_probe(left, self.left_key, build)
                li, ri = J.join_expand(lo, offsets, total, build)
                out = J.apply_gather_maps(left, build.batch, li, ri,
                                          self.schema)
            yield self._count_out(out)

    def cleanup(self) -> None:
        with self._lock:
            self._build = None
            self._build_done = False
        super().cleanup()

    def describe(self):
        return (f"GpuBroadcastHashJoin[{self.join_type}, "
                f"lkey={self.left_key}, rkey={self.right_key}]")
