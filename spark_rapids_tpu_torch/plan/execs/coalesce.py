"""Coalescing under retry.

Counterpart of ``spark_rapids_tpu/plan/execs/coalesce.py``
(``retry_over_spillable`` :98, ``retry_over_stream_pieces`` :139;
``coalesce_to_one`` :198 is ``kernels/selection.py``'s).  Both retry helpers run their body under
``with_retry_no_split`` with pin-balanced attempts: each attempt
materializes its inputs (a pin each) and unpins them before it ends,
after the body returns or before the retry's spill, so that the spill can
free exactly the inputs the next attempt brings back.  The concat runs
inside the body, so a result discarded by an OOM is made again after the
spill instead of staying on the device.  ``retry_per_batch`` runs a
per-batch step under ``with_retry`` with a split policy (the port's
split-and-retry site: the reference's execs use only the no-split
form).  The rest of the reference's
file (the coalesce exec, ``maybe_shrink``) is ROADMAP queue 1 item 6.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, TypeVar

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.kernels.selection import coalesce_to_one
from spark_rapids_tpu_torch.memory.retry import (with_retry,
                                                 with_retry_no_split)
from spark_rapids_tpu_torch.memory.spill import SpillableBatchHandle

R = TypeVar("R")


def split_in_half(batch: ColumnarBatch) -> List[ColumnarBatch]:
    """The split policy of a per-batch step: the batch's two halves, as
    views (a batch of one row cannot split)."""
    from spark_rapids_tpu_torch.shuffle.transport import slice_batch
    n = batch.num_rows
    if n < 2:
        return [batch]
    return [slice_batch(batch, 0, n // 2), slice_batch(batch, n // 2,
                                                       n - n // 2)]


def retry_per_batch(batch: ColumnarBatch,
                    step: Callable[[ColumnarBatch], R]) -> List[R]:
    """``step`` over a batch under ``with_retry``: a split-and-retry OOM
    halves the batch and runs each half, so the step must be one whose
    outputs over the pieces stand for its output over the batch (a
    projection, a filter, a partial aggregate)."""
    return with_retry([batch], step, split_policy=split_in_half)


def retry_over_spillable(handles: Sequence[SpillableBatchHandle],
                         body: Callable[[ColumnarBatch], R]) -> R:
    """``body(coalesce_to_one(the handles' batches))`` under retry, pins
    balanced per attempt.  ``body`` keeps nothing of its input past its
    return; the caller still closes the handles."""
    handles = list(handles)

    def attempt():
        pinned = []
        try:
            mats = []
            for h in handles:
                mats.append(h.materialize())
                pinned.append(h)
            return body(coalesce_to_one(mats))
        finally:
            for h in pinned:
                h.unpin()

    return with_retry_no_split(attempt)


def retry_over_stream_pieces(piece_lists, body: Callable[[list], R]) -> R:
    """``body(lists of materialized batches)`` under retry over shuffle
    pieces (``shuffle/transport.py`` ``StreamPiece``), pins balanced per
    attempt.  The pieces of one stored batch share its handle, which pins
    once an attempt; each piece is then a view of it."""
    piece_lists = [list(lst) for lst in piece_lists]

    def attempt():
        pinned = []
        backings = {}       # id(handle) -> the materialized stored batch
        try:
            mats = []
            for lst in piece_lists:
                cur = []
                for p in lst:
                    key = id(p.handle)
                    if key not in backings:
                        backings[key] = p.materialize_pinned()
                        pinned.append(p)
                    cur.append(p.as_view(backings[key]))
                mats.append(cur)
            return body(mats)
        finally:
            for p in pinned:
                p.unpin()

    return with_retry_no_split(attempt)
