"""Retry on OOM: spill, then run the step again.

Counterpart of ``spark_rapids_tpu/memory/retry.py`` (``enable_oom_injection``
:54, ``with_retry_no_split`` :90, ``with_retry`` :125 with its split
policy), the contract of upstream's RmmRapidsRetryIterator: the step must
be safe to run again, and the inputs it must bring back after a spill are
spillable handles.  A ``GpuRetryOOM``, or a real CUDA out-of-memory error,
spills every spillable handle, empties the caching allocator's cache and
runs the step again, at most ``spark.rapids.sql.retry.maxAttempts`` times;
a ``GpuSplitAndRetryOOM`` splits the input by the policy and retries each
piece.  No other error is caught.  ``with_capacity_retry`` (:187) grows
XLA's static output capacities and has no counterpart here: the port's
kernels count, then allocate.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

from spark_rapids_tpu_torch.memory import metrics as task_metrics
from spark_rapids_tpu_torch.memory.arena import (
    GpuRetryOOM, GpuSplitAndRetryOOM, as_retry_oom, device_arena,
    enter_retry_scope, exit_retry_scope, release_device_memory)

T = TypeVar("T")
U = TypeVar("U")

#: spark.rapids.sql.retry.maxAttempts (memory.initialize_memory sets it)
MAX_RETRIES = 8
MAX_SPLIT_DEPTH = 32


def enable_oom_injection(num_ooms: int = 1, skip: int = 0,
                         kind: str = "retry") -> None:
    device_arena().inject_ooms(num_ooms, skip=skip, kind=kind)


def disable_oom_injection() -> None:
    device_arena().clear_injection()


def with_retry_no_split(fn: Callable[[], T]) -> T:
    """Run fn; on a retry OOM spill and run it again (withRetryNoSplit
    upstream)."""
    last: Optional[GpuRetryOOM] = None
    enter_retry_scope()
    try:
        for _ in range(MAX_RETRIES):
            try:
                device_arena().maybe_throw_injected()
                return fn()
            except GpuSplitAndRetryOOM as e:
                raise GpuSplitAndRetryOOM(
                    "split-and-retry OOM in a no-split context") from e
            except RuntimeError as e:
                last = as_retry_oom(e)
                if last is None:
                    raise
            # outside the handler: the error's traceback holds the failed
            # attempt's frames, and with them its tensors
            last = last.with_traceback(None)
            task_metrics.get().retry_count += 1
            release_device_memory()
        raise last
    finally:
        exit_retry_scope()


def with_retry(inputs: Sequence[T], fn: Callable[[T], U],
               split_policy: Optional[Callable[[T], List[T]]] = None
               ) -> List[U]:
    """Run fn over each input; on a retry OOM spill and run again; on a
    split-and-retry OOM split the input by ``split_policy`` and run each
    piece (withRetry upstream)."""
    out: List[U] = []
    queue: List[Tuple[T, int]] = [(i, 0) for i in inputs]
    enter_retry_scope()
    try:
        while queue:
            item, depth = queue.pop(0)
            attempts = 0
            while True:
                try:
                    device_arena().maybe_throw_injected()
                    out.append(fn(item))
                    break
                except GpuSplitAndRetryOOM:
                    task_metrics.get().split_retry_count += 1
                    # a policy need not shrink its input: bound the depth
                    if split_policy is None or depth >= MAX_SPLIT_DEPTH:
                        raise
                    pieces = split_policy(item)
                    if len(pieces) <= 1:
                        raise
                    queue = [(p, depth + 1) for p in pieces] + queue
                    break
                except RuntimeError as e:
                    oom = as_retry_oom(e)
                    if oom is None:
                        raise
                    attempts += 1
                    task_metrics.get().retry_count += 1
                    if attempts >= MAX_RETRIES:
                        raise oom from e
                # outside the handler, as in with_retry_no_split
                release_device_memory()
    finally:
        exit_retry_scope()
    return out
