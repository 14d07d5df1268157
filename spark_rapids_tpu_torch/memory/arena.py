"""Device memory arena: budget accounting and the OOM signals.

Counterpart of ``spark_rapids_tpu/memory/arena.py`` (the OOM classes
:29-45, ``is_device_oom`` :49, ``translate_device_oom`` :76, the retry
scope :107-117, ``DeviceArena`` :123 with its budget, spill callback and
OOM injection :150-170).  PyTorch's CUDA caching allocator owns the card's
memory; the arena keeps account of what the spillable handles hold on the
device on top of it.  A reservation that would pass the budget first asks
the spill framework to move handles off the device, then raises
``GpuRetryOOM`` or ``GpuSplitAndRetryOOM`` into the task.

A real allocator failure (``torch.cuda.OutOfMemoryError``, or a
``RuntimeError`` reading "CUDA out of memory") is the same signal:
``translate_device_oom`` and the retry loops of ``memory/retry.py`` turn
it into ``GpuRetryOOM`` after spilling every handle and emptying the
allocator's cache.

OOM injection is a test switch, off by default: ``inject_ooms`` arms a
count of synthetic OOMs that fire only inside a retry scope (code outside
``with_retry`` has no way to recover).  The reference routes it through
its chaos registry, which the port does not have.
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Optional

import torch


class GpuOOM(RuntimeError):
    """Base class of the retryable device-memory signals."""


class GpuRetryOOM(GpuOOM):
    """Retry the whole operation after spilling (GpuRetryOOM upstream)."""


class GpuSplitAndRetryOOM(GpuOOM):
    """Split the input and retry each piece (GpuSplitAndRetryOOM
    upstream)."""


def is_device_oom(exc: BaseException) -> bool:
    """True when exc is the CUDA caching allocator's out-of-memory error."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and "CUDA out of memory" in str(exc)


#: process-lifetime count of real device OOMs turned into retries (the task
#: metrics are per thread)
GLOBAL_DEVICE_OOM_COUNT = 0


def note_device_oom() -> None:
    """Count one real device OOM, in the process and in the task."""
    global GLOBAL_DEVICE_OOM_COUNT
    from spark_rapids_tpu_torch.memory import metrics as task_metrics
    GLOBAL_DEVICE_OOM_COUNT += 1
    task_metrics.get().device_oom_count += 1


def release_device_memory() -> None:
    """Spill every spillable handle, then hand the caching allocator's
    free blocks back to CUDA, so that a rerun finds the memory."""
    from spark_rapids_tpu_torch.memory.spill import spill_framework
    spill_framework().spill_device(1 << 62)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def as_retry_oom(e: RuntimeError) -> Optional[GpuRetryOOM]:
    """The retry OOM an error stands for, or None when it is no OOM: a
    ``GpuRetryOOM`` as it is, a real CUDA OOM (counted) as a new one.  The
    one translation of the allocator's error, for the retry loops and for
    ``translate_device_oom``."""
    if isinstance(e, GpuRetryOOM):
        return e
    if isinstance(e, GpuOOM) or not is_device_oom(e):
        return None
    note_device_oom()
    return GpuRetryOOM(f"CUDA out of memory, as a retry: {e}")


def translate_device_oom(fn):
    """Wrap a device step so that a real CUDA OOM becomes ``GpuRetryOOM``
    after an emergency spill (the reference's wrapper of its cached
    programs; the port's retry loops translate on their own)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except RuntimeError as e:
            oom = as_retry_oom(e)
            if oom is None or oom is e:
                raise
        release_device_memory()
        raise oom

    return wrapper


_RETRY_SCOPE = threading.local()


def enter_retry_scope() -> None:
    _RETRY_SCOPE.depth = getattr(_RETRY_SCOPE, "depth", 0) + 1


def exit_retry_scope() -> None:
    _RETRY_SCOPE.depth = getattr(_RETRY_SCOPE, "depth", 1) - 1


def in_retry_scope() -> bool:
    """Injected OOMs fire only inside a retry-covered region."""
    return getattr(_RETRY_SCOPE, "depth", 0) > 0


class DeviceArena:
    """Byte budget of the spillable handles on one card.

    ``spill_cb`` is installed by the spill framework: called with the bytes
    needed, it returns the bytes it freed.  A budget of 0 is unlimited.
    """

    def __init__(self, budget_bytes: int = 0):
        self.budget_bytes = budget_bytes
        self.used_bytes = 0
        self.peak_bytes = 0
        self._lock = threading.RLock()
        self._spill_cb: Optional[Callable[[int], int]] = None
        #: armed injection: [remaining, skip, kind] or None
        self._inject: Optional[list] = None

    def set_spill_callback(self, cb: Optional[Callable[[int], int]]) -> None:
        with self._lock:
            self._spill_cb = cb

    # -- OOM injection -------------------------------------------------------

    def inject_ooms(self, num_ooms: int, skip: int = 0,
                    kind: str = "retry") -> None:
        """Arm ``num_ooms`` synthetic OOMs after ``skip`` checks in retry
        scopes pass."""
        if kind not in ("retry", "split"):
            raise ValueError(f"injected OOM kind {kind!r}: retry or split")
        with self._lock:
            self._inject = [int(num_ooms), int(skip), kind]

    def clear_injection(self) -> None:
        with self._lock:
            self._inject = None

    def maybe_throw_injected(self) -> None:
        """Called where a retry body starts and where a handle reserves."""
        if not in_retry_scope():
            return
        with self._lock:
            inj = self._inject
            if inj is None or inj[0] <= 0:
                return
            if inj[1] > 0:
                inj[1] -= 1
                return
            inj[0] -= 1
            kind = inj[2]
        if kind == "retry":
            raise GpuRetryOOM("injected retry OOM")
        raise GpuSplitAndRetryOOM("injected split-and-retry OOM")

    # -- reservations --------------------------------------------------------

    def reserve(self, nbytes: int) -> None:
        """Account nbytes on the device; spill, then raise, over the budget.

        The spill callback runs without the arena lock: spilling takes the
        handles' locks, whose holders may wait on this one."""
        self.maybe_throw_injected()
        with self._lock:
            needed = 0
            if self.budget_bytes and self.used_bytes + nbytes > \
                    self.budget_bytes:
                needed = self.used_bytes + nbytes - self.budget_bytes
            cb = self._spill_cb
        freed = cb(needed) if needed and cb else 0
        with self._lock:
            if self.budget_bytes and self.used_bytes + nbytes > \
                    self.budget_bytes:
                if needed and freed <= 0:
                    raise GpuSplitAndRetryOOM(
                        f"device arena over budget: need {nbytes} B, used "
                        f"{self.used_bytes} B of {self.budget_bytes} B, "
                        "nothing left to spill")
                raise GpuRetryOOM("device arena over budget after spilling "
                                  f"{freed} B")
            self.used_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.used_bytes -= nbytes
            if self.used_bytes < 0:
                raise AssertionError("arena release underflow")


_GLOBAL_ARENA = DeviceArena()


def device_arena() -> DeviceArena:
    return _GLOBAL_ARENA


def configure(budget_bytes: int) -> None:
    """Set the global arena's budget (0: unlimited)."""
    _GLOBAL_ARENA.budget_bytes = int(budget_bytes)
