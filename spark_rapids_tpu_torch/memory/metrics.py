"""Per-task memory metrics: retry counts and device OOMs.

The port's copy of ``spark_rapids_tpu/memory/metrics.py`` (``TaskMetrics``
:15, ``get`` :47, ``reset`` :55), without the XLA capacity retries.  A
thread-local holds the running task's metrics.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict


@dataclasses.dataclass
class TaskMetrics:
    retry_count: int = 0
    split_retry_count: int = 0
    device_oom_count: int = 0        # real CUDA out-of-memory errors
    spill_write_failures: int = 0    # disk spills that failed (the host
                                     # copy was kept)
    spill_corruption_errors: int = 0  # spill files that failed their
                                      # reload checksum

    def merge(self, other: "TaskMetrics") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


_TLS = threading.local()


def get() -> TaskMetrics:
    m = getattr(_TLS, "metrics", None)
    if m is None:
        m = TaskMetrics()
        _TLS.metrics = m
    return m


def reset() -> TaskMetrics:
    """Start the current thread's metrics anew; return the previous ones."""
    prev = get()
    _TLS.metrics = TaskMetrics()
    return prev
