"""Memory runtime: the arena's accounting, spill, and retry on OOM.

Counterpart of ``spark_rapids_tpu/memory/__init__.py`` (``initialize_memory``
:34).  The port's engine runs one task at a time on the calling thread
(``plan/engine.py``), so the reference's device semaphore and tenants
(``semaphore.py``, ``tenant.py``) are not ported yet (ROADMAP queue 1 item
9).
"""
from spark_rapids_tpu_torch.memory.arena import (  # noqa: F401
    DeviceArena, GpuOOM, GpuRetryOOM, GpuSplitAndRetryOOM, device_arena,
    is_device_oom, translate_device_oom)
from spark_rapids_tpu_torch.memory.retry import (  # noqa: F401
    disable_oom_injection, enable_oom_injection, with_retry,
    with_retry_no_split)
from spark_rapids_tpu_torch.memory.spill import (  # noqa: F401
    SpillableBatchHandle, SpillCorruptionError, SpillFramework,
    make_spillable, spill_framework)


def initialize_memory(conf, device=None) -> None:
    """Apply a conf snapshot to the memory runtime: retry attempts, the
    host spill limit, spill checksums, the leak audit and the arena's
    budget (the executor plugin's memory init upstream)."""
    from spark_rapids_tpu_torch.memory import retry as _retry
    from spark_rapids_tpu_torch.memory.device_manager import \
        initialize_device
    from spark_rapids_tpu_torch.memory.spill import (set_leak_audit,
                                                     set_spill_checksum)
    _retry.MAX_RETRIES = conf.retry_max_attempts
    spill_framework().host_limit_bytes = conf.host_spill_storage_size
    set_spill_checksum(conf.spill_checksum_enabled)
    set_leak_audit(conf.memory_leak_audit)
    initialize_device(conf, device)
