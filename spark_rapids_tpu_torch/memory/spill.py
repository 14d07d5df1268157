"""Spill framework: handles over batches that live on the device, in
pinned host memory or on disk.

Counterpart of ``spark_rapids_tpu/memory/spill.py``
(``SpillableBatchHandle`` :133, ``SpillFramework`` :396, ``make_spillable``
:525, the leak audit :535-584).

* An exec that holds a batch across other work wraps it in a
  ``SpillableBatchHandle`` and drops its own reference.  The handle owns
  the data: a column that holds a view (a slice of a larger batch) is
  copied into tensors of its own when the handle is made, a string
  column's bytes cut to its rows' (a view of a shuffle block need not
  start at byte 0), so that dropping the handle's tensors frees exactly
  its ``size_bytes``.  ``materialize`` brings it back to the device (from
  host or disk where it was spilled) and pins it until ``unpin``;
  ``close`` releases every tier.
* ``spill_to_host`` copies a handle's tensors into pinned host memory
  (``pin_memory=True``) and drops the device copy.  The copy is
  asynchronous, so the stream is synchronized before the device tensors
  are let go and before the host bytes are read: the caching allocator
  would otherwise hand their blocks to a later kernel while the copy
  still reads them, or a disk write would read bytes not yet arrived.
* ``spill_to_disk`` writes the host copy as ``.npz`` into the framework's
  spill directory, with the checksum of ``utils/checksum.py`` over the
  file when ``spark.rapids.memory.spill.checksum.enabled``; a reload
  verifies it and raises ``SpillCorruptionError`` on a mismatch.  A
  failed write keeps the host copy.
* The framework spills device handles in (priority, least recently used)
  order when the arena asks, and moves host copies to disk while the
  host tier holds more than ``spark.rapids.memory.host.spillStorageSize``.

A pinned handle (one a caller holds materialized) refuses to spill: the
caller's tensors would keep the device memory alive anyway.  So does a
handle whose storage a tensor outside it still shares (a view that a
reader of the shuffle store kept): spilling it would free nothing, and
the arena, which releases a handle's bytes when it spills, would count
memory that is still held.  The
reference's tenant paths (``spill_tenant`` :455) and chaos hooks are not
ported.  On the CPU the "device" tier is host memory, and the host copy
is a plain clone.
"""
from __future__ import annotations

import io
import logging
import os
import shutil
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.memory import metrics as task_metrics
from spark_rapids_tpu_torch.memory.arena import device_arena
from spark_rapids_tpu_torch.utils.checksum import file_checksum, verify_frame

log = logging.getLogger(__name__)


class SpillCorruptionError(IOError):
    """A spill file no longer matches the checksum taken when it was
    written: the batch cannot be reloaded."""


#: verify spill files against their checksum on reload
#: (spark.rapids.memory.spill.checksum.enabled)
_SPILL_CHECKSUM = [True]


def set_spill_checksum(enabled: bool) -> None:
    _SPILL_CHECKSUM[0] = bool(enabled)


def spill_checksum_enabled() -> bool:
    return _SPILL_CHECKSUM[0]


HostColumn = Dict[str, torch.Tensor]


def batch_device_bytes(batch: ColumnarBatch) -> int:
    """Bytes of the batch's tensors."""
    return sum(t.numel() * t.element_size() for t in _batch_tensors(batch))


def owned(batch: ColumnarBatch) -> ColumnarBatch:
    """The batch with each column that holds a view copied into tensors of
    its own, a string column's bytes cut to its rows'.  A column of a
    string view shares its byte buffer with its base (the same tensor), so
    its offsets being a view is what marks it."""
    def is_view(c: DeviceColumn) -> bool:
        return any(t._base is not None for t in (c.data, c.validity,
                                                  c.offsets)
                   if t is not None)
    views = [is_view(c) for c in batch.columns]
    if not any(views):
        return batch
    strings = [c for c, v in zip(batch.columns, views) if v and c.is_string]
    # one device->host read: each string view's byte range
    bounds = (torch.stack([t for c in strings for t in
                           (c.offsets[0], c.offsets[-1])]).tolist()
              if strings else [])
    cols, si = [], 0
    for c, v in zip(batch.columns, views):
        if not v:
            cols.append(c)
        elif c.is_string:
            lo, hi = bounds[2 * si], bounds[2 * si + 1]
            si += 1
            cols.append(DeviceColumn(c.data[lo:hi].clone(),
                                     c.validity.clone(), c.dtype,
                                     c.offsets - lo))
        else:
            cols.append(DeviceColumn(
                c.data.clone(memory_format=torch.contiguous_format),
                c.validity.clone(), c.dtype))
    return ColumnarBatch(tuple(cols), batch.num_rows, batch.schema)


def _batch_tensors(batch: ColumnarBatch) -> List[torch.Tensor]:
    return [t for c in batch.columns for t in (c.data, c.validity, c.offsets)
            if t is not None]


def _storage_shared(batch: ColumnarBatch) -> bool:
    """True when a tensor outside the batch (which holds no views) still
    references the storage of one of its tensors, so that dropping the
    batch would free nothing there.  A storage's use count is the tensors
    over it, plus the wrapper that asks."""
    own: Dict[int, set] = {}
    uses: Dict[int, int] = {}
    for t in _batch_tensors(batch):
        st = t.untyped_storage()
        if st.nbytes() == 0:
            continue
        key = st.data_ptr()
        own.setdefault(key, set()).add(id(t))
        uses[key] = torch._C._storage_Use_Count(st._cdata) - 1
        del st
    return any(uses[k] > len(ids) for k, ids in own.items())


def _to_host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    if not pin:
        return t.clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def _batch_to_host(batch: ColumnarBatch) -> List[HostColumn]:
    """Owning host copies of the batch's tensors (pinned from the card);
    the stream is synchronized before returning."""
    dev = batch.device
    pin = dev.type == "cuda"
    out: List[HostColumn] = []
    for c in batch.columns:
        host = {"data": _to_host(c.data, pin),
                "valid": _to_host(c.validity, pin)}
        if c.is_string:
            host["offsets"] = _to_host(c.offsets, pin)
        out.append(host)
    if pin:
        torch.cuda.current_stream(dev).synchronize()
    return out


def _host_to_batch(host: List[HostColumn], schema: Schema, num_rows: int,
                   device: torch.device) -> ColumnarBatch:
    def up(t: torch.Tensor) -> torch.Tensor:
        return t if device.type == "cpu" else t.to(device, non_blocking=True)
    cols = tuple(DeviceColumn(up(h["data"]), up(h["valid"]), dt,
                              up(h["offsets"]) if "offsets" in h else None)
                 for h, dt in zip(host, schema.dtypes))
    return ColumnarBatch(cols, num_rows, schema)


def _host_bytes(host: List[HostColumn]) -> int:
    return sum(t.numel() * t.element_size() for h in host for t in h.values())


class SpillableBatchHandle:
    """Owning handle over a batch on the device, in host memory or on
    disk (SpillableColumnarBatch upstream)."""

    def __init__(self, batch: ColumnarBatch, framework: "SpillFramework",
                 priority: int = 0):
        batch = owned(batch)
        self._fw = framework
        self._lock = threading.RLock()
        self._device: Optional[ColumnarBatch] = batch
        self._host: Optional[List[HostColumn]] = None
        self._disk_path: Optional[str] = None
        self._disk_crc = 0              # 0: the file was not checksummed
        self._disk_nbytes = 0
        self._schema = batch.schema
        self._num_rows = batch.num_rows
        self._home = batch.device
        self.priority = priority
        self.last_use = time.monotonic()
        self.size_bytes = batch_device_bytes(batch)
        self.closed = False
        self._pins = 0
        self.creation_site: Optional[str] = None
        if _LEAK_AUDIT[0]:
            import traceback
            self.creation_site = "".join(traceback.format_stack(limit=14))
        device_arena().reserve(self.size_bytes)
        framework._register(self)

    # -- tier movement -------------------------------------------------------

    def spill_to_host(self) -> int:
        """Device -> pinned host.  Returns the device bytes freed (0 when
        the handle is not on the device, is pinned, or shares its storage
        with a tensor outside it)."""
        with self._lock:
            if self._device is None or self.closed or self._pins > 0 \
                    or _storage_shared(self._device):
                return 0
            self._host = _batch_to_host(self._device)
            self._device = None
            device_arena().release(self.size_bytes)
            self._fw.metrics.spill_to_host_bytes += self.size_bytes
            self._fw.metrics.spill_to_host_count += 1
            return self.size_bytes

    def spill_to_disk(self) -> int:
        """Host -> disk.  Returns the host bytes freed (0 when the handle
        is not on the host, or the write failed: the host copy is kept)."""
        with self._lock:
            if self._host is None or self.closed:
                return 0
            arrays = {f"c{i}_{k}": t.numpy() for i, h in enumerate(self._host)
                      for k, t in h.items()}
            path = None
            try:
                fd, path = tempfile.mkstemp(suffix=".npz",
                                            dir=self._fw.spill_dir)
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **arrays)
                crc = file_checksum(path) if spill_checksum_enabled() else 0
            except OSError as e:
                if path is not None:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                self._fw.metrics.write_failures += 1
                task_metrics.get().spill_write_failures += 1
                log.warning("spill to disk failed (the host copy is kept): "
                            "%s", e)
                return 0
            freed = _host_bytes(self._host)
            self._disk_path, self._disk_crc = path, crc
            self._disk_nbytes = freed
            self._host = None
            self._fw.metrics.spill_to_disk_bytes += freed
            self._fw.metrics.spill_to_disk_count += 1
            return freed

    def _read_disk(self) -> None:
        """Disk -> host, verifying the checksum (under the handle's lock)."""
        with open(self._disk_path, "rb") as f:
            data = f.read()
        if not verify_frame(data, self._disk_crc):
            self._fw.metrics.corruption_errors += 1
            task_metrics.get().spill_corruption_errors += 1
            raise SpillCorruptionError(
                f"spill file {self._disk_path} failed its checksum "
                f"({len(data)} bytes, expected {self._disk_crc:#010x}): "
                "refusing to reload corrupt data")
        host: List[HostColumn] = [{} for _ in self._schema.dtypes]
        with np.load(io.BytesIO(data)) as z:
            for name in z.files:
                ci, key = name[1:].split("_", 1)
                host[int(ci)][key] = torch.from_numpy(z[name].copy())
        os.unlink(self._disk_path)
        self._disk_path, self._disk_crc, self._disk_nbytes = None, 0, 0
        self._host = host
        self._fw.metrics.read_spill_bytes += _host_bytes(host)

    def materialize(self) -> ColumnarBatch:
        """The batch on the device, pinned until ``unpin``; the handle keeps
        ownership.  The arena reservation is taken before the handle's lock
        (it may spill other handles)."""
        with self._lock:
            if self.closed:
                raise AssertionError("materialize after close")
            self.last_use = time.monotonic()
            if self._device is not None:
                self._pins += 1
                return self._device
        device_arena().reserve(self.size_bytes)   # may spill / raise
        try:
            with self._lock:
                if self.closed:
                    raise AssertionError("handle closed during materialize")
                if self._device is None:
                    if self._host is None:
                        self._read_disk()
                    self._fw.metrics.unspill_host_bytes += _host_bytes(
                        self._host)
                    self._device = _host_to_batch(
                        self._host, self._schema, self._num_rows, self._home)
                    self._host = None
                    reserved = True
                else:           # a concurrent materialize won
                    reserved = False
                self._pins += 1
                self.last_use = time.monotonic()
                batch = self._device
        except BaseException:
            device_arena().release(self.size_bytes)
            raise
        if not reserved:
            device_arena().release(self.size_bytes)
        return batch

    def unpin(self) -> None:
        """The batch materialize() returned is no longer in use: the
        handle may spill again."""
        with self._lock:
            if self._pins > 0:
                self._pins -= 1

    @contextmanager
    def borrowed(self):
        """``with h.borrowed() as batch:`` pinned for the block only."""
        batch = self.materialize()
        try:
            yield batch
        finally:
            self.unpin()

    def release_device_copy(self) -> ColumnarBatch:
        """Materialize, then hand the batch out and close the handle."""
        batch = self.materialize()
        with self._lock:
            self._device = None
            self._pins = 0
            self.closed = True
        self._fw._unregister(self)
        device_arena().release(self.size_bytes)
        return batch

    def on_device(self) -> bool:
        with self._lock:
            return self._device is not None

    def tier(self) -> str:
        """'device', 'host', 'disk' or 'closed'."""
        with self._lock:
            if self.closed:
                return "closed"
            if self._device is not None:
                return "device"
            return "host" if self._host is not None else "disk"

    def host_nbytes(self) -> int:
        with self._lock:
            return _host_bytes(self._host) if self._host is not None else 0

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            if self._device is not None:
                device_arena().release(self.size_bytes)
                self._device = None
            self._host = None
            if self._disk_path is not None:
                try:
                    os.unlink(self._disk_path)
                except OSError:
                    pass
                self._disk_path = None
        self._fw._unregister(self)


class SpillMetrics:
    def __init__(self):
        self.spill_to_host_bytes = 0
        self.spill_to_host_count = 0
        self.spill_to_disk_bytes = 0
        self.spill_to_disk_count = 0
        self.read_spill_bytes = 0       # read back from disk
        self.unspill_host_bytes = 0     # copied back to the device
        self.write_failures = 0
        self.corruption_errors = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(vars(self))


class SpillFramework:
    """Registry of spillable handles, and the arena's pressure callback."""

    def __init__(self, spill_dir: Optional[str] = None,
                 host_limit_bytes: int = 0):
        self._lock = threading.RLock()
        self._handles: List[SpillableBatchHandle] = []
        self._owns_spill_dir = spill_dir is None
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="gpu_spill_")
        self.host_limit_bytes = host_limit_bytes
        self.metrics = SpillMetrics()
        # a framework made directly must not take the pressure callback
        # from the global one, whose handles it does not manage
        if device_arena()._spill_cb is None:
            device_arena().set_spill_callback(self.spill_device)

    def _register(self, h: SpillableBatchHandle) -> None:
        with self._lock:
            self._handles.append(h)

    def _unregister(self, h: SpillableBatchHandle) -> None:
        with self._lock:
            if h in self._handles:
                self._handles.remove(h)

    def _snapshot(self) -> List[SpillableBatchHandle]:
        """The handles, copied under the framework lock: a handle's lock is
        never taken inside it."""
        with self._lock:
            return list(self._handles)

    def spill_device(self, need_bytes: int) -> int:
        """Spill device handles, by (priority, least recently used), until
        need_bytes are freed or none is left; then keep the host tier
        within its limit."""
        freed = 0
        for h in sorted((h for h in self._snapshot() if h.on_device()),
                        key=lambda h: (h.priority, h.last_use)):
            if freed >= need_bytes:
                break
            freed += h.spill_to_host()
        if self.host_limit_bytes:
            self._enforce_host_limit()
        return freed

    def _enforce_host_limit(self) -> None:
        hosted = sorted(((h, h.host_nbytes()) for h in self._snapshot()),
                        key=lambda hs: (hs[0].priority, hs[0].last_use))
        total = sum(nb for _, nb in hosted)
        for h, nb in hosted:
            if total <= self.host_limit_bytes:
                break
            if nb:
                total -= h.spill_to_disk()

    def leaked_handles(self) -> List[SpillableBatchHandle]:
        """Handles never closed (the leak audit)."""
        return [h for h in self._snapshot() if not h.closed]

    def assert_no_leaks(self, context: str = "") -> None:
        leaks = self.leaked_handles()
        if not leaks:
            return
        lines = [f"{len(leaks)} spillable handle(s) leaked"
                 + (f" after {context}" if context else "") + ":"]
        for h in leaks[:10]:
            lines.append(f"  - {h.size_bytes} bytes, pins={h._pins}")
            if h.creation_site:
                lines.append(h.creation_site)
        raise AssertionError("\n".join(lines))

    def close(self) -> None:
        global _FRAMEWORK
        for h in self._snapshot():
            h.close()
        if device_arena()._spill_cb == self.spill_device:
            device_arena().set_spill_callback(None)
        if self._owns_spill_dir:
            shutil.rmtree(self.spill_dir, ignore_errors=True)
        if _FRAMEWORK is self:
            _FRAMEWORK = None


_FRAMEWORK: Optional[SpillFramework] = None


def spill_framework() -> SpillFramework:
    global _FRAMEWORK
    if _FRAMEWORK is None:
        _FRAMEWORK = SpillFramework()
    # re-arm the pressure callback if a framework made directly took it
    # and was closed
    if device_arena()._spill_cb is None:
        device_arena().set_spill_callback(_FRAMEWORK.spill_device)
    return _FRAMEWORK


def make_spillable(batch: ColumnarBatch,
                   priority: int = 0) -> SpillableBatchHandle:
    return SpillableBatchHandle(batch, spill_framework(), priority=priority)


# -- leak audit (spark.rapids.memory.debug.leakAudit) -----------------------

_LEAK_AUDIT = [False]


def set_leak_audit(enabled: bool) -> None:
    """Record the creation stack of new handles, for ``assert_no_leaks``."""
    _LEAK_AUDIT[0] = bool(enabled)

