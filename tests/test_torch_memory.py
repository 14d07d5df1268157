"""The port's memory runtime on the CPU: the arena's budget, the spill
tiers (device -> host -> disk, checksummed), retry and split on OOM, OOM
injection, the device manager, the leak audit, task completion.

The cases of ``tests/test_memory.py`` that apply, against
``spark_rapids_tpu_torch.memory``; the capacity retry (:115, :129) is XLA
machinery the port does not have.  A real OOM is a raised
``torch.cuda.OutOfMemoryError`` (on the card the caching allocator raises
it).  The end-to-end case holds a grouped query against the JAX package's
CPU oracle, exact (integer sums and counts).
"""
import os

import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession
import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import Schema as JSchema

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.memory import (
    GpuRetryOOM, GpuSplitAndRetryOOM, SpillCorruptionError, device_arena,
    make_spillable, spill_framework, translate_device_oom, with_retry,
    with_retry_no_split)
from spark_rapids_tpu_torch.memory import arena as arena_mod
from spark_rapids_tpu_torch.memory import metrics as task_metrics
from spark_rapids_tpu_torch.memory import retry as retry_mod
from spark_rapids_tpu_torch.memory.spill import set_leak_audit
from spark_rapids_tpu_torch.memory.task_completion import (
    on_task_completion, task_scope)
from spark_rapids_tpu_torch.utils.checksum import (file_checksum,
                                                   frame_checksum,
                                                   verify_frame)

SCHEMA = Schema.of(a=T.LONG, b=T.DOUBLE, s=T.STRING)


def mk_batch(n=100):
    return ColumnarBatch.from_pydict(
        {"a": list(range(n)), "b": [i * 0.5 for i in range(n)],
         "s": [None if i % 7 == 0 else f"row{i}" for i in range(n)]},
        SCHEMA, "cpu")


def real_oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.00 GiB")


@pytest.fixture(autouse=True)
def _clean_arena():
    arena = device_arena()
    arena.budget_bytes = 0
    arena.used_bytes = 0
    arena.peak_bytes = 0
    yield
    spill_framework().close()
    arena.clear_injection()
    arena.budget_bytes = 0
    arena.used_bytes = 0


def test_spill_roundtrip_device_host_disk():
    b = mk_batch(64)
    expected = b.rows()
    h = make_spillable(b)
    assert h.on_device() and h.tier() == "device"
    used_before = device_arena().used_bytes
    assert used_before == h.size_bytes > 0
    freed = h.spill_to_host()
    assert freed == h.size_bytes and h.tier() == "host"
    assert device_arena().used_bytes == used_before - freed
    assert h.spill_to_disk() > 0 and h.tier() == "disk"
    assert h.materialize().rows() == expected
    h.unpin()
    h.close()
    assert device_arena().used_bytes == 0


def test_spill_of_a_string_view_keeps_its_rows():
    """A slice of a string column (offsets not starting at 0) is compacted
    when the handle is made, spills while its base batch lives on, and
    comes back with its rows."""
    from spark_rapids_tpu_torch.shuffle.transport import slice_batch
    b = mk_batch(50)
    view = slice_batch(b, 13, 20)
    h = make_spillable(view)
    assert h.size_bytes < sum(t.nbytes for c in b.columns
                              for t in (c.data, c.validity, c.offsets)
                              if t is not None)
    assert h.spill_to_host() == h.size_bytes
    h.spill_to_disk()
    with h.borrowed() as back:
        assert back.rows() == b.rows()[13:33]
        assert int(back.columns[2].offsets[0]) == 0
    h.close()


def test_a_handle_sharing_its_storage_does_not_spill():
    """A handle whose batch a reader took a view of, and kept, frees
    nothing by spilling: it stays on the device and the arena keeps its
    bytes; once the view is gone it spills."""
    from spark_rapids_tpu_torch.shuffle.transport import slice_batch
    h = make_spillable(mk_batch(50))
    with h.borrowed() as back:
        kept = slice_batch(back, 2, 5)
    used = device_arena().used_bytes
    assert h.spill_to_host() == 0 and h.tier() == "device"
    assert device_arena().used_bytes == used
    rows = kept.rows()
    del kept
    assert h.spill_to_host() == h.size_bytes and h.tier() == "host"
    assert device_arena().used_bytes == used - h.size_bytes
    with h.borrowed() as back:
        assert back.rows()[2:7] == rows
    h.close()
    assert device_arena().used_bytes == 0


def test_arena_pressure_triggers_spill():
    h1 = make_spillable(mk_batch(256))
    device_arena().budget_bytes = int(h1.size_bytes * 1.5)
    h2 = make_spillable(mk_batch(256))
    assert not h1.on_device() and h2.on_device()
    assert spill_framework().metrics.spill_to_host_bytes == h1.size_bytes
    h1.close()
    h2.close()


def test_host_limit_cascades_to_disk_with_checksum():
    fw = spill_framework()
    fw.host_limit_bytes = 1
    h = make_spillable(mk_batch(128))
    device_arena().budget_bytes = h.size_bytes
    h2 = make_spillable(mk_batch(128))    # spills h, then h to disk
    assert h.tier() == "disk" and fw.metrics.spill_to_disk_bytes > 0
    assert h._disk_crc == file_checksum(h._disk_path)
    h2.close()
    assert h.materialize().rows() == mk_batch(128).rows()
    assert fw.metrics.read_spill_bytes > 0
    h.close()


def test_corrupt_spill_file_raises():
    h = make_spillable(mk_batch(32))
    h.spill_to_host()
    h.spill_to_disk()
    with open(h._disk_path, "r+b") as f:
        f.seek(os.path.getsize(h._disk_path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(SpillCorruptionError):
        h.materialize()
    assert spill_framework().metrics.corruption_errors == 1
    assert device_arena().used_bytes == 0
    h.close()


def test_checksum_helpers():
    assert frame_checksum(b"") != 0
    assert verify_frame(b"abc", frame_checksum(b"abc"))
    assert not verify_frame(b"abd", frame_checksum(b"abc"))
    assert verify_frame(b"anything", 0)


def test_with_retry_no_split_retries_after_oom():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise GpuRetryOOM("synthetic")
        return 42

    assert with_retry_no_split(fn) == 42
    assert calls["n"] == 2


def test_with_retry_no_split_gives_up_after_max_attempts():
    def fn():
        raise GpuRetryOOM("always")

    with pytest.raises(GpuRetryOOM):
        with_retry_no_split(fn)


def test_with_retry_split_policy():
    def fn(item):
        if len(item) > 2:
            raise GpuSplitAndRetryOOM("too big")
        return sum(item)

    out = with_retry([[1, 2, 3, 4, 5, 6]], fn,
                     split_policy=lambda x: [x[:len(x) // 2],
                                             x[len(x) // 2:]])
    assert sum(out) == 21 and len(out) > 1


def test_with_retry_split_exhausted_raises():
    def fn(item):
        raise GpuSplitAndRetryOOM("always")

    with pytest.raises(GpuSplitAndRetryOOM):
        with_retry([[1]], fn, split_policy=lambda x: [x])


def test_injected_oom_is_retried_transparently():
    retry_mod.enable_oom_injection(num_ooms=1)
    h = make_spillable(mk_batch(32))

    def fn(handle):
        with handle.borrowed() as batch:
            return [r[0] for r in batch.rows()]

    before = task_metrics.get().retry_count
    (vals,) = with_retry([h], fn)
    assert vals == list(range(32))
    assert task_metrics.get().retry_count == before + 1
    h.close()


def test_injection_kind_split():
    retry_mod.enable_oom_injection(num_ooms=1, kind="split")
    out = with_retry([3], lambda item: item * 2,
                     split_policy=lambda x: [x, x])
    assert out == [6, 6]


def test_injection_fires_only_in_a_retry_scope():
    retry_mod.enable_oom_injection(num_ooms=1)
    device_arena().maybe_throw_injected()     # outside: nothing
    assert with_retry_no_split(lambda: 7) == 7


def test_pinned_handle_refuses_to_spill():
    h = make_spillable(mk_batch(64))
    with h.borrowed():
        assert h.spill_to_host() == 0 and h.on_device()
    assert h.spill_to_host() == h.size_bytes
    h.close()


def test_device_manager_probe_and_budget():
    from spark_rapids_tpu_torch.memory import device_manager as DM
    info = DM.probe_device()
    assert info.name == "cpu" and info.total_bytes is None
    real = DM.probe_device
    try:
        DM.probe_device = lambda device=None: DM.DeviceInfo(
            torch.device("cuda", 0), 16 << 30, 15 << 30, "fake")
        DM.initialize_device(RapidsConf(
            {"spark.rapids.memory.tpu.allocFraction": "0.5"}))
        assert device_arena().budget_bytes == 8 << 30
    finally:
        DM.probe_device = real


def test_is_device_oom_matches_cuda_oom():
    assert arena_mod.is_device_oom(real_oom())
    assert arena_mod.is_device_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 20.00 MiB"))
    assert not arena_mod.is_device_oom(RuntimeError("CUDA error: misaligned"))
    assert not arena_mod.is_device_oom(ValueError("out of memory"))


def test_real_oom_translates_to_retry_with_spill():
    h = make_spillable(mk_batch())
    calls = {"n": 0}
    before = arena_mod.GLOBAL_DEVICE_OOM_COUNT

    def fn(_):
        calls["n"] += 1
        if calls["n"] == 1:
            raise real_oom()
        return calls["n"]

    assert with_retry([None], fn) == [2]
    assert not h.on_device()         # the emergency spill took it
    assert arena_mod.GLOBAL_DEVICE_OOM_COUNT == before + 1
    h.close()


def test_real_oom_translates_in_no_split_path():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise real_oom()
        return "ok"

    assert with_retry_no_split(fn) == "ok" and calls["n"] == 2


def test_translate_device_oom_wrapper():
    @translate_device_oom
    def boom():
        raise real_oom()

    with pytest.raises(GpuRetryOOM):
        boom()

    @translate_device_oom
    def other():
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal"):
        other()


def test_non_oom_exceptions_propagate_unchanged():
    def fn(_):
        raise ValueError("regular bug")

    with pytest.raises(ValueError):
        with_retry([None], fn)
    with pytest.raises(ValueError):
        with_retry_no_split(lambda: fn(None))


def test_leak_audit_tracks_and_asserts():
    fw = spill_framework()
    set_leak_audit(True)
    try:
        h = make_spillable(mk_batch(2))
        assert "test_leak_audit_tracks_and_asserts" in h.creation_site
        assert h in fw.leaked_handles()
        with pytest.raises(AssertionError, match="leaked"):
            fw.assert_no_leaks("unit test")
        h.close()
        assert h not in fw.leaked_handles()
    finally:
        set_leak_audit(False)


def test_leak_audit_off_by_default_no_stack_capture():
    h = make_spillable(mk_batch(1))
    try:
        assert h.creation_site is None
    finally:
        h.close()


def test_task_completion_runs_newest_first_and_isolates_errors():
    order = []
    with pytest.raises(RuntimeError, match="1 task-completion"):
        with task_scope():
            on_task_completion(lambda: order.append(1))
            on_task_completion(lambda: 1 / 0)
            on_task_completion(lambda: order.append(3))
    assert order == [3, 1]
    assert not on_task_completion(lambda: None)


def test_session_applies_memory_conf():
    GpuSession({"spark.rapids.memory.host.spillStorageSize": "12345",
                "spark.rapids.memory.spill.checksum.enabled": "false",
                "spark.rapids.sql.retry.maxAttempts": "3"}, device="cpu")
    from spark_rapids_tpu_torch.memory import spill as spill_mod
    try:
        assert spill_framework().host_limit_bytes == 12345
        assert not spill_mod.spill_checksum_enabled()
        assert retry_mod.MAX_RETRIES == 3
    finally:
        GpuSession(device="cpu")
    assert retry_mod.MAX_RETRIES == 8 and spill_mod.spill_checksum_enabled()


def test_query_leaves_no_leaked_handles():
    """A shuffle and a grouped aggregate close every handle they made;
    the rows are the JAX package's CPU oracle's, exact."""
    fw = spill_framework()
    data = {"k": [i % 5 for i in range(200)], "v": list(range(200))}
    s = GpuSession({"spark.rapids.memory.debug.leakAudit": "true"},
                   device="cpu")
    try:
        df = s.create_dataframe(
            [ColumnarBatch.from_pydict(data, Schema.of(k=T.INT, v=T.LONG),
                                       "cpu")], num_partitions=2)
        rows = sorted(df.group_by("k").agg(PE.sum_("v").alias("s"),
                                           PE.count().alias("n")).collect())
        assert not fw.leaked_handles()
        assert device_arena().used_bytes == 0
    finally:
        set_leak_audit(False)
    oracle = TpuSession({"spark.rapids.sql.enabled": "false"})
    jdf = oracle.create_dataframe(data, JSchema.of(k=JT.INT, v=JT.LONG),
                                  num_partitions=2)
    want = sorted(jdf.group_by("k").agg(JE.sum_(JE.col("v")).alias("s"),
                                        JE.count().alias("n")).collect())
    assert rows == want and len(rows) == 5
