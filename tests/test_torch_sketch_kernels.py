"""The sketch slice's kernels' plain versions against the JAX package, on
the CPU, bit for bit: R1 (``kernels/partition.py`` ``round_robin_order``)
against ``round_robin_partition``, B1 / B2 (``kernels/bloom.py``
``bloom_put`` / ``bloom_probe``) against ``build_bits`` / ``might_contain``,
L1 (``kernels/hll.py`` ``hll_update``) against ``global_update`` /
``seg_update`` and L2 (``hll_merge``) against ``merge_rows``; the copied
host helpers against the reference's; and the gather and concat of a
wide fixed-width row.

Each JAX function runs under ``jax.jit`` at one padded capacity (CAP), so
that it compiles once per static argument; the rows past a case's count
are dead rows.  Inputs come from numpy seeds: LONG values over the whole
int64 range with its ends, 10% nulls.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import bloom as JB
from spark_rapids_tpu.kernels import hll as JH
from spark_rapids_tpu.kernels import partition as JP

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels import bloom as BK
from spark_rapids_tpu_torch.kernels import hll as HL
from spark_rapids_tpu_torch.kernels import partition as PK
from spark_rapids_tpu_torch.kernels import selection as S

CAP = 1024
ROWS = (0, 5, 1000)
NUM_BITS = BK.optimal_num_bits(300, 0.03)       # 2,240 bits, k = 5
K = BK.optimal_num_hashes(300, NUM_BITS)
P = 9                                            # rsd 0.05


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _longs(n: int, seed: int):
    """(values, validity): int64 over the whole range, its ends and -1,
    10% nulls (a null slot holds zero)."""
    rng = np.random.RandomState(seed)
    v = rng.randint(-2**63, 2**63 - 1, n, dtype=np.int64)
    v[:min(n, 4)] = [-2**63, 2**63 - 1, -1, 0][:n]
    ok = rng.rand(n) >= 0.1
    return np.where(ok, v, 0), ok


def _table(n: int, seed: int) -> pa.Table:
    v, ok = _longs(n, seed)
    return pa.table({"l": pa.array(v, pa.int64(), mask=~ok),
                     "k": pa.array(np.arange(n, dtype=np.int32))})


def _jax_col(table: pa.Table):
    return JaxBatch.from_arrow(table, capacity=CAP)


def _port_col(table: pa.Table) -> DeviceColumn:
    return arrow_to_batch(table, "cpu").columns[0]


def test_host_helpers_match_reference():
    for items in (1, 100, 1000, 1_000_000):
        for fpp in (0.01, 0.03, 0.2):
            nb = BK.optimal_num_bits(items, fpp)
            assert nb == JB.optimal_num_bits(items, fpp)
            assert BK.optimal_num_hashes(items, nb) == \
                JB.optimal_num_hashes(items, nb)
    assert BK.optimal_num_bits(1_000_000, 0.03) == 7_298_496
    assert BK.optimal_num_hashes(1_000_000, 7_298_496) == 5
    for rsd in (0.3, 0.05, 0.01, 0.001):
        assert HL.p_from_rsd(rsd) == JH.p_from_rsd(rsd)
    for v in (0, -1, 2**63 - 1, -2**63, 12345):
        assert BK.py_bit_positions(v, NUM_BITS, K) == \
            JB.py_bit_positions(v, NUM_BITS, K)
    rng = np.random.RandomState(4)
    for m in (16, 32, 64, 512):
        regs = rng.randint(0, 12, m).astype(np.int8)
        regs[rng.rand(m) < 0.3] = 0
        assert HL.estimate_np(regs) == JH.estimate_np(regs)
    v, ok = _longs(300, 6)
    assert np.array_equal(HL.update_np(v, ok, P), JH.update_np(v, ok, P))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("n", (1, 2, 7, 64))
@pytest.mark.parametrize("start", (0, 3))
def test_round_robin_matches_reference(rows, n, start):
    table = _table(rows, seed=rows + n)
    out, counts = _jit(JP.round_robin_partition, num_partitions=n)(
        _jax_col(table), start_partition=start)
    want = np.asarray(out.columns[1].data)[:rows]
    batch = arrow_to_batch(table, "cpu")
    got, got_counts = PK.round_robin_partition(batch, n, start)
    assert got_counts == np.asarray(counts).tolist()
    assert np.array_equal(got.columns[1].data.numpy(), want)
    assert np.array_equal(got.columns[0].data.numpy(),
                          np.asarray(out.columns[0].data)[:rows])
    assert np.array_equal(PK.round_robin_order(rows, n, start, "cpu").numpy(),
                          want)


def test_round_robin_reference_case():
    """tests/test_kernels.py:306: 5 rows into 2 partitions."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
    batch = ColumnarBatch.from_pydict({"k": [0, 1, 2, 3, 4]},
                                      Schema.of(k=T.INT), "cpu")
    out, counts = PK.round_robin_partition(batch, 2)
    assert counts == [3, 2]
    assert out.columns[0].to_pylist() == [0, 2, 4, 1, 3]
    # the start rotates: 3 batches of 10 rows into 4 partitions
    total = [0] * 4
    for ordinal in range(3):
        for p, c in enumerate(PK.round_robin_counts(10, 4, ordinal % 4)):
            total[p] += c
    assert total == [7, 8, 8, 7]


@pytest.mark.parametrize("rows", ROWS)
def test_bloom_matches_reference(rows):
    table = _table(rows, seed=rows + 11)
    jcol = _jax_col(table).columns[0]
    bits = _jit(JB.build_bits, num_bits=NUM_BITS, k=K)(jcol, rows)
    # a second batch ORs into the same filter
    other = _table(37, seed=rows + 12)
    bits = _jit(JB.build_bits, num_bits=NUM_BITS, k=K)(
        _jax_col(other).columns[0], 37, bits=bits)
    words = torch.zeros(NUM_BITS // 64, dtype=torch.int64)
    BK.bloom_put(words, _port_col(table), K)
    BK.bloom_put(words, _port_col(other), K)
    want = np.asarray(bits)
    assert np.array_equal(BK.words_to_bits(words.numpy()), want)
    assert BK.serialize(want, K) == JB.serialize(want, K)
    probe = _table(CAP, seed=rows + 13).slice(0, max(rows, 1))
    pcol = _port_col(probe)
    hit = _jit(JB.might_contain, k=K)(bits, _jax_col(probe).columns[0])
    valid = np.asarray(_jax_col(probe).columns[0].validity)[:probe.num_rows]
    want_hit = np.asarray(hit)[:probe.num_rows] & valid
    assert np.array_equal(BK.bloom_probe(words, pcol, K).numpy(), want_hit)
    # every value put is found
    got = BK.bloom_probe(words, _port_col(table), K).numpy()
    assert np.array_equal(got, table.column("l").is_valid().to_numpy(
        zero_copy_only=False))


def test_bloom_wire_round_trip_and_words():
    bits = np.random.RandomState(3).rand(NUM_BITS) < 0.4
    blob = BK.serialize(bits, K)
    back, k = BK.deserialize(blob)
    assert k == K and np.array_equal(back, bits)
    assert JB.deserialize(blob)[1] == K
    assert np.array_equal(JB.deserialize(blob)[0], bits)
    f = BK.PyBloomFilter(NUM_BITS, K, bits)
    assert np.array_equal(BK.words_to_bits(f.words()), bits)
    assert BK.PyBloomFilter.from_bytes(f.serialize()).k == K


@pytest.mark.parametrize("rows", ROWS)
def test_hll_global_matches_reference(rows):
    table = _table(rows, seed=rows + 21)
    jb = _jax_col(table)
    want = np.asarray(_jit(JH.global_update, p=P)(jb.columns[0],
                                                   jb.live_mask()))
    got = HL.hll_update(_port_col(table), P)
    assert got.shape == (1, 1 << P) and got.dtype == torch.int8
    assert np.array_equal(got[0].numpy(), want)


def _segments(rows: int, seed: int) -> np.ndarray:
    """Sorted segment starts from 0: one-row segments, a long one, and
    random cuts."""
    rng = np.random.RandomState(seed)
    cuts = {0, 1, 2, 3} | set(rng.randint(0, rows, rows // 20).tolist())
    return np.array(sorted(c for c in cuts if c < rows), np.int32)


def _jax_seg_update(col, batch, segment_ids, p):
    layout = types.SimpleNamespace(sorted_batch=batch,
                                   segment_ids=segment_ids)
    return JH.seg_update(col, layout, p)


@pytest.mark.parametrize("rows", (5, 1000))
def test_hll_grouped_matches_reference(rows):
    table = _table(rows, seed=rows + 31)
    starts = _segments(rows, rows)
    seg = np.zeros(CAP, np.int32)
    seg[starts[1:]] = 1
    seg = np.cumsum(seg).astype(np.int32)
    seg[rows:] = len(starts)         # dead rows: a segment of their own
    jb = _jax_col(table)
    want = np.asarray(_jit(_jax_seg_update, p=P)(
        jb.columns[0], jb, jnp.asarray(seg)))[:len(starts)]
    got = HL.hll_update(_port_col(table), P, torch.from_numpy(starts))
    assert got.shape == (len(starts), 1 << P)
    assert np.array_equal(got.numpy(), want)


def _jax_merge(regs, valid, seg, cap, m):
    keep = jnp.where(valid[:, None], regs, jnp.int8(0))
    return JH.merge_rows(keep, seg, cap, m)


@pytest.mark.parametrize("rows", (1, 5, 1000))
@pytest.mark.parametrize("grouped", (False, True))
def test_hll_merge_matches_reference(rows, grouped):
    rng = np.random.RandomState(rows)
    m = 1 << P
    regs = rng.randint(0, 40, (CAP, m)).astype(np.int8)
    regs[rng.rand(CAP, m) < 0.5] = 0
    valid = rng.rand(CAP) >= 0.1
    valid[rows:] = False
    starts = _segments(rows, rows + 1) if grouped else np.zeros(1, np.int32)
    seg = np.zeros(CAP, np.int32)
    seg[starts[1:]] = 1
    seg = np.cumsum(seg).astype(np.int32)
    if grouped:
        want = np.asarray(_jit(_jax_merge, cap=CAP, m=m)(
            jnp.asarray(regs), jnp.asarray(valid), jnp.asarray(seg)))
        want = want[:len(starts)]
    else:
        want = np.asarray(_jit(_jax_merge, cap=CAP, m=m)(
            jnp.asarray(regs), jnp.asarray(valid), None))
    got = HL.hll_merge(torch.from_numpy(regs[:rows]),
                       torch.from_numpy(valid[:rows]),
                       torch.from_numpy(starts))
    assert np.array_equal(got.numpy(), want)


def test_hll_merge_of_no_rows_is_empty_registers():
    got = HL.hll_merge(torch.zeros((0, 512), dtype=torch.int8),
                       torch.zeros(0, dtype=torch.bool),
                       torch.zeros(1, dtype=torch.int32))
    assert got.shape == (1, 512) and not bool(got.any())


def test_clz64_is_exact_at_every_width():
    """A float64 conversion would round 2^k - 1 up; the search does not."""
    x = []
    for k in range(65):
        for v in ((1 << k) - 1, 1 << k if k < 64 else 0):
            x.append(v - (1 << 64) if v >= 1 << 63 else v)
    got = HL.clz64(torch.tensor(x, dtype=torch.int64)).tolist()
    want = [64 - (v & (2**64 - 1)).bit_length() for v in x]
    assert got == want


def test_estimate_sum_is_exact_in_any_order():
    """sum(2^-r) over 512 registers with every r <= 43 is exact in
    float64, so its order (the card's tree, numpy's pairwise) cannot
    change the estimate."""
    rng = np.random.RandomState(8)
    regs = rng.randint(0, 44, 512)
    terms = np.power(2.0, -regs.astype(np.float64))
    exact = sum(int(2 ** (43 - r)) for r in regs)       # in units of 2^-43
    for _ in range(5):
        rng.shuffle(terms)
        acc = 0.0
        for t in terms:
            acc += t
        assert acc * 2.0 ** 43 == exact
        assert terms.sum() * 2.0 ** 43 == exact


WIDE = T.ArrayType(T.ByteType(), contains_null=False, length=512)


def _wide_column(n: int, seed: int) -> DeviceColumn:
    rng = np.random.RandomState(seed)
    regs = rng.randint(-128, 128, (n, 512)).astype(np.int8)
    valid = rng.rand(n) >= 0.1
    return DeviceColumn.from_numpy(regs, WIDE, valid)


def test_gather_and_concat_carry_a_wide_row():
    """An [n, 512] int8 row moves whole through the plain gather and
    concat (the kernels move it as 16-byte chunks)."""
    c = _wide_column(300, 1)
    idx = torch.tensor([5, -1, 299, 300, 0, 5], dtype=torch.int32)
    g = S.gather_columns([c], idx)[0]
    want = c.data.numpy()[[5, 0, 299, 0, 0, 5]]
    ok = np.array([c.validity[5], False, c.validity[299], False,
                   c.validity[0], c.validity[5]])
    assert g.data.shape == (6, 512) and g.dtype == WIDE
    assert np.array_equal(g.validity.numpy(), ok)
    assert np.array_equal(g.data.numpy(), np.where(ok[:, None], want, 0))
    pieces = [c.slice_rows(0, 100), _wide_column(0, 2), c.slice_rows(250, 300)]
    cat = S.concat_column(pieces)
    assert cat.data.shape == (150, 512)
    assert np.array_equal(cat.data.numpy(), np.concatenate(
        [np.where(p.validity.numpy()[:, None], p.data.numpy(), 0)
         for p in pieces]))


@pytest.mark.parametrize("width", (3, 12, 24, 40))
def test_gather_and_concat_refuse_other_widths(width):
    """A row the kernels would not move raises; it is never cut to one
    byte."""
    data = torch.zeros((4, width), dtype=torch.int8)
    c = DeviceColumn(data, torch.ones(4, dtype=torch.bool),
                     T.ArrayType(T.ByteType(), contains_null=False,
                                 length=width))
    with pytest.raises(ValueError, match="a row of"):
        S.gather_columns([c], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="a row of"):
        S.concat_column([c, c])


def test_sketch_wrappers_launch_nothing_on_the_cpu():
    before = dict(_lib.LAUNCHES)
    v, ok = _longs(64, 9)
    col = DeviceColumn.from_numpy(v, T.LONG, ok)
    words = torch.zeros(NUM_BITS // 64, dtype=torch.int64)
    BK.bloom_put(words, col, K)
    BK.bloom_probe(words, col, K)
    regs = HL.hll_update(col, P)
    HL.hll_merge(regs, torch.ones(1, dtype=torch.bool),
                 torch.zeros(1, dtype=torch.int32))
    PK.round_robin_order(64, 7, 2, "cpu")
    assert dict(_lib.LAUNCHES) == before


class _FakeSketchLib:
    """Stands in for the built library: records which HLL entry point a
    wrapper called."""

    def __init__(self):
        self.calls = []

    def srt_hll_max_registers(self):
        return 1 << 13

    def srt_hll_global(self, *args):
        self.calls.append("global")
        return 0

    def srt_hll_grouped(self, *args):
        self.calls.append("grouped")
        return 0


@pytest.mark.parametrize("starts, entry", [
    (None, "global"), ([0], "global"), ([0, 3], "grouped")])
def test_one_sketch_takes_the_global_kernel(monkeypatch, starts, entry):
    """One sketch of every row (no starts, or one segment) goes to the
    global kernel, which spreads the rows over the whole grid; only
    several segments take the grouped kernel's block a segment."""
    fake = _FakeSketchLib()
    monkeypatch.setattr(_lib, "lib", lambda: fake)
    monkeypatch.setattr(_lib, "stream", lambda dev: None)
    monkeypatch.setattr(_lib, "LAUNCHES", type(_lib.LAUNCHES)())
    v, ok = _longs(8, 12)
    s = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    out = HL._hll_update_cuda(torch.from_numpy(v), torch.from_numpy(ok), P,
                              s)
    assert fake.calls == [entry]
    assert out.shape == (1 if starts is None else len(starts), 1 << P)
    assert _lib.LAUNCHES[HL.HLL_UPDATE] == 1


def test_spill_round_trip_of_a_wide_row():
    """A batch holding an [n, 512] register plane and a LONG column goes
    device -> host -> disk and back whole, a slice of it too
    (tests/test_torch_memory.py's round trip)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
    from spark_rapids_tpu_torch.memory import (device_arena, make_spillable,
                                               spill_framework)
    from spark_rapids_tpu_torch.shuffle.transport import slice_batch
    def batch():
        v, ok = _longs(200, 10)
        return ColumnarBatch(
            (_wide_column(200, 3), DeviceColumn.from_numpy(v, T.LONG, ok)),
            200, Schema(("r", "l"), (WIDE, T.LONG)))
    arena = device_arena()
    used = arena.used_bytes
    whole = batch()
    try:
        # the whole batch (no other reference to its tensors), then a view
        for b, want in ((batch(), whole), (slice_batch(whole, 17, 50),
                                           slice_batch(whole, 17, 50))):
            h = make_spillable(b)
            del b
            assert h.spill_to_host() == h.size_bytes and h.tier() == "host"
            assert h.spill_to_disk() > 0 and h.tier() == "disk"
            with h.borrowed() as back:
                for got, w in zip(back.columns, want.columns, strict=True):
                    assert got.dtype == w.dtype
                    assert torch.equal(got.data, w.data)
                    assert torch.equal(got.validity, w.validity)
            h.close()
    finally:
        spill_framework().close()
        arena.used_bytes = used
