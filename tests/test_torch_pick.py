"""The picks and bitwise reductions of the port on the CPU, against the
JAX package.

Kernel level: each plain version the port's wrappers run on CPU tensors
(``segmented_pick``, ``masked_pick``, ``segmented_bitwise``,
``masked_bitwise``), through the port's ``kernels/groupby.py``, is held
against the JAX function it ports (``seg_pick``, ``seg_pick_by``,
``seg_extreme_string``, ``seg_bitwise``, ``global_pick``,
``global_pick_by``, ``global_extreme_string``, ``global_bitwise``) on the
same seeded table grouped by both packages' ``group_rows``: values and
validity exactly (floats bit for bit).  The tables hold 10% nulls, an
all-null group, ties (half the values from seven), NaN, infinities and
both zeros among the floats, and strings of 0-70 bytes with bytes >= 0x80,
shared prefixes and binaryCompare's edges ("ab" beside "ab\\0", "" beside
"a"); an empty batch too.

The reference orders MAX_BY / MIN_BY's floats two ways, and the port
follows each: grouped, NaN is above +inf (``seg_pick_by`` reduces y with
``seg_max``); global, NaN counts as +inf, so of the two the first row
wins (``global_pick_by``).  Pinned on one group, v = [10, 20, 30, 40], x
= [1.0, inf, NaN, -0.0]: max_by(v, x) is 30 grouped and 20 global.
"""
import math
import struct

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import groupby as jgb

from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels import reduction as R

MAX_BYTES = 128      # covers the longest string (the reference's bucket)
ROWS = 1_500
ARROW = {"bool": pa.bool_(), "byte": pa.int8(), "short": pa.int16(),
         "int": pa.int32(), "long": pa.int64(), "float": pa.float32(),
         "double": pa.float64(), "string": pa.string()}
KEY_KINDS = list(ARROW)
BIT_KINDS = ["byte", "short", "int", "long"]
SPECIAL = [0.0, -0.0, float("nan"), float("inf"), -float("inf")]
EDGES = ["ab", "ab\x00", "", "a", "ab\x00\x00", "\xff", "\x80", "abcdefgh",
         "abcdefgh\x00", "abcdefghi", "é" * 20]


def _values(kind: str, rng, n: int) -> list:
    if kind == "string":
        pool = EDGES + ["".join(chr(c) for c in rng.randint(32, 256, ln))
                        for ln in rng.randint(0, 70, 40)]
        prefix = "shared-prefix-"
        return [(prefix if rng.rand() < 0.3 else "") + pool[i]
                for i in rng.randint(0, len(pool), n)]
    if kind == "bool":
        return (rng.rand(n) < 0.5).tolist()
    if kind in ("float", "double"):
        v = rng.randn(n) * 100
        pick = rng.rand(n) < 0.15
        v[pick] = rng.choice(SPECIAL, int(pick.sum()))
    else:
        info = np.iinfo({"byte": np.int8, "short": np.int16,
                         "int": np.int32, "long": np.int64}[kind])
        v = rng.randint(info.min, info.max, n, dtype=np.int64)
    few = rng.rand(n) < 0.5
    v[few] = rng.randint(-3, 4, int(few.sum()))
    return v.tolist()


def _table(kind: str, seed: int, n: int = ROWS,
           value_kind: str = "long") -> pa.Table:
    """k: keys 0-39 (5% null); y of ``kind``, group 3 all null and, for
    floats, group 5 only NaN; x of ``value_kind``, 10% null."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 40, n)
    y = _values(kind, rng, n)
    y_ok = (rng.rand(n) >= 0.1) & (k != 3)
    if kind in ("float", "double"):
        y = [float("nan") if g == 5 else v for g, v in zip(k, y)]
    x = _values(value_kind, rng, n)
    x_ok = rng.rand(n) >= 0.1
    return pa.table({
        "k": pa.array(k.astype(np.int32), mask=rng.rand(n) < 0.05),
        "x": pa.array([v if ok else None for v, ok in zip(x, x_ok)],
                      ARROW[value_kind]),
        "y": pa.array([v if ok else None for v, ok in zip(y, y_ok)],
                      ARROW[kind])})


def _both(table: pa.Table):
    """(reference batch, reference layout, port layout, groups)."""
    jb = JaxBatch.from_arrow(table)
    ref = jgb.group_rows(jb, [0])
    got = G.group_rows(arrow_to_batch(table, "cpu"), [0])
    g = int(ref.num_groups)
    assert got.num_groups == g
    return jb, ref, got, g


def _bits(v):
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else struct.pack("<d", v)
    return v


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    assert [_bits(v) for v in got] == [_bits(v) for v in want]


@pytest.mark.parametrize("ignore_nulls", [False, True])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_pick_matches_seg_pick_and_global_pick(kind, last, ignore_nulls):
    """FIRST / LAST of a column of every kind, per group and over the
    batch."""
    jb, ref, got, g = _both(_table(kind, seed=len(kind) + 7 * last))
    want = jgb.seg_pick(ref.sorted_batch.columns[2], ref, ignore_nulls, last)
    have = G.seg_pick(got.sorted_batch.columns[2], got, ignore_nulls, last)
    _same(have.to_pylist(), want.to_pylist(g))
    want = jgb.global_pick(jb.columns[2], jb.live_mask(), ignore_nulls, last)
    have = G.global_pick(arrow_to_batch(jb.to_arrow(), "cpu").columns[2],
                         ignore_nulls, last)
    _same(have.to_pylist(), want.to_pylist(1))


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_pick_by_matches_seg_pick_by_and_global_pick_by(kind, is_min):
    """max_by / min_by: an int64 value (a string value for a string key)
    picked by a key of every kind, per group and over the batch."""
    table = _table(kind, seed=31 + len(kind),
                   value_kind="string" if kind == "string" else "long")
    jb, ref, got, g = _both(table)
    rc, gc = ref.sorted_batch.columns, got.sorted_batch.columns
    want = jgb.seg_pick_by(rc[1], rc[2], ref, is_min,
                           string_max_bytes=MAX_BYTES)
    _same(G.seg_pick_by(gc[1], gc[2], got, is_min).to_pylist(),
          want.to_pylist(g))
    pb = arrow_to_batch(table, "cpu")
    want = jgb.global_pick_by(jb.columns[1], jb.columns[2], jb.live_mask(),
                              is_min, string_max_bytes=MAX_BYTES)
    _same(G.global_pick_by(pb.columns[1], pb.columns[2], is_min).to_pylist(),
          want.to_pylist(1))


@pytest.mark.parametrize("is_min", [True, False])
def test_string_extremes_match_seg_and_global_extreme_string(is_min):
    jb, ref, got, g = _both(_table("string", seed=53))
    want = jgb.seg_extreme_string(ref.sorted_batch.columns[2], ref, is_min,
                                  MAX_BYTES)
    have = G.seg_extreme_string(got.sorted_batch.columns[2], got, is_min)
    _same(have.to_pylist(), want.to_pylist(g))
    want = jgb.global_extreme_string(jb.columns[2], jb.live_mask(), is_min,
                                     MAX_BYTES)
    have = G.global_extreme_string(
        arrow_to_batch(jb.to_arrow(), "cpu").columns[2], is_min)
    _same(have.to_pylist(), want.to_pylist(1))


BIT_OPS = ["bit_and", "bit_or", "bit_xor"]


@jax.jit
def _jax_seg_bitwise(col, sorted_batch, segment_ids, num_groups, boundary):
    """The reference's seg_bitwise for every op, under jit as its exec runs
    it: called eagerly its segmented scan compiles op by op, ~15 s a type
    on this CPU; here one program a type."""
    layout = jgb.GroupedLayout(sorted_batch, segment_ids, num_groups,
                               boundary)
    return {op: jgb.seg_bitwise(col, layout, op, col.dtype.jnp_dtype)
            for op in BIT_OPS}


@pytest.mark.parametrize("op", BIT_OPS)
@pytest.mark.parametrize("kind", BIT_KINDS)
def test_bitwise_matches_seg_bitwise_and_global_bitwise(kind, op):
    jb, ref, got, g = _both(_table(kind, seed=71))
    col = ref.sorted_batch.columns[2]
    want_v, want_ok = _jax_seg_bitwise(col, ref.sorted_batch,
                                       ref.segment_ids, ref.num_groups,
                                       ref.boundary)[op]
    have_v, have_ok = G.seg_bitwise(got.sorted_batch.columns[2], got, op)
    ok = np.asarray(want_ok)[:g]
    np.testing.assert_array_equal(have_ok.numpy(), ok)
    assert have_v.numpy().dtype == np.asarray(want_v).dtype
    np.testing.assert_array_equal(have_v.numpy()[ok], np.asarray(want_v)[:g][ok])
    assert not have_v.numpy()[~ok].any()     # a null slot holds zero
    assert ok.any() and not ok.all()           # group 3 has no valid row
    want_v, want_ok = jgb.global_bitwise(jb.columns[2], jb.live_mask(), op,
                                         col.dtype.jnp_dtype)
    pc = arrow_to_batch(jb.to_arrow(), "cpu").columns[2]
    have_v, have_ok = G.global_bitwise(pc, op)
    assert bool(have_ok[0]) == bool(np.asarray(want_ok)[0])
    assert int(have_v[0]) == int(np.asarray(want_v)[0])


@pytest.mark.parametrize("kind", ["double", "string", "byte"])
def test_empty_batch_matches_the_reference(kind):
    """No rows: no groups, and one null row over the batch."""
    table = _table(kind, seed=5, n=0)
    jb, ref, got, g = _both(table)
    assert g == 0
    pb = arrow_to_batch(table, "cpu")
    assert G.seg_pick(got.sorted_batch.columns[2], got, False,
                      False).num_rows == 0
    for last in (False, True):
        want = jgb.global_pick(jb.columns[2], jb.live_mask(), False, last)
        _same(G.global_pick(pb.columns[2], False, last).to_pylist(),
              want.to_pylist(1))
    want = jgb.global_pick_by(jb.columns[1], jb.columns[2], jb.live_mask(),
                              False, string_max_bytes=MAX_BYTES)
    _same(G.global_pick_by(pb.columns[1], pb.columns[2], False).to_pylist(),
          want.to_pylist(1))
    if kind == "byte":
        v, ok = G.global_bitwise(pb.columns[2], "bit_and")
        assert v.tolist() == [0] and ok.tolist() == [False]


def test_nan_against_inf_follows_each_reference_mode():
    """One group, v = [10, 20, 30, 40], x = [1.0, inf, NaN, -0.0]: grouped
    max_by(v, x) is 30 (NaN above +inf), global 20 (NaN equal to +inf,
    the first row wins), in the reference and in the port; min_by is 40
    (-0.0) both ways."""
    table = pa.table({"k": pa.array([7] * 4, pa.int32()),
                      "x": pa.array([10, 20, 30, 40], pa.int64()),
                      "y": pa.array([1.0, float("inf"), float("nan"), -0.0])})
    jb, ref, got, g = _both(table)
    rc, gc = ref.sorted_batch.columns, got.sorted_batch.columns
    pb = arrow_to_batch(table, "cpu")
    for is_min, grouped, glob in ((False, 30, 20), (True, 40, 40)):
        assert jgb.seg_pick_by(rc[1], rc[2], ref, is_min).to_pylist(1) \
            == [grouped]
        assert G.seg_pick_by(gc[1], gc[2], got, is_min).to_pylist() \
            == [grouped]
        assert jgb.global_pick_by(jb.columns[1], jb.columns[2],
                                  jb.live_mask(), is_min).to_pylist(1) \
            == [glob]
        assert G.global_pick_by(pb.columns[1], pb.columns[2],
                                is_min).to_pylist() == [glob]


def test_plain_versions_keep_their_contracts():
    """The plain versions' own contracts: -1 where no row qualifies, the
    lowest row among ties, a prefix before the longer string, and the
    bitwise results at the data's width."""
    v = torch.tensor([False, True, True, False, True])
    st = torch.tensor([0, 1, 3], dtype=torch.int32)
    key = torch.tensor([0, 5, 5, 9, 2], dtype=torch.int16)
    none = torch.zeros(5, dtype=torch.bool)
    assert R.segmented_pick("max", v, st, key).tolist() == [-1, 1, 4]
    assert R.segmented_pick("max", none, st, key).tolist() == [-1, -1, -1]
    assert R.segmented_pick("last", none, st).tolist() == [0, 2, 4]
    assert R.segmented_pick("last", none, st,
                            ignore_nulls=True).tolist() == [-1, -1, -1]
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    s = DeviceColumn.from_strings(["ab", "ab\x00", "", "a", None])
    assert R.masked_pick("max", s.validity, s.data, s.offsets).tolist() == [1]
    assert R.masked_pick("min", s.validity, s.data, s.offsets).tolist() == [2]
    d = torch.tensor([-128, 127, -1, 0, 5], dtype=torch.int8)
    out, ok = R.segmented_bitwise("bit_xor", d, v, st)
    assert out.dtype == torch.int8 and out.tolist() == [0, -128, 5]
    assert ok.tolist() == [False, True, True]
    with pytest.raises(TypeError):
        R.masked_bitwise("bit_or", d.to(torch.float32), v)
    with pytest.raises(ValueError):
        R.masked_pick("first", v, key)
