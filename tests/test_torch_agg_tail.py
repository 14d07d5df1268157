"""MIN, MAX, the variances and standard deviations, BOOL_AND and BOOL_OR
through the port on the CPU, against the JAX package.

Kernel level: each plain version the port's wrappers run on CPU tensors
(``segmented_extreme``, ``segmented_m2``) is held against the JAX
function it ports (``seg_min``, ``seg_max``, ``seg_m2_update``,
``seg_m2_merge``) on the same seeded input grouped by both packages'
``group_rows``: validity and MIN / MAX exact (floats bit for bit, NaN
and -0.0 included), M2 within 1e-12 relative (the packages add the
squares in different orders).  The signed zero is pinned: the JAX
package's extremes order -0.0 below 0.0 on the CPU, whatever the order
of the rows, and so does the port.

Query level: the held shapes of tests/test_queries.py
(``test_global_aggregate`` :149, ``test_grouped_aggregate`` :163, MIN /
MAX of all five of its column types) and tests/test_variance.py's four
cases, BOOL_AND / BOOL_OR, an empty input, an all-null and an all-NaN
group and -0.0, each fused and unfused in 1 and 3 partitions, against
the JAX package's CPU oracle (``spark.rapids.sql.enabled=false``), which
its own tests hold its device path to; the device path compiles each of
these grouped queries for 13-40 s on this CPU.  Rows compare sorted,
keys, counts, MIN and MAX exactly (NaN equal to NaN), the rest within
1e-9 relative (``tests/test_queries.py`` ``_eq_val``: the oracle sums
row by row, the port in partials).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.expressions import aggregates as JA
from spark_rapids_tpu.kernels import groupby as jgb
from tests.test_queries import SCHEMA, _eq_val, _normalize, make_data

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.expressions import aggregates as PA
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels import reduction as R
from spark_rapids_tpu_torch.testing import held
from spark_rapids_tpu_torch.testing.held import extreme_aggs, variance_aggs

M2_RTOL = 1e-12
HELD_ROWS = 500      # make_data's default size
ORACLE_CONF = {"spark.rapids.sql.enabled": "false"}
FUSE = {True: {}, False: {"spark.rapids.sql.tpu.fuseStages": "false"}}

# -- kernel level --------------------------------------------------------------

ARROW_TYPES = {"int": pa.int32(), "date": pa.date32(), "long": pa.int64(),
               "dec": pa.decimal128(12, 2), "float": pa.float32(),
               "double": pa.float64(), "bool": pa.bool_()}
SPECIAL = [0.0, -0.0, float("nan"), float("inf"), -float("inf")]


def _values(kind: str, rng, n: int):
    if kind == "bool":
        return rng.rand(n) < 0.5
    if kind in ("float", "double"):
        v = rng.randn(n) * 100
        special = rng.rand(n) < 0.1
        v[special] = rng.choice(SPECIAL, special.sum())
        return v.astype(np.float32 if kind == "float" else np.float64)
    if kind == "long":
        return rng.randint(-2**62, 2**62, n, dtype=np.int64)
    if kind == "dec":
        return rng.randint(-10**11, 10**11, n, dtype=np.int64)
    return rng.randint(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)


def _arrow(kind: str, vals: np.ndarray, valid: np.ndarray) -> pa.Array:
    if kind == "dec":
        import decimal
        return pa.array([decimal.Decimal(int(x)).scaleb(-2) if ok else None
                         for x, ok in zip(vals, valid)], ARROW_TYPES[kind])
    if kind == "date":
        return pa.array(vals, pa.int32(), mask=~valid).cast(pa.date32())
    return pa.array(vals, ARROW_TYPES[kind], mask=~valid)


def _grouped_table(kind: str, seed: int, n: int = 600) -> pa.Table:
    """Keys 0-19 (5% null): group 3 has no valid value; for floats group 5
    holds only NaNs and group 6 only zeros of both signs."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 20, n).astype(np.int32)
    vals = _values(kind, rng, n)
    valid = (rng.rand(n) >= 0.1) & (k != 3)
    if kind in ("float", "double"):
        vals[k == 5] = np.nan
        vals[k == 6] = np.where(rng.rand((k == 6).sum()) < 0.5, 0.0, -0.0)
    return pa.table({"k": pa.array(k, mask=rng.rand(n) < 0.05),
                     "v": _arrow(kind, vals, valid)})


def _grouped_both(table: pa.Table):
    """(reference layout, port layout, number of groups)."""
    ref = jgb.group_rows(JaxBatch.from_arrow(table), [0])
    got = G.group_rows(arrow_to_batch(table, "cpu"), [0])
    g = int(ref.num_groups)
    assert got.num_groups == g
    return ref, got, g


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({4: np.int32, 8: np.int64}[a.itemsize]) \
        if a.dtype.kind == "f" else a


def _assert_extremes(got_v, got_ok, ref_v, ref_ok, g: int) -> None:
    ok = np.asarray(ref_ok)[:g]
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    ref = np.asarray(ref_v)[:g]
    got = got_v.numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(_bits(got[ok]), _bits(ref[ok]))
    assert not got[~ok].any()     # a null slot holds zero


@pytest.mark.parametrize("kind", list(ARROW_TYPES))
@pytest.mark.parametrize("is_min", [True, False])
def test_segmented_extreme_matches_seg_min_and_seg_max(kind, is_min):
    ref, got, g = _grouped_both(_grouped_table(kind, seed=len(kind)))
    ref_v, ref_ok = (jgb.seg_min if is_min else jgb.seg_max)(
        ref.sorted_batch.columns[1], ref)
    fn = G.seg_min if is_min else G.seg_max
    got_v, got_ok = fn(got.sorted_batch.columns[1], G.SegmentSums(got))
    _assert_extremes(got_v, got_ok, ref_v, ref_ok, g)


def _signed_zero_cases():
    return [[0.0, -0.0], [-0.0, 0.0], [1.0, 0.0, -0.0, 0.0],
            [0.0, float("nan"), -0.0]]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_signed_zero_is_pinned_to_the_reference(dtype):
    """The reference's seg_min gives -0.0 and its seg_max 0.0 whatever the
    rows' order (XLA's min / max on this CPU); its global MIN / MAX the
    same.  The port's plain versions give the same bits."""
    from spark_rapids_tpu.columnar.column import DeviceColumn as JaxColumn
    from spark_rapids_tpu.plan.execs.aggregate import (
        _global_update as jax_global_update)
    for vals in _signed_zero_cases():
        x = np.array(vals, dtype)
        n = len(x)
        valid = np.ones(n, np.bool_)
        table = pa.table({"k": pa.array(np.zeros(n, np.int32)),
                          "v": pa.array(x)})
        ref, got, g = _grouped_both(table)
        for is_min in (True, False):
            rv, rok = (jgb.seg_min if is_min else jgb.seg_max)(
                ref.sorted_batch.columns[1], ref)
            gv, gok = R.segmented_extreme(torch.from_numpy(x),
                                          torch.from_numpy(valid),
                                          got.starts, is_min)
            _assert_extremes(gv, gok, rv, rok, g)
            jcol = JaxColumn.from_numpy(x, ref.sorted_batch.columns[1].dtype,
                                        valid, capacity=n)
            jv, _ = jax_global_update(JA.MIN if is_min else JA.MAX, jcol,
                                      jnp.ones(n, jnp.bool_), None)
            pv, _, _ = R.masked_extreme(torch.from_numpy(x),
                                        torch.from_numpy(valid), is_min)
            assert _bits(pv.numpy()) == _bits(np.asarray(jv).reshape(1))
            if not any(math.isnan(v) for v in vals) or is_min:
                assert math.copysign(1.0, float(pv[0])) == \
                    (-1.0 if is_min else 1.0)


@pytest.mark.parametrize("kind", ["int", "long", "float", "double",
                                  "large_mean"])
def test_segmented_m2_update_matches_seg_m2_update(kind):
    """Two-pass M2 per group; ``large_mean`` is test_variance.py:20's
    data (1e8 + (i % 7) - 3), where the sum-of-squares identity would
    cancel to 0."""
    if kind == "large_mean":
        n = 600
        k = (np.arange(n) % 3).astype(np.int32)
        table = pa.table({"k": k, "v": 1.0e8 + (np.arange(n) % 7) - 3.0})
    else:
        table = _grouped_table(kind, seed=17 + len(kind))
    ref, got, g = _grouped_both(table)
    ref_v, ref_ok = jgb.seg_m2_update(ref.sorted_batch.columns[1], ref)
    got_v, got_ok = G.seg_m2_update(got.sorted_batch.columns[1],
                                    G.SegmentSums(got))
    ok = np.asarray(ref_ok)[:g]
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    np.testing.assert_allclose(got_v.numpy()[ok], np.asarray(ref_v)[:g][ok],
                               rtol=M2_RTOL, equal_nan=True)
    if kind == "large_mean":
        assert (got_v.numpy() > 1.0).all()


def test_segmented_m2_merge_matches_seg_m2_merge():
    """Partial (M2, sum, count) rows keyed 0-12, some with count 0 (a null
    M2, sum 0), group 4 only such rows."""
    rng = np.random.RandomState(23)
    n = 600
    k = rng.randint(0, 13, n).astype(np.int32)
    cnt = rng.randint(0, 50, n).astype(np.int64)
    cnt[k == 4] = 0
    valid = cnt > 0
    s = np.where(valid, rng.randn(n) * 1e3, 0.0)
    m2 = np.where(valid, rng.rand(n) * 1e4, 0.0)
    table = pa.table({"k": k, "m2": pa.array(m2, mask=~valid),
                      "s": pa.array(s, mask=~valid), "n": cnt})
    ref, got, g = _grouped_both(table)
    rc, gc = ref.sorted_batch.columns, got.sorted_batch.columns
    ref_v, ref_ok = jgb.seg_m2_merge(rc[1], rc[2], rc[3], ref)
    got_v, got_ok = G.seg_m2_merge(gc[1], gc[2], gc[3], G.SegmentSums(got))
    ok = np.asarray(ref_ok)[:g]
    assert not ok.all() and ok.any()
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    np.testing.assert_allclose(got_v.numpy()[ok], np.asarray(ref_v)[:g][ok],
                               rtol=M2_RTOL)


@pytest.mark.parametrize("starts", [[0], [0, 1, 2, 3], [0, 7, 8, 300, 599]])
def test_m2_plain_one_segment_is_the_masked_version(starts):
    """The whole-batch plain versions are the segmented ones over one
    segment, for both modes."""
    rng = np.random.RandomState(len(starts))
    n = 600
    x = torch.from_numpy(rng.randn(n) * 10 + 5)
    valid = torch.from_numpy(rng.rand(n) >= 0.2)
    st = torch.tensor(starts, dtype=torch.int32)
    total, _, cnt, _ = R.segmented_sum(x, valid, st)
    seg = R.segmented_m2("update", x, valid, st, total, cnt)
    if len(starts) == 1:
        whole = R.masked_m2("update", x, valid, total, cnt)
        torch.testing.assert_close(whole, seg, rtol=M2_RTOL, atol=0)
        v, ok, nv = R.masked_extreme(x, valid, True)
        sv, sok = R.segmented_extreme(x, valid, st, True)
        assert torch.equal(v, sv) and torch.equal(ok, sok)
        assert nv.item() == int(valid.sum())
    # merge the per-segment partials back into one group: Chan's formula
    # gives the M2 of all the rows
    one = torch.zeros(1, dtype=torch.int32)
    ones = torch.ones(len(starts), dtype=torch.bool)
    t2 = R.segmented_sum(total, ones, one)[0]
    n2 = R.segmented_sum(cnt, ones, one)[0]
    merged = R.segmented_m2("merge", seg, ones, one, t2, n2, total, cnt)
    t_all, _, c_all = R.masked_sum(x, valid)
    direct = R.masked_m2("update", x, valid, t_all, c_all)
    torch.testing.assert_close(merged, direct, rtol=1e-10, atol=0)


# -- query level ---------------------------------------------------------------


def test_held_table_is_make_data():
    """The port's held generator draws tests/test_queries.py's make_data
    streams, vectorised: the same 500 rows, nulls and all."""
    want = make_data()
    data, validity = held.columns(HELD_ROWS, 0)
    assert held.SCHEMA.names == SCHEMA.names
    for name in SCHEMA.names:
        got = [v.item() if ok else None
               for v, ok in zip(data[name], validity[name])]
        assert len(got) == len(want[name])
        for a, b in zip(got, want[name]):
            assert (a is None and b is None) or a == b or (
                a is not None and b is not None and math.isnan(a)
                and math.isnan(b)), (name, a, b)


def _bools(E):
    mod = JA if E is JE else PA
    b = E.col("b")
    return [mod.BoolAnd(b).alias("all_b"), mod.BoolOr(b).alias("any_b")]


def _large_mean():
    n = 4096
    return ({"k": [i % 3 for i in range(n)],
             "v": [1.0e8 + float(i % 7) - 3.0 for i in range(n)]},
            {"k": "int", "v": "double"})


def _edge_groups():
    """Group 1 all null, group 2 all NaN, group 3 NaN beside numbers,
    group 4 zeros of both signs, group 5 one row."""
    x = ([None] * 4 + [float("nan")] * 4 + [float("nan"), 1.5, -2.0, 3.0]
         + [0.0, -0.0, -0.0, 0.0] + [7.25])
    return ({"k": [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5], "x": x},
            {"k": "int", "x": "double"})


TYPES = {"int": pa.int32(), "long": pa.int64(), "double": pa.float64(),
         "float": pa.float32(), "bool": pa.bool_()}

# case -> (data, the query over a dataframe and the DSL module E); the
# held shapes are the port's testing/held.py, the ones phase 12 of
# chip_smoke.py runs on the card
CASES = {
    **{name: ("held", fn) for name, fn in held.QUERIES.items()},
    "grouped_variance_float": ("held", lambda df, E: df.group_by("k").agg(
        E.var_samp("f").alias("vs"), E.stddev_pop("f").alias("sp"))),
    "variance_large_mean": ("large_mean", lambda df, E: df.group_by(
        "k").agg(E.var_pop("v").alias("vp"))),
    "variance_single_row_group": ("single_row", lambda df, E: df.group_by(
        "k").agg(E.var_samp("v").alias("vs"))),
    "bool_and_or": ("held", lambda df, E: df.agg(*_bools(E))),
    "grouped_bool_and_or": ("held", lambda df, E: df.group_by("k").agg(
        *_bools(E))),
    "empty_global": ("held", lambda df, E: df.filter(
        E.col("v") > E.lit(10**18)).agg(
        *extreme_aggs(E, "vx"), E.var_samp("x"), *_bools(E))),
    "empty_grouped": ("held", lambda df, E: df.filter(
        E.col("v") > E.lit(10**18)).group_by("k").agg(*extreme_aggs(E, "x"))),
    "edge_groups": ("edges", lambda df, E: df.group_by("k").agg(
        *extreme_aggs(E, "x"), *variance_aggs(E, "x"))),
    "edge_groups_global": ("edges", lambda df, E: df.filter(
        E.col("k") == E.lit(4)).agg(*extreme_aggs(E, "x"))),
}


@functools.lru_cache(maxsize=None)
def _tables(data: str, parts: int):
    """The case's data as Arrow batches (several a partition)."""
    if data == "held":
        # the port's generator, crossing to the reference through Arrow
        return [b.to_arrow() for b in held.batches(
            HELD_ROWS, "cpu", batch_rows=HELD_ROWS // (2 * parts) + 1)]
    if data == "large_mean":
        cols, kinds = _large_mean()
    elif data == "single_row":
        cols, kinds = ({"k": [1, 2, 2], "v": [10.0, 1.0, 3.0]},
                       {"k": "int", "v": "double"})
    else:
        cols, kinds = _edge_groups()
    n = len(cols["k"])
    step = max(n // (2 * parts), 1)
    return [pa.table({c: pa.array(v[o:o + step], TYPES[kinds[c]])
                      for c, v in cols.items()})
            for o in range(0, n, step)]


@functools.lru_cache(maxsize=None)
def _reference(case: str, parts: int):
    data, query = CASES[case]
    sess = TpuSession(ORACLE_CONF)
    df = sess.create_dataframe([JaxBatch.from_arrow(t)
                                for t in _tables(data, parts)],
                               num_partitions=parts)
    return _normalize(query(df, JE).collect())


def _port(case: str, parts: int, fused: bool):
    data, query = CASES[case]
    sess = GpuSession(FUSE[fused], device="cpu")
    df = sess.create_dataframe([arrow_to_batch(t, "cpu")
                                for t in _tables(data, parts)],
                               num_partitions=parts)
    return query(df, PE)


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_aggregate_matches_reference(case, fused, parts):
    ref = _reference(case, parts)
    got = _normalize(_port(case, parts, fused).collect())
    assert len(got) == len(ref)
    if case == "empty_global":
        assert len(got) == 1 and all(v is None for v in got[0])
    for r, g in zip(ref, got):
        assert len(r) == len(g)
        for a, b in zip(r, g):
            assert _eq_val(a, b), (case, r, g)


def test_edge_groups_by_hand():
    """All-null group: every result null; all-NaN group: MIN and MAX NaN,
    the variances NaN; NaN among numbers: MIN the smallest number, MAX
    NaN; zeros: MIN -0.0, MAX 0.0; one row: var_samp null, var_pop 0."""
    rows = {r[0]: r[1:] for r in _port("edge_groups", 3, True).collect()}
    assert all(v is None for v in rows[1])
    mn, mx, vs, vp, sd, sp = rows[2]
    assert all(math.isnan(v) for v in (mn, mx, vs, vp, sd, sp))
    assert rows[3][0] == -2.0 and math.isnan(rows[3][1])
    assert math.copysign(1.0, rows[4][0]) == -1.0
    assert math.copysign(1.0, rows[4][1]) == 1.0
    assert rows[4][2:] == (0.0, 0.0, 0.0, 0.0)
    assert rows[5][:2] == (7.25, 7.25) and rows[5][2] is None
    assert rows[5][3] == 0.0


def test_variance_large_mean_keeps_its_spread():
    """test_variance.py:20: mean 1e8, the true population variance of
    (i % 7) - 3 over each group, within 1e-4 relative as there."""
    data, _ = _large_mean()
    vals, ks = np.array(data["v"]), np.array(data["k"])
    for k, vp in _port("variance_large_mean", 3, True).collect():
        expect = vals[ks == k].var()
        assert expect > 1.0 and abs(vp - expect) < 1e-4 * expect


def test_global_extremes_after_a_filter_stay_one_segment():
    """A global MIN / MAX / M2 aggregate after a filter is one fused
    segment: the filter's kernel compacts the inputs, the whole-batch
    kernels reduce them."""
    plan = _port("filtered_global", 3, True).explain()
    assert "GpuFusedSegment[HashAggregate <- Filter" in plan
    plan = _port("filtered_global", 3, False).explain()
    assert "GpuFusedSegment" not in plan


def test_string_and_unported_inputs_raise():
    """A variance of a string raises: there is no fallback.  MIN / MAX
    and the variances over BYTE run (BYTE and DOUBLE results; held
    against the reference in tests/test_torch_key_kinds.py), as MIN / MAX
    over STRING do (tests/test_torch_agg_pick.py)."""
    sess = GpuSession(device="cpu")
    df = sess.create_dataframe(pa.table({"s": ["a", "b"], "k": [1, 2],
                                         "b": pa.array([1, 2], pa.int8())}))
    assert df.agg(PE.min_("b"), PE.max_("b")).collect() == [(1, 2)]
    with pytest.raises(NotImplementedError):
        df.agg(PE.var_samp("s")).collect()
    assert df.agg(PE.var_samp("b")).collect() == [(0.5,)]
