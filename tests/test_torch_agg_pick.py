"""STRING MIN / MAX, FIRST / LAST, MAX_BY / MIN_BY and the bit aggregates
through the port on the CPU, against the JAX package.

Query level: the ten cases of tests/test_agg_tail.py that inject no OOM
(its table ``_data``, which ``testing/held.py`` draws as ``tail_columns``,
and its small tables), and the tail queries phase 13 of chip_smoke.py
runs on the card, each fused and unfused in 1 and 3 partitions, against
the JAX package's CPU oracle (``spark.rapids.sql.enabled=false``), which
tests/test_agg_tail.py holds its device path to; that device path
compiles each of these queries for 2-15 s on this CPU.  Both packages
take the same Arrow batches and deal them to partitions round-robin, so
FIRST / LAST see the same input order.  Rows compare sorted, values
exactly (NaN equal to NaN).

The one place where the reference's device path and its oracle differ
is pinned here: a global FIRST / LAST over two partitions, one of which
a filter empties.  The device path's partial of no rows is a padded row
whose pick is null, and FIRST at the merge picks it; the oracle, and
Spark, skip it.  The port gives the oracle's answer (ROADMAP queue 3).
"""
import functools
import math

import pyarrow as pa
import pytest

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from tests.test_agg_tail import _data
from tests.test_queries import _normalize

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.testing import held

ORACLE_CONF = {"spark.rapids.sql.enabled": "false"}
FUSE = {True: {}, False: {"spark.rapids.sql.tpu.fuseStages": "false"}}
TYPES = {"k": pa.int32(), "v": pa.int64(), "x": pa.float64(),
         "s": pa.string(), "b": pa.int8()}


def _ties():
    return {"k": [1, 1, 1, 2, 2], "v": [10, 20, 30, 40, 50],
            "x": [5.0, 5.0, 1.0, 7.0, 7.0],
            "s": ["a", "b", "c", "d", "e"], "b": [0, 1, 2, 3, 4]}


def _string_ties():
    return {"k": [1, 1, 1, 2], "v": [10, 20, 30, 40],
            "x": [1.0, 2.0, 3.0, 4.0],
            "s": ["zz", "zz", "aa", "mm"], "b": [0, 1, 2, 3]}


def _null_string_group():
    return {"k": [1, 1, 2, 2], "v": [10, 20, 30, 40],
            "x": [1.0, 2.0, 3.0, 4.0],
            "s": [None, None, "b", "a"], "b": [0, 1, 2, 3]}


def _all_null_bits():
    return {"k": [1, 2], "v": [None, None], "x": [1.0, 2.0],
            "s": ["a", "b"], "b": [None, None]}


def _string_edges():
    """test_min_max_over_strings: "" before everything, "s1" a prefix of
    the "s1-..." values."""
    data = _data()
    data["s"][3] = ""
    data["s"][4] = "s1"
    return data


DATA = {"tail": _data, "tail100": lambda: _data(100), "ties": _ties,
        "string_ties": _string_ties, "null_string_group": _null_string_group,
        "all_null_bits": _all_null_bits, "string_edges": _string_edges}

# case -> (data, query over a dataframe and the DSL module E, the rows
# every partitioning gives or None); the tail queries are phase 13's
CASES = {
    **{name: ("tail", fn, None) for name, fn in held.TAIL_QUERIES.items()},
    "first_last_global_empty": ("tail100", lambda df, E: df.filter(
        E.col("v") > E.col("v")).agg(E.first("v").alias("f"),
                                     E.last("s").alias("l")),
        [(None, None)]),
    "first_last_global": ("tail100", lambda df, E: df.agg(
        E.first("v", ignore_nulls=True).alias("f"), E.last("x").alias("l")),
        None),
    "max_by_ties_take_first_row": ("ties", lambda df, E: df.group_by(
        "k").agg(E.max_by("v", "x").alias("m")), [(1, 10), (2, 40)]),
    "max_by_string_keys_global_and_ties": ("string_ties", lambda df, E:
                                           df.agg(
        E.max_by("v", "s").alias("m"), E.min_by("v", "s").alias("n")),
        [(10, 30)]),
    "max_by_string_keys_all_null_group": ("null_string_group", lambda df, E:
                                          df.group_by("k").agg(
        E.max_by("v", "s").alias("m")), [(1, None), (2, 30)]),
    "min_max_over_strings": ("string_edges", held.grouped_string_extremes,
                             None),
    "bit_aggregates_global_all_null": ("all_null_bits", lambda df, E:
                                       df.agg(
        E.bit_and("v").alias("ba"), E.bit_or("b").alias("bo")),
        [(None, None)]),
}


@functools.lru_cache(maxsize=None)
def _tables(data: str, parts: int):
    """The case's rows as Arrow batches, two a partition."""
    cols = DATA[data]()
    n = len(cols["k"])
    step = max(-(-n // (2 * parts)), 1)
    return [pa.table({c: pa.array(v[o:o + step], TYPES[c])
                      for c, v in cols.items()})
            for o in range(0, n, step)]


@functools.lru_cache(maxsize=None)
def _reference(case: str, parts: int):
    data, query, _ = CASES[case]
    df = TpuSession(ORACLE_CONF).create_dataframe(
        [JaxBatch.from_arrow(t) for t in _tables(data, parts)],
        num_partitions=parts)
    return _normalize(query(df, JE).collect())


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    return a == b


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_aggregate_tail_matches_reference(case, fused, parts):
    data, query, rows = CASES[case]
    df = GpuSession(FUSE[fused], device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in _tables(data, parts)],
        num_partitions=parts)
    got = _normalize(query(df, PE).collect())
    ref = _reference(case, parts)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r) and all(map(_same, g, r)), (case, g, r)
    if rows is not None and parts == 1:
        assert got == rows


def _two_partitions(session, batch):
    t1 = pa.table({"k": pa.array([1, 2], pa.int32()),
                   "v": pa.array([10, 20], pa.int64())})
    t2 = pa.table({"k": pa.array([3, 4], pa.int32()),
                   "v": pa.array([30, 40], pa.int64())})
    return session.create_dataframe([batch(t1), batch(t2)], num_partitions=2)


@pytest.mark.parametrize("keep,oracle,device", [
    ("k > 2", (30, 40), (None, 40)),
    ("k < 3", (10, 20), (10, None)),
])
def test_first_last_skip_an_emptied_partition(keep, oracle, device):
    """The port equals the JAX package's CPU oracle (and Spark); the JAX
    package's device path picks the emptied partition's padded null row,
    a fault of the reference recorded in ROADMAP queue 3."""
    def build(df, E):
        k = E.col("k")
        kept = k > E.lit(2) if keep == "k > 2" else k < E.lit(3)
        return df.filter(kept).agg(E.first("v").alias("f"),
                                   E.last("v").alias("l"))
    jax_rows = {}
    for enabled in ("false", "true"):
        sess = TpuSession({"spark.rapids.sql.enabled": enabled})
        jax_rows[enabled] = build(_two_partitions(sess, JaxBatch.from_arrow),
                                  JE).collect()
    assert jax_rows["false"] == [oracle]
    assert jax_rows["true"] == [device]
    for fuse in FUSE.values():
        sess = GpuSession(fuse, device="cpu")
        got = build(_two_partitions(
            sess, lambda t: arrow_to_batch(t, "cpu")), PE).collect()
        assert got == [oracle]


@pytest.mark.parametrize("key", ["b", "h"])
def test_byte_and_short_are_value_columns_only(key):
    """BYTE and SHORT cross the Arrow bridge and feed the tail's
    aggregates; they are group, sort and join keys too (the last key
    kinds: tests/test_torch_key_kinds.py holds them against the
    reference)."""
    table = pa.table({"b": pa.array([1, -2, 3], pa.int8()),
                      "h": pa.array([300, -2, 7], pa.int16()),
                      "k": pa.array([1, 1, 2], pa.int32())})
    sess = GpuSession(device="cpu")
    df = sess.create_dataframe(table)
    assert df.group_by("k").agg(PE.bit_or(key).alias("o"),
                                PE.first(key).alias("f")).collect() == (
        [(1, -1, 1), (2, 3, 3)] if key == "b" else [(1, -2, 300), (2, 7, 7)])
    vals = table.column(key).to_pylist()
    assert sorted(df.group_by(key).agg(PE.count().alias("n")).collect()) \
        == sorted((v, 1) for v in vals)
    assert [r[0] for r in df.order_by(key).select(key).collect()] == \
        sorted(vals)
    joined = df.join(sess.create_dataframe(table.select([key])), on=key)
    assert sorted(r[0] for r in joined.select(key).collect()) == sorted(vals)
