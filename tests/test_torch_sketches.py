"""The sketch slice through GpuSession on the CPU, against the JAX package:
``repartition`` (hash and round robin), ``range``, ``collect_partitions``,
the runtime bloom filter (``build_bloom`` and ``might_contain``) and
``approx_count_distinct``.

The cases are the reference's: tests/test_hashing_sketches.py :56-125
(the bloom filter's bits bit for bit and its wire round trip, the probe's
rows, the HLL estimates global, grouped and over 20,000 ids exactly, a
STRING input refused), tests/test_queries.py:223 ``repartition(5, k)``,
tests/test_string_keys.py:33 ``repartition(4, s)`` and
tests/test_range_shuffle.py:198's round-robin rotation.  Both packages
get the same batches (Arrow tables); a partition's rows are compared in
order against the JAX device path with stage fusion off (the path whose
round-robin start rotates per batch, as the port's does), the rest
against its CPU oracle (``spark.rapids.sql.enabled=false``).
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.expressions import (
    BloomFilterMightContain as JBloomFilterMightContain,
    approx_count_distinct as j_acd, col as jcol, count as jcount)
from spark_rapids_tpu.kernels import bloom as JB

import spark_rapids_tpu_torch.expressions as E
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels import bloom as BK
from spark_rapids_tpu_torch.plan.execs.exchange import GpuShuffleExchangeExec
from tests.test_queries import make_data
from tests.test_strings import WORDS as STRING_WORDS

ORACLE = {"spark.rapids.sql.enabled": "false"}
UNFUSED = {"spark.rapids.sql.tpu.fuseStages": "false"}
HASH_WORDS = ["", "a", "tpu", "hello world", "x" * 40, None,
              "日本語テキスト"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(tables, jsess, psess, parts):
    """The same Arrow tables as one batch each, dealt to ``parts``
    partitions round-robin by both packages."""
    jdf = jsess.create_dataframe([JaxBatch.from_arrow(t) for t in tables],
                                 num_partitions=parts)
    pdf = psess.create_dataframe([arrow_to_batch(t, psess.device)
                                  for t in tables], num_partitions=parts)
    return jdf, pdf


def _sketch_tables(n=400):
    """tests/test_hashing_sketches.py ``_df`` (:23-36) in tables of 128."""
    rng = np.random.RandomState(3)
    data = {
        "i": [int(v) if v % 7 else None
              for v in rng.randint(-10**6, 10**6, n)],
        "l": rng.randint(-2**60, 2**60, n).tolist(),
        "d": [float(v) for v in rng.uniform(-5, 5, n)],
        "s": [HASH_WORDS[v % len(HASH_WORDS)]
              for v in rng.randint(0, 100, n)],
        "g": rng.randint(0, 4, n).tolist(),
    }
    types = {"i": pa.int32(), "l": pa.int64(), "d": pa.float64(),
             "s": pa.string(), "g": pa.int32()}
    table = pa.table({k: pa.array(v, types[k]) for k, v in data.items()})
    return [table.slice(o, 128) for o in range(0, n, 128)]


def _query_tables():
    """tests/test_queries.py ``source`` (:124): make_data() in 5 tables."""
    data = make_data()
    types = {"k": pa.int32(), "v": pa.int64(), "x": pa.float64(),
             "f": pa.float32(), "b": pa.bool_()}
    table = pa.table({k: pa.array(v, types[k]) for k, v in data.items()})
    step = table.num_rows // 5
    return [table.slice(o, step) for o in range(0, table.num_rows, step)]


def _string_tables():
    """tests/test_strings.py ``strings_df`` (:36) in tables of 40."""
    rng = np.random.RandomState(3)
    n = 120
    data = {"s": [STRING_WORDS[i % len(STRING_WORDS)] for i in range(n)],
            "t": [STRING_WORDS[(i * 7 + 3) % len(STRING_WORDS)]
                  for i in range(n)],
            "n": rng.randint(-3, 12, n).tolist()}
    for cname in ("s", "t"):
        for i in rng.choice(n, n // 6, replace=False):
            data[cname][i] = None
    table = pa.table({"s": pa.array(data["s"], pa.string()),
                      "t": pa.array(data["t"], pa.string()),
                      "n": pa.array(data["n"], pa.int32())})
    return [table.slice(o, 40) for o in range(0, n, 40)]


def _partitions(df):
    """Each partition's rows in order, as reprs (NaN equals NaN)."""
    return [[repr(row) for b in part for row in b.to_arrow().to_pylist()]
            for part in df.collect_partitions()]


@pytest.mark.parametrize("case", ["queries_k5", "strings_s4",
                                  "round_robin4"])
def test_repartition_partitions_equal_reference(case):
    """Each partition's rows, in order, equal the JAX device path's (stage
    fusion off: its unfused exchange); the round-robin start rotates per
    map batch over every input partition."""
    tables = _string_tables() if case == "strings_s4" else _query_tables()
    jdf, pdf = _frames(tables, TpuSession(UNFUSED),
                       GpuSession(device="cpu"), 3)
    if case == "queries_k5":
        jq, pq = jdf.repartition(5, jcol("k")), pdf.repartition(5, E.col("k"))
    elif case == "strings_s4":
        jq, pq = jdf.repartition(4, jcol("s")), pdf.repartition(4, E.col("s"))
    else:
        jq, pq = jdf.repartition(4), pdf.repartition(4)
    want = _partitions(jq)
    got = _partitions(pq)
    assert len(got) == len(want)
    assert got == want
    assert sorted(sum(got, [])) == sorted(
        map(repr, [r for t in tables for r in t.to_pylist()]))


def test_round_robin_start_rotates_across_batches():
    """tests/test_range_shuffle.py:198: 3 batches x 10 rows over 4
    partitions; rotated starts give [7, 8, 8, 7] (unrotated [9, 9, 6,
    6])."""
    sess = GpuSession(device="cpu")
    tables = [pa.table({"v": pa.array(range(i * 10, i * 10 + 10),
                                      pa.int64())}) for i in range(3)]
    df = sess.create_dataframe([arrow_to_batch(t, "cpu") for t in tables],
                               num_partitions=3)
    plan = df.repartition(4).physical_plan()
    assert isinstance(plan, GpuShuffleExchangeExec)
    assert plan.describe() == "GpuShuffleExchange[round_robin, 4]"
    counts = plan.partition_row_counts()
    rows = sorted(r[0] for p in range(4) for b in plan.execute_partition(p)
                  for r in b.rows())
    plan.cleanup()
    assert counts == [7, 8, 8, 7]
    assert rows == list(range(30))


def test_range_equals_reference():
    for args, parts in (((0, 5000, 5), 1), ((20_000,), 3), ((7, -20, -3), 2),
                        ((5, 5), 2)):
        want = TpuSession(ORACLE).range(*args, num_partitions=parts).collect()
        got = GpuSession(device="cpu").range(
            *args, num_partitions=parts).collect()
        assert got == want, args
    sess = GpuSession({"spark.rapids.sql.batchSizeRows": "1000"},
                      device="cpu")
    parts = sess.range(0, 2_500, num_partitions=2).collect_partitions()
    assert [[b.num_rows for b in p] for p in parts] == [[1000, 250],
                                                        [1000, 250]]


@pytest.fixture(scope="module")
def blooms():
    """The reference's and the port's build_bloom over range(0, 5000, 5)
    (test_hashing_sketches.py:62-63)."""
    want = TpuSession().range(0, 5000, 5).build_bloom(
        jcol("id"), expected_items=1000, fpp=0.03)
    got = GpuSession(device="cpu").range(0, 5000, 5).build_bloom(
        E.col("id"), expected_items=1000, fpp=0.03)
    return want, got


def test_bloom_bits_equal_reference_and_round_trip(blooms):
    want, got = blooms
    assert (got.num_bits, got.k) == (want.num_bits, want.k) == (7360, 5)
    assert np.array_equal(got.bits, want.bits)
    blob = got.serialize()
    assert blob == want.serialize()
    back = BK.PyBloomFilter.from_bytes(blob)
    assert np.array_equal(back.bits, got.bits) and back.k == got.k
    assert np.array_equal(JB.PyBloomFilter.from_bytes(blob).bits, got.bits)


def test_bloom_probe_rows_equal_reference(blooms):
    """might_contain over range(0, 5000): the port's rows equal the JAX
    CPU oracle's; no false negatives, bounded false positives
    (test_hashing_sketches.py:72-83)."""
    want_f, got_f = blooms
    want = TpuSession(ORACLE).range(0, 5000).filter(
        JBloomFilterMightContain(jcol("id"), want_f)).collect()
    got = GpuSession(device="cpu").range(0, 5000).filter(
        E.BloomFilterMightContain(E.col("id"), got_f)).collect()
    assert got == want
    members = {r[0] for r in got}
    assert all(v in members for v in range(0, 5000, 5))
    assert len(members) - 1000 < 400


def test_bloom_probe_null_is_null():
    sess = GpuSession(device="cpu")
    f = sess.range(0, 100).build_bloom(E.col("id"), expected_items=100)
    t = pa.table({"l": pa.array([1, None, 3, 1000], pa.int64())})
    df = sess.create_dataframe([arrow_to_batch(t, "cpu")])
    rows = df.select(E.BloomFilterMightContain(E.col("l"), f).alias("m"),
                     E.col("l")).collect()
    assert [r[0] for r in rows][:3] == [True, None, True]


def test_bloom_python_oracle_matches_port_build():
    """test_hashing_sketches.py:86-96."""
    dev = GpuSession(device="cpu").range(0, 300, 3).build_bloom(
        E.col("id"), expected_items=100)
    py = BK.PyBloomFilter(dev.num_bits, dev.k)
    for v in range(0, 300, 3):
        py.put(v)
    assert np.array_equal(dev.bits, py.bits)


def test_might_contain_probes_long_only():
    sess = GpuSession(device="cpu")
    f = sess.range(0, 10).build_bloom(E.col("id"), expected_items=10)
    tables = _sketch_tables()
    df = sess.create_dataframe([arrow_to_batch(t, "cpu") for t in tables])
    with pytest.raises(NotImplementedError, match="probes LONG values"):
        df.filter(E.BloomFilterMightContain(E.col("i"), f)).collect()


def _acd_rows(jq, pq):
    want = sorted(jq.collect(), key=repr)
    got = sorted(pq.collect(), key=repr)
    assert got == want
    return got


def test_approx_count_distinct_global_equals_reference():
    jdf, pdf = _frames(_sketch_tables(), TpuSession(ORACLE),
                       GpuSession(device="cpu"), 2)
    rows = _acd_rows(jdf.agg(j_acd(jcol("l")).alias("acd"),
                             jcount().alias("n")),
                     pdf.agg(E.approx_count_distinct("l").alias("acd"),
                             E.count().alias("n")))
    est, n = rows[0]
    assert n == 400 and 0.8 * 400 < est < 1.2 * 400


def test_approx_count_distinct_grouped_equals_reference():
    conf = {"spark.rapids.sql.batchSizeRows": str(1 << 14)}
    jdf, pdf = _frames(_sketch_tables(), TpuSession({**ORACLE, **conf}),
                       GpuSession(conf, device="cpu"), 2)
    rows = _acd_rows(jdf.group_by("g").agg(j_acd(jcol("i")).alias("acd")),
                     pdf.group_by("g").agg(
                         E.approx_count_distinct("i").alias("acd")))
    assert len(rows) == 4
    assert all(50 < est < 150 for _, est in rows)


def test_approx_count_distinct_wide_equals_reference():
    """20,000 distinct ids at rsd 0.05, within 3 sigma; also at p = 4 and
    p = 12 and grouped across the exchange."""
    jsess, psess = TpuSession(ORACLE), GpuSession(
        {"spark.rapids.sql.batchSizeRows": "8192"}, device="cpu")
    rows = _acd_rows(
        jsess.range(20_000, num_partitions=3).agg(
            j_acd(jcol("id")).alias("a"), j_acd(jcol("id"), 0.3).alias("b"),
            j_acd(jcol("id"), 0.02).alias("c")),
        psess.range(20_000, num_partitions=3).agg(
            E.approx_count_distinct("id").alias("a"),
            E.approx_count_distinct("id", 0.3).alias("b"),
            E.approx_count_distinct("id", 0.02).alias("c")))
    assert abs(rows[0][0] - 20_000) < 0.15 * 20_000
    _acd_rows(
        jsess.range(20_000, num_partitions=3).select(
            (jcol("id") % 7).alias("g"), jcol("id")).group_by("g").agg(
            j_acd(jcol("id")).alias("a")),
        psess.range(20_000, num_partitions=3).select(
            (E.col("id") % 7).alias("g"), E.col("id")).group_by("g").agg(
            E.approx_count_distinct("id").alias("a")))


def test_global_approx_count_distinct_updates_one_sketch(monkeypatch):
    """The global partial hashes each batch into one sketch (no starts:
    the global kernel on the card), and the final merge folds the
    partials as one segment."""
    from spark_rapids_tpu_torch.plan.execs import aggregate as AGG
    seen = {"update": [], "merge": []}
    update, merge = AGG.hll_update, AGG.hll_merge

    def spy_update(col, p, starts=None):
        seen["update"].append(starts)
        return update(col, p, starts)

    def spy_merge(regs, validity, starts):
        seen["merge"].append(starts.tolist())
        return merge(regs, validity, starts)

    monkeypatch.setattr(AGG, "hll_update", spy_update)
    monkeypatch.setattr(AGG, "hll_merge", spy_merge)
    sess = GpuSession(device="cpu")
    got = sess.range(0, 600, num_partitions=3).agg(
        E.approx_count_distinct("id").alias("a")).collect()
    assert seen["update"] and all(s is None for s in seen["update"])
    assert seen["merge"] and all(s == [0] for s in seen["merge"])
    assert abs(got[0][0] - 600) < 0.15 * 600


def test_approx_count_distinct_over_no_rows_is_zero():
    sess = GpuSession(device="cpu")
    assert sess.range(5, 5, num_partitions=2).agg(
        E.approx_count_distinct("id").alias("a")).collect() == [(0,)]


@pytest.mark.parametrize("column", ["s", "d"])
def test_approx_count_distinct_string_or_float_raises(column):
    """The reference falls back to its CPU (test_hashing_sketches.py:
    110-114); the port has none, so planning raises its reason."""
    sess = GpuSession(device="cpu")
    df = sess.create_dataframe([arrow_to_batch(t, "cpu")
                                for t in _sketch_tables()])
    with pytest.raises(NotImplementedError,
                       match="hashes long-representable values"):
        df.agg(E.approx_count_distinct(column).alias("a")).collect()


def test_grouped_approx_count_distinct_cap_raises():
    """batchSizeRows * 2^p <= 2^26: 131,072 rows at p = 9 is the most."""
    tables = _sketch_tables()
    for rows, ok in ((131_072, True), (131_073, False)):
        sess = GpuSession({"spark.rapids.sql.batchSizeRows": str(rows)},
                          device="cpu")
        df = sess.create_dataframe([arrow_to_batch(t, "cpu")
                                    for t in tables])
        q = df.group_by("g").agg(E.approx_count_distinct("l").alias("a"))
        if ok:
            assert len(q.collect()) == 4
        else:
            with pytest.raises(NotImplementedError,
                               match="needs batchSizeRows \\* 2\\^p"):
                q.collect()


def test_sketch_chains_run_op_by_op():
    """might_contain and an HLL slot have no program instruction: their
    chains are not fused segments, and give the same rows unfused."""
    sess = GpuSession(device="cpu")
    f = sess.range(0, 300, 3).build_bloom(E.col("id"), expected_items=100)
    df = sess.range(0, 600, num_partitions=2)
    q = df.filter(E.BloomFilterMightContain(E.col("id"), f)).agg(
        E.approx_count_distinct("id").alias("a"), E.count().alias("n"))
    assert "GpuFusedSegment" not in q.explain()
    plain = GpuSession(UNFUSED, device="cpu").range(0, 600, num_partitions=2)
    want = plain.filter(E.BloomFilterMightContain(E.col("id"), f)).agg(
        E.approx_count_distinct("id").alias("a"), E.count().alias("n"))
    assert q.collect() == want.collect()
    assert q.collect()[0][1] >= 100
