"""The port's out-of-core paths and its range sort on the CPU, against the
JAX package's CPU oracle (``spark.rapids.sql.enabled=false``).

The 14 cases of ``tests/test_out_of_core.py`` (inputs of 8,192 rows, 16
times a 512-row ``batchSizeRows``, so that the sort, the aggregate, the
join and the window take their out-of-core branches), the 5 of
``tests/test_range_sort.py`` (each also at a batch target small enough
that the range sort samples and routes), the two-pass huge window key of
``tests/test_window.py:196``, and q72's join chain with a ``batchSizeRows``
below its inventory build partitions.  The injected-OOM cases of
``tests/test_tpch.py:32``, ``tests/test_tpcds_gauntlet.py:133``,
``tests/test_agg_tail.py:192``, ``tests/test_decimal128.py:165`` and
``tests/test_window.py:128`` (and q72's chain) run through this file's
``inject_oom`` fixture, which arms the port's own injection.  The right and full joins
of the reference's join case are in tests/test_torch_outer_join.py.

Tolerance: keys, counts and integer sums exact; floats within bench.py's
rule, |a - b| <= 1e-6 * max(1, |b|) (sums run in another order); rows in
order where the query ends in a sort, else sorted first.
"""
import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.batch import Schema as JaxSchema
from spark_rapids_tpu.kernels.sort import SortOrder as JaxOrder
from tests.test_queries import _normalize

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.kernels.sort import SortOrder as PortOrder
from spark_rapids_tpu_torch.memory import device_arena, spill_framework
from spark_rapids_tpu_torch.memory import metrics as task_metrics
from spark_rapids_tpu_torch.memory import retry as retry_mod
from spark_rapids_tpu_torch.plan.engine import GpuEngine
from spark_rapids_tpu_torch.plan.execs.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.plan.execs.join import GpuShuffledHashJoinExec
from spark_rapids_tpu_torch.plan.execs.range_sort import GpuRangeSortExec
from spark_rapids_tpu_torch.plan.execs.sort import GpuSortExec
from spark_rapids_tpu_torch.plan.execs.window import GpuWindowExec
from spark_rapids_tpu_torch.testing import held
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds
from spark_rapids_tpu_torch.testing import tpch as port_tpch

TARGET_ROWS = 512
N = 8192
ORACLE = {"spark.rapids.sql.enabled": "false"}
DSL = {"jax": (JE, JaxOrder), "port": (PE, PortOrder)}
COLS = (("k", "INT"), ("v", "LONG"), ("x", "DOUBLE"), ("s", "STRING"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six pytest workers' torch thread pools contend: one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def inject_oom():
    """Arm the port's OOM injection (``memory.retry``), one retry OOM, as
    the reference's @inject_oom marker arms its own."""
    before = task_metrics.get().retry_count
    retry_mod.enable_oom_injection(num_ooms=1, skip=0, kind="retry")
    try:
        yield
        assert task_metrics.get().retry_count > before
    finally:
        retry_mod.disable_oom_injection()


def _conf(extra=None):
    conf = {"spark.rapids.sql.batchSizeRows": str(TARGET_ROWS),
            "spark.rapids.sql.join.broadcastRowThreshold": "0",
            "spark.sql.shuffle.partitions": "2"}
    conf.update(extra or {})
    return conf


def big_data(seed=0, n=N, nkeys=500):
    """``tests/test_out_of_core.py`` ``big_source``'s columns."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, nkeys, n)
    data = {"k": k.tolist(), "v": rng.randint(-10**9, 10**9, n).tolist(),
            "x": rng.randn(n).tolist(),
            "s": [f"s{val % 97}" for val in k.tolist()]}
    for cname in ("k", "v", "x"):
        vals = data[cname]
        for idx in rng.choice(n, size=n // 11, replace=False):
            vals[idx] = None
    return data


def _frame(which, sess, data, cols=COLS, num_partitions=2, step=TARGET_ROWS):
    """The same batches, in the same order, for either package."""
    n = len(data[cols[0][0]])
    pieces = [{c: data[c][o:o + step] for c, _ in cols}
              for o in range(0, n, step)]
    if which == "jax":
        sch = JaxSchema(tuple(c for c, _ in cols),
                        tuple(getattr(JT, t) for _, t in cols))
        batches = [JaxBatch.from_pydict(p, sch) for p in pieces]
    else:
        sch = Schema(tuple(c for c, _ in cols),
                     tuple(getattr(T, t) for _, t in cols))
        batches = [ColumnarBatch.from_pydict(p, sch, "cpu") for p in pieces]
    return sess.create_dataframe(batches, num_partitions=num_partitions)


def _eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return abs(a - b) <= 1e-6 * max(1.0, abs(b))
    return a == b


def assert_rows(got, want, ordered):
    if not ordered:
        got, want = _normalize(got), _normalize(want)
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) and all(_eq(x, y) for x, y in zip(g, w)), \
            (i, g, w)


def run_port(build, conf):
    """(rows, plan) of build('port', session) under conf."""
    df = build("port", GpuSession(conf, device="cpu"))
    plan = df.physical_plan()
    rows = GpuEngine().collect(plan)
    assert not spill_framework().leaked_handles()
    assert device_arena().used_bytes == 0
    return rows, plan


def assert_ooc_equal(build, ordered=False, extra_conf=None):
    """build(which, session) -> DataFrame; the port at the small batch
    target against the oracle.  Returns the port's plan."""
    want = build("jax", TpuSession(ORACLE)).collect()
    got, plan = run_port(build, _conf(extra_conf))
    assert_rows(got, want, ordered)
    return plan


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)


def _branches(plan, cls):
    out = {}
    for n in _nodes(plan):
        if isinstance(n, cls):
            for k, v in n.branches.items():
                out[k] = out.get(k, 0) + v
    return out


def src(which, sess, seed=0, n=N, nkeys=500, num_partitions=2):
    return _frame(which, sess, big_data(seed, n, nkeys),
                  num_partitions=num_partitions)


# -- tests/test_out_of_core.py ----------------------------------------------

def _sort_global(which, s):
    E, O = DSL[which]
    return src(which, s, num_partitions=1).order_by(
        (E.col("v"), O(ascending=True, nulls_first=True)))


def test_ooc_sort_global():
    plan = assert_ooc_equal(_sort_global, ordered=True)
    assert _branches(plan, GpuSortExec) == {"out_of_core": 1}


def test_ooc_sort_desc_multikey():
    def build(which, s):
        E, O = DSL[which]
        return src(which, s, num_partitions=1).order_by(
            (E.col("k"), O(ascending=False, nulls_first=False)),
            (E.col("x"), O(ascending=True, nulls_first=True)))
    assert_ooc_equal(build, ordered=True)


def test_ooc_sort_heavy_duplicates():
    def build(which, s):
        E, O = DSL[which]
        return src(which, s, nkeys=3, num_partitions=1).order_by(
            (E.col("k"), O(ascending=True, nulls_first=True))).select(
            E.col("k"), E.col("v"))
    assert_ooc_equal(build, ordered=True)


def _groupby(which, s, n=N):
    E, _ = DSL[which]
    return src(which, s, n=n).group_by(E.col("k")).agg(
        E.count(E.lit(1)).alias("n"), E.sum_(E.col("v")).alias("sv"),
        E.min_(E.col("x")).alias("mx"), E.max_(E.col("v")).alias("xv"),
        E.avg(E.col("x")).alias("ax"))


def test_ooc_groupby():
    plan = assert_ooc_equal(_groupby)
    assert _branches(plan, GpuHashAggregateExec).get("out_of_core", 0) >= 1


def test_ooc_groupby_string_key():
    def build(which, s):
        E, _ = DSL[which]
        return src(which, s).group_by(E.col("s")).agg(
            E.count(E.lit(1)).alias("n"), E.sum_(E.col("v")).alias("sv"))
    assert_ooc_equal(build)


def test_ooc_global_agg():
    def build(which, s):
        E, _ = DSL[which]
        return src(which, s).agg(
            E.count(E.lit(1)).alias("n"), E.sum_(E.col("v")).alias("sv"),
            E.min_(E.col("v")).alias("mn"))
    assert_ooc_equal(build)


def _join(which, s, how="inner", n=N // 4, key="k"):
    E, _ = DSL[which]
    left = src(which, s, seed=1, n=n, nkeys=800)
    right = src(which, s, seed=2, n=n // 2, nkeys=800).select(
        E.col(key).alias("r" + key), E.col("v").alias("rv"))
    return left.join(right, on=([E.col(key)], [E.col("r" + key)]), how=how)


@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi",
                                       "left_anti"])
def test_ooc_shuffled_join_small(join_type):
    plan = assert_ooc_equal(lambda w, s: _join(w, s, join_type))
    assert _branches(plan, GpuShuffledHashJoinExec).get("out_of_core") >= 1


def test_ooc_join_string_keys_small():
    assert_ooc_equal(lambda w, s: _join(w, s, key="s"))


def test_ooc_broadcast_stream_chunking():
    def build(which, s):
        E, _ = DSL[which]
        left = src(which, s, seed=3)
        right = src(which, s, seed=4, n=64, num_partitions=1).select(
            E.col("k").alias("rk"), E.col("v").alias("rv"))
        return left.join(right, on=([E.col("k")], [E.col("rk")]))
    assert_ooc_equal(build, extra_conf={
        "spark.rapids.sql.join.broadcastRowThreshold": "100000"})


def test_ooc_sort_inject_oom(inject_oom):
    def build(which, s):
        E, O = DSL[which]
        return src(which, s, n=N // 2, num_partitions=1).order_by(
            (E.col("v"), O(ascending=True, nulls_first=True)))
    assert_ooc_equal(build, ordered=True)


def test_ooc_groupby_inject_oom(inject_oom):
    def build(which, s):
        E, _ = DSL[which]
        return src(which, s, n=N // 2).group_by(E.col("k")).agg(
            E.count(E.lit(1)).alias("n"), E.sum_(E.col("v")).alias("sv"))
    assert_ooc_equal(build)


def test_ooc_join_inject_oom(inject_oom):
    assert_ooc_equal(lambda w, s: _join(w, s, n=N // 2))


def test_ooc_spill_pressure():
    """The out-of-core group-by with the arena's budget below its queued
    buckets and a host tier of 64 KB: handles go to the host and on to
    disk, checksummed, and come back."""
    fw = spill_framework()
    m0 = dict(fw.metrics.as_dict())
    device_arena().budget_bytes = 1 << 17
    try:
        assert_ooc_equal(_groupby, extra_conf={
            "spark.rapids.memory.host.spillStorageSize": str(1 << 16)})
    finally:
        fw.host_limit_bytes = 1 << 30
        device_arena().budget_bytes = 0
    m = fw.metrics.as_dict()
    for k in ("spill_to_host_bytes", "spill_to_disk_bytes",
              "read_spill_bytes"):
        assert m[k] > m0[k], k
    assert m["corruption_errors"] == m0["corruption_errors"]


def _groupby_v(which, s):
    """GROUP BY a near-unique key: the partials are as large as the
    input, 8 map batches of 1,024 rows, so that each shuffle block (~470
    rows) leaves a run of the 512-row target open."""
    E, _ = DSL[which]
    return _frame(which, s, big_data(nkeys=500), num_partitions=8,
                  step=N // 8).group_by(E.col("v")).agg(
        E.count(E.lit(1)).alias("n"), E.sum_(E.col("k")).alias("sk"))


def test_ooc_groupby_reads_the_store_under_a_quarter_of_it():
    """Phase 18 (b)'s squeeze at a small size: the arena's budget a
    quarter of the shuffle store (two of its eight map batches) and a
    64 KB host tier.  The final aggregate reads the store a block at a
    time and no reader keeps a block's view past it, so each stored batch
    can spill before the next is brought back; the rows are the
    oracle's."""
    from spark_rapids_tpu_torch.plan.execs.exchange import \
        GpuShuffleExchangeExec
    plan = _groupby_v("port", GpuSession(_conf(), device="cpu")) \
        .physical_plan()
    try:
        for p in range(plan.num_partitions()):
            for _ in plan.execute_partition(p):
                pass
        store = sum(n._store.stored_bytes() for n in _nodes(plan)
                    if isinstance(n, GpuShuffleExchangeExec))
    finally:
        plan.cleanup()
    fw = spill_framework()
    m0 = dict(fw.metrics.as_dict())
    device_arena().budget_bytes = store // 4
    try:
        plan = assert_ooc_equal(_groupby_v, extra_conf={
            "spark.rapids.memory.host.spillStorageSize": str(1 << 16)})
    finally:
        fw.host_limit_bytes = 1 << 30
        device_arena().budget_bytes = 0
    assert _branches(plan, GpuHashAggregateExec)["out_of_core"] >= 1
    m = fw.metrics.as_dict()
    for k in ("spill_to_host_bytes", "spill_to_disk_bytes",
              "read_spill_bytes"):
        assert m[k] > m0[k], k


def test_ooc_window_key_batched():
    def running(which, s):
        E, _ = DSL[which]
        return src(which, s, nkeys=200).with_column(
            "w", E.over(E.sum_("v"), partition_by=["k"], order_by=["v"]))

    def rows_frame(which, s):
        E, _ = DSL[which]
        return src(which, s, nkeys=200).with_column(
            "w", E.over(E.min_("v"), partition_by=["k"], order_by=["v"],
                        frame=E.WindowFrame("rows", -3, 3)))
    for build in (running, rows_frame):
        plan = assert_ooc_equal(build)
        assert _branches(plan, GpuWindowExec) == {"out_of_core": 2}


# -- tests/test_window.py:196: one partition key past every batch ----------

def test_unbounded_agg_two_pass_huge_key():
    """tests/test_window.py:196: one key holds half the rows (far past a
    batchSizeRows of 256), every frame the whole partition: the two-pass
    path, its per-key states merged on the host (double-double sums,
    Spark's MIN / MAX order), gives the oracle's rows; a NaN and a -0.0
    ride in x."""
    rng = np.random.RandomState(8)
    n = 2000
    data = {"k": [1] * (n // 2) + rng.randint(2, 6, n - n // 2).tolist(),
            "v": rng.randint(-50, 50, n).tolist(),
            "x": rng.randn(n).tolist()}
    for i in rng.choice(n, n // 7, replace=False):
        data["v"][i] = None
    data["x"][10], data["x"][20] = float("nan"), -0.0
    cols = (("k", "INT"), ("v", "LONG"), ("x", "DOUBLE"))

    def build(which, s):
        E, _ = DSL[which]
        return _frame(which, s, data, cols, step=250).select(
            E.col("k"), E.col("v"),
            E.over(E.sum_("v"), partition_by=["k"]).alias("sv"),
            E.over(E.count("v"), partition_by=["k"]).alias("nv"),
            E.over(E.count(), partition_by=["k"]).alias("nr"),
            E.over(E.min_("v"), partition_by=["k"]).alias("mn"),
            E.over(E.max_("x"), partition_by=["k"]).alias("mx"),
            E.over(E.avg("v"), partition_by=["k"]).alias("av"),
            E.over(E.sum_("x"), partition_by=["k"]).alias("sx"))
    plan = assert_ooc_equal(build, extra_conf={
        "spark.rapids.sql.batchSizeRows": "256"})
    assert _branches(plan, GpuWindowExec).get("two_pass", 0) >= 1


# -- tests/test_range_sort.py ------------------------------------------------

RS_COLS = (("k", "INT"), ("v", "LONG"), ("x", "DOUBLE"), ("f", "FLOAT"),
           ("b", "BOOLEAN"))


def _rs_source(which, s):
    from tests.test_queries import make_data
    return _frame(which, s, make_data(), RS_COLS, num_partitions=3, step=100)


RANGE_SORTS = {
    "asc_desc": lambda w, s: _rs_source(w, s).order_by(
        ("v", DSL[w][1](False)), ("k", DSL[w][1](True))),
    "nulls_last": lambda w, s: _rs_source(w, s).order_by(
        ("x", DSL[w][1](True, nulls_first=False)), ("v", DSL[w][1](True))),
}


@pytest.mark.parametrize("target", ["1048576", "64"])
def test_global_sort_is_range_partitioned(target):
    got, plan = run_port(RANGE_SORTS["asc_desc"],
                         {"spark.rapids.sql.batchSizeRows": target})
    assert isinstance(plan, GpuRangeSortExec)
    assert "GpuRangeSort" in plan.tree_string()
    assert plan.branch == ("small" if target == "1048576" else "routed")


@pytest.mark.parametrize("target", ["1048576", "64"])
@pytest.mark.parametrize("case", list(RANGE_SORTS))
def test_range_sort_correct(case, target):
    """test_range_sort_correct_asc_desc and test_range_sort_nulls_last."""
    want = RANGE_SORTS[case]("jax", TpuSession(ORACLE)).collect()
    got, plan = run_port(RANGE_SORTS[case],
                         {"spark.rapids.sql.batchSizeRows": target})
    assert_rows(got, want, ordered=True)


WORDS = ["", "a", "ab", "ab\x00", "abc", "b", "ba", "zz", "é", "éa",
         "longer string here", "longer string", "z" * 20]


@pytest.mark.parametrize("target", ["1048576", "16"])
def test_range_sort_string_keys(target):
    rng = np.random.RandomState(3)
    n = 120
    data = {"s": [WORDS[i % len(WORDS)] for i in range(n)],
            "t": [WORDS[(i * 7 + 3) % len(WORDS)] for i in range(n)],
            "n": rng.randint(-3, 12, n).tolist()}
    for cname in ("s", "t"):
        for i in rng.choice(n, n // 6, replace=False):
            data[cname][i] = None
    cols = (("s", "STRING"), ("t", "STRING"), ("n", "INT"))

    def build(which, s):
        O = DSL[which][1]
        return _frame(which, s, data, cols, num_partitions=3,
                      step=40).order_by(("s", O(True)), ("n", O(True)),
                                        ("t", O(True)))
    want = build("jax", TpuSession(ORACLE)).collect()
    got, _ = run_port(build, {"spark.rapids.sql.batchSizeRows": target})
    assert_rows(got, want, ordered=True)


def test_range_sort_long_string_key_300_partitions():
    """A routed ORDER BY over a string key of up to 226 bytes (30 order
    words with its null word and length, past what fits a register-held
    key) in 300 partitions (299 boundaries, more than one radix pass of
    partition ids): the rows of the oracle, in order."""
    n = 900
    stem = "p" * 190
    data = {"s": [None if i % 41 == 0 else
                  stem + f"{(i * 37) % 450:05d}" + "x" * (i % 31)
                  for i in range(n)],
            "i": list(range(n))}
    cols = (("s", "STRING"), ("i", "INT"))

    def build(which, s):
        O = DSL[which][1]
        return _frame(which, s, data, cols, num_partitions=300,
                      step=3).order_by(("s", O(False)), ("i", O(True)))
    want = build("jax", TpuSession(ORACLE)).collect()
    got, plan = run_port(build, {"spark.rapids.sql.batchSizeRows": "64",
                                 "spark.sql.shuffle.partitions": "300"})
    assert isinstance(plan, GpuRangeSortExec)
    assert plan.out_partitions == 300 and plan.branch == "routed"
    assert_rows(got, want, ordered=True)


@pytest.mark.parametrize("target", ["1048576", "100"])
def test_range_sort_skewed_distribution(target):
    rng = np.random.RandomState(1)
    n = 900
    vals = np.where(rng.rand(n) < 0.8, 7, rng.randint(0, 1000, n))
    data = {"v": vals.tolist(), "i": list(range(n))}
    cols = (("v", "LONG"), ("i", "INT"))

    def build(which, s):
        return _frame(which, s, data, cols, num_partitions=3,
                      step=300).order_by(("v", DSL[which][1](True)))
    want = build("jax", TpuSession(ORACLE)).collect()
    got, plan = run_port(build, {"spark.rapids.sql.batchSizeRows": target})
    assert_rows(got, want, ordered=True)


# -- injected OOMs through whole queries -------------------------------------

def test_q6_with_injected_oom(inject_oom):
    """tests/test_tpch.py:32."""
    from spark_rapids_tpu.testing import tpch as jax_tpch
    t = port_tpch.lineitem_batches(20_000, "cpu")[0].to_arrow()
    got = port_tpch.q6(GpuSession(device="cpu").create_dataframe(
        t, num_partitions=3)).collect()
    want = jax_tpch.q6(TpuSession(ORACLE).create_dataframe(
        [JaxBatch.from_arrow(t)], num_partitions=3)).collect()
    assert_rows(got, want, ordered=True)


def test_agg_tail_with_injected_oom(inject_oom):
    """tests/test_agg_tail.py:192: the tail's queries over its table."""
    data, valid = held.tail_columns(700, 3)
    port = GpuSession(device="cpu").create_dataframe(
        held.tail_batches(data, valid, "cpu", batch_rows=250),
        num_partitions=2)
    jax = TpuSession(ORACLE).create_dataframe(
        [JaxBatch.from_arrow(b.to_arrow()) for b in
         held.tail_batches(data, valid, "cpu", batch_rows=250)],
        num_partitions=2)
    for name in ("grouped_first_last", "grouped_max_min_by", "grouped_bits"):
        assert_rows(held.TAIL_QUERIES[name](port).collect(),
                    held.TAIL_QUERIES[name](jax, JE).collect(), False)


def test_decimal128_sum_with_injected_oom(inject_oom):
    """tests/test_decimal128.py:165: the grouped Decimal128 SUM, exact."""
    from tests.test_torch_decimal128 import assert_rows as dec_rows
    from tests.test_torch_decimal128 import dec_dfs, port_rows
    q = held.DEC_AGG_QUERIES["dec_sum_grouped"]
    pdf, jdf = dec_dfs()
    dec_rows(port_rows(q(pdf)), q(jdf, JE, JT).collect())


def test_q25_with_injected_oom(inject_oom):
    """tests/test_tpcds_gauntlet.py:133: q25 (tests/test_torch_q25.py's
    tables and shuffled plan) under an injected retry OOM, in order."""
    from tests.test_torch_q25 import (CS_BATCH, N_CS, N_SR, N_SS,
                                      SHUFFLED_CONF, SR_BATCH, SR_POOL,
                                      SS_BATCH)
    from spark_rapids_tpu.testing import tpcds as jax_tpcds
    ss = jax_tpcds.gen_store_sales(N_SS, batch_rows=SS_BATCH)
    sr = jax_tpcds.gen_store_returns(N_SR, sales=ss, match_frac=0.9,
                                     batch_rows=SR_BATCH)
    cs = jax_tpcds.gen_catalog_sales(N_CS, pair_pool=jax_tpcds.host_pool(
        sr, SR_POOL), match_frac=0.7, batch_rows=CS_BATCH)
    facts = {"ss": ss, "sr": sr, "cs": cs}
    dims = {"dd": jax_tpcds.gen_date_dim(), "store": jax_tpcds.gen_store(),
            "item": jax_tpcds.gen_item()}
    oracle = TpuSession(ORACLE)
    want = jax_tpcds.q25(
        *(oracle.create_dataframe(facts[k], num_partitions=2)
          for k in ("ss", "sr", "cs")),
        *(oracle.create_dataframe([dims[k]]) for k in ("dd", "store",
                                                       "item"))).collect()
    sess = GpuSession(SHUFFLED_CONF, device="cpu")
    got = port_tpcds.q25(
        *(sess.create_dataframe([arrow_to_batch(b.to_arrow(), "cpu")
                                 for b in facts[k]], num_partitions=2)
          for k in ("ss", "sr", "cs")),
        *(sess.create_dataframe([arrow_to_batch(dims[k].to_arrow(), "cpu")])
          for k in ("dd", "store", "item"))).collect()
    assert_rows(got, want, ordered=True)
    assert len(got) == len(want) > 0


def test_q72_chain_with_injected_oom(inject_oom):
    """q72's join chain and rows (the shuffled, adaptive and broadcast
    joins of the gauntlet) under an injected retry OOM, at a batch target
    its inventory partitions pass."""
    _q72_chain_case(batch_rows="2000")


def test_window_with_injected_oom(inject_oom):
    """tests/test_window.py:128: the held W1-W7 queries."""
    data, valid = held.window_columns(300)
    for name in held.WINDOW_QUERIES:
        port = GpuSession(device="cpu").create_dataframe(
            held.window_batches(data, valid, "cpu", 100), num_partitions=3)
        jax = TpuSession(ORACLE).create_dataframe(
            [JaxBatch.from_arrow(b.to_arrow()) for b in
             held.window_batches(data, valid, "cpu", 100)],
            num_partitions=3)
        assert_rows(held.WINDOW_QUERIES[name](port).collect(),
                    held.WINDOW_QUERIES[name](jax, JE).collect(), False)


# -- q72 with its inventory join out of core ---------------------------------

def _q72_tables():
    cs = port_tpcds.gen_catalog_sales(8_000, "cpu", batch_rows=4001)
    pool = port_tpcds.host_pool(port_tpcds.iter_catalog_sales(
        8_000, batch_rows=4001), ["cs_item_sk", "cs_order_number"])
    tables = {
        "cs": cs, "inv": port_tpcds.gen_inventory(20_000, "cpu",
                                                  batch_rows=10_001),
        "cr": port_tpcds.gen_catalog_returns(3_000, "cpu", order_pool=pool,
                                             match_frac=0.6, batch_rows=1501),
        "warehouse": [port_tpcds.gen_warehouse("cpu")],
        "item": [port_tpcds.gen_item("cpu")],
        "cd": [port_tpcds.gen_customer_demographics("cpu")],
        "hd": [port_tpcds.gen_household_demographics("cpu")],
        "dd": [port_tpcds.gen_date_dim("cpu")],
        "promo": [port_tpcds.gen_promotion("cpu")]}
    return {k: [b.to_arrow() for b in v] for k, v in tables.items()}


_Q72 = {}


def _q72_chain_case(batch_rows: str):
    from tests.test_torch_q72 import FACTS, TABLES, _chain
    from spark_rapids_tpu.testing import tpcds as jax_tpcds
    if not _Q72:
        tables = _q72_tables()
        oracle = TpuSession(ORACLE)
        jdfs = {k: oracle.create_dataframe(
            [JaxBatch.from_arrow(b) for b in v],
            num_partitions=2 if k in FACTS else 1) for k, v in tables.items()}
        _Q72.update(tables=tables, q72=jax_tpcds.q72(
            *(jdfs[k] for k in TABLES)).collect(),
            chain=_chain(JE, JaxOrder, jdfs["cs"], jdfs["inv"],
                         jdfs["promo"], jdfs["cr"]).collect())
    conf = {"spark.rapids.sql.join.broadcastRowThreshold": "1000",
            "spark.sql.shuffle.partitions": "4",
            "spark.rapids.sql.batchSizeRows": batch_rows}
    sess = GpuSession(conf, device="cpu")
    dfs = {k: sess.create_dataframe([arrow_to_batch(b, "cpu") for b in v],
                                    num_partitions=2 if k in FACTS else 1)
           for k, v in _Q72["tables"].items()}
    chain = _chain(PE, PortOrder, dfs["cs"], dfs["inv"], dfs["promo"],
                   dfs["cr"]).physical_plan()
    assert GpuEngine().collect(chain) == _Q72["chain"]
    q72 = port_tpcds.q72(*(dfs[k] for k in TABLES)).physical_plan()
    assert GpuEngine().collect(q72) == _Q72["q72"]
    inv = [n for n in _nodes(q72) if isinstance(n, GpuShuffledHashJoinExec)
           and "inv_item_sk" in n.children[1].schema.names]
    assert len(inv) == 1 and inv[0].branches["out_of_core"] >= 1
    assert inv[0].largest_build_rows > int(batch_rows)


def test_q72_inventory_join_out_of_core():
    """q72 and its join chain at a batchSizeRows of 2,000, below each
    inventory build partition (~5,000 rows in 4 partitions): the
    conditional inventory join takes the out-of-core branch and the rows
    stay the oracle's, in order."""
    _q72_chain_case(batch_rows="2000")


@pytest.mark.parametrize("fuse", ["true", "false"])
def test_split_oom_halves_a_batch(fuse):
    """An injected split-and-retry OOM at the first retry site (the fused
    partial aggregate, or the unfused project) halves that batch; the rows
    stay the oracle's."""
    before = task_metrics.get().split_retry_count
    retry_mod.enable_oom_injection(num_ooms=1, skip=0, kind="split")
    try:
        assert_ooc_equal(_groupby, extra_conf={
            "spark.rapids.sql.tpu.fuseStages": fuse})
    finally:
        retry_mod.disable_oom_injection()
    assert task_metrics.get().split_retry_count == before + 1


def test_global_agg_merges_runs_past_a_one_row_target():
    """A global aggregate whose partials outnumber a batchSizeRows of 1
    merges them in runs of two until one is left."""
    def build(which, s):
        E, _ = DSL[which]
        return src(which, s, n=2048).agg(E.count().alias("n"),
                                          E.sum_(E.col("v")).alias("sv"))
    plan = assert_ooc_equal(build, extra_conf={
        "spark.rapids.sql.batchSizeRows": "1"})
    assert _branches(plan, GpuHashAggregateExec).get("out_of_core", 0) == 1
