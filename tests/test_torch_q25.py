"""TPC-DS q25 through the port's GpuSession on the CPU, against the JAX
package's CPU oracle (``spark.rapids.sql.enabled=false``: its rows equal
its device path's within 1e-9 on these tables) on the same tables:
store_sales 24,000 rows,
store_returns 8,000 (90% copied from sales), catalog_sales 12,000 (70%
copied from the returns' (customer, item) pairs), 2 partitions each, as
tests/test_tpcds_gauntlet.py:55 draws them; date_dim, store and item as
generated.

The port's generators must give the reference's tables row for row, and
q25's rows must be the reference's in order: keys exact, sums within
1e-12 relative (the packages add in different orders).  The JAX query runs
once per module, the tables drawn once for the generator cases (which do
not wait for it).  The port runs it twice: with
``broadcastRowThreshold=1000`` and 4 shuffle partitions, where the
store_sales x store_returns join is adaptive and goes shuffled, the
catalog_sales join is a planned shuffled join whose sides are read
through coalesced readers sharing one spec, and the date_dim joins are
adaptive and broadcast; and with the default threshold, where every join
broadcasts.  LIMIT is checked beside.
"""
import pyarrow as pa
import pytest

from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpcds as jax_tpcds

from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.plan.engine import GpuEngine
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuCoalescedShuffleReaderExec, GpuShuffleExchangeExec)
from spark_rapids_tpu_torch.plan.execs.join import (
    GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.plan.execs.scan import GpuInMemoryScanExec
from spark_rapids_tpu_torch.plan.execs.sort import GpuLimitExec
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds

F64_RTOL = 1e-12
N_SS, N_SR, N_CS = 24_000, 8_000, 12_000
SS_BATCH, SR_BATCH, CS_BATCH = N_SS // 3 + 1, 4001, 6001
SS_POOL = ["ss_ticket_number", "ss_item_sk", "ss_customer_sk",
           "ss_sold_date_sk"]
SR_POOL = ["sr_customer_sk", "sr_item_sk", "sr_returned_date_sk"]
THR = "spark.rapids.sql.join.broadcastRowThreshold"
SHUFFLED_CONF = {THR: "1000", "spark.sql.shuffle.partitions": "4"}


@pytest.fixture(scope="module")
def tables():
    """The reference's six tables as Arrow (facts as lists of batches)."""
    ss = jax_tpcds.gen_store_sales(N_SS, batch_rows=SS_BATCH)
    sr = jax_tpcds.gen_store_returns(N_SR, sales=ss, match_frac=0.9,
                                     batch_rows=SR_BATCH)
    pool = jax_tpcds.host_pool(sr, SR_POOL)
    cs = jax_tpcds.gen_catalog_sales(N_CS, pair_pool=pool, match_frac=0.7,
                                     batch_rows=CS_BATCH)
    tables = {"ss": [b.to_arrow() for b in ss],
              "sr": [b.to_arrow() for b in sr],
              "cs": [b.to_arrow() for b in cs],
              "dd": jax_tpcds.gen_date_dim().to_arrow(),
              "store": jax_tpcds.gen_store().to_arrow(),
              "item": jax_tpcds.gen_item().to_arrow()}
    return tables


@pytest.fixture(scope="module")
def reference(tables):
    """The reference's tables and its q25 rows (its CPU oracle)."""
    sess = TpuSession({"spark.rapids.sql.enabled": "false"})

    def df(name, parts=1):
        t = tables[name]
        return sess.create_dataframe(
            [JaxBatch.from_arrow(b) for b in (t if isinstance(t, list)
                                              else [t])],
            num_partitions=parts)
    rows = jax_tpcds.q25(df("ss", 2), df("sr", 2), df("cs", 2), df("dd"),
                         df("store"), df("item")).collect()
    return tables, rows


def _port_dfs(tables, conf=None):
    sess = GpuSession(conf, device="cpu")

    def df(name, parts=1):
        t = tables[name]
        return sess.create_dataframe(
            [arrow_to_batch(b, "cpu") for b in (t if isinstance(t, list)
                                                else [t])],
            num_partitions=parts)
    return (df("ss", 2), df("sr", 2), df("cs", 2), df("dd"), df("store"),
            df("item"))


def _assert_rows_in_order(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g[:4] == r[:4]
        for a, b in zip(g[4:], r[4:]):
            assert a == pytest.approx(b, rel=F64_RTOL)


def _nodes(node, seen=None):
    """Every exec of a tree once, the adaptive joins' chosen execs (which
    hold the adaptive join's own children) included."""
    seen = set() if seen is None else seen
    if id(node) in seen:
        return
    seen.add(id(node))
    yield node
    kids = list(node.children)
    if isinstance(node, GpuAdaptiveJoinExec) and node.inner is not None:
        kids.append(node.inner)
    for k in kids:
        yield from _nodes(k, seen)


def _right_names(join):
    return set(join.children[1].schema.names)


@pytest.mark.parametrize("table", ["store_returns", "catalog_sales",
                                   "store"])
def test_tpcds_generators_match_reference(tables, table):
    """The pools come from the host chunks, their null slots zeroed as the
    reference's device read-back gives them; each fact chunk reseeds, so
    the same batch_rows."""
    if table == "store":
        assert port_tpcds.gen_store("cpu").to_arrow().equals(tables["store"])
        return
    ss_pool = port_tpcds.host_pool(
        port_tpcds.iter_store_sales(N_SS, batch_rows=SS_BATCH), SS_POOL)
    sr = port_tpcds.gen_store_returns(N_SR, "cpu", pool=ss_pool,
                                      match_frac=0.9, batch_rows=SR_BATCH)
    if table == "store_returns":
        got, want = sr, tables["sr"]
        zero = pa.compute.sum(pa.compute.equal(
            pa.concat_tables(want).column("sr_customer_sk"), 0)).as_py()
        assert zero > 0    # the pooled null customers
    else:
        sr_pool = port_tpcds.host_pool(
            port_tpcds.iter_store_returns(N_SR, pool=ss_pool, match_frac=0.9,
                                          batch_rows=SR_BATCH), SR_POOL)
        got = port_tpcds.gen_catalog_sales(N_CS, "cpu", pair_pool=sr_pool,
                                           match_frac=0.7,
                                           batch_rows=CS_BATCH)
        want = tables["cs"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_arrow().equals(w)


def test_q25_shuffled_matches_reference_in_order(reference):
    """Threshold 1000, 4 shuffle partitions: the reference's plan shapes
    and its rows, in order."""
    tables, ref = reference
    plan = port_tpcds.q25(*_port_dfs(tables, SHUFFLED_CONF)).physical_plan()
    got = GpuEngine().collect(plan)
    _assert_rows_in_order(got, ref)
    assert isinstance(plan, GpuLimitExec) and plan.n == 100
    nodes = list(_nodes(plan))
    adaptive = [n for n in nodes if isinstance(n, GpuAdaptiveJoinExec)]
    chosen = {name: n.chosen for n in adaptive for name in _right_names(n)}
    assert chosen["sr_ticket_number"] == "shuffled"     # ss x sr
    assert chosen["d1_date_sk"] == "broadcast"
    planned = [n for n in nodes if isinstance(n, GpuShuffledHashJoinExec)
               and "cs_item_sk" in _right_names(n)]
    assert len(planned) == 1
    readers = planned[0].children
    assert all(isinstance(r, GpuCoalescedShuffleReaderExec) for r in readers)
    assert readers[0].spec is readers[1].spec
    assert all(isinstance(r.children[0], GpuShuffleExchangeExec)
               for r in readers)
    # every shuffled join took the streamed probe
    shuffled = [n for n in nodes if isinstance(n, GpuShuffledHashJoinExec)]
    assert len(shuffled) >= 2
    assert all(set(n.branches) == {"streamed"} for n in shuffled)


def test_q25_broadcast_matches_reference_in_order(reference):
    """The default threshold: all seven joins broadcast."""
    tables, ref = reference
    plan = port_tpcds.q25(*_port_dfs(tables)).physical_plan()
    got = GpuEngine().collect(plan)
    _assert_rows_in_order(got, ref)
    joins = [n for n in _nodes(plan) if isinstance(
        n, (GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec,
            GpuAdaptiveJoinExec))]
    assert len(joins) == 7
    assert all(isinstance(n, GpuBroadcastHashJoinExec) for n in joins)


def test_q25_physical_plan_runs_nothing(reference):
    """Planning never runs an exchange's map side or an adaptive join's
    decision, and the aliased date_dim projections keep the one column q25
    reads of each."""
    tables, _ = reference
    plan = port_tpcds.q25(*_port_dfs(tables, SHUFFLED_CONF)).physical_plan()
    nodes = list(_nodes(plan))
    exchanges = [n for n in nodes if isinstance(n, GpuShuffleExchangeExec)]
    assert exchanges and all(n._store is None for n in exchanges)
    adaptive = [n for n in nodes if isinstance(n, GpuAdaptiveJoinExec)]
    assert len(adaptive) == 5     # ss x sr, three date_dims, item
    assert all(n.chosen is None and n.inner is None for n in adaptive)
    readers = [n for n in nodes
               if isinstance(n, GpuCoalescedShuffleReaderExec)]
    assert len(readers) == 3      # the cs join's two, the final aggregate's
    assert all(n.spec._groups is None for n in readers)
    for n in adaptive:
        names = _right_names(n)
        if any(x.startswith("d") and x[1] in "123" for x in names):
            assert len(names) == 1 and min(names).endswith("_date_sk")


def _limit_df(n):
    t = pa.table({"k": pa.array(list(range(20)), pa.int32()),
                  "s": pa.array([f"r{i}" for i in range(20)])})
    sess = GpuSession({"spark.rapids.sql.batchSizeRows": "4"}, device="cpu")
    return sess.create_dataframe(t, num_partitions=2).limit(n)


@pytest.mark.parametrize("n,want,batches_read", [
    (6, [0, 1, 2, 3, 8, 9], 2),        # cuts the second batch
    (12, [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19], 3),  # all of part 0
    (0, [], 0),
    (30, [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19, 4, 5, 6, 7, 12, 13, 14,
          15], 5),
])
def test_limit_cuts_inside_a_batch_and_between_partitions(n, want,
                                                          batches_read):
    """Batches of 4 rows go round robin to 2 partitions (partition 0 holds
    rows 0-3, 8-11 and 16-19); the limit reads partitions in order and
    stops as soon as it has n rows, reading no further batch."""
    plan = _limit_df(n).physical_plan()
    assert isinstance(plan, GpuLimitExec)
    got = GpuEngine().collect(plan)
    assert [r[0] for r in got] == want
    assert [r[1] for r in got] == [f"r{i}" for i in want]
    scan = plan.children[0]
    assert isinstance(scan, GpuInMemoryScanExec)
    assert scan.output_batches.value == batches_read


class _Counts:
    """Stands in for a hash exchange: its reduce partitions' row counts."""

    def __init__(self, counts, schema):
        self.counts, self.schema = counts, schema

    def partition_row_counts(self):
        return list(self.counts)


@pytest.mark.parametrize("counts,target,want", [
    # add, then close at acc >= target (exchange.py:466-474)
    (([5, 5, 5, 10, 1], [0, 0, 0, 0, 0]), 10, [[0, 1], [2, 3], [4]]),
    (([5, 5, 5, 10, 1], [5, 0, 0, 0, 0]), 10, [[0], [1, 2], [3], [4]]),
    (([1, 1, 1, 1], [1, 1, 1, 1]), 100, [[0, 1, 2, 3]]),
    (([162, 161], [900, 899]), 1048, [[0], [1]]),
])
def test_shared_coalesce_spec_merges_both_sides_counts(counts, target, want):
    """Adjacent partitions merge until the rows of both join sides reach
    the target; both readers see the one grouping."""
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.execs.exchange import SharedCoalesceSpec
    schema = Schema(("k",), (T.INT,))
    spec = SharedCoalesceSpec(target)
    for c in counts:
        spec.register(_Counts(c, schema))
    assert spec.groups() == want
    # the byte goal caps the rows: 5 bytes a row (int32 + validity)
    capped = SharedCoalesceSpec(10**9, target_bytes=5 * target)
    for c in counts:
        capped.register(_Counts(c, schema))
    assert capped.groups() == want


def test_shuffled_join_over_target_raises_out_of_core(reference):
    """A build partition above batchSizeRows takes the reference's
    out-of-core branch (spillable co-buckets joined pairwise), which gives
    the rows of the in-core join."""
    tables, _ = reference
    from spark_rapids_tpu_torch import expressions as PE
    rows = {}
    for target in ("1000", "1000000"):
        ss, sr, *_ = _port_dfs(tables, {
            THR: "0", "spark.sql.shuffle.partitions": "2",
            "spark.rapids.sql.batchSizeRows": target})
        df = ss.join(sr, on=([PE.col("ss_ticket_number"),
                              PE.col("ss_item_sk")],
                             [PE.col("sr_ticket_number"),
                              PE.col("sr_item_sk")]))
        plan = df.physical_plan()
        assert isinstance(plan, GpuShuffledHashJoinExec)
        rows[target] = sorted(GpuEngine().collect(plan), key=repr)
        if target == "1000":
            assert plan.branches["out_of_core"] >= 1
            assert plan.largest_build_rows > 1000
            assert plan.sub_buckets >= 2
        else:
            assert plan.branches["out_of_core"] == 0
    assert rows["1000"] == rows["1000000"] and rows["1000"]


@pytest.mark.parametrize("conf,adaptive,shuffled,readers", [
    # six planned shuffled joins (all but store's), each side read
    # through a reader, and the final aggregate's reader
    ({"spark.rapids.sql.join.adaptive.enabled": "false"}, 0, 6, 13),
    # the adaptive joins decide as before; no exchange has a reader
    ({"spark.rapids.sql.adaptive.coalescePartitions.enabled": "false"}, 5,
     3, 0),
])
def test_q25_without_adaptive_joins_or_readers(reference, conf, adaptive,
                                               shuffled, readers):
    """The two switches the slice adds, each turned off under threshold
    1000: the plan changes, the rows stay the reference's."""
    tables, ref = reference
    plan = port_tpcds.q25(*_port_dfs(tables, {**SHUFFLED_CONF, **conf})
                          ).physical_plan()
    got = GpuEngine().collect(plan)
    _assert_rows_in_order(got, ref)
    nodes = list(_nodes(plan))
    assert sum(isinstance(n, GpuAdaptiveJoinExec) for n in nodes) == adaptive
    assert sum(isinstance(n, GpuShuffledHashJoinExec)
               for n in nodes) == shuffled
    assert sum(isinstance(n, GpuCoalescedShuffleReaderExec)
               for n in nodes) == readers
