"""TPC-DS q14a through the port's GpuSession on the CPU, against the JAX
package's CPU oracle (``spark.rapids.sql.enabled=false``: its rows equal
its device path's within 1e-9 on these tables, where the device path
compiles q14a for ~40 s) on the same tables: three channels of 3,000 sales
rows each (seeds 41, 43 and 47, 2 partitions) and 200 items, as
tests/test_tpcds.py:86 draws them.

The port's channel generators must give the reference's tables row for
row.  q14a's rows must be the reference's in order, under the rule of
``bench.py`` ``_check_rows`` (:224-235): exact but for the float sums,
which agree within 1e-6 relative (the packages add in different orders).
The query runs with the fixed threshold of 150.0 (tests/test_tpcds.py:86)
and with the scalar subquery computed live (:104).
q14a_subset (:37) is held against the reference beside, and the plan's
semi joins, union and expand are checked in every join strategy.
"""
import pyarrow as pa
import pytest

from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpcds as jax_tpcds

from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.plan.execs.basic import (GpuProjectExec,
                                                     GpuUnionExec)
from spark_rapids_tpu_torch.plan.execs.join import (
    GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.plan.execs.misc import GpuExpandExec
from spark_rapids_tpu_torch.plan.fused import GpuFusedSegmentExec
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds

N_CHANNEL = 3000
SEEDS = {"ss": 41, "cs": 43, "ws": 47}
N_ITEMS = 200
THRESHOLD = 150.0
THR = "spark.rapids.sql.join.broadcastRowThreshold"
# the channel joins go shuffled (and the semi joins with them)
SHUFFLED_CONF = {THR: "100", "spark.sql.shuffle.partitions": "4"}
ORACLE_CONF = {"spark.rapids.sql.enabled": "false"}


def check_rows_in_order(got, want):
    """``_check_rows`` of bench.py in order: exact for non-floats, floats
    within 1e-6 relative (at least 1e-6 absolute)."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert isinstance(a, float) and b == b and \
                    abs(a - b) <= 1e-6 * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def tables():
    """The reference's channel sales and item as Arrow tables."""
    out = {k: [b.to_arrow() for b in jax_tpcds.gen_channel_sales(
        N_CHANNEL, seed=s)] for k, s in SEEDS.items()}
    out["it"] = [jax_tpcds.gen_item(N_ITEMS).to_arrow()]
    return out


def _dfs(tables, sess, make):
    return [sess.create_dataframe([make(b) for b in tables[k]],
                                  num_partitions=1 if k == "it" else 2)
            for k in ("ss", "cs", "ws", "it")]


def _port_dfs(tables, conf=None):
    return _dfs(tables, GpuSession(conf, device="cpu"),
                lambda b: arrow_to_batch(b, "cpu"))


@pytest.mark.parametrize("kind", ["sales", "returns"])
def test_channel_generators_match_reference(kind):
    """Both channel generators, row for row, across chunks that reseed."""
    ref_gen, port_gen = {
        "sales": (jax_tpcds.gen_channel_sales, port_tpcds.gen_channel_sales),
        "returns": (jax_tpcds.gen_channel_returns,
                    port_tpcds.gen_channel_returns)}[kind]
    ref = ref_gen(5000, n_items=300, seed=7, batch_rows=2001)
    got = port_gen(5000, "cpu", n_items=300, seed=7, batch_rows=2001)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.to_arrow().equals(r.to_arrow())


def test_q14a_matches_reference(tables):
    """q14a with the fixed threshold and with the live scalar subquery:
    the reference's rows in order, the grand total and the channel
    subtotals among them; the shuffled semi joins give the same rows."""
    sess = TpuSession(ORACLE_CONF)
    jdfs = _dfs(tables, sess, JaxBatch.from_arrow)
    want_fixed = jax_tpcds.q14a(*jdfs, avg_threshold=THRESHOLD).collect()
    want_live = jax_tpcds.q14a(*jdfs).collect()
    for conf in (None, SHUFFLED_CONF):
        dfs = _port_dfs(tables, conf)
        check_rows_in_order(port_tpcds.q14a(*dfs, avg_threshold=THRESHOLD)
                            .collect(), want_fixed)
        check_rows_in_order(port_tpcds.q14a(*dfs).collect(), want_live)
    assert want_fixed[0][:3] == (None, None, None)
    assert {r[0] for r in want_fixed if r[1] is None} == {
        None, "store", "catalog", "web"}
    assert want_live != want_fixed


def test_q14a_live_threshold_is_the_union_average(tables):
    """The scalar subquery: the average price over the union of the three
    channels, as the reference computes it."""
    from spark_rapids_tpu_torch.expressions import avg
    ss, cs, ws, _ = _port_dfs(tables)
    union = (ss.select("cs_ext_sales_price")
             .union(cs.select("cs_ext_sales_price"))
             .union(ws.select("cs_ext_sales_price")))
    (got,), = union.agg(avg("cs_ext_sales_price").alias("a")).collect()
    prices = pa.concat_tables([b for k in ("ss", "cs", "ws")
                               for b in tables[k]]).column(
        "cs_ext_sales_price").to_numpy()
    assert got == pytest.approx(prices.mean(), rel=1e-12)


def _nodes(node):
    yield node
    if isinstance(node, GpuFusedSegmentExec):
        yield from node.chain
    if isinstance(node, GpuAdaptiveJoinExec) and node.inner is not None:
        yield from _nodes(node.inner)
    for c in node.children:
        yield from _nodes(c)


@pytest.mark.parametrize("conf", ["default", "shuffled"])
def test_q14a_plan(tables, conf):
    """Every semi join is planned (broadcast at this size, shuffled where
    the threshold is cut) and keeps the left columns alone; the legs meet
    in unions under one expand of four projections; the projection that
    names the channel (a string literal) runs op by op, and no segment
    holds an expand or a union."""
    dfs = _port_dfs(tables, None if conf == "default" else SHUFFLED_CONF)
    plan = port_tpcds.q14a(*dfs, avg_threshold=THRESHOLD).physical_plan()
    nodes = list(_nodes(plan))
    semi = [n for n in nodes if getattr(n, "join_type", "") == "left_semi"]
    want = (GpuBroadcastHashJoinExec if conf == "default"
            else GpuShuffledHashJoinExec)
    # two semi joins make each leg's cross_items, one more filters the leg
    assert len(semi) == 9 and all(isinstance(n, want) for n in semi)
    for n in semi:
        assert n.schema == n.children[0].schema
        assert n.children[1].schema.names == ("i_brand_id", "i_manufact_id",
                                              "i_category_id")
    assert sum(isinstance(n, GpuUnionExec) for n in nodes) == 2
    expands = [n for n in nodes if isinstance(n, GpuExpandExec)]
    assert len(expands) == 1 and len(expands[0].projections) == 4
    named = [n for n in nodes if isinstance(n, GpuProjectExec)
             and "channel" in n.schema.names and any(
                 "lit('" in repr(e) for e in n.exprs)]
    assert len(named) == 3
    for seg in (n for n in nodes if isinstance(n, GpuFusedSegmentExec)):
        assert not any(isinstance(c, (GpuExpandExec, GpuUnionExec))
                       for c in seg.chain)
        assert not any(c in named for c in seg.chain)
    assert port_tpcds.q14a(*dfs, avg_threshold=THRESHOLD).collect()


def test_q14a_subset_matches_reference():
    """q14a_subset over store_sales 60,000 rows in 3 partitions (the
    shape of tests/test_tpcds.py:10): the reference's groups."""
    ss = [b.to_arrow() for b in jax_tpcds.gen_store_sales(
        60_000, batch_rows=20_001)]
    it = jax_tpcds.gen_item().to_arrow()
    sess = TpuSession(ORACLE_CONF)
    want = jax_tpcds.q14a_subset(
        sess.create_dataframe([JaxBatch.from_arrow(t) for t in ss],
                              num_partitions=3),
        sess.create_dataframe([JaxBatch.from_arrow(it)])).collect()
    port = GpuSession(device="cpu")
    got = port_tpcds.q14a_subset(
        port.create_dataframe([arrow_to_batch(t, "cpu") for t in ss],
                              num_partitions=3),
        port.create_dataframe([arrow_to_batch(it, "cpu")])).collect()
    check_rows_in_order(sorted(got, key=repr), sorted(want, key=repr))
    assert len(got) > 20
