"""TPC-DS q3 through the port's GpuSession on the CPU, against the JAX
package's TpuSession on the same tables: store_sales 60,000 rows in 3
partitions (the shape of tests/test_tpcds.py:10), date_dim and item as
generated.

The port's generators must give the reference's tables row for row (the
data carried across is the same), and q3's rows must be the reference's
in order: keys and brand strings exact, ``sum_agg`` within 1e-12 relative
(the packages add in different orders).  The JAX query runs once per
module, with its fused reduce and its AQE coalesced reader off, the plan
shape the port runs.  Plan shapes and what the port leaves out are
checked beside.
"""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpcds as jax_tpcds

from spark_rapids_tpu_torch import expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels.sort import SortOrder
from spark_rapids_tpu_torch.plan.execs.basic import GpuFilterExec
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuCoalescedShuffleReaderExec, GpuShuffleExchangeExec)
from spark_rapids_tpu_torch.plan.execs.join import (
    GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.plan.execs.range_sort import GpuRangeSortExec
from spark_rapids_tpu_torch.plan.fused import GpuFusedSegmentExec
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds

F64_RTOL = 1e-12
N_FACT = 60_000
BATCH_ROWS = N_FACT // 3 + 1
JAX_CONF = {"spark.rapids.sql.fusion.acrossShuffle": "false",
            "spark.rapids.sql.adaptive.coalescePartitions.enabled": "false"}


@pytest.fixture(scope="module")
def reference():
    """(store_sales, date_dim, item) of the reference's generators as Arrow
    tables, and the JAX package's q3 rows."""
    ss = [b.to_arrow() for b in jax_tpcds.gen_store_sales(
        N_FACT, batch_rows=BATCH_ROWS)]
    dd = jax_tpcds.gen_date_dim().to_arrow()
    it = jax_tpcds.gen_item().to_arrow()
    sess = TpuSession(JAX_CONF)
    rows = jax_tpcds.q3(
        sess.create_dataframe([JaxBatch.from_arrow(t) for t in ss],
                              num_partitions=3),
        sess.create_dataframe([JaxBatch.from_arrow(dd)], num_partitions=1),
        sess.create_dataframe([JaxBatch.from_arrow(it)], num_partitions=1)
    ).collect()
    return (ss, dd, it), rows


def _port_dfs(tables, conf=None, num_partitions=3):
    ss, dd, it = tables
    sess = GpuSession(conf, device="cpu")
    return (sess.create_dataframe([arrow_to_batch(t, "cpu") for t in ss],
                                  num_partitions=num_partitions),
            sess.create_dataframe([arrow_to_batch(dd, "cpu")]),
            sess.create_dataframe([arrow_to_batch(it, "cpu")]))


@pytest.mark.parametrize("table", ["store_sales", "date_dim", "item"])
def test_tpcds_generators_match_reference(reference, table):
    """The port's generators draw the reference's numpy streams: equal
    tables through Arrow (the fact chunks reseed per chunk, so the same
    batch_rows)."""
    (ss, dd, it), _ = reference
    if table == "store_sales":
        got = [b.to_arrow() for b in port_tpcds.store_sales_batches(
            N_FACT, "cpu", batch_rows=BATCH_ROWS)]
        assert len(got) == len(ss) == 3
        for g, w in zip(got, ss):
            assert g.equals(w)
    elif table == "date_dim":
        assert port_tpcds.gen_date_dim("cpu").to_arrow().equals(dd)
    else:
        assert port_tpcds.gen_item("cpu").to_arrow().equals(it)


def _assert_rows_in_order(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g[:3] == r[:3]
        assert g[3] == pytest.approx(r[3], rel=F64_RTOL)


def test_q3_matches_reference_in_order(reference):
    tables, ref = reference
    got = port_tpcds.q3(*_port_dfs(tables)).collect()
    _assert_rows_in_order(got, ref)
    assert len(got) == 41    # the reference's row count at this scale
    assert all(b.startswith("Brand#") for _, _, b, _ in got)


def test_q3_plan_shape(reference):
    """Both joins broadcast, their filters pushed into the dimension
    tables; the grouped aggregate goes through the hash exchange, read
    through the AQE coalesced reader; the global sort is a range sort
    over the final aggregate's partitions."""
    tables, ref = reference
    plan = port_tpcds.q3(*_port_dfs(tables)).physical_plan()
    assert isinstance(plan, GpuRangeSortExec)
    final = plan.children[0]
    assert final.mode == "final"
    reader = final.children[0]
    assert isinstance(reader, GpuCoalescedShuffleReaderExec)
    assert isinstance(reader.children[0], GpuShuffleExchangeExec)
    # with spark.rapids.sql.tpu.fuseStages (the default) the partial
    # aggregate under the exchange is a fused segment of its own, and each
    # dimension's filter heads one with its projection
    partial = reader.children[0].children[0]
    assert isinstance(partial, GpuFusedSegmentExec)
    assert partial.chain[0].mode == "partial"
    join2 = partial.children[0]
    assert isinstance(join2, GpuBroadcastHashJoinExec)
    join1 = join2.children[0]
    assert isinstance(join1, GpuBroadcastHashJoinExec)
    for join, cond in ((join1, "d_moy"), (join2, "i_manufact_id")):
        build = join.children[1]
        assert isinstance(build, GpuFusedSegmentExec)
        assert isinstance(build.chain[0], GpuFilterExec)
        assert cond in repr(build.chain[0].condition)
    lines = plan.tree_string().splitlines()
    assert sum("GpuFilter" in ln for ln in lines) == 2
    assert sum("GpuRangeSort" in ln for ln in lines) == 1


@pytest.mark.parametrize("conf,num_partitions", [
    ({"spark.sql.shuffle.partitions": "3"}, 3),
    ({"spark.rapids.sql.batchSizeRows": "7000"}, 2),
    (None, 6),                     # more partitions than batches
])
def test_q3_plan_variants_give_the_same_rows(reference, conf,
                                             num_partitions):
    tables, ref = reference
    got = port_tpcds.q3(*_port_dfs(tables, conf, num_partitions)).collect()
    _assert_rows_in_order(got, ref)


JOIN_COLUMNS = ("ss_ticket_number", "ss_item_sk", "ss_customer_sk",
                "i_brand", "i_item_id")


@pytest.fixture(scope="module")
def reference_join(reference):
    """The JAX package's rows of store_sales joined with item on the item
    key (the columns JOIN_COLUMNS), sorted."""
    from spark_rapids_tpu.expressions import col as jcol
    (ss, _, it), _ = reference
    sess = TpuSession(JAX_CONF)
    rows = (sess.create_dataframe([JaxBatch.from_arrow(t) for t in ss],
                                  num_partitions=3)
            .join(sess.create_dataframe([JaxBatch.from_arrow(it)]),
                  on=([jcol("ss_item_sk")], [jcol("i_item_sk")]))
            .select(*JOIN_COLUMNS).collect())
    return sorted(rows, key=repr)


def test_joins_that_do_not_broadcast_raise(reference, reference_join):
    """A join that does not broadcast is adaptive (build estimate within
    8x of the threshold) or shuffled, on one partition too, and gives the
    reference's rows; a string key joins.  The left join and a residual
    condition run (every sale's item exists, so the left join gives the
    inner join's rows); a full join never broadcasts (its build is the
    side it null-extends); what is still not ported raises: the existence
    join."""
    tables, _ = reference
    ss, dd, it = _port_dfs(tables)
    on = ([PE.col("ss_item_sk")], [PE.col("i_item_sk")])
    assert isinstance(ss.join(it, on=on, how="full").physical_plan(),
                      GpuShuffledHashJoinExec)
    with pytest.raises(NotImplementedError, match="existence"):
        ss.join(it, on=on, how="existence").physical_plan()
    left = ss.join(it, on=on, how="left").select(*JOIN_COLUMNS)
    assert isinstance(left.physical_plan().children[0],
                      GpuBroadcastHashJoinExec)
    assert sorted(left.collect(), key=repr) == reference_join
    thr = "spark.rapids.sql.join.broadcastRowThreshold"
    for conf, parts, what in (({thr: "1000"}, 3, GpuAdaptiveJoinExec),
                              ({thr: "100"}, 3, GpuShuffledHashJoinExec),
                              ({thr: "0"}, 3, GpuShuffledHashJoinExec),
                              (None, 1, GpuShuffledHashJoinExec)):
        s2, _, i2 = _port_dfs(tables, conf, parts)
        df = s2.join(i2, on=on).select(*JOIN_COLUMNS)
        assert isinstance(df.physical_plan().children[0], what)
        assert sorted(df.collect(), key=repr) == reference_join
    cond = ss.join(it, on=on, condition=PE.col("i_item_sk") < 3)
    assert sorted(cond.select(*JOIN_COLUMNS).collect(), key=repr) == [
        r for r in reference_join if r[1] < 3]
    items = GpuSession({"spark.rapids.sql.batchSizeRows": "500"},
                       device="cpu").create_dataframe(tables[2],
                                                      num_partitions=2)
    brands = it.select(PE.col("i_brand").alias("b"),
                       PE.col("i_item_sk").alias("sk"))
    got = items.join(brands, on=([PE.col("i_brand")], [PE.col("b")])
                     ).select("i_item_sk", "sk").collect()
    brand = tables[2].column("i_brand").to_pylist()
    by_brand = {}
    for sk, b in enumerate(brand, 1):
        by_brand.setdefault(b, []).append(sk)
    assert sorted(got) == sorted((a, b) for a, br in enumerate(brand, 1)
                                 for b in by_brand[br])


def test_order_by_and_join_surface():
    """order_by over several partitions (strings descending, nulls, a
    stable tie), join on a shared column name, and == as EqualTo."""
    t = pa.table({"k": pa.array([3, 1, None, 2, 1, 3], pa.int32()),
                  "s": pa.array(["b", "ab\x00", "z", None, "ab", "b"]),
                  "i": pa.array(np.arange(6, dtype=np.int32))})
    sess = GpuSession({"spark.rapids.sql.batchSizeRows": "2"}, device="cpu")
    df = sess.create_dataframe(t, num_partitions=3)
    got = df.order_by(("s", SortOrder(False)), "k").collect()
    assert [r[1] for r in got] == ["z", "b", "b", "ab\x00", "ab", None]
    assert [r[2] for r in got[1:3]] == [0, 5]     # a tie keeps its order
    dims = sess.create_dataframe(pa.table({
        "k": pa.array([1, 3, 3, 4], pa.int32()),
        "name": pa.array(["one", "three", "tres", "four"])}))
    joined = df.join(dims, on=([PE.col("k")], [PE.col("k")]))
    rows = sorted(joined.select(PE.col("i"), PE.col("name")).collect())
    assert rows == [(0, "three"), (0, "tres"), (1, "one"), (4, "one"),
                    (5, "three"), (5, "tres")]
    eq = df.filter(PE.col("k") == 3).select("i").collect()
    assert sorted(r[0] for r in eq) == [0, 5]
