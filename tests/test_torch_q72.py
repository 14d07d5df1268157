"""TPC-DS q72 through the port's GpuSession on the CPU, against the JAX
package's CPU oracle (``spark.rapids.sql.enabled=false``: on these tables
its q72 and join-chain rows equal its device path's, exactly; the device
path takes ~150 s here, the oracle under a second) on the same tables:
catalog_sales 8,000 rows,
catalog_returns 3,000 (60% copied from the sales' (item, order) pairs),
inventory 20,000, 2 partitions each, as tests/test_tpcds_gauntlet.py:99
draws them; warehouse, item, customer_demographics,
household_demographics, date_dim and promotion as generated.

The port's generators must give the reference's tables row for row, and
q72's rows must be the reference's in order, every count exact.  The
tables are drawn once per module for the generator cases, and the JAX
queries run once per module beside.  The port runs q72 with
``broadcastRowThreshold=1000`` and 4 shuffle partitions, where the
inventory join is a shuffled join with its condition, the catalog_returns
left join is adaptive and goes shuffled and the promotion left join
broadcasts, once with the coalesced reader and once without; and with the
default threshold, where every join broadcasts.  q72 keeps one row at this
size, so the join chain it rests on (the conditional inventory join and
the two left joins, grouped by warehouse) is held against the reference
too.  The left join's empty builds are pinned beside.
"""
import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.expressions as RE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels.sort import SortOrder as JaxOrder
from spark_rapids_tpu.testing import tpcds as jax_tpcds

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels.sort import SortOrder as PortOrder
from spark_rapids_tpu_torch.plan.engine import GpuEngine
from spark_rapids_tpu_torch.plan.execs.join import (
    GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds

N_CS, N_CR, N_INV = 8_000, 3_000, 20_000
CS_BATCH, CR_BATCH, INV_BATCH = 4001, 1501, 10_001
ORDER_POOL = ["cs_item_sk", "cs_order_number"]
THR = "spark.rapids.sql.join.broadcastRowThreshold"
READER = "spark.rapids.sql.adaptive.coalescePartitions.enabled"
SHUFFLED_CONF = {THR: "1000", "spark.sql.shuffle.partitions": "4"}
# q72's arguments, in order; the facts are split into 2 partitions
TABLES = ("cs", "inv", "warehouse", "item", "cd", "hd", "dd", "promo", "cr")
FACTS = ("cs", "inv", "cr")
ORACLE_CONF = {"spark.rapids.sql.enabled": "false"}


def _chain(E, order, cs, inv, promo, cr):
    """The joins q72 rests on, over all rows: catalog_sales with the
    inventory snapshots of its item holding less than its quantity, then
    the left joins to promotion and catalog_returns, counted by
    warehouse."""
    j = (cs.join(inv, on=([E.col("cs_item_sk")], [E.col("inv_item_sk")]),
                 condition=(E.col("inv_quantity_on_hand")
                            < E.col("cs_quantity")))
         .join(promo, on=([E.col("cs_promo_sk")], [E.col("p_promo_sk")]),
               how="left")
         .join(cr, on=([E.col("cs_item_sk"), E.col("cs_order_number")],
                       [E.col("cr_item_sk"), E.col("cr_order_number")]),
               how="left"))
    return (j.group_by("inv_warehouse_sk")
            .agg(E.sum_(E.If(E.IsNull(E.col("p_promo_sk")), E.lit(1),
                             E.lit(0))).alias("no_promo"),
                 E.count().alias("n"),
                 E.count("cr_return_quantity").alias("returned"),
                 E.sum_("inv_quantity_on_hand").alias("on_hand"))
            .order_by(("inv_warehouse_sk", order(True))))


@pytest.fixture(scope="module")
def tables():
    """The reference's tables as Arrow (facts as lists of batches)."""
    cs = jax_tpcds.gen_catalog_sales(N_CS, batch_rows=CS_BATCH)
    pool = jax_tpcds.host_pool(cs, ORDER_POOL)
    cr = jax_tpcds.gen_catalog_returns(N_CR, order_pool=pool, match_frac=0.6,
                                       batch_rows=CR_BATCH)
    inv = jax_tpcds.gen_inventory(N_INV, batch_rows=INV_BATCH)
    tables = {"cs": cs, "inv": inv, "cr": cr,
              "warehouse": [jax_tpcds.gen_warehouse()],
              "item": [jax_tpcds.gen_item()],
              "cd": [jax_tpcds.gen_customer_demographics()],
              "hd": [jax_tpcds.gen_household_demographics()],
              "dd": [jax_tpcds.gen_date_dim()],
              "promo": [jax_tpcds.gen_promotion()]}
    return {k: [b.to_arrow() for b in v] for k, v in tables.items()}


@pytest.fixture(scope="module")
def reference(tables):
    """The tables, the reference's q72 rows and its join chain's rows
    (its CPU oracle)."""
    sess = TpuSession(ORACLE_CONF)
    dfs = {k: sess.create_dataframe([JaxBatch.from_arrow(b) for b in v],
                                    num_partitions=2 if k in FACTS else 1)
           for k, v in tables.items()}
    q72 = jax_tpcds.q72(*(dfs[k] for k in TABLES)).collect()
    chain = _chain(RE, JaxOrder, dfs["cs"], dfs["inv"], dfs["promo"],
                   dfs["cr"]).collect()
    return tables, q72, chain


def _port_dfs(tables, conf=None):
    sess = GpuSession(conf, device="cpu")
    return {k: sess.create_dataframe([arrow_to_batch(b, "cpu") for b in v],
                                     num_partitions=2 if k in FACTS else 1)
            for k, v in tables.items()}


def _nodes(node, seen=None):
    """Every exec of a tree once, with the exec each adaptive join
    built."""
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


def _join_on(nodes, cls, right_column):
    found = [n for n in nodes if isinstance(n, cls)
             and right_column in n.children[1].schema.names]
    assert len(found) == 1, (cls, right_column, found)
    return found[0]


GENERATORS = {
    "catalog_returns": lambda pool: port_tpcds.gen_catalog_returns(
        N_CR, "cpu", order_pool=pool, match_frac=0.6, batch_rows=CR_BATCH),
    "inventory": lambda pool: port_tpcds.gen_inventory(
        N_INV, "cpu", batch_rows=INV_BATCH),
    "warehouse": lambda pool: [port_tpcds.gen_warehouse("cpu")],
    "promotion": lambda pool: [port_tpcds.gen_promotion("cpu")],
    "customer_demographics": lambda pool: [
        port_tpcds.gen_customer_demographics("cpu")],
    "household_demographics": lambda pool: [
        port_tpcds.gen_household_demographics("cpu")],
}
GENERATED = {"catalog_returns": "cr", "inventory": "inv",
             "warehouse": "warehouse", "promotion": "promo",
             "customer_demographics": "cd", "household_demographics": "hd"}


@pytest.mark.parametrize("table", list(GENERATORS))
def test_tpcds_generators_match_reference(tables, table):
    """The six generators of the slice, row for row; catalog_returns
    draws from the pool of the port's own catalog_sales chunks."""
    pool = port_tpcds.host_pool(
        port_tpcds.iter_catalog_sales(N_CS, batch_rows=CS_BATCH),
        ORDER_POOL)
    got = GENERATORS[table](pool)
    want = tables[GENERATED[table]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_arrow().equals(w)


@pytest.mark.parametrize("conf", ["shuffled", "shuffled_no_reader",
                                  "broadcast"])
def test_q72_matches_reference_in_order(reference, conf):
    """q72's rows, in order and exact, under each plan; the plan's join
    kinds as the configuration makes them."""
    tables, ref, _ = reference
    confs = {"shuffled": SHUFFLED_CONF,
             "shuffled_no_reader": {**SHUFFLED_CONF, READER: "false"},
             "broadcast": None}
    dfs = _port_dfs(tables, confs[conf])
    plan = port_tpcds.q72(*(dfs[k] for k in TABLES)).physical_plan()
    got = GpuEngine().collect(plan)
    assert got == ref and len(got) >= 1
    assert all(r[5] == r[3] + r[4] for r in got)
    nodes = list(_nodes(plan))
    promo = _join_on(nodes, GpuBroadcastHashJoinExec, "p_promo_sk")
    assert promo.join_type == "left"
    if conf == "broadcast":
        joins = [n for n in nodes if isinstance(
            n, (GpuShuffledHashJoinExec, GpuAdaptiveJoinExec))]
        assert joins == []
        inv = _join_on(nodes, GpuBroadcastHashJoinExec, "inv_item_sk")
        assert inv.condition is not None
        return
    inv = _join_on(nodes, GpuShuffledHashJoinExec, "inv_item_sk")
    assert "inv_quantity_on_hand" in repr(inv.condition)
    assert set(inv.branches) == {"streamed"}
    cr = _join_on(nodes, GpuAdaptiveJoinExec, "cr_item_sk")
    assert (cr.join_type, cr.chosen) == ("left", "shuffled")
    assert isinstance(cr.inner, GpuShuffledHashJoinExec)
    assert cr.inner.join_type == "left"


@pytest.mark.parametrize("conf", ["shuffled", "broadcast"])
def test_q72_join_chain_matches_reference(reference, conf):
    """The conditional inventory join and the two left joins over every
    row (q72's filters left out), counted by warehouse: the promo-less
    rows, the rows, the matched returns and the stock summed, exact."""
    tables, _, ref = reference
    dfs = _port_dfs(tables, SHUFFLED_CONF if conf == "shuffled" else None)
    got = _chain(PE, PortOrder, dfs["cs"], dfs["inv"], dfs["promo"],
                 dfs["cr"]).collect()
    assert got == ref and len(got) == 10
    assert all(0 < r[1] < r[2] and 0 < r[3] < r[2] for r in got)


def _left_tables():
    """Sales keyed (item, order) and three returns, one matching twice;
    every key fits int32."""
    rng = np.random.RandomState(5)
    n = 400
    sales = pa.table({
        "s_item": pa.array(rng.randint(1, 50, n).astype(np.int32)),
        "s_order": pa.array(rng.randint(1, 30, n).astype(np.int32),
                            mask=rng.rand(n) < 0.1),
        "s_qty": pa.array(rng.randint(1, 100, n).astype(np.int32))})
    first = sales.slice(0, 1).to_pylist()[0]
    returns = pa.table({
        "r_item": pa.array([first["s_item"], first["s_item"], 77],
                           pa.int32()),
        "r_order": pa.array([first["s_order"], first["s_order"], 1],
                            pa.int32()),
        "r_qty": pa.array([5, 6, 7], pa.int32())})
    return sales, returns


def _left_rows_python(sales, returns):
    by_key = {}
    for r in returns.to_pylist():
        by_key.setdefault((r["r_item"], r["r_order"]), []).append(r["r_qty"])
    out = []
    for s in sales.to_pylist():
        key = (s["s_item"], s["s_order"])
        matches = by_key.get(key, []) if None not in key else []
        out += [(s["s_item"], s["s_order"], s["s_qty"], q)
                for q in matches or [None]]
    return sorted(out, key=repr)


@pytest.mark.parametrize("conf,cls", [
    ({THR: "0", "spark.sql.shuffle.partitions": "16"},
     GpuShuffledHashJoinExec),
    (None, GpuBroadcastHashJoinExec)])
def test_left_join_emits_stream_rows_against_empty_builds(conf, cls):
    """A left join on two keys whose build holds three rows: under 16
    shuffle partitions most partitions have no catalog_returns row, and
    their sales still come out, null-extended; an all-filtered build does
    the same for the broadcast and the shuffled join."""
    sales, returns = _left_tables()
    sess = GpuSession(conf, device="cpu")
    s = sess.create_dataframe(sales, num_partitions=3)
    r = sess.create_dataframe(returns, num_partitions=2)
    on = ([PE.col("s_item"), PE.col("s_order")],
          [PE.col("r_item"), PE.col("r_order")])
    for build, want_returns in ((r, returns),
                                (r.filter(PE.col("r_qty") > 100),
                                 returns.slice(0, 0))):
        df = s.join(build, on=on, how="left").select(
            "s_item", "s_order", "s_qty", "r_qty")
        plan = df.physical_plan()
        assert isinstance(plan.children[0], cls)
        got = sorted(GpuEngine().collect(plan), key=repr)
        assert got == _left_rows_python(sales, want_returns)
        assert sum(row[3] is None for row in got) >= sales.num_rows - 2
    inner = s.join(r.filter(PE.col("r_qty") > 100), on=on).collect()
    assert inner == []
