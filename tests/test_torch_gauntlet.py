"""The rest of the TPC-DS gauntlet through the port's GpuSession on the
CPU, against the JAX package on the same tables: q7, q19, q26, q42, q52,
q55 and q96, as tests/test_tpcds_gauntlet.py draws them (store_sales and
catalog_sales 24,000 rows in batches of 8,001, 2 partitions each; the
reference's dimensions, customer 8,000 and customer_address 4,000 rows).

The port's generators must give the reference's tables row for row, and
each query's rows must be the reference's in order: keys and counts
exact, float sums and averages within 1e-12 relative (the sums add in
another order).  q19 keeps few rows at this size, so its join chain and
its substring filter, without its date and manager filters, are held
grouped by brand: 3,705 rows through ``Substring`` and ``!=``.

Each reference query runs once per process, on first use, through the
JAX package's CPU oracle (``spark.rapids.sql.enabled=false``), whose rows
the reference's own gauntlet holds its device path to: the device path
compiles its string filters for minutes on a CPU (q7 162 s, q26 153 s,
the chain 65 s, q19 50 s).  On these tables the oracle's rows of q19,
q42, q52, q55 and q96 equal the device path's exactly (its path with the
two switches of tests/test_torch_q3.py), and the chain's within 1e-9.
"""
import functools

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
from spark_rapids_tpu_torch.plan.execs.basic import GpuFilterExec
from spark_rapids_tpu_torch.plan.execs.join import GpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds

N_FACT = 24_000
BATCH = N_FACT // 3 + 1
N_CUSTOMER, N_ADDRESS = 8_000, 4_000
F64_RTOL = 1e-12
ORACLE_CONF = {"spark.rapids.sql.enabled": "false"}
FACTS = ("ss", "cs")
# each query's tables, in argument order
QUERIES = {
    "q7": ("ss", "cd", "dd", "item", "promo"),
    "q19": ("ss", "dd", "item", "cust", "ca", "store"),
    "q26": ("cs", "cd", "dd", "item", "promo"),
    "q42": ("ss", "dd", "item"),
    "q52": ("ss", "dd", "item"),
    "q55": ("ss", "dd", "item"),
    "q96": ("ss", "hd", "td", "store"),
}


@functools.lru_cache(maxsize=None)
def _tables():
    """The reference's tables as Arrow (facts as lists of batches)."""
    t = jax_tpcds
    tables = {"ss": t.gen_store_sales(N_FACT, batch_rows=BATCH),
              "cs": t.gen_catalog_sales(N_FACT, batch_rows=BATCH),
              "dd": [t.gen_date_dim()], "item": [t.gen_item()],
              "store": [t.gen_store()], "promo": [t.gen_promotion()],
              "cd": [t.gen_customer_demographics()],
              "hd": [t.gen_household_demographics()],
              "cust": [t.gen_customer(N_CUSTOMER, n_addr=N_ADDRESS)],
              "ca": [t.gen_customer_address(N_ADDRESS)],
              "td": [t.gen_time_dim()]}
    return {k: [b.to_arrow() for b in v] for k, v in tables.items()}


@functools.lru_cache(maxsize=None)
def _jax_dfs():
    sess = TpuSession(ORACLE_CONF)
    return {k: sess.create_dataframe([JaxBatch.from_arrow(b) for b in v],
                                     num_partitions=2 if k in FACTS else 1)
            for k, v in _tables().items()}


def _port_dfs():
    sess = GpuSession(device="cpu")
    return {k: sess.create_dataframe([arrow_to_batch(b, "cpu") for b in v],
                                     num_partitions=2 if k in FACTS else 1)
            for k, v in _tables().items()}


def _chain(E, order, d):
    """q19's joins and substring filter over every date and item, summed
    and counted by brand."""
    col = E.col
    j = (d["ss"].join(d["dd"], on=([col("ss_sold_date_sk")],
                                   [col("d_date_sk")]))
         .join(d["item"], on=([col("ss_item_sk")], [col("i_item_sk")]))
         .join(d["cust"], on=([col("ss_customer_sk")],
                              [col("c_customer_sk")]))
         .join(d["ca"], on=([col("c_current_addr_sk")],
                            [col("ca_address_sk")]))
         .join(d["store"], on=([col("ss_store_sk")], [col("s_store_sk")]))
         .filter(E.Substring(col("ca_zip"), 1, 5)
                 != E.Substring(col("s_zip"), 1, 5)))
    return (j.group_by("i_brand")
            .agg(E.sum_("ss_ext_sales_price").alias("sales"),
                 E.count().alias("n"))
            .order_by(("i_brand", order(True))))


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The reference's rows of one query (``chain``: q19's chain)."""
    if name == "chain":
        return _chain(RE, JaxOrder, _jax_dfs()).collect()
    args = QUERIES[name]
    d = _jax_dfs()
    return getattr(jax_tpcds, name)(*(d[k] for k in args)).collect()


def _same_rows(got, want):
    """In order; floats within F64_RTOL relative, all else exact."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert abs(a - b) <= F64_RTOL * abs(b), (g, w)
            else:
                assert a == b, (g, w)


GENERATORS = {
    "customer": (lambda: [port_tpcds.gen_customer(
        "cpu", N_CUSTOMER, n_addr=N_ADDRESS)], "cust"),
    "customer_address": (lambda: [port_tpcds.gen_customer_address(
        "cpu", N_ADDRESS)], "ca"),
    "time_dim": (lambda: [port_tpcds.gen_time_dim("cpu")], "td"),
    "store_sales": (lambda: port_tpcds.store_sales_batches(
        N_FACT, "cpu", batch_rows=BATCH), "ss"),
    "catalog_sales": (lambda: port_tpcds.gen_catalog_sales(
        N_FACT, "cpu", batch_rows=BATCH), "cs"),
}


@pytest.mark.parametrize("table", list(GENERATORS))
def test_tpcds_generators_match_reference(table):
    make, key = GENERATORS[table]
    got = make()
    want = _tables()[key]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_arrow().equals(w)


def test_sf10_dimension_generators_match_reference():
    """customer and customer_address at their default sizes (the ones
    chip_smoke.py draws at SF10), row for row."""
    for port, ref in ((port_tpcds.gen_customer("cpu"),
                       jax_tpcds.gen_customer()),
                      (port_tpcds.gen_customer_address("cpu"),
                       jax_tpcds.gen_customer_address())):
        assert port.to_arrow().equals(ref.to_arrow())


@pytest.mark.parametrize("query", list(QUERIES))
def test_query_matches_reference_in_order(query):
    args = QUERIES[query]
    d = _port_dfs()
    got = getattr(port_tpcds, query)(*(d[k] for k in args)).collect()
    want = _reference(query)
    assert want, f"{query} keeps no row at this size"
    _same_rows(got, want)


def test_q19_chain_matches_reference():
    """Thousands of joined rows through Substring and !=, by brand."""
    got = _chain(PE, PortOrder, _port_dfs()).collect()
    want = _reference("chain")
    _same_rows(got, want)
    assert len(got) > 500 and sum(r[2] for r in got) > 3_000


def _nodes(node):
    yield node
    for k in node.children:
        yield from _nodes(k)


def test_q19_filter_stays_above_the_joins_and_q7_filters_promotion():
    """q19's zip filter reads both build sides, so it stays above the
    store join, and customer_address is scanned for its key and zip only;
    q7's OR filters the promotion table under its join."""
    d = _port_dfs()
    args = QUERIES["q19"]
    nodes = list(_nodes(port_tpcds.q19(*(d[k] for k in args))
                        .physical_plan()))
    zip_filter = [n for n in nodes if isinstance(n, GpuFilterExec)
                  and "substring" in repr(n.condition)]
    assert len(zip_filter) == 1
    assert isinstance(zip_filter[0].children[0], GpuBroadcastHashJoinExec)
    builds = [n.children[1].schema.names for n in nodes
              if isinstance(n, GpuBroadcastHashJoinExec)]
    assert ("ca_address_sk", "ca_zip") in builds
    args = QUERIES["q7"]
    nodes = list(_nodes(port_tpcds.q7(*(d[k] for k in args))
                        .physical_plan()))
    promo = [n for n in nodes if isinstance(n, GpuFilterExec)
             and "OR" in repr(n.condition)]
    assert len(promo) == 1
    assert promo[0].schema.names == ("p_promo_sk", "p_channel_email",
                                     "p_channel_event")
