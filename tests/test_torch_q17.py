"""TPC-DS q17 through the port's GpuSession on the CPU, against the JAX
package on the same tables, and the port's ``Divide``.

The tables are tests/test_torch_q25.py's: store_sales 24,000 rows,
store_returns 8,000 (90% copied from sales), catalog_sales 12,000 (70%
copied from the returns' (customer, item) pairs), 2 partitions each, as
tests/test_tpcds_gauntlet.py:55 draws them.  q17 is written here through
the JAX package's own DSL, with the cuts of the port's builder
(``spark_rapids_tpu_torch/testing/tpcds.py`` ``q17``: the quarters as
month ranges of 2001, ``s_store_name`` for ``s_state``).  The reference
runs through its CPU oracle (``spark.rapids.sql.enabled=false``), which
its own tests hold its device path to: its device path gives the same
100 rows here but compiles for 120 s on this CPU.

The port runs q17 in both of q25's plannings: threshold 1000 with 4
shuffle partitions (adaptive, shuffled and broadcast joins) and the
default (every join broadcast), with and without the LIMIT.  Rows compare
in order: keys and counts exact, averages within 1e-12 relative (the
packages add in different orders), standard deviations and their ratio
to the average within 1e-9 (M2 comes from partial M2s merged by Chan's
formula in the port, from one pass in the oracle), and null exactly
where a group has fewer than two rows.
"""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels.sort import SortOrder as JaxOrder
from spark_rapids_tpu.testing import tpcds as jax_tpcds

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds

AVG_RTOL, STD_RTOL = 1e-12, 1e-9
N_SS, N_SR, N_CS = 24_000, 8_000, 12_000
SS_BATCH, SR_BATCH, CS_BATCH = N_SS // 3 + 1, 4001, 6001
SR_POOL = ["sr_customer_sk", "sr_item_sk", "sr_returned_date_sk"]
SHUFFLED_CONF = {"spark.rapids.sql.join.broadcastRowThreshold": "1000",
                 "spark.sql.shuffle.partitions": "4"}
TABLES = ("ss", "sr", "cs", "dd", "store", "item")
QUANTITIES = ("ss_quantity", "sr_return_quantity", "cs_quantity")


def jax_q17(ss_df, sr_df, cs_df, dd_df, store_df, item_df, limit=100):
    """q17 in the JAX package's DSL, as the port's builder writes it."""
    col, lit = JE.col, JE.lit

    def quarters(last_moy):
        return dd_df.filter((col("d_year") == lit(2001))
                            & (col("d_moy") >= lit(1))
                            & (col("d_moy") <= lit(last_moy)))
    d1 = jax_tpcds._aliased(quarters(3), "d1")
    d2 = jax_tpcds._aliased(quarters(9), "d2")
    d3 = jax_tpcds._aliased(quarters(9), "d3")
    j = (ss_df
         .join(sr_df, on=([col("ss_ticket_number"), col("ss_item_sk")],
                          [col("sr_ticket_number"), col("sr_item_sk")]))
         .join(cs_df, on=([col("sr_customer_sk"), col("sr_item_sk")],
                          [col("cs_bill_customer_sk"), col("cs_item_sk")]))
         .join(d1, on=([col("ss_sold_date_sk")], [col("d1_date_sk")]))
         .join(d2, on=([col("sr_returned_date_sk")], [col("d2_date_sk")]))
         .join(d3, on=([col("cs_sold_date_sk")], [col("d3_date_sk")]))
         .join(store_df, on=([col("ss_store_sk")], [col("s_store_sk")]))
         .join(item_df, on=([col("ss_item_sk")], [col("i_item_sk")])))
    aggs = []
    for c in QUANTITIES:
        aggs += [JE.count(c), JE.avg(c), JE.stddev(c),
                 JE.stddev(c) / JE.avg(c)]
    out = (j.group_by("i_item_id", "i_item_desc", "s_store_name").agg(*aggs)
           .order_by(("i_item_id", JaxOrder(True)),
                     ("i_item_desc", JaxOrder(True)),
                     ("s_store_name", JaxOrder(True))))
    return out if limit is None else out.limit(limit)


@pytest.fixture(scope="module")
def reference():
    """The six tables as Arrow (facts as lists of batches) and the
    reference's q17 rows, with and without the LIMIT."""
    ss = jax_tpcds.gen_store_sales(N_SS, batch_rows=SS_BATCH)
    sr = jax_tpcds.gen_store_returns(N_SR, sales=ss, match_frac=0.9,
                                     batch_rows=SR_BATCH)
    cs = jax_tpcds.gen_catalog_sales(
        N_CS, pair_pool=jax_tpcds.host_pool(sr, SR_POOL), match_frac=0.7,
        batch_rows=CS_BATCH)
    tables = {"ss": [b.to_arrow() for b in ss],
              "sr": [b.to_arrow() for b in sr],
              "cs": [b.to_arrow() for b in cs],
              "dd": [jax_tpcds.gen_date_dim().to_arrow()],
              "store": [jax_tpcds.gen_store().to_arrow()],
              "item": [jax_tpcds.gen_item().to_arrow()]}
    sess = TpuSession({"spark.rapids.sql.enabled": "false"})
    dfs = [sess.create_dataframe([JaxBatch.from_arrow(b) for b in tables[k]],
                                 num_partitions=2 if len(tables[k]) > 1
                                 else 1) for k in TABLES]
    return tables, {100: jax_q17(*dfs).collect(),
                    None: jax_q17(*dfs, limit=None).collect()}


def _port_q17(tables, conf, limit):
    sess = GpuSession(conf, device="cpu")
    dfs = [sess.create_dataframe([arrow_to_batch(b, "cpu")
                                  for b in tables[k]],
                                 num_partitions=2 if len(tables[k]) > 1
                                 else 1) for k in TABLES]
    return port_tpcds.q17(*dfs, limit=limit).collect()


def _close(a, b, rtol) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a == b or math.isclose(a, b, rel_tol=rtol, abs_tol=0.0)


def _assert_rows_in_order(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g[:3] == r[:3]
        for f in range(3):
            count, ave, std, cov = g[3 + 4 * f: 7 + 4 * f]
            rc, ra, rs, rv = r[3 + 4 * f: 7 + 4 * f]
            assert count == rc and _close(ave, ra, AVG_RTOL), (g, r)
            assert _close(std, rs, STD_RTOL) and _close(cov, rv, STD_RTOL), \
                (g, r)
            assert (std is None) == (count < 2)


@pytest.mark.parametrize("limit", [100, None])
@pytest.mark.parametrize("conf", [SHUFFLED_CONF, {}],
                         ids=["shuffled", "broadcast"])
def test_q17_matches_reference_in_order(reference, conf, limit):
    tables, ref = reference
    got = _port_q17(tables, conf, limit)
    _assert_rows_in_order(got, ref[limit])
    if limit is None:
        assert len(got) > 100
        # groups of two or more rows hold real standard deviations (the
        # chain repeats a sale for each of its catalog rows, so the
        # store_sales quantity is often constant in a group)
        assert sum(r[13] is not None and r[13] > 0 for r in got) > 10


def _divide_batch():
    a = np.array([7.0, 0.07, -3.5, 1e300, 5.0, 9.0, 0.0])
    b = np.array([100, 0, 7, 3, 0, -2, 4], np.int64)
    a_valid = np.array([1, 1, 1, 1, 0, 1, 1], np.bool_)
    return pa.table({"a": pa.array(a, mask=~a_valid), "b": pa.array(b)})


@pytest.mark.parametrize("divisor", ["column", "literal_100", "literal_0",
                                     "literal_int"])
def test_divide_matches_reference(divisor):
    """DOUBLE, null on a zero divisor and where an operand is null; a
    literal divisor is a 0-d tensor, so the quotient is IEEE's division
    (7 / 100, not 7 * 0.01) bit for bit, as numpy's and the reference's."""
    table = _divide_batch()
    rhs = {"column": "b", "literal_100": 100.0, "literal_0": 0,
           "literal_int": 3}[divisor]

    def expr(E):
        return E.col("a") / (E.col(rhs) if isinstance(rhs, str)
                             else E.lit(rhs))
    jsess = TpuSession({"spark.rapids.sql.enabled": "false"})
    ref = jsess.create_dataframe([JaxBatch.from_arrow(table)]).select(
        expr(JE).alias("q")).collect()
    got = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(table, "cpu")]).select(expr(PE).alias("q")).collect()
    assert got == ref
    a = table.column("a").to_numpy(zero_copy_only=False)
    div = table.column("b").to_numpy() if isinstance(rhs, str) \
        else np.full(len(a), float(rhs))
    for (q,), x, d, ok in zip(got, a, div,
                              table.column("a").is_valid().to_numpy(
                                  zero_copy_only=False)):
        if not ok or d == 0:
            assert q is None
        else:
            assert np.float64(q).view(np.int64) == \
                np.float64(x / d).view(np.int64)


def test_divide_literal_is_a_zero_dim_tensor(monkeypatch):
    """The literal divisor never becomes a column: ``Literal.eval`` is not
    called, and the division is tensor by 0-d tensor."""
    from spark_rapids_tpu_torch.expressions import core
    batch = arrow_to_batch(_divide_batch(), "cpu")
    e = (PE.col("a") / PE.lit(100.0)).bind(batch.schema)
    monkeypatch.setattr(core.Literal, "eval", lambda *a: pytest.fail(
        "the literal divisor was made a column"))
    out = e.eval(EvalContext(batch))
    assert out.dtype == PT.DOUBLE and out.data.dtype == torch.float64
    assert out.data[0].item() == 7.0 / 100.0


def test_divide_of_decimals_raises():
    batch = ColumnarBatch.from_pydict(
        {"d": [1, 2]}, Schema.of(d=PT.DecimalType(10, 2)), "cpu")
    with pytest.raises(NotImplementedError, match="decimal Divide"):
        (PE.col("d") / PE.lit(2)).bind(batch.schema).dtype
