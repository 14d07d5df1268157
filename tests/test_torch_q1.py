"""TPC-H q1 through the port's GpuSession on the CPU, against the JAX
package's TpuSession on the same lineitem data (50,000 rows in 3
partitions, the shape of tests/test_tpch.py:26; the null case at 10,000
rows with seeded nulls in l_quantity and l_linenumber).

Rows are sorted by the group key before comparing.  Keys and counts must
be equal; sums and averages within 1e-12 relative, because the packages
add the partial sums in different orders.  Each JAX query runs once per
module, with the reference's fused reduce (concat + merge + finalize as
one program) and its AQE coalesced reader turned off: the port has
neither, so both packages then run the same plan, and the JAX query
compiles in a third of the time.  Neither changes the rows.
"""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpch as jax_tpch

from spark_rapids_tpu_torch import expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.plan.execs.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuCoalescedShuffleReaderExec, GpuShuffleExchangeExec)
from spark_rapids_tpu_torch.testing import tpch as port_tpch

F64_RTOL = 1e-12
CASES = {"plain": (50_000, 0.0), "nulls": (10_000, 0.1)}
JAX_CONF = {"spark.rapids.sql.fusion.acrossShuffle": "false",
            "spark.rapids.sql.adaptive.coalescePartitions.enabled": "false"}


def _lineitem_tables(n_rows: int, null_frac: float):
    """The reference's lineitem batches as Arrow tables.  With null_frac,
    l_linenumber gets nulls from a seeded mask, and l_quantity is null
    there and at other seeded rows, so the null group's quantity sums are
    null."""
    rng = np.random.RandomState(1)
    tables = []
    for b in jax_tpch.gen_lineitem(n_rows, batch_rows=n_rows // 4 + 1):
        t = b.to_arrow()
        if null_frac:
            key_nulls = rng.rand(t.num_rows) < null_frac
            qty_nulls = key_nulls | (rng.rand(t.num_rows) < null_frac)
            for name, nulls in (("l_linenumber", key_nulls),
                                ("l_quantity", qty_nulls)):
                i = t.schema.get_field_index(name)
                t = t.set_column(i, name, pa.compute.if_else(
                    pa.array(nulls), pa.scalar(None, t.schema.field(i).type),
                    t.column(i)))
        tables.append(t)
    return tables


def _port_df(tables, conf=None, num_partitions=3):
    sess = GpuSession(conf, device="cpu")
    return sess.create_dataframe([arrow_to_batch(t, "cpu") for t in tables],
                                 num_partitions=num_partitions)


def _by_key(rows):
    return sorted(rows, key=lambda r: (r[0] is not None, r[0]))


@pytest.fixture(scope="module")
def reference():
    """case -> (Arrow tables, the JAX package's q1 rows sorted by key)."""
    out = {}
    for case, (n, null_frac) in CASES.items():
        tables = _lineitem_tables(n, null_frac)
        jdf = TpuSession(JAX_CONF).create_dataframe(
            [JaxBatch.from_arrow(t) for t in tables], num_partitions=3)
        out[case] = tables, _by_key(jax_tpch.q1(jdf).collect())
    return out


def _assert_rows_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r) == 9
        assert g[0] == r[0] and g[8] == r[8]          # key and count_order
        for gv, rv in zip(g[1:8], r[1:8]):
            if rv is None:
                assert gv is None
            else:
                assert gv == pytest.approx(rv, rel=F64_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_q1_matches_reference(reference, case):
    tables, ref = reference[case]
    got = _by_key(port_tpch.q1(_port_df(tables)).collect())
    _assert_rows_close(got, ref)
    if case == "plain":
        assert [r[0] for r in got] == list(range(1, 8))
    else:   # a null group, whose l_quantity is all null
        assert [r[0] for r in got] == [None] + list(range(1, 8))
        assert got[0][1] is None and got[0][5] is None and got[0][8] > 0
        assert all(v is not None for r in got[1:] for v in r)


@pytest.mark.parametrize("conf,num_partitions", [
    ({"spark.sql.shuffle.partitions": "5"}, 3),
    ({"spark.sql.shuffle.partitions": "1"}, 2),
    (None, 1),                     # one input partition: complete mode
    (None, 6),                     # more partitions than batches: empty ones
])
def test_q1_plan_shapes_give_the_same_rows(reference, conf, num_partitions):
    tables, ref = reference["plain"]
    df = port_tpch.q1(_port_df(tables, conf, num_partitions))
    plan = df.physical_plan()
    assert isinstance(plan, GpuHashAggregateExec)
    if num_partitions == 1:
        assert plan.mode == "complete"
    else:
        assert plan.mode == "final"
        # the final aggregate reads its partitions through the AQE reader
        reader = plan.children[0]
        assert isinstance(reader, GpuCoalescedShuffleReaderExec)
        exchange = reader.children[0]
        assert isinstance(exchange, GpuShuffleExchangeExec)
        assert exchange.num_partitions() == int(
            (conf or {}).get("spark.sql.shuffle.partitions", 16))
        assert exchange.children[0].mode == "partial"
    _assert_rows_close(_by_key(df.collect()), ref)


def test_grouped_aggregate_over_no_rows_gives_no_rows(reference):
    """A grouped aggregate whose input is empty yields no row; the global
    one yields its single identity row."""
    tables, _ = reference["plain"]
    df = _port_df(tables).filter(PE.col("l_linenumber") < 0)
    assert df.group_by("l_linenumber").agg(PE.count()).collect() == []
    assert df.agg(PE.count(), PE.avg("l_linenumber")).collect() == \
        [(0, None)]


def test_add_subtract_average_and_nulls():
    """Add and Subtract promote and propagate nulls; avg over a group of
    nulls is null, and avg(int) is a double."""
    t = pa.table({"k": pa.array([1, 1, 2, 2, 3], pa.int32()),
                  "x": pa.array([1, None, 4, 6, None], pa.int32()),
                  "y": pa.array([0.5, 1.5, None, 2.0, 3.0])})
    df = GpuSession(device="cpu").create_dataframe(t)
    rows = df.select(PE.col("k"), (PE.col("x") + PE.col("y")).alias("s"),
                     (PE.col("x") - PE.lit(1)).alias("d")).collect()
    assert rows == [(1, 1.5, 0), (1, None, None), (2, None, 3),
                    (2, 8.0, 5), (3, None, None)]
    got = _by_key(df.group_by("k").agg(PE.avg("x"), PE.sum_("y"),
                                       PE.count("x")).collect())
    assert got == [(1, 1.0, 2.0, 1), (2, 5.0, 2.0, 2), (3, None, 3.0, 0)]
    # count(*) alone: the row counts come from a count over the keys
    assert _by_key(df.group_by("k").agg(PE.count()).collect()) == [
        (1, 2), (2, 2), (3, 1)]
