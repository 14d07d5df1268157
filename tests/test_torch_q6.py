"""TPC-H q6 through the port's GpuSession on the CPU, against the JAX
package's TpuSession on the same lineitem data (50,000 rows, 3
partitions, the shape of tests/test_tpch.py).

Revenue must agree within 1e-12 relative (the packages add the partial
sums in different orders); counts and nulls exactly.
"""
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpch as jax_tpch

from spark_rapids_tpu_torch import expressions as PE
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.plan.execs.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.plan.execs.basic import GpuProjectExec
from spark_rapids_tpu_torch.plan.fused import GpuFusedSegmentExec
from spark_rapids_tpu_torch.testing import tpch as port_tpch

N_ROWS = 50_000
BATCH_ROWS = N_ROWS // 4 + 1
F64_RTOL = 1e-12


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def q6_shape(df, E, T, lo=(1994, 1, 1), hi=(1995, 1, 1), with_count=False):
    """q6 written once against either package's expression DSL."""
    dec = T.DecimalType(12, 2)
    price = E.Cast(E.col("l_extendedprice"), T.DOUBLE)
    disc = E.Cast(E.col("l_discount"), T.DOUBLE)
    aggs = [E.sum_(price * disc).alias("revenue")]
    if with_count:
        aggs.append(E.count().alias("n"))
    return (df.filter((E.col("l_shipdate") >= E.lit(_days(*lo), T.DATE))
                      & (E.col("l_shipdate") < E.lit(_days(*hi), T.DATE))
                      & (E.col("l_discount") >= E.lit(5, dec))
                      & (E.col("l_discount") <= E.lit(7, dec))
                      & (E.col("l_quantity") < E.lit(2400, dec)))
            .agg(*aggs))


def _lineitem_tables(null_frac: float):
    """The reference's lineitem batches as Arrow tables; with null_frac,
    l_discount and l_shipdate get nulls from a seeded mask."""
    rng = np.random.RandomState(6)
    tables = []
    for b in jax_tpch.gen_lineitem(N_ROWS, batch_rows=BATCH_ROWS):
        t = b.to_arrow()
        for name in ("l_discount", "l_shipdate") if null_frac else ():
            i = t.schema.get_field_index(name)
            nulls = pa.array(rng.rand(t.num_rows) < null_frac)
            t = t.set_column(i, name, pa.compute.if_else(
                nulls, pa.scalar(None, t.schema.field(i).type), t.column(i)))
        tables.append(t)
    return tables


def _both(tables, build_jax, build_port):
    jax_sess = TpuSession()
    jdf = jax_sess.create_dataframe([JaxBatch.from_arrow(t) for t in tables],
                                    num_partitions=3)
    port_sess = GpuSession(device="cpu")
    pdf = port_sess.create_dataframe(
        [arrow_to_batch(t, "cpu") for t in tables], num_partitions=3)
    return build_jax(jdf).collect(), build_port(pdf).collect()


def _assert_rows_close(ref, got):
    assert len(ref) == len(got) == 1
    assert len(ref[0]) == len(got[0])
    for rv, gv in zip(ref[0], got[0]):
        if rv is None or isinstance(rv, (int, np.integer)):
            assert gv == rv
        else:
            assert gv == pytest.approx(rv, rel=F64_RTOL)


def test_q6_matches_reference():
    ref, got = _both(_lineitem_tables(0.0), jax_tpch.q6, port_tpch.q6)
    _assert_rows_close(ref, got)
    assert got[0][0] > 0


@pytest.mark.parametrize("variant", ["empty_2030", "nulls_10pct", "count"])
def test_q6_variants_match_reference(variant):
    kw = {}
    if variant == "empty_2030":
        kw = dict(lo=(2030, 1, 1), hi=(2031, 1, 1))
    if variant == "count":
        kw = dict(with_count=True)
    tables = _lineitem_tables(0.1 if variant == "nulls_10pct" else 0.0)
    ref, got = _both(tables, lambda df: q6_shape(df, JE, JT, **kw),
                     lambda df: q6_shape(df, PE, PT, **kw))
    _assert_rows_close(ref, got)
    if variant == "empty_2030":
        assert got == ref == [(None,)]
    if variant == "count":
        assert got[0][1] == ref[0][1] > 0


@pytest.mark.parametrize("fuse", ["true", "false"])
def test_q6_plan_prunes_to_four_columns_and_splits_the_aggregate(fuse):
    """With spark.rapids.sql.tpu.fuseStages (the default) the partial
    aggregate, the filter and the projection form one fused segment, as
    the reference's fuse_segments places them; without, they run op by
    op."""
    sess = GpuSession({"spark.rapids.sql.tpu.fuseStages": fuse},
                      device="cpu")
    batches = port_tpch.lineitem_batches(2_000, "cpu", batch_rows=500)
    plan = port_tpch.q6(sess.create_dataframe(batches, num_partitions=4)
                        ).physical_plan()
    assert isinstance(plan, GpuHashAggregateExec) and plan.mode == "final"
    chain = ["GpuHashAggregate", "GpuFilter", "GpuProject"]
    shape = (["GpuFusedSegment"] + ["* " + n for n in chain]
             if fuse == "true" else chain)
    assert [line.split("[")[0].split("Schema")[0].strip()
            for line in plan.tree_string().splitlines()] == [
        "GpuHashAggregate", "GpuSinglePartition"] + shape + [
        "GpuInMemoryScan"]
    node = plan
    while not isinstance(node, (GpuProjectExec, GpuFusedSegmentExec)):
        node = node.children[0]
    if fuse == "true":
        node = node.chain[-1]
    assert isinstance(node, GpuProjectExec)
    assert set(node.schema.names) == {"l_quantity", "l_extendedprice",
                                      "l_discount", "l_shipdate"}


def test_q6_from_host_arrow_and_numpy_inputs():
    """create_dataframe cuts host data into batchSizeRows batches."""
    chunk = port_tpch.gen_lineitem(3_000, batch_rows=3_000)[0]
    conf = {"spark.rapids.sql.batchSizeRows": "700"}
    sess = GpuSession(conf, device="cpu")
    from_numpy = sess.create_dataframe(chunk, port_tpch.LINEITEM_SCHEMA,
                                       num_partitions=2)
    table = port_tpch.lineitem_batches(3_000, "cpu", batch_rows=3_000
                                       )[0].to_arrow()
    from_arrow = sess.create_dataframe(table, num_partitions=2)
    for df in (from_numpy, from_arrow):
        assert sum(b.num_rows for p in df.plan.partitions for b in p) == 3_000
        assert max(b.num_rows for p in df.plan.partitions for b in p) == 700
    assert port_tpch.q6(from_numpy).collect() == \
        port_tpch.q6(from_arrow).collect()
    assert from_numpy.count() == 3_000
    one = GpuSession(device="cpu").create_dataframe(table)
    assert port_tpch.q6(one).collect() == port_tpch.q6(from_arrow).collect()


def test_session_checks_batches_and_conf():
    with pytest.raises(NotImplementedError, match="CPU oracle"):
        GpuSession({"spark.rapids.sql.enabled": "false"}, device="cpu")
    batches = port_tpch.lineitem_batches(10, torch.device("cpu"))
    sess = GpuSession(device="cpu")
    # l_tax is a decimal: the decimal quotient is not ported
    with pytest.raises(NotImplementedError, match="decimal Divide"):
        sess.create_dataframe(batches).filter(PE.col("l_tax") / 1)
