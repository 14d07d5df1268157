"""TPC-DS q5 through the port's GpuSession on the CPU, against the JAX
package's CPU oracle (``spark.rapids.sql.enabled=false``: its rows equal
its device path's within 1e-9 on these tables) on the same tables: three
channels (catalog, store,
web) of 4,000 sales rows (seeds 17, 18, 19) and 1,500 returns rows (seeds
19, 20, 21), 2 partitions each, and date_dim, as tests/test_tpcds.py:53
draws them.

q5 unions each channel's sales with its returns, names the channel with a
string literal, unions the three legs, joins a one-month date window and
rolls up (channel, id) through an expand.  Its rows must be the
reference's in order under the rule of ``bench.py`` ``_check_rows``
(exact but for the float sums, within 1e-6 relative), with broadcast
joins and with shuffled ones; q5_subset (:29) is held against the
reference beside.
"""
import pytest

from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpcds as jax_tpcds

from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.plan.execs.basic import GpuUnionExec
from spark_rapids_tpu_torch.plan.execs.misc import GpuExpandExec
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds
from tests.test_torch_q14a import ORACLE_CONF, check_rows_in_order

CHANNELS = ("catalog", "store", "web")
N_SALES, N_RETURNS = 4000, 1500
# the date join and the rollup's exchange with 4 partitions: shuffled
SHUFFLED_CONF = {"spark.rapids.sql.join.broadcastRowThreshold": "10",
                 "spark.sql.shuffle.partitions": "4"}


def _tables():
    out = {}
    for i, name in enumerate(CHANNELS):
        out[name] = (
            [b.to_arrow() for b in jax_tpcds.gen_channel_sales(
                N_SALES, seed=17 + i)],
            [b.to_arrow() for b in jax_tpcds.gen_channel_returns(
                N_RETURNS, seed=19 + i)])
    return out, jax_tpcds.gen_date_dim().to_arrow()


def _q5(mod, sess, make, tables, dd):
    channels = {n: tuple(sess.create_dataframe([make(b) for b in t],
                                               num_partitions=2)
                         for t in tables[n]) for n in CHANNELS}
    return mod.q5(channels, sess.create_dataframe([make(dd)]))


def test_q5_matches_reference():
    """q5's rows in order: the grand total first, each channel's subtotal
    before its ids; the port's union has the legs' 12 partitions."""
    tables, dd = _tables()
    want = _q5(jax_tpcds, TpuSession(ORACLE_CONF), JaxBatch.from_arrow, tables,
               dd).collect()
    for conf in (None, SHUFFLED_CONF):
        df = _q5(port_tpcds, GpuSession(conf, device="cpu"),
                 lambda b: arrow_to_batch(b, "cpu"), tables, dd)
        check_rows_in_order(df.collect(), want)
    assert want[0][:2] == (None, None)
    assert {r[0] for r in want if r[1] is None} == {None, *CHANNELS}
    unions = []
    stack = [df.physical_plan()]
    while stack:
        n = stack.pop()
        stack += list(n.children)
        unions += [n] if isinstance(n, GpuUnionExec) else []
        if isinstance(n, GpuExpandExec):
            assert len(n.projections) == 3
    top = [u for u in unions if not any(u in v.children for v in unions)]
    assert len(unions) == 5 and top[0].num_partitions() == 12


def test_q5_subset_matches_reference():
    """q5_subset over store_sales 60,000 rows in 3 partitions and date_dim
    (tests/test_tpcds.py:29): the reference's per-store sums."""
    ss = [b.to_arrow() for b in jax_tpcds.gen_store_sales(
        60_000, batch_rows=20_001)]
    dd = jax_tpcds.gen_date_dim().to_arrow()
    sess = TpuSession(ORACLE_CONF)
    want = jax_tpcds.q5_subset(
        sess.create_dataframe([JaxBatch.from_arrow(t) for t in ss],
                              num_partitions=3),
        sess.create_dataframe([JaxBatch.from_arrow(dd)])).collect()
    port = GpuSession(device="cpu")
    got = port_tpcds.q5_subset(
        port.create_dataframe([arrow_to_batch(t, "cpu") for t in ss],
                              num_partitions=3),
        port.create_dataframe([arrow_to_batch(dd, "cpu")])).collect()
    check_rows_in_order(sorted(got), sorted(want))
    assert len(got) == 50


@pytest.mark.parametrize("how", ["sales", "returns"])
def test_q5_legs_name_their_channel(how):
    """A leg's union of sales and returns, then the channel column: a
    string literal in every row, after the leg's six columns."""
    tables, _ = _tables()
    sess = GpuSession(device="cpu")
    from spark_rapids_tpu_torch.expressions import lit
    side = 0 if how == "sales" else 1
    df = sess.create_dataframe([arrow_to_batch(b, "cpu")
                                for b in tables["web"][side]])
    named = df.with_column("channel", lit("web"))
    rows = named.collect()
    assert named.schema.names[-1] == "channel"
    assert len(rows) == (N_SALES if how == "sales" else N_RETURNS)
    assert {r[-1] for r in rows} == {"web"}
