"""Decimal128 and Decimal64 queries through the port's GpuSession on the
CPU, against the JAX package, exactly.

Every case of ``tests/test_decimal128.py`` and ``tests/test_decimal.py``
but four that wait: Decimal128 sort, group and join keys and its murmur3
hash (ROADMAP queue 2 item 12a (rest); here they must raise), and the
injected OOM (queue 1 item 7).  The tables are the reference tests' own
(``df`` at 200 rows in batches of 80 and 70, 2 partitions), fed to both
packages as the same unscaled Python ints; the two-limb queries are
``testing/held.py``'s ``DEC_ROW_QUERIES`` and ``DEC_AGG_QUERIES``, which
build the JAX twin from the same function.  The JAX side is its CPU
oracle (``spark.rapids.sql.enabled=false``), the Python-int semantics its
device path is tested against, and for three elementwise queries its
device path too.  TPC-H q1 with its decimal types (``q1_decimal``) runs
at 20,000 rows in 3 partitions against the same query in the JAX DSL.

The port returns decimals as ``decimal.Decimal`` (through Arrow), the JAX
package as unscaled ints: each port value is turned into its unscaled
int, and every value compares exactly (tolerance 0), doubles included.
"""
import decimal

import jax.numpy as jnp
import numpy as np
import pytest

from spark_rapids_tpu import expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.batch import Schema as JaxSchema
from spark_rapids_tpu.kernels import decimal as JD
from spark_rapids_tpu.kernels.sort import SortOrder as JaxSortOrder

from spark_rapids_tpu_torch import expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import to_python
from spark_rapids_tpu_torch.kernels.sort import SortOrder
from spark_rapids_tpu_torch.plan.fused import GpuFusedSegmentExec
from spark_rapids_tpu_torch.testing import held
from spark_rapids_tpu_torch.testing import tpch as port_tpch
from tests.test_queries import _normalize

ORACLE = {"spark.rapids.sql.enabled": "false"}
DEVICE = {"spark.rapids.sql.enabled": "true"}


def unscaled(v):
    """A port value as the JAX package gives it: a decimal's unscaled
    int."""
    if isinstance(v, decimal.Decimal):   # its digits, exactly
        sign, digits, _ = v.as_tuple()
        n = int("".join(map(str, digits)))
        return -n if sign else n
    return v


def port_rows(df) -> list:
    return [tuple(unscaled(v) for v in r) for r in df.collect()]


def assert_rows(got, want, ordered=False):
    if not ordered:
        got, want = _normalize(got), _normalize(want)
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g == w, (g, w)


def dec_lists(n=200, seed=11):
    """``tests/test_decimal128.py`` ``df``'s columns as Python lists."""
    data, valid = held.decimal_columns(n, seed)
    out = {}
    for c in "ab":
        out[c] = [to_python(lo, hi) if ok else None
                  for (lo, hi), ok in zip(data[c].tolist(), valid[c])]
    out["c"] = data["c"].tolist()
    out["k"] = data["k"].tolist()
    return out


def both_dfs(lists, port_schema, jax_schema, rows_per_batch, parts,
             conf=None, jax_conf=ORACLE):
    """The same lists as batches of ``rows_per_batch`` in both packages."""
    n = len(next(iter(lists.values())))
    cuts = range(0, n, rows_per_batch)
    pdf = GpuSession(conf, device="cpu").create_dataframe(
        [ColumnarBatch.from_pydict({c: v[o:o + rows_per_batch]
                                    for c, v in lists.items()},
                                   port_schema, "cpu") for o in cuts],
        num_partitions=parts)
    jdf = TpuSession(jax_conf).create_dataframe(
        [JaxBatch.from_pydict({c: v[o:o + rows_per_batch]
                               for c, v in lists.items()}, jax_schema)
         for o in cuts], num_partitions=parts)
    return pdf, jdf


JAX_DEC_SCHEMA = JaxSchema(("a", "b", "c", "k"), held.decimal_schema(JT))


def dec_dfs(n=200, seed=11, parts=2, conf=None, jax_conf=ORACLE):
    return both_dfs(dec_lists(n, seed), held.DEC_SCHEMA, JAX_DEC_SCHEMA, 80,
                    parts, conf, jax_conf)


def test_decimal128_roundtrip():
    """Unscaled ints through a Decimal128 column, and through Arrow's
    decimal128 slots, exactly."""
    vals = [0, None, 10**37, -(10**37), 123456789012345678901234567,
            -(1 << 100), 10**38 - 1, -(10**38 - 1)]
    sch = Schema(("v",), (T.DecimalType(38, 0),))
    b = ColumnarBatch.from_pydict({"v": vals}, sch, "cpu")
    assert b.columns[0].to_pylist() == vals
    assert [unscaled(r[0]) for r in b.rows()] == vals
    again = arrow_to_batch(b.to_arrow(), "cpu")
    assert again.columns[0].to_pylist() == vals
    j = JaxBatch.from_pydict({"v": vals}, JaxSchema(("v",),
                                                    (JT.DecimalType(38, 0),)))
    assert j.to_pydict()["v"] == again.columns[0].to_pylist()
    assert b.columns[0].slice_rows(2, 5).to_pylist() == vals[2:5]


@pytest.mark.parametrize("name", [q for q in held.DEC_ROW_QUERIES
                                  if q != "dec_casts"])   # casts: below
def test_decimal128_elementwise(name):
    """add / subtract, the multiply whose products past 38 digits are null,
    the mixed Decimal64 + Decimal128 add, the comparison filter and the
    divide: the oracle's rows."""
    q = held.DEC_ROW_QUERIES[name]
    pdf, jdf = dec_dfs()
    assert_rows(port_rows(q(pdf)), q(jdf, JE, JT).collect())


@pytest.mark.parametrize("name", ["dec_add_sub", "dec_mul", "dec_divide"])
def test_decimal128_elementwise_device_path(name):
    """The same against the JAX device path's two-limb kernels."""
    q = held.DEC_ROW_QUERIES[name]
    pdf, jdf = dec_dfs(jax_conf=DEVICE)
    assert_rows(port_rows(q(pdf)), q(jdf, JE, JT).collect())


def test_decimal128_casts():
    """``test_decimal128_casts``: up, HALF_UP down, the narrowing that
    overflows, the widening of a Decimal64, to LONG and from INT, the
    oracle's rows.  The cast to DOUBLE is the reference's ``to_double(a) /
    10.0**4`` (``kernels/decimal.py:209``), run eagerly, bit for bit: the
    oracle divides Python ints exactly, and the device path's XLA program
    rounds that expression otherwise (-91087068067082203710 at scale 4 is
    -9108706806708220.0 eagerly and -9108706806708222.0 jitted); the
    reference test's float tolerance hides both."""
    pdf, jdf = dec_dfs()
    got = _normalize(port_rows(held.dec_casts(pdf)))
    want = _normalize(held.dec_casts(jdf, JE, JT).collect())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:4] + g[5:] == w[:4] + w[5:], (g, w)
        if g[0] is None:                 # a is null
            assert g[4] is None and w[4] is None
            continue
        a = g[0] // 100                  # up = a * 10**2, exactly
        h, lo = JD.const128(a)
        eager = float(JD.to_double(jnp.asarray([h]), jnp.asarray([lo]))[0]
                      / 10.0 ** 4)
        assert np.float64(g[4]).view(np.int64) == \
            np.float64(eager).view(np.int64), (a, g[4], eager)


@pytest.mark.parametrize("name", list(held.DEC_AGG_QUERIES))
def test_decimal128_aggregates(name):
    """SUM grouped and global (decimal(25,4) -> decimal(35,4), decimal(30,2)
    -> decimal(38,2), decimal(12,2) -> decimal(22,2)), the overflow to
    null, AVG, MIN / MAX grouped and global."""
    q = held.DEC_AGG_QUERIES[name]
    pdf, jdf = dec_dfs()
    assert_rows(port_rows(q(pdf)), q(jdf, JE, JT).collect())


def test_decimal128_sum_overflow_nulls():
    """Exceeding the result precision yields NULL, not a wrapped value:
    group 1 at update (one partition) and at the merge (its partials
    from two partitions poison it)."""
    big = 10 ** 37
    lists = {"v": [big * 9, big * 9, big * 9, 5], "k": [1, 1, 1, 2]}
    for parts in (1, 2):
        pdf, jdf = both_dfs(
            lists, Schema(("v", "k"), (T.DecimalType(38, 0), T.INT)),
            JaxSchema(("v", "k"), (JT.DecimalType(38, 0), JT.INT)), 2, parts)
        got = port_rows(pdf.group_by("k").agg(PE.sum_(PE.col("v"))))
        assert dict(got) == {1: None, 2: 5}
        assert_rows(got, jdf.group_by("k").agg(JE.sum_(JE.col("v"))
                                               ).collect())


def test_decimal128_through_shuffle():
    """SUM128 partials through the hash exchange (4 shuffle partitions)
    and the coalesced reader: the oracle's rows."""
    pdf, jdf = dec_dfs(parts=2, conf={"spark.sql.shuffle.partitions": "4"})
    q = held.dec_sum_grouped
    assert "GpuShuffleExchange" in q(pdf).explain()
    assert_rows(port_rows(q(pdf)), q(jdf, JE, JT).collect())


def test_avg_decimal_result_type():
    """avg(decimal(12,2)) -> decimal(16,6), avg(decimal(25,4)) ->
    decimal(29,8), each group exact against Python's HALF_UP."""
    pdf, _ = dec_dfs()
    q = held.dec_avg(pdf)
    assert [d for d in q.schema.dtypes][1:] == [T.DecimalType(16, 6),
                                                  T.DecimalType(29, 8)]
    got = {r[0]: r[1] for r in port_rows(q)}
    lists = dec_lists()
    assert len(got) == 7
    for k in got:
        vs = [c for c, kk in zip(lists["c"], lists["k"]) if kk == k]
        num = sum(vs) * 10 ** 4
        q_, r = divmod(abs(num), len(vs))
        q_ += 1 if 2 * r >= len(vs) else 0
        assert got[k] == (-q_ if num < 0 else q_)


def test_decimal128_divide_fuzz_vs_python():
    """The reference test's fuzz through the query: random magnitudes,
    signs, zero divisors, results past the precision; the oracle's rows,
    which are Python's exact HALF_UP quotients."""
    rng = np.random.RandomState(7)
    n = 300
    a = [int(x) * int(10 ** int(e)) for x, e in zip(
        rng.randint(-10**9, 10**9, n), rng.randint(0, 12, n))]
    b = [int(x) * int(10 ** int(e)) for x, e in zip(
        rng.randint(-10**6, 10**6, n), rng.randint(0, 6, n))]
    b[::17] = [0] * len(b[::17])
    for i in rng.choice(n, n // 10, replace=False):
        a[i] = None
    pdf, jdf = both_dfs(
        {"a": a, "b": b},
        Schema(("a", "b"), (T.DecimalType(25, 4), T.DecimalType(12, 2))),
        JaxSchema(("a", "b"), (JT.DecimalType(25, 4), JT.DecimalType(12, 2))),
        n, 1)
    got = port_rows(pdf.select((PE.col("a") / PE.col("b")).alias("q")))
    assert_rows(got, jdf.select((JE.col("a") / JE.col("b")).alias("q")
                                ).collect(), ordered=True)
    assert sum(r[0] is None for r in got) >= len(b[::17])


def test_decimal128_keys_raise():
    """Decimal128 as a sort, group or join key no longer raises (the keys
    of ROADMAP queue 2 item 12a (rest) are ported): each query gives the
    oracle's rows."""
    pdf, jdf = dec_dfs(n=60)
    for q, ordered in (
            (lambda df, E, O: df.order_by(("a", O(True)), ("k", O(True))),
             True),
            (lambda df, E, O: df.group_by("a").agg(E.count()), False),
            (lambda df, E, O: df.join(df.select(E.col("a").alias("a2")),
                                      on=([E.col("a")], [E.col("a2")]),
                                      how="left"), False)):
        assert_rows(port_rows(q(pdf, PE, SortOrder)),
                    q(jdf, JE, JaxSortOrder).collect(), ordered=ordered)


def test_decimal128_runs_op_by_op():
    """Every two-limb query plans on the port's execs (there is no CPU
    fallback); a Decimal128 expression or a SUM128 / MIN128 / MAX128
    buffer does not lower into a fused program, so its chain runs op by
    op, with the same rows."""
    pdf, _ = dec_dfs()
    for q in (held.dec_add_sub(pdf), held.dec_sum_grouped(pdf),
              held.dec_min_max_global(pdf)):
        plan = q.physical_plan()
        nodes, todo = [], [plan]
        while todo:
            n = todo.pop()
            nodes.append(n)
            todo.extend(n.children)
        assert not any(isinstance(n, GpuFusedSegmentExec) for n in nodes)


# -- Decimal64 (tests/test_decimal.py) ----------------------------------------

D12_2, D10_4 = T.DecimalType(12, 2), T.DecimalType(10, 4)
J12_2, J10_4 = JT.DecimalType(12, 2), JT.DecimalType(10, 4)


def dec64_dfs(parts=2, n=200, seed=6):
    """``tests/test_decimal.py`` ``df``: a decimal(12,2), b decimal(10,4),
    k INT, in batches of 70."""
    rng = np.random.RandomState(seed)
    a = rng.randint(-10**9, 10**9, n).tolist()
    b = rng.randint(-10**7, 10**7, n).tolist()
    k = rng.randint(0, 9, n).tolist()
    for i in rng.choice(n, n // 8, replace=False):
        a[i] = None
    return both_dfs({"a": a, "b": b, "k": k},
                    Schema(("a", "b", "k"), (D12_2, D10_4, T.INT)),
                    JaxSchema(("a", "b", "k"), (J12_2, J10_4, JT.INT)), 70,
                    parts)


def dec64_queries(E, TT, D12, D10):
    c, C = E.col, E.Cast
    return {
        "add_sub_mul": lambda d: d.select(
            c("k"), (c("a") + c("b")).alias("s"), (c("a") - c("b")).alias("d"),
            (C(c("a"), TT.DecimalType(8, 2)) * C(c("b"), TT.DecimalType(8, 4))
             ).alias("m")),
        "filter": lambda d: d.filter(c("a") > C(c("b"), D12)).select(
            c("a"), c("b")),
        "casts": lambda d: d.select(
            C(c("a"), TT.DecimalType(14, 4)).alias("up"),
            C(c("a"), TT.DecimalType(10, 0)).alias("down"),
            C(c("a"), TT.LONG).alias("l"), C(c("a"), TT.DOUBLE).alias("dd"),
            C(c("k"), TT.DecimalType(10, 2)).alias("fromint")),
        "group_key": lambda d: d.group_by("a").agg(E.count().alias("n")),
        "sum_promotes": lambda d: d.group_by("k").agg(E.sum_("a").alias("sa")),
    }


@pytest.mark.parametrize("name", ["add_sub_mul", "filter", "casts",
                                  "group_key", "sum_promotes"])
def test_decimal64_queries(name):
    """Decimal64 arithmetic, the comparison filter, the casts (HALF_UP
    down, to LONG and DOUBLE, from INT), a Decimal64 group key, and
    sum(decimal(12,2)) -> decimal(22,2) through SUM128."""
    pdf, jdf = dec64_dfs()
    pq = dec64_queries(PE, T, D12_2, D10_4)[name]
    jq = dec64_queries(JE, JT, J12_2, J10_4)[name]
    assert_rows(port_rows(pq(pdf)), jq(jdf).collect())


def test_decimal64_sort_keys_in_order():
    pdf, jdf = dec64_dfs()
    got = port_rows(pdf.order_by(("a", SortOrder(True)),
                                 ("b", SortOrder(False))))
    assert_rows(got, jdf.order_by(("a", JaxSortOrder(True)),
                                  ("b", JaxSortOrder(False))).collect(),
                ordered=True)


def test_decimal_add_widens_past_64():
    """decimal(18,0) + decimal(18,0) -> decimal(19,0): 1.8e18 held exactly
    in two limbs."""
    pdf, jdf = both_dfs(
        {"x": [10**17 * 9, 5], "y": [10**17 * 9, 7]},
        Schema(("x", "y"), (T.DecimalType(18, 0),) * 2),
        JaxSchema(("x", "y"), (JT.DecimalType(18, 0),) * 2), 2, 1)
    got = port_rows(pdf.select((PE.col("x") + PE.col("y")).alias("s")))
    assert got == [(10**17 * 18,), (12,)]
    assert_rows(got, jdf.select((JE.col("x") + JE.col("y")).alias("s")
                                ).collect(), ordered=True)


# -- TPC-H q1 with its decimal types --------------------------------------------

def jax_q1_decimal(df):
    """``q1_decimal`` in the JAX package's DSL: the same expressions over
    the reference's lineitem."""
    from spark_rapids_tpu.testing import tpch as jtpch
    one = JE.lit(1, JT.DecimalType(1, 0))
    c = JE.col
    disc_price = c("l_extendedprice") * (one - c("l_discount"))
    charge = disc_price * (one + c("l_tax"))
    return (df.filter(c("l_shipdate") <= JE.lit(jtpch._days(1998, 9, 2),
                                                JT.DATE))
            .group_by("l_linenumber")
            .agg(JE.sum_(c("l_quantity")).alias("sum_qty"),
                 JE.sum_(c("l_extendedprice")).alias("sum_base_price"),
                 JE.sum_(disc_price).alias("sum_disc_price"),
                 JE.sum_(charge).alias("sum_charge"),
                 JE.avg(c("l_quantity")).alias("avg_qty"),
                 JE.avg(c("l_extendedprice")).alias("avg_price"),
                 JE.avg(c("l_discount")).alias("avg_disc"),
                 JE.count().alias("count_order")))


def test_q1_decimal_matches_reference():
    """q1_decimal over 20,000 lineitem rows in 3 partitions: the spec's
    decimal types, every value exact; the JAX package's rows."""
    batches = port_tpch.lineitem_batches(20_000, "cpu", batch_rows=5_001)
    pdf = GpuSession(device="cpu").create_dataframe(batches,
                                                    num_partitions=3)
    q = port_tpch.q1_decimal(pdf)
    assert list(q.schema.dtypes)[1:] == [
        T.DecimalType(22, 2), T.DecimalType(22, 2), T.DecimalType(36, 4),
        T.DecimalType(38, 6), T.DecimalType(16, 6), T.DecimalType(16, 6),
        T.DecimalType(16, 6), T.LONG]
    got = port_rows(q)
    jdf = TpuSession(ORACLE).create_dataframe(
        [JaxBatch.from_arrow(b.to_arrow()) for b in batches],
        num_partitions=3)
    want = jax_q1_decimal(jdf).collect()
    assert_rows(got, want)
    assert len(got) == 7 and all(v is not None for r in got for v in r)
