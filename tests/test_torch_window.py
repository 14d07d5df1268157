"""Window functions through the port's GpuSession on the CPU, against the
JAX package on the same tables.

The table is tests/test_window.py's ``wdf`` (k INT of 11 keys, t INT
0-39, v LONG and x DOUBLE with n // 9 nulls each, 300 rows in batches of
100, 3 partitions), drawn by ``held.window_columns`` with the row index
``i`` beside; both packages get the same batches, which each deals to its
partitions round-robin.  The reference runs through its CPU oracle
(``spark.rapids.sql.enabled=false``), which its own tests hold its device
path to; its device path compiles each query on this CPU.  The cases:
all of tests/test_window.py's ``WINDOW_EXPRS``, a few of them in one
partition, its other query tests, the inputs of its two-pass tests with
their ``batchSizeRows`` (the port runs them through its one path), the
held window queries W1-W7 of ``testing/held.py``, the float-key bounded
RANGE frame the port refuses, and TPC-DS q98 (store_sales 24,000 rows in
2 partitions, rows in order).  Rows compare as tests/test_queries.py's
``_normalize`` / ``_eq_val`` do: sorted, floats within 1e-9 relative.

Where the reference's device path and its oracle differ, a pin test runs
the device path, the oracle and the port on one tiny input (ROADMAP queue
3): MIN over NaN (the device path's running and whole-partition
extremes carry the NaN), a frame sum after a NaN (its prefix carries it),
the signed zero of MIN / MAX (the oracle's depends on the rows' order),
and a bounded RANGE frame over an INT key near -2**31 and a null key
(both binary-search the same run).
"""
import math
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpcds as jax_tpcds
from tests.test_queries import _eq_val, _normalize
from tests.test_window import WINDOW_EXPRS, wdf

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.kernels.sort import SortOrder as PortOrder
from spark_rapids_tpu_torch.testing import held
from spark_rapids_tpu_torch.testing import tpcds as port_tpcds

ORACLE = {"spark.rapids.sql.enabled": "false"}
DEVICE = {"spark.rapids.sql.enabled": "true"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tests' small tensors: under
    pytest-xdist the workers share the cores, and each torch op's thread
    pool then waits on the others (a 4,097-row plain kernel ran 130x
    slower in 6 processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(n=300, seed=2, batch_rows=100):
    """The window table as Arrow batches (what both packages upload)."""
    data, validity = held.window_columns(n, seed)
    return [ColumnarBatch.to_arrow(b) for b in held.window_batches(
        data, validity, "cpu", batch_rows)]


def _jax_df(sess, tables, parts):
    return sess.create_dataframe([JaxBatch.from_arrow(t) for t in tables],
                                 num_partitions=parts)


def _port_df(sess, tables, parts):
    return sess.create_dataframe([arrow_to_batch(t, "cpu") for t in tables],
                                 num_partitions=parts)


def _assert_rows(got, want, ordered=False):
    if not ordered:
        got, want = _normalize(got), _normalize(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_eq_val(a, b) for a, b in zip(g, w)), \
            (g, w)


def _check(build, tables=None, parts=3, conf=None, ordered=False):
    """build(df, E) in both packages: the reference's oracle rows, then
    the port's, compared."""
    tables = _tables() if tables is None else tables
    want = build(_jax_df(TpuSession(ORACLE), tables, parts), JE).collect()
    got = build(_port_df(GpuSession(conf, device="cpu"), tables, parts),
                PE).collect()
    _assert_rows(got, want, ordered)
    return got


def test_window_columns_are_wdf():
    """held.window_columns(300) is wdf's table row for row."""
    rows = wdf(TpuSession(ORACLE)).collect()
    mine = [r[:4] for t in _tables() for r in ColumnarBatch.from_arrow(
        t, "cpu").rows()]
    assert sorted(mine, key=repr) == sorted(rows, key=repr)
    assert [r[4] for t in _tables() for r in ColumnarBatch.from_arrow(
        t, "cpu").rows()] == list(range(300))


def _to_port(e):
    """A JAX expression of tests/test_window.py in the port's DSL."""
    name = type(e).__name__
    if name == "Col":
        return PE.col(e.name)
    if name == "WindowExpression":
        f = e.spec.frame
        return PE.over(_to_port(e.function),
                       [_to_port(p) for p in e.spec.partition_by],
                       [(_to_port(o), PortOrder(s.ascending, s.nulls_first))
                        for o, s in e.spec.order_by],
                       PE.WindowFrame(f.kind, f.start, f.end))
    if name in ("Lead", "Lag"):
        return getattr(PE, name)(_to_port(e.child), e.offset)
    if e.children:
        return {"Sum": PE.sum_, "Count": PE.count, "Average": PE.avg,
                "Min": PE.min_, "Max": PE.max_}[name](_to_port(e.children[0]))
    return getattr(PE, "count" if name == "Count" else name)()


def _window_case(wexpr):
    def build(df, E):
        return df.with_column("w", wexpr if E is JE else _to_port(wexpr))
    return build


@pytest.mark.parametrize("wexpr", WINDOW_EXPRS, ids=lambda e: repr(e)[:70])
def test_window_functions(wexpr):
    _check(_window_case(wexpr))


@pytest.mark.parametrize("wexpr", [WINDOW_EXPRS[i] for i in (0, 3, 8, 11,
                                                            13, 19, 23)],
                         ids=lambda e: repr(e)[:70])
def test_window_functions_one_partition(wexpr):
    _check(_window_case(wexpr), parts=1)


def test_window_no_partition():
    _check(lambda df, E: df.with_column(
        "w", E.over(E.RowNumber(), order_by=["t", "v"])),
        tables=_tables(n=120))


def test_rank_family_extended():
    def build(df, E):
        def w(fn):
            return E.over(fn, partition_by=["k"], order_by=["t"])
        return df.select(E.col("k"), E.col("t"),
                         w(E.PercentRank()).alias("pr"),
                         w(E.CumeDist()).alias("cd"),
                         w(E.Ntile(3)).alias("nt"))
    _check(build)


def test_first_last_nth_value():
    """The three frames share (k; t): one Window node in the port, three
    frames of one node that the reference's tag sends to its CPU."""
    def build(df, E):
        v = E.col("v")
        return df.select(
            E.col("k"), E.col("t"), v,
            E.over(E.FirstValue(v), partition_by=["k"],
                   order_by=["t"]).alias("fv"),
            E.over(E.LastValue(v), partition_by=["k"], order_by=["t"],
                   frame=E.WindowFrame("range", None, None)).alias("lv"),
            E.over(E.NthValue(v, 2), partition_by=["k"], order_by=["t"],
                   frame=E.WindowFrame("rows", 1, 1)).alias("nv"))
    _check(build)
    df = build(_port_df(GpuSession(device="cpu"), _tables(), 3), PE)
    assert df.explain().count("GpuWindow[") == 1


def test_window_nested_in_scalar_expr():
    def build(df, E):
        return df.select(
            E.col("k"), E.col("t"),
            (E.over(E.sum_("v"), partition_by=["k"], order_by=["t"])
             + E.col("v")).alias("run_plus_v"),
            (E.over(E.RowNumber(), partition_by=["k"], order_by=["t"]) * 10
             ).alias("rn10"))
    _check(build)


def test_two_window_specs_one_select():
    def build(df, E):
        w1 = E.over(E.sum_("v"), partition_by=["k"], order_by=["t"])
        return df.select(
            E.col("k"), E.col("t"), w1.alias("a"), (w1 + 1).alias("a1"),
            E.over(E.Rank(), partition_by=["t"], order_by=["v"]).alias("b"),
            E.over(E.count(), partition_by=["k"]).alias("c"))
    _check(build)
    df = build(_port_df(GpuSession(device="cpu"), _tables(), 3), PE)
    assert df.explain().count("GpuWindow[") == 3     # a and a1 share one


def test_filter_and_project_above_a_window_fuse():
    """The window exec is a boundary of the fused-segment pass: the
    filter and projections above it become one segment over it."""
    def build(df, E):
        return df.select("i", "v", E.over(
            E.sum_("v"), partition_by=["k"], order_by=["t"]).alias("s")) \
            .filter(E.col("s") > E.lit(0)) \
            .select("i", (E.col("s") + E.col("v")).alias("sv"))
    _check(build)
    text = build(_port_df(GpuSession(device="cpu"), _tables(), 3),
                 PE).explain().splitlines()
    assert text[0].startswith("GpuFusedSegment[Project <- Project <- Filter]")
    assert any(line.strip().startswith("GpuWindow[") and "*" not in line
               for line in text)


# -- the inputs of tests/test_window.py's two-pass tests -----------------------

def _kvx_tables(k, v, x, key_type, batch):
    n = len(k)
    return [pa.table({"k": pa.array(k[o:o + batch], key_type),
                      "v": pa.array(v[o:o + batch], pa.int64()),
                      "x": pa.array(x[o:o + batch], pa.float64())})
            for o in range(0, n, batch)]


def _huge_key():
    rng = np.random.RandomState(8)
    n = 2000
    k = [1] * (n // 2) + rng.randint(2, 6, n - n // 2).tolist()
    v = rng.randint(-50, 50, n).tolist()
    x = rng.randn(n).tolist()
    for i in rng.choice(n, n // 7, replace=False):
        v[i] = None
    return _kvx_tables(k, v, x, pa.int32(), 250), "256"


def _global():
    rng = np.random.RandomState(12)
    n = 1000
    k = rng.randint(0, 5, n).tolist()
    v = rng.randint(-9, 9, n).tolist()
    x = rng.randn(n).tolist()
    return _kvx_tables(k, v, x, pa.int32(), 200), "128"


def _nan_keys():
    rng = np.random.RandomState(5)
    n = 800
    k = [float("nan") if i % 3 == 0 else float(i % 4) for i in range(n)]
    k[10], k[20] = -0.0, 0.0
    v = rng.randint(-9, 9, n).tolist()
    return _kvx_tables(k, v, [0.0] * n, pa.float64(), 160), "128"


def _high_cardinality():
    rng = np.random.RandomState(6)
    n = 400
    v = rng.randint(-9, 9, n).tolist()
    return _kvx_tables(list(range(n)), v, rng.randn(n).tolist(), pa.int32(),
                       100), "64"


def _huge_key_query(df, E):
    def w(fn):
        return E.over(fn, partition_by=["k"])
    return df.select(E.col("k"), E.col("v"), w(E.sum_("v")).alias("sv"),
                     w(E.count("v")).alias("nv"), w(E.count()).alias("nr"),
                     w(E.min_("v")).alias("mn"), w(E.max_("x")).alias("mx"),
                     w(E.avg("v")).alias("av"))


TWO_PASS = {
    "huge_key": (_huge_key, _huge_key_query),
    "global": (_global, lambda df, E: df.select(
        E.col("k"), E.col("v"), E.over(E.sum_("v")).alias("sv"),
        E.over(E.count()).alias("n"))),
    "nan_keys": (_nan_keys, lambda df, E: df.select(
        E.col("v"), E.over(E.sum_("v"), partition_by=["k"]).alias("sv"),
        E.over(E.count(), partition_by=["k"]).alias("n"))),
    "high_cardinality": (_high_cardinality, lambda df, E: df.select(
        E.col("k"), E.col("v"),
        E.over(E.sum_("v"), partition_by=["k"]).alias("sv"))),
}


@pytest.mark.parametrize("case", list(TWO_PASS))
def test_two_pass_inputs(case):
    """The reference takes its two-pass or key-batched path for these
    (a partition past batchSizeRows); the port's one path gives the
    oracle's rows."""
    make, build = TWO_PASS[case]
    tables, batch_rows = make()
    _check(build, tables=tables, parts=2,
           conf={"spark.rapids.sql.batchSizeRows": batch_rows})


@pytest.mark.parametrize("name", list(held.WINDOW_QUERIES))
def test_held_window_queries(name):
    """W1-W7 of testing/held.py, which chip_smoke.py runs at 15,003,037
    rows, at wdf's size."""
    _check(held.WINDOW_QUERIES[name])


def test_bounded_range_over_a_float_key_raises():
    we = {E: E.over(E.sum_("v"), partition_by=["k"], order_by=["x"],
                    frame=E.WindowFrame("range", -1, 1)) for E in (JE, PE)}
    explain = _jax_df(TpuSession(DEVICE), _tables(), 3).with_column(
        "w", we[JE]).explain()
    assert "will NOT" in explain
    df = _port_df(GpuSession(device="cpu"), _tables(), 3).with_column(
        "w", we[PE])
    with pytest.raises(NotImplementedError, match="bounded range frame"):
        df.collect()


def test_unported_window_inputs_raise():
    """What the reference's tag sends to its CPU raises, with its
    reason: a bounded RANGE frame over a descending key, FIRST_VALUE over
    strings."""
    df = _port_df(GpuSession(device="cpu"), _tables(), 3)
    with pytest.raises(NotImplementedError, match="single ascending"):
        df.with_column("w", PE.over(
            PE.sum_("v"), partition_by=["k"],
            order_by=[("t", PortOrder(False))],
            frame=PE.WindowFrame("range", -1, 1))).collect()
    strings = GpuSession(device="cpu").create_dataframe(
        pa.table({"k": pa.array([1, 1, 2], pa.int32()),
                  "s": pa.array(["a", "b", None])}))
    with pytest.raises(NotImplementedError, match="over strings"):
        strings.with_column("w", PE.over(PE.FirstValue(PE.col("s")),
                                         partition_by=["k"])).collect()


# -- TPC-DS q98 ----------------------------------------------------------------

N_SS = 24_000
SS_BATCH = N_SS // 3 + 1


def jax_q98(ss_df, dd_df, item_df):
    """q98 in the JAX package's DSL, as the port's builder writes it."""
    col, lit = JE.col, JE.lit
    dd = dd_df.filter((col("d_date_ord") >= lit(port_tpcds.Q98_FIRST_DAY))
                      & (col("d_date_ord") <= lit(port_tpcds.Q98_LAST_DAY)))
    cat = col("i_category")
    a, b, c = port_tpcds.Q98_CATEGORIES
    item = item_df.filter((cat == lit(a)) | (cat == lit(b))
                          | (cat == lit(c)))
    keys = ("i_item_id", "i_item_desc", "i_category", "i_brand")
    return (ss_df
            .join(item, on=([col("ss_item_sk")], [col("i_item_sk")]))
            .join(dd, on=([col("ss_sold_date_sk")], [col("d_date_sk")]))
            .group_by(*keys)
            .agg(JE.sum_("ss_ext_sales_price").alias("itemrevenue"))
            .select(*keys, col("itemrevenue"),
                    (col("itemrevenue") * lit(100) / JE.over(
                        JE.sum_("itemrevenue"), partition_by=["i_brand"])
                     ).alias("revenueratio"))
            .order_by("i_category", "i_brand", "i_item_id", "i_item_desc",
                      "revenueratio"))


def test_q98_in_order():
    ss = [b.to_arrow() for b in jax_tpcds.gen_store_sales(
        N_SS, batch_rows=SS_BATCH)]
    dims = [[jax_tpcds.gen_date_dim().to_arrow()],
            [jax_tpcds.gen_item().to_arrow()]]
    sess = TpuSession(ORACLE)
    want = jax_q98(sess.create_dataframe(
        [JaxBatch.from_arrow(t) for t in ss], num_partitions=2),
        *(sess.create_dataframe([JaxBatch.from_arrow(t[0])]) for t in dims)
    ).collect()
    port = GpuSession(device="cpu")
    df = port_tpcds.q98(port.create_dataframe(
        [arrow_to_batch(t, "cpu") for t in ss], num_partitions=2),
        *(port.create_dataframe([arrow_to_batch(t[0], "cpu")]) for t in dims))
    got = df.collect()
    _assert_rows(got, want, ordered=True)
    assert len({r[3] for r in got}) > 10          # many brands
    text = df.explain()
    assert "GpuWindow[" in text and "GpuShuffleExchange[hash" in text


# -- the reference's properties, pinned ----------------------------------------

NAN, INF = float("nan"), float("inf")


def _pin(table, window, column="t"):
    """(device path, oracle, port) rows of one window over a tiny table,
    sorted by ``column``; each package's Window node holds one spec, so
    the reference's device path runs it (its explain has no "will
    NOT")."""
    out = []
    for conf in (DEVICE, ORACLE):
        df = TpuSession(conf).create_dataframe(
            [JaxBatch.from_arrow(table)]).select(
                JE.col(column), window(JE).alias("w"))
        if conf is DEVICE:
            assert "will NOT" not in df.explain()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the oracle's int32 wrap
            out.append(df.collect())
    out.append(GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(table, "cpu")]).select(
            PE.col(column), window(PE).alias("w")).collect())
    return [[r[1] for r in sorted(rows, key=lambda r: (r[0] is not None,
                                                       r[0]))]
            for rows in out]


def _same(a, b) -> bool:
    """Equal, floats bit for bit (NaN equal to NaN, -0.0 apart from
    0.0)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float):
            if not (math.isnan(x) and math.isnan(y)) and (
                    x != y or math.copysign(1, x) != math.copysign(1, y)):
                return False
        elif x != y:
            return False
    return True


NAN_TABLE = pa.table({"k": pa.array([1] * 7, pa.int32()),
                      "t": pa.array(range(7), pa.int32()),
                      "x": pa.array([1.0, NAN, 0.0, -0.0, 2.0, INF, 3.0])})
ZERO_TABLE = pa.table({"k": pa.array([1] * 4, pa.int32()),
                       "t": pa.array(range(4), pa.int32()),
                       "x": pa.array([0.0, -0.0, -0.0, 0.0])})


def _kt(E, fn, frame=None):
    return E.over(fn, partition_by=["k"], order_by=["t"], frame=frame)


#: case -> (table, window, the device path's rows, the oracle's, the
#: port's); the port gives the oracle's (Spark's) answer over NaN and the
#: device path's signed zero
PINS = {
    "running_min_over_nan": (
        NAN_TABLE, lambda E: _kt(E, E.min_("x")),
        [1.0] + [NAN] * 6, [1.0, 1.0, 0.0, -0.0, -0.0, -0.0, -0.0],
        [1.0, 1.0, 0.0, -0.0, -0.0, -0.0, -0.0]),
    "whole_min_over_nan": (
        NAN_TABLE, lambda E: E.over(E.min_("x"), partition_by=["k"]),
        [NAN] * 7, [-0.0] * 7, [-0.0] * 7),
    "rows_sum_after_nan": (
        NAN_TABLE, lambda E: _kt(E, E.sum_("x"), E.WindowFrame("rows", 0, 0)),
        [1.0] + [NAN] * 6, [1.0, NAN, 0.0, 0.0, 2.0, INF, 3.0],
        [1.0, NAN, 0.0, 0.0, 2.0, INF, 3.0]),
    "whole_min_signed_zero": (
        ZERO_TABLE, lambda E: E.over(E.min_("x"), partition_by=["k"]),
        [-0.0] * 4, [0.0] * 4, [-0.0] * 4),
    "running_max_signed_zero": (
        ZERO_TABLE, lambda E: _kt(E, E.max_("x")),
        [0.0] * 4, [0.0, -0.0, -0.0, 0.0], [0.0] * 4),
    "rows_min_signed_zero": (
        ZERO_TABLE, lambda E: _kt(E, E.min_("x"),
                                  E.WindowFrame("rows", -1, 0)),
        [0.0, -0.0, -0.0, -0.0], [0.0, -0.0, -0.0, 0.0],
        [0.0, -0.0, -0.0, -0.0]),
}


@pytest.mark.parametrize("case", list(PINS))
def test_pinned_extremes_and_sums(case):
    table, window, device, oracle, port = PINS[case]
    got = _pin(table, window)
    assert _same(got[0], device), got[0]
    assert _same(got[1], oracle), got[1]
    assert _same(got[2], port), got[2]


#: INT order keys ASC NULLS FIRST: the null sorts first with its zeroed
#: data, then two keys near -2**31 where key - 5 wraps
RANGE_TABLE = pa.table({
    "k": pa.array([1] * 5, pa.int32()),
    "o": pa.array([None, -2147483647, -2147483646, 5, 7], pa.int32()),
    "v": pa.array([1] * 5, pa.int64())})
#: frame -> (the device path's counts, the oracle's; the port's are the
#: device path's, and Spark's are [1, 1, 1, 1, 1] and [1, 2, 1, 2, 1])
RANGE_PINS = {(-5, 0): ([0, 0, 0, 1, 2], [3, 0, 0, 4, 2]),
              (0, 5): ([1, 3, 1, 2, 1], [4, 0, 0, 2, 1])}


@pytest.mark.parametrize("frame", list(RANGE_PINS))
def test_pinned_range_frame_wrap_and_null_key(frame):
    device, oracle = RANGE_PINS[frame]
    got = _pin(RANGE_TABLE, lambda E: E.over(
        E.count("v"), partition_by=["k"], order_by=["o"],
        frame=E.WindowFrame("range", *frame)), column="o")
    assert got == [device, oracle, device]
