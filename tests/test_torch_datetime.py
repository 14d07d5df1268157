"""The port's TIMESTAMP, time zones, date functions and the arithmetic and
conditional rest through GpuSession on the CPU, against the JAX package's
CPU oracle (``spark.rapids.sql.enabled=false``) on the same Arrow tables.

The table is ``testing/held.py`` ``date_columns`` (the generators of
tests/test_timezone.py :22-37, tests/test_math_datetime.py :22-48 and
tests/test_hashing_sketches.py :23-36) at a few hundred rows in two
partitions.  The cases: every expression of ``held.date_exprs`` (the
DATE_EXPRS of tests/test_math_datetime.py :71-77, then the rest of the
datetime module), every test of tests/test_timezone.py (:39-105) in its
three zones (from / to UTC, the session zone's fields and cast to DATE,
two zones in two sessions, GROUP BY the local hour), DATE <-> TIMESTAMP,
GROUP BY, ORDER BY and a join on a TIMESTAMP, a TIMESTAMP through the
Arrow bridge (units, zones, values before 1684), every expression of
``held.arith_exprs`` (D5), the MIN edges of div, unary minus and abs,
and the held queries D1-D5.  Every value is exact: integers, and doubles
bit for bit (NaN equal to NaN).  The port collects a TIMESTAMP as a
UTC ``datetime`` and a DATE as a ``date``; the JAX package gives their
microseconds and days, to which ``_host`` converts.

Pinned (ROADMAP queue 3): the zone table's 1900-2100 horizon (the port
follows the reference's device path, Spark and the reference's oracle
extend the rules); DATE -> TIMESTAMP at midnight UTC whatever the session
zone (both reference paths; Spark takes the zone's midnight); and the
remainder and quotient of a MIN dividend, where the reference's
``sign * (|a| op |b|)`` overflows and the port gives Java's answer.
"""
import datetime
import math

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import timezone as JTZ
from tests.test_queries import _normalize

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import (arrow_to_batch,
                                                   batch_to_arrow)
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.core import EvalContext
from spark_rapids_tpu_torch.kernels import timezone as TZ
from spark_rapids_tpu_torch.testing import held

ORACLE = {"spark.rapids.sql.enabled": "false"}
_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_MICRO = datetime.timedelta(microseconds=1)
ROWS = 300


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(v):
    """A port value as the JAX package collects it: a TIMESTAMP as its
    microseconds, a DATE as its epoch days."""
    if isinstance(v, datetime.datetime):
        return (v - _EPOCH_UTC) // _MICRO
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    return v


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    return a == b


def _tables(n=ROWS, seed=8, batch_rows=128):
    data, validity = held.date_columns(n, seed)
    return [b.to_arrow() for b in held.date_batches(data, validity, "cpu",
                                                    batch_rows)]


TABLES = _tables()


def _dim_tables():
    data, validity = held.date_columns(ROWS, 8)
    return [held.date_dimension_batch(
        held.date_dimension(data, validity, rows=64), "cpu").to_arrow()]


def _frames(tables, parts, conf):
    jdf = TpuSession({**ORACLE, **conf}).create_dataframe(
        [JaxBatch.from_arrow(t) for t in tables], num_partitions=parts)
    pdf = GpuSession(conf, device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in tables], num_partitions=parts)
    return jdf, pdf


def _check(build, tables=None, parts=2, ordered=False, tz=None, dim=None):
    """build(df, E, T) in both packages over the same Arrow tables (with
    ``dim``, build(df, dim_df, E, T)): the oracle's rows, then the
    port's, exactly."""
    conf = {} if tz is None else {"spark.sql.session.timeZone": tz}
    jdf, pdf = _frames(TABLES if tables is None else tables, parts, conf)
    if dim is not None:
        jdim, pdim = _frames(dim, 1, conf)
        want = build(jdf, jdim, JE, JT).collect()
        got = build(pdf, pdim, PE, T).collect()
    else:
        want = build(jdf, JE, JT).collect()
        got = build(pdf, PE, T).collect()
    got = [tuple(map(_host, r)) for r in got]
    want = [tuple(r) for r in want]
    if not ordered:
        got, want = _normalize(got), _normalize(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w)), \
            (g, w)
    return got


# -- the datetime module (tests/test_math_datetime.py :71-77 and the rest) ---

@pytest.mark.parametrize("j", range(len(held.date_exprs())),
                         ids=[repr(e)[:40] for e in held.date_exprs()])
def test_date_expression(j):
    _check(lambda df, E, T_: df.select(
        E.col("k"), E.col("d"), held.date_exprs(E, T_)[j].alias("r")))


def test_civil_conversion_against_python_datetime():
    from spark_rapids_tpu_torch.expressions.datetime import _civil_from_days
    dates = [(1582, 10, 15), (1900, 2, 28), (2000, 2, 29), (2024, 12, 31),
             (1970, 1, 1), (2400, 2, 29), (1, 1, 1), (9999, 12, 31)]
    days = torch.tensor([(datetime.date(*d) - _EPOCH).days for d in dates])
    y, m, d = _civil_from_days(days)
    assert list(zip(y.tolist(), m.tolist(), d.tolist())) == dates


# -- tests/test_timezone.py ----------------------------------------------------

@pytest.mark.parametrize("tz", held.DATE_ZONES)
def test_from_utc_timestamp(tz):
    _check(lambda df, E, T_: df.select(
        E.from_utc_timestamp(E.col("ts"), tz).alias("local"), E.col("k")))


@pytest.mark.parametrize("tz", held.DATE_ZONES)
def test_to_utc_timestamp(tz):
    _check(lambda df, E, T_: df.select(
        E.to_utc_timestamp(E.col("ts"), tz).alias("utc"), E.col("k")))


@pytest.mark.parametrize("tz", held.DATE_ZONES)
def test_session_timezone_extraction(tz):
    _check(held.dates_session, tz=tz)


def test_session_timezone_cast_to_date():
    _check(lambda df, E, T_: df.select(
        E.Cast(E.col("ts"), T_.DATE).alias("d"), E.col("k")),
        tz="America/Los_Angeles")


def test_session_timezone_set_conf_and_two_sessions():
    """set_conf changes the zone of later actions; two sessions in two
    zones give their own hours (and each the oracle's)."""
    rows = {}
    for tz in ("UTC", "Asia/Kolkata"):
        rows[tz] = _check(lambda df, E, T_: df.select(
            E.col("k"), E.Hour(E.col("ts")).alias("h")), tz=tz)
    assert rows["UTC"] != rows["Asia/Kolkata"]
    sess = GpuSession(device="cpu")
    df = sess.create_dataframe([arrow_to_batch(t, "cpu") for t in TABLES])
    q = lambda: _normalize(df.select(   # noqa: E731
        PE.col("k"), PE.Hour(PE.col("ts"))).collect())
    assert q() == rows["UTC"]
    sess.set_conf("spark.sql.session.timeZone", "Asia/Kolkata")
    assert q() == rows["Asia/Kolkata"]


def test_tz_group_by_local_hour():
    got = _check(held.dates_local_hour, tz="America/Los_Angeles")
    assert len(got) == 25   # 24 hours and the null group


# -- casts and keys ------------------------------------------------------------

@pytest.mark.parametrize("tz", ["UTC", "America/Los_Angeles"])
def test_date_timestamp_casts(tz):
    _check(lambda df, E, T_: df.select(
        E.col("k"), E.Cast(E.col("d"), T_.TIMESTAMP).alias("dts"),
        E.Cast(E.col("ts"), T_.DATE).alias("tsd"),
        E.Cast(E.Cast(E.col("d"), T_.TIMESTAMP), T_.DATE).alias("back")),
        tz=tz)


def test_date_to_timestamp_ignores_the_session_zone():
    """Pinned: DATE -> TIMESTAMP is the day's midnight UTC in both
    reference paths and the port, in any session zone; Spark takes the
    session zone's midnight (for 2021-03-14 in Los Angeles, 08:00 UTC)."""
    day = (datetime.date(2021, 3, 14) - _EPOCH).days
    table = [pa.table({"d": pa.array([day], pa.date32())})]
    got = _check(lambda df, E, T_: df.select(
        E.Cast(E.col("d"), T_.TIMESTAMP).alias("t")), table, parts=1,
        tz="America/Los_Angeles")
    assert got == [(day * 86_400_000_000,)]
    spark = datetime.datetime(2021, 3, 14, 8, tzinfo=datetime.timezone.utc)
    assert got[0][0] != (spark - _EPOCH_UTC) // _MICRO


@pytest.mark.parametrize("name", ["dates_group_ts", "dates_order_ts"])
def test_timestamp_keys(name):
    _check(held.DATE_QUERIES[name], ordered=name == "dates_order_ts")


def test_timestamp_join():
    got = _check(held.dates_join_ts, dim=_dim_tables())
    assert got[0][0] > 0


def test_a_timestamp_chain_stays_fused():
    """A chain that passes a TIMESTAMP through, or compares it, lowers to
    one fused segment (an int64 register) and gives the unfused rows."""
    edge = held.DST_EDGES[2] * 1_000_000
    build = lambda df, E: df.filter(   # noqa: E731
        (E.col("ts") >= E.lit(edge, T.TIMESTAMP))
        | (E.col("ts") == E.col("ts"))).select(E.col("ts"), E.col("k"))
    rows = {}
    for fuse in ("true", "false"):
        sess = GpuSession({"spark.rapids.sql.tpu.fuseStages": fuse},
                          device="cpu")
        df = sess.create_dataframe([arrow_to_batch(t, "cpu")
                                    for t in TABLES], num_partitions=2)
        q = build(df, PE)
        assert ("GpuFusedSegment" in q.explain()) == (fuse == "true")
        rows[fuse] = q.collect()
    assert rows["true"] == rows["false"] and len(rows["true"]) > 0


def test_arrow_timestamps_in_and_out():
    """Any unit and zone comes in as microseconds (a null filled before the
    conversion: no float64 on the way, so a value before 1684 is exact);
    out it is timestamp("us", tz="UTC")."""
    micros = [-2**62 + 7, -11_000_000_000_000_123, None, 0, -1,
              2**53 + 1, 4_102_444_800_000_000]
    table = pa.table({
        "us": pa.array(micros, pa.timestamp("us")),
        "ms": pa.array([None if v is None else v // 1000 for v in micros],
                       pa.timestamp("ms", tz="America/Los_Angeles")),
        "s": pa.array([None if v is None else v // 10**6 for v in micros],
                      pa.timestamp("s", tz="+05:30"))})
    batch = arrow_to_batch(table, "cpu")
    assert batch.schema.dtypes == (T.TIMESTAMP,) * 3
    for name, div in (("us", 1), ("ms", 1000), ("s", 10**6)):
        c = batch.column(name)
        want = [None if v is None else (v // div) * div for v in micros]
        got = [None if not ok else int(v) for v, ok in
               zip(c.data.tolist(), c.validity.tolist())]
        assert got == want, name
    back = batch_to_arrow(batch)
    assert back.schema.field("us").type == pa.timestamp("us", tz="UTC")
    assert back.column("us").cast(pa.int64()).to_pylist() == micros
    jax_batch = JaxBatch.from_arrow(back.select(["us"]))
    assert np.asarray(jax_batch.columns[0].data)[:len(micros)].tolist() == [
        0 if v is None else v for v in micros]


def test_from_pydict_takes_micros():
    early = -11_000_000_000_000_123          # 1621, past 2**53
    b = ColumnarBatch.from_pydict({"t": [1, None, early]},
                                  Schema.of(t=T.TIMESTAMP), "cpu")
    assert b.columns[0].data.tolist() == [1, 0, early]
    assert [_host(r[0]) for r in b.rows()] == [1, None, early]


# -- the zone horizon (pinned) -------------------------------------------------

def _jax_shift(fn, micros, tz):
    trans, offs = JTZ.zone_table(tz)
    return np.asarray(fn(jnp.asarray(np.array(micros, np.int64)),
                         jnp.asarray(trans), jnp.asarray(offs))).tolist()


def test_zone_horizon_follows_the_device_path():
    """Pinned: the table spans 1900-2100.  In America/Los_Angeles on
    2150-07-01 and 1850-07-01 (UTC), T1 and T2 take the table's end
    offsets (-8 h) as the reference's device path does; its zoneinfo
    oracle (and Spark) give -7 h (DST rules extended) and -7:52:58 (LMT)."""
    tz = "America/Los_Angeles"
    micros = [int(datetime.datetime(y, 7, 1, tzinfo=datetime.timezone.utc)
                  .timestamp()) * 1_000_000 for y in (2150, 1850)]
    t = torch.tensor(micros)
    for port, device, oracle in (
            (TZ.utc_to_local_micros, JTZ.utc_to_local_micros,
             JTZ.np_utc_to_local),
            (TZ.local_to_utc_micros, JTZ.local_to_utc_micros,
             JTZ.np_local_to_utc)):
        got = port(t, tz).tolist()
        assert got == _jax_shift(device, micros, tz)
        want = oracle(np.array(micros, np.int64), tz).tolist()
        assert got != want
        hours = [abs(g - m) / 3.6e9 for g, m in zip(got, micros)]
        assert hours == [8.0, 8.0]
        spark = [abs(w - m) / 3.6e9 for w, m in zip(want, micros)]
        assert spark[0] == 7.0 and spark[1] == pytest.approx(7.8828, abs=1e-4)


# -- the arithmetic and conditional rest (D5) ----------------------------------

@pytest.mark.parametrize("j", range(len(held.arith_exprs())),
                         ids=[repr(e)[:40] for e in held.arith_exprs()])
def test_arith_expression(j):
    _check(lambda df, E, T_: df.select(
        E.col("k"), held.arith_exprs(E, T_)[j].alias("r")))


@pytest.mark.parametrize("dt, lo", [(T.INT, -2**31), (T.LONG, -2**63)],
                         ids=["int", "long"])
def test_min_edges_wrap_and_do_not_crash(dt, lo):
    """MIN div -1, -MIN and abs(MIN) in this process (an integer MIN / -1
    traps on the CPU): the quotient is LONG (INT's is 2**31), the rest
    wrap to MIN; MIN % -1 is 0; a zero divisor is null."""
    b = ColumnarBatch.from_pydict(
        {"a": [lo, lo, lo, 7, -7], "b": [-1, 0, 1, -1, 2]},
        Schema.of(a=dt, b=dt), "cpu")
    ctx = EvalContext(b)
    a, bb = PE.col("a").bind(b.schema), PE.col("b").bind(b.schema)
    div = PE.IntegralDivide(a, bb).eval(ctx).to_pylist()
    assert div == [-lo if dt == T.INT else lo, None, lo, -7, -3]
    assert PE.Remainder(a, bb).eval(ctx).to_pylist() == [0, None, 0, 0, -1]
    assert PE.UnaryMinus(a).eval(ctx).to_pylist() == [lo, lo, lo, -7, 7]
    assert PE.Abs(a).eval(ctx).to_pylist() == [lo, lo, lo, 7, 7]


def test_min_dividend_pins_java():
    """Pinned: the reference computes ``sign(a) * (|a| op |b|)``, which
    overflows at MIN.  INT_MIN % 3: the reference's device path and oracle
    give -1, Java and the port -2; LONG_MIN div 3: the reference gives
    3074457345618258603, Java and the port -3074457345618258602."""
    table = [pa.table({"a": pa.array([-2**31], pa.int32()),
                       "l": pa.array([-2**63], pa.int64()),
                       "b": pa.array([3], pa.int32())})]
    build = lambda df, E, T_: df.select(   # noqa: E731
        E.Remainder(E.col("a"), E.col("b")).alias("r"),
        E.IntegralDivide(E.col("l"), E.col("b")).alias("q"))
    jdf, pdf = _frames(table, 1, {})
    assert build(jdf, JE, JT).collect() == [(-1, 3074457345618258603)]
    assert build(pdf, PE, T).collect() == [(-2, -3074457345618258602)]
    dev = build(TpuSession({}).create_dataframe(
        [JaxBatch.from_arrow(table[0])]), JE, JT).collect()
    assert dev == [(-1, 3074457345618258603)]


@pytest.mark.parametrize("op", ["NullIf", "Greatest", "Least"])
def test_string_conditionals_raise_at_planning(op):
    df = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in TABLES])
    with pytest.raises(NotImplementedError, match="over strings"):
        df.select(getattr(PE, op)(PE.col("s"), PE.lit("a"))).physical_plan()


def test_untyped_null_literal():
    df = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in TABLES])
    rows = df.select(PE.col("k"), PE.lit(None).alias("n")).collect()
    assert all(r[1] is None for r in rows) and len(rows) == ROWS


# -- the held queries D1-D5 -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(held.DATE_QUERIES))
def test_held_date_query(name):
    tz = held.SESSION_ZONE if name in ("dates_session",
                                       "dates_local_hour") else None
    if name == "dates_join_ts":
        _check(held.dates_join_ts, dim=_dim_tables())
    else:
        _check(held.DATE_QUERIES[name], tz=tz,
               ordered=name == "dates_order_ts")


def test_timestamp_window_keys():
    """A TIMESTAMP partitions, orders and bounds a RANGE frame as the
    LONG it is held as: ROW_NUMBER by ts within i, and COUNT over the hour
    before each row of the whole table (the rows with a ts: a null RANGE
    key is a pinned split of the reference's two paths,
    tests/test_torch_window.py)."""
    got = _check(lambda df, E, T_: df.filter(E.col("ts").is_not_null()).select(
        E.col("k"),
        E.over(E.RowNumber(), partition_by=["i"], order_by=["ts", "k"])
        .alias("rn"),
        E.over(E.count(E.col("k")), order_by=["ts"],
               frame=E.WindowFrame("range", -3_600_000_000, 0)).alias("c")))
    assert max(r[2] for r in got) > 3   # the DST edges' clusters
