"""The port's casts, numeric promotion and the null and set predicates
through GpuSession on the CPU, against the JAX package's CPU oracle
(``spark.rapids.sql.enabled=false``) on the same Arrow tables.

The cases: every test of tests/test_cast_strings.py (:52-141) but float
-> string, which has no counterpart here (the port raises with the
reference's reason, at plan time); ``CAST_EXPRS`` of
tests/test_expressions.py (:159-167) over its ``make_batch`` (:28, 257
rows with NaN, +-inf, +-0.0 and 20% nulls) and the rest of the lattice
over it (BOOLEAN to and from every number, FLOAT <-> DOUBLE, narrowing
to SHORT and BYTE, the decimals); the promotions over BYTE, SHORT and
FLOAT; IS NOT NULL, IN with a null in the list, COALESCE and ``<=>``; a
cast over a growing string (``concat``); and the held casts C1-C4 of
``testing/held.py`` at 420 rows.  Rows compare with the reference tests'
own tolerance (``tests/test_queries.py`` ``_eq_val``: floats within
relative 1e-9 or absolute 1e-12; everything else exact), a DATE as its
epoch days and a decimal as its unscaled int.  A chain over BYTE, SHORT
or FLOAT has no program form (``expressions/program.py``): it raises
NotLowerable there and runs op by op.
"""
import datetime
import decimal
import functools

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from tests.test_cast_strings import (BOOL_STRINGS, DATE_STRINGS,
                                     FLOAT_STRINGS, INT_STRINGS)
from tests.test_expressions import make_batch
from tests.test_queries import _eq_val, _normalize

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.expressions import program as P
from spark_rapids_tpu_torch.testing import held

ORACLE = {"spark.rapids.sql.enabled": "false"}
_EPOCH = datetime.date(1970, 1, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(v):
    """A port value as the JAX package collects it: a DATE as its epoch
    days, a decimal as its unscaled int."""
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    if isinstance(v, decimal.Decimal):
        return int(v.scaleb(-v.as_tuple().exponent))
    return v


def _check(build, tables, parts=1, ordered=True):
    """build(df, E, T) in both packages over the same Arrow tables: the
    oracle's rows, then the port's."""
    jdf = TpuSession(ORACLE).create_dataframe(
        [JaxBatch.from_arrow(t) for t in tables], num_partitions=parts)
    pdf = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in tables], num_partitions=parts)
    want = build(jdf, JE, JT).collect()
    got = [tuple(map(_host, r)) for r in build(pdf, PE, T).collect()]
    if not ordered:
        got, want = _normalize(got), _normalize(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_eq_val(a, b) for a, b in zip(g, w)), \
            (g, w)
    return got


def _texts(vals):
    return [pa.table({"s": pa.array(vals, pa.string())})]


# -- tests/test_cast_strings.py -----------------------------------------------

@pytest.mark.parametrize("dst", ["INT", "LONG", "SHORT", "BYTE"])
def test_cast_string_to_integral(dst):
    _check(lambda df, E, T_: df.select(
        E.col("s"), E.Cast(E.col("s"), getattr(T_, dst)).alias("v")),
        _texts(INT_STRINGS))


@pytest.mark.parametrize("dst", ["DOUBLE", "FLOAT"])
def test_cast_string_to_floating(dst):
    _check(lambda df, E, T_: df.select(
        E.col("s"), E.Cast(E.col("s"), getattr(T_, dst)).alias("v")),
        _texts(FLOAT_STRINGS))


def test_cast_string_to_date():
    _check(lambda df, E, T_: df.select(
        E.col("s"), E.Cast(E.col("s"), T_.DATE).alias("v")),
        _texts(DATE_STRINGS))


def test_cast_string_to_boolean():
    _check(lambda df, E, T_: df.select(
        E.col("s"), E.Cast(E.col("s"), T_.BOOLEAN).alias("v")),
        _texts(BOOL_STRINGS))


def _values(vals, pa_type):
    return [pa.table({"v": pa.array(vals, pa_type)})]


@pytest.mark.parametrize("vals, pa_type", [
    ([0, 1, -1, 42, -9223372036854775808, 9223372036854775807, 1000000,
      -999, None, 10, -10], pa.int64()),
    ([0, 5, -2147483648, 2147483647, None, 100], pa.int32()),
    ([0, -32768, 32767, None, 7], pa.int16()),
    ([0, -128, 127, None, -7], pa.int8()),
    ([True, False, None, True], pa.bool_()),
], ids=["long", "int", "short", "byte", "bool"])
def test_cast_to_string(vals, pa_type):
    _check(lambda df, E, T_: df.select(
        E.col("v"), E.Cast(E.col("v"), T_.STRING).alias("s")),
        _values(vals, pa_type))


def test_cast_date_to_string():
    """Years outside [1, 9999] are NULL on both (the dates themselves
    are not collected: Python's date has no such years)."""
    days = [(datetime.date(2020, 2, 29) - _EPOCH).days, 0,
            (datetime.date(999, 12, 31) - _EPOCH).days,
            (datetime.date(9999, 1, 1) - _EPOCH).days, None, 0, 18000,
            -719163, 2932897]
    _check(lambda df, E, T_: df.select(
        E.Cast(E.col("v"), T_.STRING).alias("s")),
        _values(days, pa.date32()))


def test_cast_roundtrip_filter():
    """Parse inside a filter pipeline, with ``is_not_null``."""
    _check(lambda df, E, T_: df.filter(
        E.Cast(E.col("s"), T_.LONG).is_not_null()).select(
        E.col("s"), E.Cast(E.col("s"), T_.LONG).alias("v")),
        _texts(INT_STRINGS))


def test_float_to_string_raises_with_the_reference_reason():
    """The reference keeps it off its device (castFloatToString); the port
    has no CPU bridge: planning raises."""
    df = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(_values([1.5, 2.5], pa.float64())[0], "cpu")])
    for dtype in (T.DOUBLE, T.FLOAT):
        q = df.select(PE.Cast(PE.Cast(PE.col("v"), dtype), T.STRING))
        with pytest.raises(NotImplementedError,
                           match=f"cast {dtype!r} -> string is not "
                                 "supported"):
            q.collect()


@pytest.mark.parametrize("src, dst", [
    (T.DATE, T.INT), (T.INT, T.DATE), (T.DOUBLE, T.STRING),
    (T.DecimalType(10, 2), T.BOOLEAN), (T.DATE, T.DOUBLE)])
def test_unsupported_casts_follow_the_reference(src, dst):
    assert not PE.Cast.supported(src, dst)
    assert not JE.Cast.supported(*(getattr(JT, repr(t).upper())
                                   if not isinstance(t, T.DecimalType)
                                   else JT.DecimalType(10, 2)
                                   for t in (src, dst)))


def test_cast_over_a_growing_string_runs():
    """The reference's tag for a string cast over concat (bucket
    machinery) is not ported: it plans and runs."""
    _check(lambda df, E, T_: df.select(E.Cast(E.ConcatStrings(
        E.col("s"), E.lit("1")), T_.LONG).alias("v")), _texts(INT_STRINGS))


# -- tests/test_expressions.py over make_batch --------------------------------

MAKE_BATCH = [make_batch().to_arrow()]

#: CAST_EXPRS (:159-167), then the rest of the lattice over make_batch
LATTICE = {
    "i_long": lambda E, T_: E.Cast(E.col("i"), T_.LONG),
    "l_int_wraps": lambda E, T_: E.Cast(E.col("l"), T_.INT),
    "i_double": lambda E, T_: E.Cast(E.col("i"), T_.DOUBLE),
    "d_int_saturates": lambda E, T_: E.Cast(E.col("d"), T_.INT),
    "f_long": lambda E, T_: E.Cast(E.col("f"), T_.LONG),
    "b_int": lambda E, T_: E.Cast(E.col("b"), T_.INT),
    "i_boolean": lambda E, T_: E.Cast(E.col("i"), T_.BOOLEAN),
    "d_boolean": lambda E, T_: E.Cast(E.col("d"), T_.BOOLEAN),
    "b_double": lambda E, T_: E.Cast(E.col("b"), T_.DOUBLE),
    "b_byte": lambda E, T_: E.Cast(E.col("b"), T_.BYTE),
    "d_float": lambda E, T_: E.Cast(E.col("d"), T_.FLOAT),
    "f_double": lambda E, T_: E.Cast(E.col("f"), T_.DOUBLE),
    "l_short": lambda E, T_: E.Cast(E.col("l"), T_.SHORT),
    "i_byte": lambda E, T_: E.Cast(E.col("i"), T_.BYTE),
    "s_long": lambda E, T_: E.Cast(E.col("s"), T_.LONG),
    "d_short": lambda E, T_: E.Cast(E.col("d") * E.lit(1e5), T_.SHORT),
    "d_byte": lambda E, T_: E.Cast(E.col("d") * E.lit(300.0), T_.BYTE),
    "f_int": lambda E, T_: E.Cast(E.col("f"), T_.INT),
    "d_long_huge": lambda E, T_: E.Cast(E.col("d") * E.lit(1e19), T_.LONG),
    "l_float": lambda E, T_: E.Cast(E.col("l"), T_.FLOAT),
    "s_float": lambda E, T_: E.Cast(E.col("s"), T_.FLOAT),
    "i_decimal": lambda E, T_: E.Cast(E.col("i"), T_.DecimalType(12, 2)),
    "decimal_short": lambda E, T_: E.Cast(
        E.Cast(E.col("i"), T_.DecimalType(12, 2)), T_.SHORT),
    "decimal_byte": lambda E, T_: E.Cast(
        E.Cast(E.col("s"), T_.DecimalType(7, 3)), T_.BYTE),
    "decimal_float": lambda E, T_: E.Cast(
        E.Cast(E.col("l"), T_.DecimalType(18, 3)), T_.FLOAT),
    "decimal128_short": lambda E, T_: E.Cast(
        E.Cast(E.col("l"), T_.DecimalType(25, 2)), T_.SHORT),
    "decimal128_float": lambda E, T_: E.Cast(
        E.Cast(E.col("l"), T_.DecimalType(25, 2)), T_.FLOAT),
}


@pytest.mark.parametrize("name", list(LATTICE))
def test_cast_lattice(name):
    _check(lambda df, E, T_: df.select(LATTICE[name](E, T_).alias("v")),
           MAKE_BATCH)


def test_boolean_to_decimal_is_spark_value():
    """Pinned split: cast(TRUE AS decimal(5,1)) is 1.0 (unscaled 10) in
    the port, as in Spark; both of the reference's paths take the BOOLEAN
    branch before the decimal one (``casts.py:112``, ``:191``) and give
    the unscaled 1, which is 0.1."""
    t = [pa.table({"b": pa.array([True, False, None])})]
    q = lambda df, E, T_: df.select(  # noqa: E731
        E.Cast(E.col("b"), T_.DecimalType(5, 1)).alias("v"))
    want = q(TpuSession(ORACLE).create_dataframe(
        [JaxBatch.from_arrow(t[0])]), JE, JT).collect()
    got = q(GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(t[0], "cpu")]), PE, T).collect()
    assert want == [(1,), (0,), (None,)]
    assert got == [(decimal.Decimal("1.0"),), (decimal.Decimal("0.0"),),
                   (None,)]


def _promotion_table(n=257, seed=3):
    """make_batch's columns with a BYTE ``y`` beside them."""
    rng = np.random.RandomState(seed)
    t = make_batch().to_arrow()
    y = rng.randint(-128, 128, n).astype(np.int8)
    return [t.append_column("y", pa.array(y, pa.int8(),
                                          mask=rng.rand(n) < 0.2))]


PROMOTION = _promotion_table()

PREDICATES = {
    "y_plus_i": lambda E, T_: E.col("y") + E.col("i"),
    "y_gt_1": lambda E, T_: E.col("y") > E.lit(1),
    "y_times_s": lambda E, T_: E.col("y") * E.col("s"),
    "f_plus_d": lambda E, T_: E.col("f") + E.col("d"),
    "f_lt_d": lambda E, T_: E.col("f") < E.col("d"),
    "s_minus_f": lambda E, T_: E.col("s") - E.col("f"),
    "if_b_i_s": lambda E, T_: E.If(E.col("b"), E.col("i"), E.col("s")),
    "is_not_null": lambda E, T_: E.col("f").is_not_null(),
    "is_null": lambda E, T_: E.col("y").is_null(),
    "in_with_null": lambda E, T_: E.In(E.col("i"), [1, 2, 3, None]),
    "in_short": lambda E, T_: E.In(E.col("s"), [5, -5]),
    "in_double": lambda E, T_: E.In(E.col("d"), [0.0, float("nan")]),
    "coalesce": lambda E, T_: E.Coalesce(E.col("i"), E.col("s"), E.lit(0)),
    "coalesce_float": lambda E, T_: E.Coalesce(E.col("f"), E.col("f")),
    "coalesce_all_null": lambda E, T_: E.Coalesce(E.col("i"), E.col("i")),
    "null_safe_eq": lambda E, T_: E.EqualNullSafe(E.col("i"), E.col("s")),
    "null_safe_eq_double": lambda E, T_: E.EqualNullSafe(E.col("d"),
                                                         E.col("d")),
    "null_safe_eq_byte": lambda E, T_: E.EqualNullSafe(E.col("y"),
                                                       E.lit(3)),
}


@pytest.mark.parametrize("name", list(PREDICATES))
def test_promotion_and_predicates(name):
    _check(lambda df, E, T_: df.select(PREDICATES[name](E, T_).alias("v")),
           PROMOTION)


def test_string_predicates():
    """IN, COALESCE and <=> over strings (COALESCE through the string
    select)."""
    t = [pa.table({"a": pa.array(["x", None, "yy", "", None]),
                   "b": pa.array([None, "q", "yy", None, None])})]
    _check(lambda df, E, T_: df.select(
        E.In(E.col("a"), ["x", "", None]).alias("i"),
        E.Coalesce(E.col("a"), E.col("b")).alias("c"),
        E.EqualNullSafe(E.col("a"), E.col("b")).alias("e")), t)


def test_byte_chain_runs_op_by_op():
    """No register kind for BYTE, SHORT or FLOAT: NotLowerable, nothing
    else, and the filter over them still runs (the oracle's rows)."""
    schema = arrow_to_batch(PROMOTION[0], "cpu").schema
    for e in (PE.col("y") + PE.col("i"), PE.col("y") > 1,
              PE.col("f") + PE.col("d"), PE.col("s") * PE.col("i"),
              PE.Cast(PE.col("i"), T.BYTE)):
        bound = e.bind(schema)
        assert not P.lowerable(bound, schema.dtypes, value=True)
        with pytest.raises(P.NotLowerable):
            P.ProgramBuilder(schema.dtypes).value(
                bound, [P.Column(dt, ordinal=i)
                        for i, dt in enumerate(schema.dtypes)])
    _check(lambda df, E, T_: df.filter(E.col("y") > E.lit(1)).select(
        (E.col("y") + E.col("i")).alias("v"), E.col("f") + E.col("d")),
        PROMOTION)


# -- the held casts -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cast_tables(n=420, batch_rows=150):
    """The held cast table as Arrow batches, drawn at first use."""
    data, validity = held.cast_columns(n)
    return [b.to_arrow() for b in held.cast_batches(data, validity, "cpu",
                                                    batch_rows)]


@pytest.mark.parametrize("name", list(held.CAST_ROW_QUERIES))
def test_held_cast_rows(name):
    """C1-C3: every row, in order (one partition)."""
    _check(lambda df, E, T_: held.CAST_ROW_QUERIES[name](df, E, T_),
           _cast_tables())


def test_held_cast_ingest():
    """C4 over 2 partitions; no row loses l through its text."""
    rows = _check(lambda df, E, T_: held.casts_ingest(df, E, T_),
                  _cast_tables(), parts=2, ordered=False)
    assert all(r[3] == 0 for r in rows)
    assert sum(r[2] for r in rows) > 100


def test_held_cast_table():
    """The pools hold tests/test_cast_strings.py's texts first, and about
    a tenth of each column is null."""
    pools = held.cast_pools()
    assert pools["si"][:len(INT_STRINGS)] == INT_STRINGS
    assert pools["sd"][:len(FLOAT_STRINGS)] == FLOAT_STRINGS
    assert pools["sdt"][:len(DATE_STRINGS)] == DATE_STRINGS
    assert pools["sb"] == BOOL_STRINGS
    assert "2100-12-31" in pools["sdt"] and "1900-1-1" in pools["sdt"]
    data, validity = held.cast_columns(20_000)
    for c in held.CAST_SCHEMA.names:
        share = 1 - validity[c].mean()
        assert (share == 0) if c == "k" else 0.08 < share < 0.16, (c, share)
