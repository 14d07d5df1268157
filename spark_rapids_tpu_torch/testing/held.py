"""The held aggregate shapes: the table and queries of the reference's
``tests/test_queries.py`` (``SCHEMA`` :101, ``make_data`` :104-121,
``test_global_aggregate`` :149, ``test_grouped_aggregate`` :163) and
``tests/test_variance.py`` (:6, :14), the aggregate tail's table and
queries of ``tests/test_agg_tail.py`` (``SCHEMA`` :18, ``_data`` :20-38),
the two-limb decimals of ``tests/test_decimal128.py``, and the window
shapes of ``tests/test_window.py`` (``wdf`` :29, ``WINDOW_EXPRS``
:46-87), at any size, without JAX.

No TPC query over the repo's generators runs MIN or MAX, so these shapes
are the main path of the port's extremes: ``k`` INT (13 keys), ``v``
LONG, ``x`` DOUBLE (NaN, +inf and -0.0 at rows 0-2), ``f`` FLOAT, ``b``
BOOLEAN, each with n // 7 nulls.  ``columns`` draws the numpy streams of
``make_data`` in its order, vectorised, so ``columns(500, 0)`` is
``make_data()`` row for row.

Each query takes the dataframe and the DSL module to build it with (the
port's by default): the same function builds the JAX package's twin in
the CPU tests.

The tail's table (``TAIL_SCHEMA``): ``k`` INT (9 keys), ``v`` LONG
(-1000..999), ``x`` DOUBLE (3 decimals; NaN, -0.0 and +inf at rows 0-2),
``s`` STRING ``f"s{i % 19}-{'y' * (i % 5)}"`` for a code i in 0-99 (3-8
bytes, 95 distinct values), ``b`` BYTE, n // 6 nulls each in v, x, s and
b.  ``tail_columns`` draws ``_data``'s numpy streams in its order,
vectorised, so ``tail_columns(700, 3)`` is ``_data()`` row for row; it
returns ``s`` as its codes, which ``tail_strings`` turns into the
column's bytes, so that an answer can be computed over the codes
(``TAIL_RANK``: each code's rank in the strings' byte order) and never
over millions of Python strings.  ``tail_batches(..., with_short=True)``
adds ``h`` SHORT, ``v`` narrowed (its values fit), for the BYTE and SHORT
key queries (``TAIL_KEY_QUERIES``).

The held joins (``join_columns``): the shapes of the reference's
``tests/test_joins.py`` ``left_df`` :19 (``k`` INT, ``lv`` LONG, ``lx``
DOUBLE) and ``right_df`` :35 (``k`` INT, ``rv`` LONG) at any size with its
ratios: the left side n rows, keys uniform in [0, n / 15), lv in [-1000,
1000), lx normal; the right side n / 2 rows, keys in [0, n / 12), rv in
[-1000, 1000); n / 8 nulls in each column of each side.
``JOIN_QUERIES`` are the right, full, cross and keyless joins over them,
each followed by aggregates so that few rows come back.

The held string shapes (``string_columns``): ``s`` and ``t`` the pool of
``tests/test_strings.py`` (``WORDS`` :30) at ``i % 12`` and ``(7i + 3) %
12`` with a sixth of each null, ``n`` INT in [-3, 12) (``strings_df``
:36-48; ``string_columns(120)`` is its s, t and n row for row), ``u``
the pool of ``tests/test_string_functions.py`` (``VALS`` :20, with its
two nulls) at ``i % 20``, ``r`` the pool of ``tests/test_regex.py``
(``STRINGS`` :37, the LIKE extras of :156, two nulls) at ``i % 42``, and
``i`` the row's index.  The strings come as codes into their pools
(``STRING_POOLS``), so that an answer can be computed once a code.
``STRING_QUERIES`` are S1 (the 19 ``EXPRS`` of tests/test_strings.py
:53-73 in one select), S2 (the 20 functions of
tests/test_string_functions.py :37-60 and both ``concat_ws`` of :67-72,
over u and t), S3 (the RLIKE patterns of tests/test_regex.py :138-144
and its LIKE patterns of :152-158, over r), S4 (the filter pipeline of
tests/test_strings.py :99-104, then GROUP BY the upper-cased prefix with
COUNT(*)) and S5 (a string IF and a string CASE WHEN, each grouped with
COUNT(*)).

The held casts (``cast_columns``): the text pools of the reference's
``tests/test_cast_strings.py`` (:17-48) with generated texts after them
(``cast_pools``: ``si`` 4,096 integer texts, ``sd`` 4,096 doubles in
repr, exponent and fixed forms, ``sdt`` every date of 1900-2100 in one-
and two-digit forms), and ``l`` LONG over the full range, ``i`` INT,
``d`` DATE over years 1-9999 and past them, ``x`` DOUBLE with NaN,
+-inf, +-0.0 and +-1e19, each drawn as codes into a pool of 65,536
values; ``b`` BOOLEAN, ``y`` BYTE, ``h`` SHORT, ``k`` the row's index;
about 10% nulls in every column but ``k``.  ``CAST_QUERIES`` are C1 (the
eight parse casts in one select), C2 (LONG, INT, DATE and BOOLEAN to
STRING), C3 (the numeric lattice, BYTE / SHORT promotion, COALESCE over a
parse, IN with a null) and C4 (the rows whose ``si`` parses, grouped by
``sdt`` as a DATE: the sum of ``sd`` as a DOUBLE, COUNT(*), and the rows
whose ``l`` does not come back through its text).  Each takes the DSL
and the types module (``E``, ``T_``) to build it with.

The held dates and hashes (``date_columns``): ``ts`` TIMESTAMP as the
reference's ``tests/test_timezone.py`` ``df`` (:22-37) draws it, seconds
in [-631152000, 3786912000) (1950-2090), a quarter of the rows within
2 h of its four DST edges, random microseconds, 10% null; ``d`` DATE,
``i`` INT and ``x`` DOUBLE as ``tests/test_math_datetime.py`` ``df``
(:22-48) draws them (days in +-30000 with 2000-02-29, 1900-02-28 and
1970-01-01 at rows 0-2; i in [-50, 50); x normal * 100 with NaN, +-inf,
0.0 and -0.0 first); ``l`` LONG in [-2**60, 2**60) and ``s`` STRING as
``tests/test_hashing_sketches.py`` ``_df`` (:23-36) draws them, its word
pool for 3/4 of the rows and 64 rows of 33-200 bytes after it for the
rest (``DATE_POOL``; ``s`` as codes into it); ``f`` FLOAT with NaN, +-0.0 and +-inf; ``m`` INT
over int32's range; ``k`` the row's index.  One row in 1,000, and rows
5 and 6, hold ``m`` = INT_MIN and ``l`` = LONG_MIN beside ``i`` = -1;
n // 8 nulls in d, i, x, l, f and m.  ``DATE_QUERIES``: D1 ``from_utc_
timestamp`` / ``to_utc_timestamp`` in three zones, D2 the session
zone's fields and cast (``dates_session``) and GROUP BY its hour
(``dates_local_hour``), D3 the date functions, D4 the hashes, GROUP BY,
ORDER BY and an equi-join on ``ts`` (against ``date_dimension``), D5
``%``, unary minus, ``div``, ``abs``, ``nullif``, ``nvl2``, ``greatest``
and ``least``.  Each takes the DSL and the types module; the JAX
package's DSL exports some of these names only from its ``datetime``
and ``conditional`` modules, which ``_fns`` adds.
"""
from __future__ import annotations

import functools
import importlib
import types
from typing import Dict, List, Tuple

import numpy as np

from spark_rapids_tpu_torch import expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batch_from_numpy
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema

SCHEMA = Schema.of(k=T.INT, v=T.LONG, x=T.DOUBLE, f=T.FLOAT, b=T.BOOLEAN)
NKEYS = 13


def columns(n: int, seed: int = 0
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(values, validity) per column; a null slot holds zero."""
    rng = np.random.RandomState(seed)
    data = {
        "k": rng.randint(0, NKEYS, n).astype(np.int32),
        "v": rng.randint(-10**9, 10**9, n).astype(np.int64),
        "x": rng.randn(n),
        "f": rng.randn(n).astype(np.float32),
        "b": rng.rand(n) > 0.5,
    }
    data["x"][:3] = [np.nan, np.inf, -0.0][:n]
    validity = {}
    for name in SCHEMA.names:
        ok = np.ones(n, np.bool_)
        ok[rng.choice(n, size=n // 7, replace=False)] = False
        validity[name] = ok
        data[name] = np.where(ok, data[name], np.zeros((), data[name].dtype))
    return data, validity


def batches(n: int, device, seed: int = 0, batch_rows: int = 1 << 20
            ) -> List[ColumnarBatch]:
    data, validity = columns(n, seed)
    return [batch_from_numpy({c: (data[c][o:o + batch_rows],
                                  validity[c][o:o + batch_rows])
                              for c in SCHEMA.names}, SCHEMA, device)
            for o in range(0, n, batch_rows)]


def extreme_aggs(E, cols: str) -> list:
    return [f(c).alias(f"{f.__name__}_{c}") for c in cols
            for f in (E.min_, E.max_)]


def variance_aggs(E, cols: str) -> list:
    return [f(c).alias(f"{f.__name__}_{c}") for c in cols
            for f in (E.var_samp, E.var_pop, E.stddev, E.stddev_pop)]


def global_aggregate(df, E=PE):
    """test_global_aggregate (:149)."""
    return df.agg(E.sum_("v").alias("sv"), E.count("v").alias("cv"),
                  E.count().alias("cs"), E.min_("v").alias("mn"),
                  E.max_("v").alias("mx"), E.avg("x").alias("ax"))


def grouped_aggregate(df, E=PE):
    """test_grouped_aggregate (:163)."""
    return df.group_by("k").agg(
        E.sum_("v").alias("sv"), E.count("v").alias("cv"),
        E.min_("x").alias("mn"), E.max_("x").alias("mx"),
        E.avg("v").alias("av"))


def global_extremes(df, E=PE):
    """MIN and MAX of all five columns."""
    return df.agg(*extreme_aggs(E, "kvxfb"))


def grouped_extremes(df, E=PE):
    return df.group_by("k").agg(*extreme_aggs(E, "vxfb"))


def global_variance(df, E=PE):
    """test_variance.py :6 over ``x`` and, as :14 does, ``v``."""
    return df.agg(*variance_aggs(E, "xv"))


def grouped_variance(df, E=PE):
    return df.group_by("k").agg(*variance_aggs(E, "xv"))


def filtered_global(df, E=PE):
    """A global MIN / MAX / M2 after a filter: one fused segment."""
    return df.filter(E.col("v") > E.lit(0)).agg(
        *extreme_aggs(E, "kxfb"), E.var_samp("v").alias("var_samp_v"),
        E.stddev_pop("x").alias("stddev_pop_x"))


QUERIES = {f.__name__: f for f in (
    global_aggregate, grouped_aggregate, global_extremes, grouped_extremes,
    global_variance, grouped_variance, filtered_global)}


# -- the aggregate tail (tests/test_agg_tail.py) --------------------------------

TAIL_SCHEMA = Schema.of(k=T.INT, v=T.LONG, x=T.DOUBLE, s=T.STRING, b=T.BYTE)
TAIL_KEYS = 9
TAIL_CODES = 100
#: the string of each code
TAIL_STRINGS = [f"s{i % 19}-{'y' * (i % 5)}" for i in range(TAIL_CODES)]
_TAIL_BYTES = [t.encode() for t in TAIL_STRINGS]
#: each code's dense rank in the strings' unsigned byte order (equal
#: strings share one)
TAIL_RANK = np.searchsorted(sorted(set(_TAIL_BYTES)), _TAIL_BYTES).astype(
    np.int64)


def tail_columns(n: int, seed: int = 3
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(values, validity) per column of the tail's table, ``s`` as its
    codes; a null slot holds zero (a null ``s`` code 0)."""
    rng = np.random.RandomState(seed)
    data = {"k": rng.randint(0, TAIL_KEYS, n).astype(np.int32),
            "v": rng.randint(-1000, 1000, n).astype(np.int64),
            "x": np.round(rng.randn(n), 3),
            "s": rng.randint(0, TAIL_CODES, n).astype(np.int8),
            "b": rng.randint(-128, 128, n).astype(np.int8)}
    data["x"][:3] = [np.nan, -0.0, np.inf][:n]
    validity = {"k": np.ones(n, np.bool_)}
    for name in "vxsb":
        ok = np.ones(n, np.bool_)
        ok[rng.choice(n, n // 6, replace=False)] = False
        validity[name] = ok
        data[name] = np.where(ok, data[name], np.zeros((), data[name].dtype))
    return data, validity


def tail_strings(codes: np.ndarray, valid: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The STRING column of these codes: (int32 offsets, uint8 bytes,
    validity), a null row of length 0."""
    return pool_strings(codes, valid, TAIL_STRINGS)


def tail_batches(data: Dict[str, np.ndarray],
                 validity: Dict[str, np.ndarray], device,
                 batch_rows: int = 1 << 20,
                 with_short: bool = False) -> List[ColumnarBatch]:
    """``tail_columns``' columns as device batches of ``batch_rows``;
    ``with_short``: and ``h`` SHORT, ``v`` narrowed, with v's nulls."""
    n = len(data["k"])
    schema = TAIL_SHORT_SCHEMA if with_short else TAIL_SCHEMA
    out = []
    for o in range(0, n, batch_rows):
        cut = {c: (data[c][o:o + batch_rows], validity[c][o:o + batch_rows])
               for c in TAIL_SCHEMA.names}
        cut["s"] = tail_strings(*cut["s"])
        if with_short:
            cut["h"] = (cut["v"][0].astype(np.int16), cut["v"][1])
        out.append(batch_from_numpy(cut, schema, device))
    return out


def grouped_first_last(df, E=PE):
    """test_first_last_grouped (:49)."""
    return df.group_by("k").agg(
        E.first("v").alias("fv"), E.last("v").alias("lv"),
        E.first("v", ignore_nulls=True).alias("fvn"),
        E.last("v", ignore_nulls=True).alias("lvn"),
        E.first("s").alias("fs"), E.last("s", ignore_nulls=True).alias("lsn"))


def global_first_last(df, E=PE):
    """test_first_last_global_and_empty's second query (:76), with the
    first and last ``s`` and ``b``."""
    return df.agg(E.first("v", ignore_nulls=True).alias("f"),
                  E.last("x").alias("l"), E.first("s").alias("fs"),
                  E.last("b", ignore_nulls=True).alias("lbn"))


def grouped_max_min_by(df, E=PE):
    """test_max_by_min_by (:83)."""
    return df.group_by("k").agg(
        E.max_by("v", "x").alias("mbx"), E.min_by("v", "x").alias("nbx"),
        E.max_by("s", "v").alias("mbs"), E.min_by("s", "v").alias("nbs"))


def grouped_by_string(df, E=PE):
    """test_max_by_min_by_string_ordering_keys (:108)."""
    return df.group_by("k").agg(
        E.max_by("v", "s").alias("mvs"), E.min_by("v", "s").alias("nvs"),
        E.max_by("s", "s").alias("mss"), E.min_by("x", "s").alias("nxs"))


def global_by_string(df, E=PE):
    """test_max_by_string_keys_global_and_ties (:126), over the table."""
    return df.agg(E.max_by("v", "s").alias("m"),
                  E.min_by("v", "s").alias("n"))


def grouped_string_extremes(df, E=PE):
    """test_min_max_over_strings (:152)."""
    return df.group_by("k").agg(E.Min(E.col("s")).alias("mn"),
                                E.Max(E.col("s")).alias("mx"))


def grouped_bits(df, E=PE):
    """test_bit_aggregates (:168)."""
    return df.group_by("k").agg(
        E.bit_and("v").alias("ba"), E.bit_or("v").alias("bo"),
        E.bit_xor("v").alias("bx"), E.bit_and("b").alias("bab"),
        E.bit_xor("b").alias("bxb"))


def global_bits(df, E=PE):
    """test_bit_aggregates_global_all_null (:180)'s aggregates, and the
    rest of the family, over the table."""
    return df.agg(*[f(c).alias(f"{f.__name__}_{c}") for c in "vb"
                    for f in (E.bit_and, E.bit_or, E.bit_xor)])


TAIL_QUERIES = {f.__name__: f for f in (
    grouped_first_last, global_first_last, grouped_max_min_by,
    grouped_by_string, global_by_string, grouped_string_extremes,
    grouped_bits, global_bits)}

TAIL_SHORT_SCHEMA = Schema(TAIL_SCHEMA.names + ("h",),
                           TAIL_SCHEMA.dtypes + (T.SHORT,))
#: the BYTE dimension the tail joins on b: every BYTE value once, with
#: ``d`` = its value + 1000
BYTE_DIM_SCHEMA = Schema.of(db=T.BYTE, d=T.INT)


def byte_dimension(device) -> ColumnarBatch:
    """The 256-row BYTE dimension (-128..127)."""
    b = np.arange(-128, 128).astype(np.int8)
    ok = np.ones(256, np.bool_)
    return batch_from_numpy({"db": (b, ok),
                             "d": (b.astype(np.int32) + 1000, ok)},
                            BYTE_DIM_SCHEMA, device)


def group_by_byte(df, E=PE):
    """GROUP BY b: COUNT and MIN(x), ordered by b."""
    return df.group_by("b").agg(E.count().alias("n"),
                                E.min_("x").alias("mx")).order_by("b")


def byte_extremes(df, E=PE):
    """GROUP BY k: MIN, MAX and VARIANCE of b."""
    return df.group_by("k").agg(E.min_("b").alias("mn"),
                                E.max_("b").alias("mx"),
                                E.var_samp("b").alias("vb"))


def group_by_short(df, E=PE):
    """GROUP BY h: COUNT and MAX(b), ordered by h."""
    return df.group_by("h").agg(E.count().alias("n"),
                                E.max_("b").alias("mb")).order_by("h")


def join_on_byte(df, dim, E=PE):
    """An inner join on b against the BYTE dimension: COUNT, SUM(v) and
    SUM(d)."""
    return df.join(dim, on=([E.col("b")], [E.col("db")])).agg(
        E.count().alias("n"), E.sum_("v").alias("sv"),
        E.sum_("d").alias("sd"))


#: the BYTE / SHORT key queries over the tail's table (``join_on_byte``
#: also takes the dimension's dataframe)
TAIL_KEY_QUERIES = {f.__name__: f for f in (
    group_by_byte, byte_extremes, group_by_short, join_on_byte)}


# -- the two-limb decimal shapes (tests/test_decimal128.py) ------------------

DEC_KEYS = 7


def decimal_schema(T_=T) -> Schema:
    """``a`` decimal(25,4), ``b`` decimal(30,2), ``c`` decimal(12,2), ``k``
    INT, in the types module ``T_`` (the port's, or the reference's)."""
    return (T_.DecimalType(25, 4), T_.DecimalType(30, 2),
            T_.DecimalType(12, 2), T_.INT)


DEC_SCHEMA = Schema(("a", "b", "c", "k"), decimal_schema())


def _product_limbs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """x * y (|x| < 2**31, 0 <= y < 2**62) exactly, as int64 [n, 2] (low,
    high) limbs: y's 32-bit halves keep each partial product in int64."""
    yl = (y & 0xFFFFFFFF).astype(np.int64)
    yh = (y >> 32).astype(np.int64)
    p1 = x * yl                      # |p1| < 2**63
    p2 = x * yh
    lo = (p2.astype(np.uint64) << np.uint64(32)) + p1.astype(np.uint64)
    carry = (lo < (p2.astype(np.uint64) << np.uint64(32))).astype(np.int64)
    hi = (p2 >> 32) + (p1 >> 63) + carry
    return np.stack([lo.view(np.int64), hi], 1)


def decimal_columns(n: int, seed: int = 11
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``df``'s streams in its order, vectorised: ``a`` = x * y with x in
    [-10**9, 10**9) and y in [0, 10**11), ``b`` the same with y < 10**14
    (both int64 [n, 2] limbs), ``c`` in [-10**9, 10**9), ``k`` in [0, 7);
    n // 9 nulls in ``a`` and in ``b``.  ``decimal_columns(200)`` is
    ``df()``'s rows."""
    rng = np.random.RandomState(seed)
    ax, ay = rng.randint(-10**9, 10**9, n), rng.randint(0, 10**11, n)
    bx, by = rng.randint(-10**9, 10**9, n), rng.randint(0, 10**14, n)
    data = {"a": _product_limbs(ax.astype(np.int64), ay.astype(np.int64)),
            "b": _product_limbs(bx.astype(np.int64), by.astype(np.int64)),
            "c": rng.randint(-10**9, 10**9, n).astype(np.int64),
            "k": rng.randint(0, DEC_KEYS, n).astype(np.int32)}
    validity = {c: np.ones(n, np.bool_) for c in data}
    for c in "ab":
        validity[c][rng.choice(n, n // 9, replace=False)] = False
        data[c][~validity[c]] = 0
    return data, validity


def decimal_batches(data, validity, device, batch_rows: int
                    ) -> List[ColumnarBatch]:
    n = len(data["k"])
    return [batch_from_numpy({c: (data[c][o:o + batch_rows],
                                  validity[c][o:o + batch_rows])
                              for c in DEC_SCHEMA.names}, DEC_SCHEMA, device)
            for o in range(0, n, batch_rows)]


def dec_add_sub(df, E=PE, T_=T):
    return df.select((E.col("a") + E.col("b")).alias("s"),
                     (E.col("a") - E.col("b")).alias("d"), E.col("k"))


def dec_mul(df, E=PE, T_=T):
    """decimal(25,4) x decimal(12,2) -> decimal(38,6): products past 38
    digits are null."""
    return df.select((E.col("a") * E.col("c")).alias("m"), E.col("k"))


def dec_mixed(df, E=PE, T_=T):
    return df.select((E.col("c") + E.col("a")).alias("s"))


def dec_filter(df, E=PE, T_=T):
    return df.filter(E.col("a") > E.Cast(E.col("c"), T_.DecimalType(25, 4))
                     ).select(E.col("a"), E.col("k"))


def dec_casts(df, E=PE, T_=T):
    C, c = E.Cast, E.col
    return df.select(C(c("a"), T_.DecimalType(30, 6)).alias("up"),
                     C(c("a"), T_.DecimalType(20, 1)).alias("down"),
                     C(c("a"), T_.DecimalType(12, 2)).alias("narrow"),
                     C(c("c"), T_.DecimalType(30, 2)).alias("widen"),
                     C(c("a"), T_.DOUBLE).alias("dbl"),
                     C(c("a"), T_.LONG).alias("lng"),
                     C(c("k"), T_.DecimalType(28, 3)).alias("from_int"))


def dec_divide(df, E=PE, T_=T):
    return df.select((E.col("a") / E.col("c")).alias("q"), E.col("k"))


def dec_sum_grouped(df, E=PE, T_=T):
    return df.group_by("k").agg(E.sum_(E.col("a")).alias("sa"),
                                E.sum_(E.col("b")).alias("sb"),
                                E.sum_(E.col("c")).alias("sc"),
                                E.count().alias("n"))


def dec_sum_global(df, E=PE, T_=T):
    return df.agg(E.sum_(E.col("a")).alias("sa"), E.count().alias("n"))


def dec_overflow(df, E=PE, T_=T):
    """k * 10**37 as decimal(38,0) (exact products of LONG literals cast
    to decimal(38,0)), summed: every group but k = 0 passes 38 digits and
    is null."""
    d38 = T_.DecimalType(38, 0)
    big = E.Cast(E.col("k"), d38)
    for factor in (10 ** 18, 10 ** 18, 10):
        big = big * E.Cast(E.lit(factor), d38)
    return df.group_by("k").agg(E.sum_(big).alias("sv"))


def dec_avg(df, E=PE, T_=T):
    return df.group_by("k").agg(E.avg(E.col("c")).alias("ac"),
                                E.avg(E.col("a")).alias("aa"))


def dec_min_max_grouped(df, E=PE, T_=T):
    return df.group_by("k").agg(E.min_(E.col("a")).alias("mn"),
                                E.max_(E.col("a")).alias("mx"),
                                E.count(E.col("a")).alias("n"))


def dec_min_max_global(df, E=PE, T_=T):
    return df.agg(E.min_(E.col("b")).alias("mn"),
                  E.max_(E.col("b")).alias("mx"))


#: the elementwise queries, and the aggregates
DEC_ROW_QUERIES = {f.__name__: f for f in (
    dec_add_sub, dec_mul, dec_mixed, dec_filter, dec_casts, dec_divide)}
DEC_AGG_QUERIES = {f.__name__: f for f in (
    dec_sum_grouped, dec_sum_global, dec_overflow, dec_avg,
    dec_min_max_grouped, dec_min_max_global)}


# -- the window shapes (tests/test_window.py) ----------------------------------

#: wdf's columns and ``i``, the row's index in the table (no window reads
#: it: it lets an answer computed elsewhere find its row)
WINDOW_SCHEMA = Schema.of(k=T.INT, t=T.INT, v=T.LONG, x=T.DOUBLE, i=T.LONG)
WINDOW_KEYS = 11


def window_columns(n: int, seed: int = 2
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """wdf's numpy streams in its order, vectorised (``window_columns(300)``
    is ``wdf``'s rows): k INT of 11 keys, t INT 0-39 (ties make peer runs),
    v LONG -100..99 and x DOUBLE (randn) with n // 9 nulls each; a null
    slot holds zero.  Returns (values, validity)."""
    rng = np.random.RandomState(seed)
    data = {"k": rng.randint(0, WINDOW_KEYS, n).astype(np.int32),
            "t": rng.randint(0, 40, n).astype(np.int32),
            "v": rng.randint(-100, 100, n).astype(np.int64),
            "x": rng.randn(n),
            "i": np.arange(n, dtype=np.int64)}
    validity = {c: np.ones(n, np.bool_) for c in WINDOW_SCHEMA.names}
    for c in ("v", "x"):
        validity[c][rng.choice(n, n // 9, replace=False)] = False
        data[c] = np.where(validity[c], data[c], np.zeros((), data[c].dtype))
    return data, validity


def window_batches(data: Dict[str, np.ndarray],
                   validity: Dict[str, np.ndarray], device,
                   batch_rows: int = 100) -> List[ColumnarBatch]:
    n = len(data["i"])
    return [batch_from_numpy({c: (data[c][o:o + batch_rows],
                                  validity[c][o:o + batch_rows])
                              for c in WINDOW_SCHEMA.names}, WINDOW_SCHEMA,
                             device) for o in range(0, n, batch_rows)]


def _kt(E, fn, frame=None):
    return E.over(fn, partition_by=["k"], order_by=["t"], frame=frame)


def window_ranks(df, E=PE):
    """W1: the rank family over (k; t)."""
    return df.select(
        E.col("i"), _kt(E, E.RowNumber()).alias("rn"),
        _kt(E, E.Rank()).alias("rk"), _kt(E, E.DenseRank()).alias("drk"),
        _kt(E, E.PercentRank()).alias("pr"), _kt(E, E.CumeDist()).alias("cd"),
        _kt(E, E.Ntile(3)).alias("nt"))


def window_running(df, E=PE):
    """W2: the default RANGE UNBOUNDED PRECEDING..CURRENT ROW frame."""
    return df.select(
        E.col("i"), _kt(E, E.sum_("v")).alias("sv"),
        _kt(E, E.count("v")).alias("cv"), _kt(E, E.avg("v")).alias("av"),
        _kt(E, E.min_("v")).alias("mn"), _kt(E, E.max_("x")).alias("mx"))


def window_whole(df, E=PE):
    """W3: the whole partition of k."""
    def whole(fn):
        return E.over(fn, partition_by=["k"])
    return df.select(
        E.col("i"), whole(E.sum_("v")).alias("sv"),
        whole(E.count()).alias("n"), whole(E.min_("v")).alias("mn"),
        whole(E.max_("x")).alias("mx"), whole(E.avg("v")).alias("av"))


def window_offsets(df, E=PE):
    """W4: LEAD, LAG, FIRST_VALUE and LAST_VALUE over the whole RANGE,
    NTH_VALUE over ROWS 1..1."""
    both = E.WindowFrame("range", None, None)
    return df.select(
        E.col("i"), _kt(E, E.Lead(E.col("v"), 1)).alias("ld"),
        _kt(E, E.Lag(E.col("v"), 2)).alias("lg"),
        _kt(E, E.FirstValue(E.col("v")), both).alias("fv"),
        _kt(E, E.LastValue(E.col("v")), both).alias("lv"),
        _kt(E, E.NthValue(E.col("v"), 2),
            E.WindowFrame("rows", 1, 1)).alias("nv"))


#: the ROWS frames of WINDOW_EXPRS (:59-73): (function, column, start, end)
ROWS_FRAMES = (("sum_", "v", -2, 0), ("avg", "x", -3, 3),
               ("count", None, None, 0), ("min_", "v", -2, 0),
               ("max_", "v", -3, 3), ("min_", "x", -4, 1),
               ("max_", "x", 0, 2))
#: its bounded RANGE frames (:75-86)
RANGE_FRAMES = (("sum_", "v", -5, 5), ("count", "v", -3, 0),
                ("avg", "v", -10, -2), ("min_", "v", -4, 4),
                ("max_", "v", None, 3), ("sum_", "v", -2, None))


def _framed(df, E, kind, frames):
    cols = [E.col("i")]
    for j, (fn, c, start, end) in enumerate(frames):
        agg = getattr(E, fn)(c) if c is not None else getattr(E, fn)()
        cols.append(_kt(E, agg, E.WindowFrame(kind, start, end)).alias(
            f"w{j}"))
    return df.select(*cols)


def window_rows(df, E=PE):
    """W5: the seven ROWS frames."""
    return _framed(df, E, "rows", ROWS_FRAMES)


def window_range(df, E=PE):
    """W6: the six bounded RANGE frames."""
    return _framed(df, E, "range", RANGE_FRAMES)


def window_global(df, E=PE):
    """W7: ROW_NUMBER over (t, v) with no partition: one partition of
    every row."""
    return df.select(E.col("i"), E.over(E.RowNumber(),
                                        order_by=["t", "v"]).alias("rn"))


WINDOW_QUERIES = {f.__name__: f for f in (
    window_ranks, window_running, window_whole, window_offsets, window_rows,
    window_range, window_global)}


# -- the held joins (tests/test_joins.py) ------------------------------------

JOIN_LEFT_SCHEMA = Schema.of(k=T.INT, lv=T.LONG, lx=T.DOUBLE)
JOIN_RIGHT_SCHEMA = Schema.of(k=T.INT, rv=T.LONG)
#: the build of the cross and keyless joins: the right side's first rows
JOIN_SMALL_BUILD = 16


def _join_side(rng, cols: Dict[str, np.ndarray], n: int
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    validity = {}
    for name in cols:
        ok = np.ones(n, np.bool_)
        ok[rng.choice(n, n // 8, replace=False)] = False
        validity[name] = ok
        cols[name] = np.where(ok, cols[name], np.zeros((), cols[name].dtype))
    return cols, validity


def join_columns(n: int, seed: int = 5) -> tuple:
    """((left values, left validity), (right values, right validity)):
    ``left_df`` and ``right_df``'s shapes at n and n // 2 rows (see the
    module's docstring); a null slot holds zero."""
    rng = np.random.RandomState(seed)
    nr = n // 2
    left = {"k": rng.randint(0, max(n // 15, 1), n).astype(np.int32),
            "lv": rng.randint(-1000, 1000, n).astype(np.int64),
            "lx": rng.randn(n)}
    right = {"k": rng.randint(0, max(n // 12, 1), nr).astype(np.int32),
             "rv": rng.randint(-1000, 1000, nr).astype(np.int64)}
    return _join_side(rng, left, n), _join_side(rng, right, nr)


def join_batches(data: Dict[str, np.ndarray],
                 validity: Dict[str, np.ndarray], schema: Schema, device,
                 batch_rows: int = 1 << 20, rows: int = -1
                 ) -> List[ColumnarBatch]:
    """One side's columns (its first ``rows``; -1: all) as device batches
    of ``batch_rows``."""
    n = len(data[schema.names[0]]) if rows < 0 else rows
    return [batch_from_numpy(
        {c: (data[c][o:min(o + batch_rows, n)],
             validity[c][o:min(o + batch_rows, n)]) for c in schema.names},
        schema, device) for o in range(0, n, batch_rows)]


def join_aggs(E) -> list:
    return [E.count().alias("n"), E.count("lv").alias("nl"),
            E.sum_("lv").alias("sl"), E.sum_("rv").alias("sr")]


def right_join(left, right, E=PE):
    """J1: the right join on k."""
    return left.join(right, "k", how="right").agg(*join_aggs(E))


def full_join(left, right, E=PE):
    """J2: the full join on k."""
    return left.join(right, "k", how="full").agg(*join_aggs(E))


def full_join_by_rv(left, right, E=PE):
    """J2 grouped: the full join on k, GROUP BY rv."""
    return left.join(right, "k", how="full").group_by("rv").agg(
        E.count().alias("n"), E.sum_("lv").alias("sl"))


def full_join_condition(left, right, E=PE):
    """J3: the full join on k with lv < rv."""
    return left.join(right, "k", how="full",
                     condition=E.col("lv") < E.col("rv")).agg(*join_aggs(E))


def cross_join(left, small, E=PE):
    """J4: the cross join with the small build."""
    return left.join(small, ([], []), how="cross").agg(*join_aggs(E))


def keyless_inner(left, small, E=PE):
    """J5: the keyless inner join with lv < rv."""
    return left.join(small, None, how="inner",
                     condition=E.col("lv") < E.col("rv")).agg(*join_aggs(E))


def keyless_right(left, small, E=PE):
    """J5: the keyless right join with lv < rv."""
    return left.join(small, None, how="right",
                     condition=E.col("lv") < E.col("rv")).agg(*join_aggs(E))


#: the held joins: name -> (query, whether its build is the small one)
JOIN_QUERIES = {f.__name__: (f, small) for f, small in (
    (right_join, False), (full_join, False), (full_join_by_rv, False),
    (full_join_condition, False), (cross_join, True),
    (keyless_inner, True), (keyless_right, True))}


# -- the held string shapes -------------------------------------------------

STRING_SCHEMA = Schema.of(s=T.STRING, t=T.STRING, n=T.INT, u=T.STRING,
                          r=T.STRING, i=T.LONG)
#: tests/test_strings.py WORDS (:30)
STRING_WORDS = ["apple", "Banana", "", "cherry pie", "  padded  ", "MiXeD",
                "über", "日本語", "a", "zz top", "CHERRY", "ap%ple"]
#: tests/test_string_functions.py VALS (:20), with its two nulls
STRING_VALS = ["hello world", "  padded  ", "", "a", "ababab",
               "The Quick brown", "x,y,z", "aaa", "Mixed CASE text", None,
               "tab\there", "ünïcode", "ends with space ", " leading",
               "a.b.c.d", "no-match", None, "ααβ", "repeatrepeat",
               "...dots..."]
#: tests/test_regex.py STRINGS (:37), the LIKE extras (:156), two nulls
STRING_REGEX = ["", "a", "abc", "xabcx", "aaab", "ab", "acd", "abd", "12",
                "12345", "user@site.com", "color", "colour", "  hello  ",
                "foobaz", "barbaz", ".*", "héllo", "hello\nabc", "abc\r",
                "aBc", "deadBEEF", "ααα", "abcd", "café", "zzz", "abcabc",
                "cdcd", "aad", "+42", "0x1F", "abe", "ace", "bcd",
                "a_b", "axbyc", "100%", "ab", "a%bxc", "xy", None, None]
#: each string column's pool: its codes index it
STRING_POOLS = {"s": STRING_WORDS, "t": STRING_WORDS, "u": STRING_VALS,
                "r": STRING_REGEX}


def string_columns(n: int, seed: int = 3
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(values, validity) per column, the strings as int8 codes into
    their pools: strings_df's streams in its order (n first, then the
    nulls of s, then of t), so ``string_columns(120)`` is its s, t and n
    row for row."""
    rng = np.random.RandomState(seed)
    i = np.arange(n, dtype=np.int64)
    data = {"s": (i % 12).astype(np.int8),
            "t": ((7 * i + 3) % 12).astype(np.int8),
            "n": rng.randint(-3, 12, n).astype(np.int32),
            "u": (i % len(STRING_VALS)).astype(np.int8),
            "r": (i % len(STRING_REGEX)).astype(np.int8),
            "i": i}
    validity = {c: np.ones(n, np.bool_) for c in STRING_SCHEMA.names}
    for c in ("s", "t"):
        validity[c][rng.choice(n, n // 6, replace=False)] = False
    for c in ("u", "r"):
        present = np.array([v is not None for v in STRING_POOLS[c]])
        validity[c] = present[data[c]]
    return data, validity


def pool_strings(codes: np.ndarray, valid: np.ndarray, pool: List
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The STRING column of these codes into ``pool``: (int32 offsets,
    uint8 bytes, validity), a null row of length 0.  Each output byte is
    gathered from the pool's bytes, so a long pool row costs only its
    own rows."""
    raw = [b"" if v is None else v.encode() for v in pool]
    lengths = np.array([len(b) for b in raw], np.int64)
    starts = np.cumsum(lengths) - lengths
    flat = np.frombuffer(b"".join(raw), np.uint8)
    row_len = np.where(valid, lengths[codes], 0)
    offsets = np.zeros(len(codes) + 1, np.int64)
    np.cumsum(row_len, out=offsets[1:])
    row = np.repeat(np.arange(len(codes)), row_len)
    src = starts[codes][row] + np.arange(int(offsets[-1])) - offsets[:-1][row]
    return offsets.astype(np.int32), flat[src], valid


def string_batches(data: Dict[str, np.ndarray],
                   validity: Dict[str, np.ndarray], device,
                   batch_rows: int = 1 << 20) -> List[ColumnarBatch]:
    """``string_columns``' columns as device batches of ``batch_rows``."""
    n = len(data["i"])
    out = []
    for o in range(0, n, batch_rows):
        cut = {}
        for c in STRING_SCHEMA.names:
            vals, ok = data[c][o:o + batch_rows], validity[c][o:o + batch_rows]
            cut[c] = (pool_strings(vals, ok, STRING_POOLS[c])
                      if c in STRING_POOLS else (vals, ok))
        out.append(batch_from_numpy(cut, STRING_SCHEMA, device))
    return out


def string_exprs(E=PE) -> list:
    """tests/test_strings.py EXPRS (:53-73), named r0..r18."""
    col, lit = E.col, E.lit
    s = col("s")
    exprs = [
        E.Length(s), E.Upper(s), E.Lower(s),
        E.Substring(s, lit(2), lit(3)), E.Substring(s, lit(-3), lit(2)),
        E.Substring(s, col("n"), lit(2)), E.ConcatStrings(s, col("t")),
        E.ConcatStrings(s, lit("!")), E.Trim(s), E.StartsWith(s, lit("ap")),
        E.EndsWith(s, lit("y")), E.Contains(s, lit("err")),
        E.Like(s, "%err%"), E.Like(s, "ap%"), E.Like(s, "%pie"),
        E.Like(s, "apple"), s == col("t"), s < col("t"),
        s >= lit("cherry")]
    return [e.alias(f"r{k}") for k, e in enumerate(exprs)]


def string_functions(E=PE) -> list:
    """tests/test_string_functions.py's 20 functions (:37-60) over u, and
    its two concat_ws (:67-72) over u and t, named f0..f21."""
    u, t = E.col("u"), E.col("t")
    exprs = [
        E.LTrim(u), E.RTrim(u), E.Reverse(u), E.InitCap(u), E.Ascii(u),
        E.StringReplace(u, "a", "XY"), E.StringReplace(u, "ab", ""),
        E.StringReplace(u, ".", "--"), E.StringReplace(u, "aa", "b"),
        E.StringInstr(u, "b"), E.StringInstr(u, "zzz"), E.StringInstr(u, ""),
        E.StringLocate("a", u, 3), E.StringLocate("a", u, 0),
        E.StringRepeat(u, 3), E.StringRepeat(u, 0), E.Lpad(u, 8, "*"),
        E.Lpad(u, 3, "xy"), E.Rpad(u, 8, "*"), E.Rpad(u, 0, "z"),
        E.ConcatWs("-", u, t), E.ConcatWs("", u, t, u)]
    return [e.alias(f"f{k}") for k, e in enumerate(exprs)]


#: tests/test_regex.py's RLIKE (:138-140) and LIKE (:152-153) patterns
RLIKE_PATTERNS = ["[a-z]+", r"\d{2,4}", "(ab|cd)+", r"\w+@\w+\.com", "^a",
                  "d$", "a.c", "colou?r"]
LIKE_PATTERNS = ["a_b%c", "%b_", "_", "%", "a%b%c", r"100\%", "__", "a\\_b"]


def regex_exprs(E=PE) -> list:
    r = E.col("r")
    return ([E.RLike(r, p).alias(f"m{k}")
             for k, p in enumerate(RLIKE_PATTERNS)]
            + [E.Like(r, p).alias(f"l{k}")
               for k, p in enumerate(LIKE_PATTERNS)])


def strings_select(df, E=PE):
    """S1."""
    return df.select(E.col("i"), E.col("s"), E.col("t"), E.col("n"),
                     *string_exprs(E))


def strings_functions(df, E=PE):
    """S2."""
    return df.select(E.col("i"), E.col("u"), *string_functions(E))


def strings_regex(df, E=PE):
    """S3."""
    return df.select(E.col("i"), E.col("r"), *regex_exprs(E))


def strings_filter_grouped(df, E=PE):
    """S4: tests/test_strings.py test_string_filter_pipeline (:99-104),
    grouped by its upper-cased prefix."""
    s = E.col("s")
    return df.filter(E.Not(E.IsNull(s)) & E.Contains(s, E.lit("e"))).select(
        s, E.Length(s).alias("len"),
        E.Upper(E.Substring(s, E.lit(1), E.lit(4))).alias("pre")).group_by(
        "pre").agg(E.count().alias("c"), E.sum_("len").alias("sl"))


def strings_if_grouped(df, E=PE):
    """S5a: IF(n > 5, s, t) grouped, COUNT(*)."""
    return df.select(E.If(E.col("n") > 5, E.col("s"), E.col("t")).alias(
        "v")).group_by("v").agg(E.count().alias("c"))


def strings_case_grouped(df, E=PE):
    """S5b: CASE WHEN n < 0 THEN s WHEN n < 5 THEN t ELSE 'z' END grouped,
    COUNT(*)."""
    n = E.col("n")
    return df.select(E.CaseWhen([(n < 0, E.col("s")), (n < 5, E.col("t"))],
                                E.lit("z")).alias("v")).group_by("v").agg(
        E.count().alias("c"))


#: the row queries (S1-S3: an output row per input row) and the grouped
#: ones (S4, S5)
STRING_ROW_QUERIES = {f.__name__: f for f in (
    strings_select, strings_functions, strings_regex)}
STRING_AGG_QUERIES = {f.__name__: f for f in (
    strings_filter_grouped, strings_if_grouped, strings_case_grouped)}
STRING_QUERIES = {**STRING_ROW_QUERIES, **STRING_AGG_QUERIES}


# -- the held casts -----------------------------------------------------------

CAST_SCHEMA = Schema.of(si=T.STRING, sd=T.STRING, sdt=T.STRING, sb=T.STRING,
                        l=T.LONG, i=T.INT, d=T.DATE, b=T.BOOLEAN,
                        x=T.DOUBLE, y=T.BYTE, h=T.SHORT, k=T.LONG)
#: tests/test_cast_strings.py INT_STRINGS (:17)
CAST_INT_STRINGS = [
    "0", "1", "-1", "+42", "  17  ", "2147483647", "2147483648",
    "-2147483648", "-2147483649", "9223372036854775807",
    "9223372036854775808", "-9223372036854775808", "-9223372036854775809",
    "3.7", "-3.9", "3.", ".5", "-.5", "007", "", "  ", "abc", "12a", "a12",
    "1 2", "+", "-", ".", "1.2.3", "--5", "1e3", None, "\t13\n", "127",
    "128", "-128", "-129", "32767", "32768", "-32768", "-32769",
]
#: FLOAT_STRINGS (:25)
CAST_FLOAT_STRINGS = [
    "0", "1.5", "-2.25", "3", ".5", "5.", "1e3", "1E-3", "-1.25e2",
    "+0.125", "1e308", "1e309", "-1e309", "1e-300", "12345678901234567890",
    "0.0000000000000000001234", "Infinity", "-Infinity", "+infinity", "inf",
    "-INF", "NaN", "nan", "-nan", "", "abc", "1e", "e3", "1e+", "1.2e3.4",
    "  2.5  ", None, "1.7976931348623157e308", "0.001", "100.",
]
#: DATE_STRINGS (:33)
CAST_DATE_STRINGS = [
    "2020-01-01", "2020-1-1", "2020-12-31", "2020-02-29", "2021-02-29",
    "1999-9-9", "2020", "2020-06", "0001-01-01", "9999-12-31",
    "2020-13-01", "2020-00-10", "2020-01-32", "2020-01-00", "20-01-01",
    "202O-01-01", "", "  2020-03-04  ", "2020-01-01x", None, "1970-01-01",
]
#: BOOL_STRINGS (:40)
CAST_BOOL_STRINGS = ["true", "TRUE", "t", "y", "yes", "1", "false", "False",
                     "f", "n", "no", "0", "maybe", "", "  true ", None, "10"]
CAST_GENERATED = 4096
#: the numeric columns' value pools' size
CAST_VALUES = 1 << 16
_LONG_EDGES = [-2**63, 2**63 - 1, -2**63 + 1, 2**63 - 2, 0, 1, -1, 2**31,
               -2**31 - 1, 10**18, -10**18]
_DAY_EDGES = [-719162, 2932896, -719163, 2932897, -10**6, 3 * 10**6, 0]
_DOUBLE_EDGES = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e19,
                 -1e19, 2.0**31, -2.0**31 - 1, 2.0**63, -2.0**63,
                 2147483647.5, -2147483648.5, 9.3e18, 1e300, -1e300, 0.5,
                 -0.5, 127.9, -128.9, 32767.5]


def _int_texts(rng, count: int) -> List[str]:
    """Integer texts: signs, padding, leading zeros, fractions, the
    bounds of every width and one past them, over-long digit runs,
    non-digits and non-ASCII digits."""
    edges = []
    for lo, hi in ((-2**7, 2**7 - 1), (-2**15, 2**15 - 1),
                   (-2**31, 2**31 - 1), (-2**63, 2**63 - 1)):
        edges += [str(v) for v in (lo, hi, lo - 1, hi + 1)]
    junk = ["1e3", "12a", "0x1F", "١٢", "１２", "+-1",
            "1 2", "", " ", "-", ".", "1..2", "++1", "1-", "é"]
    out = list(edges) + junk
    while len(out) < count:
        kind = rng.randint(8)
        digits = "".join(map(str, rng.randint(0, 10, rng.randint(1, 20))))
        sign = ["", "-", "+"][rng.randint(3)]
        if kind <= 2:
            out.append(sign + digits.lstrip("0") or "0")
        elif kind == 3:
            out.append(" \t"[rng.randint(2)] * rng.randint(1, 4) + sign
                       + digits + " \n"[rng.randint(2)] * rng.randint(0, 3))
        elif kind == 4:
            out.append(sign + "0" * rng.randint(1, 12) + digits[:6])
        elif kind == 5:
            frac = "".join(map(str, rng.randint(0, 10, rng.randint(0, 6))))
            out.append(sign + digits[:rng.randint(0, 8)] + "." + frac)
        elif kind == 6:
            out.append(sign + digits + "".join(
                map(str, rng.randint(0, 10, rng.randint(1, 8)))))
        else:
            out.append(junk[rng.randint(len(junk))] + digits[:3])
    return out[:count]


def _double_texts(rng, count: int) -> List[str]:
    """Double texts: Python's repr and exponent forms over 10**-300 to
    10**300, fixed forms, more than 15 significant digits, padding."""
    out = []
    while len(out) < count:
        v = float(10.0 ** rng.uniform(-300, 300)) * (-1) ** rng.randint(2)
        kind = rng.randint(6)
        if kind <= 1:
            out.append(repr(v))
        elif kind == 2:
            out.append(f"{v:.{rng.randint(0, 21)}e}")
        elif kind == 3:
            w = float(rng.uniform(-1e6, 1e6))
            out.append(f"{w:.{rng.randint(0, 12)}f}")
        elif kind == 4:
            out.append(f"{v:.{rng.randint(0, 21)}E}".replace("E+", "E"))
        else:
            out.append("  " + repr(float(rng.normal(0, 1e4))) + " ")
    return out[:count]


def _date_texts() -> List[str]:
    """Every date of 1900-2100, as yyyy-mm-dd and as yyyy-m-d where that
    differs."""
    import datetime
    out = []
    day = datetime.date(1900, 1, 1)
    one = datetime.timedelta(days=1)
    while day.year <= 2100:
        two = day.isoformat()
        out.append(two)
        short = f"{day.year:04d}-{day.month}-{day.day}"
        if short != two:
            out.append(short)
        day += one
    return out


@functools.lru_cache(maxsize=None)
def cast_pools() -> Dict[str, list]:
    """Each column's pool (its codes index it): the text pools of
    tests/test_cast_strings.py (:17-48), each but ``sb`` with generated
    texts after them, and the numeric columns' values."""
    pools = {}
    rng = np.random.RandomState(16)
    pools["si"] = CAST_INT_STRINGS + _int_texts(rng, CAST_GENERATED)
    pools["sd"] = CAST_FLOAT_STRINGS + _double_texts(rng, CAST_GENERATED)
    pools["sdt"] = CAST_DATE_STRINGS + _date_texts()
    pools["sb"] = list(CAST_BOOL_STRINGS)
    m = CAST_VALUES
    small = np.arange(-32, 32)
    longs = rng.randint(-2**63, 2**63 - 1, m, dtype=np.int64)
    longs[:len(_LONG_EDGES)] = _LONG_EDGES
    longs[64:128] = small
    ints = rng.randint(-2**31, 2**31 - 1, m, dtype=np.int64)
    ints[:4] = [-2**31, 2**31 - 1, 0, -1]
    ints[64:128] = small
    days = rng.randint(-719162, 2932897, m)
    days[:len(_DAY_EDGES)] = _DAY_EDGES
    xs = np.concatenate([_DOUBLE_EDGES, rng.uniform(-1e10, 1e10, m // 2),
                         rng.normal(0, 1e3, m)])[:m]
    pools["l"] = longs
    pools["i"] = ints.astype(np.int32)
    pools["d"] = days.astype(np.int32)
    pools["x"] = xs.astype(np.float64)
    return pools


#: the columns drawn as codes into ``cast_pools``
CAST_CODED = ("si", "sd", "sdt", "sb", "l", "i", "d", "x")


def cast_columns(n: int, seed: int = 16
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(values, validity) per column: the coded columns as int32 codes
    into ``cast_pools``, ``b`` BOOLEAN, ``y`` BYTE, ``h`` SHORT and ``k``
    the row's index; about 10% nulls in every column but ``k`` (and a
    text pool's None)."""
    rng = np.random.RandomState(seed)
    pools = cast_pools()
    data = {c: rng.randint(0, len(pools[c]), n).astype(np.int32)
            for c in CAST_CODED}
    data["b"] = rng.rand(n) < 0.5
    data["y"] = rng.randint(-128, 128, n).astype(np.int8)
    data["h"] = rng.randint(-2**15, 2**15, n).astype(np.int16)
    data["k"] = np.arange(n, dtype=np.int64)
    validity = {c: rng.rand(n) >= 0.1 for c in CAST_SCHEMA.names}
    validity["k"][:] = True
    for c in ("si", "sd", "sdt", "sb"):
        present = np.array([v is not None for v in pools[c]])
        validity[c] &= present[data[c]]
    return data, validity


def cast_batches(data: Dict[str, np.ndarray],
                 validity: Dict[str, np.ndarray], device,
                 batch_rows: int = 1 << 20) -> List[ColumnarBatch]:
    """``cast_columns``' columns as device batches of ``batch_rows``."""
    pools = cast_pools()
    n = len(data["k"])
    out = []
    for o in range(0, n, batch_rows):
        cut = {}
        for c in CAST_SCHEMA.names:
            vals, ok = data[c][o:o + batch_rows], validity[c][o:o + batch_rows]
            if CAST_SCHEMA.dtype_of(c) == T.STRING:
                cut[c] = pool_strings(vals, ok, pools[c])
            elif c in CAST_CODED:
                cut[c] = (pools[c][vals], ok)
            else:
                cut[c] = (vals, ok)
        out.append(batch_from_numpy(cut, CAST_SCHEMA, device))
    return out


def casts_parse(df, E=PE, T_=T):
    """C1: the eight parse casts in one select."""
    C, c = E.Cast, E.col
    return df.select(
        c("k"), C(c("si"), T_.INT).alias("p_int"),
        C(c("si"), T_.LONG).alias("p_long"),
        C(c("si"), T_.SHORT).alias("p_short"),
        C(c("si"), T_.BYTE).alias("p_byte"),
        C(c("sd"), T_.DOUBLE).alias("p_double"),
        C(c("sd"), T_.FLOAT).alias("p_float"),
        C(c("sdt"), T_.DATE).alias("p_date"),
        C(c("sb"), T_.BOOLEAN).alias("p_bool"))


def casts_format(df, E=PE, T_=T):
    """C2: LONG, INT, DATE and BOOLEAN to STRING."""
    C, c = E.Cast, E.col
    return df.select(c("k"), C(c("l"), T_.STRING).alias("f_long"),
                     C(c("i"), T_.STRING).alias("f_int"),
                     C(c("d"), T_.STRING).alias("f_date"),
                     C(c("b"), T_.STRING).alias("f_bool"))


def casts_numeric(df, E=PE, T_=T):
    """C3: the numeric lattice, BYTE / SHORT promotion, COALESCE over a
    parse and IN with a null in the list."""
    C, c = E.Cast, E.col
    return df.select(
        c("k"), C(c("x"), T_.INT).alias("x_int"),
        C(c("x"), T_.LONG).alias("x_long"), C(c("l"), T_.INT).alias("l_int"),
        C(c("i"), T_.DOUBLE).alias("i_double"),
        C(c("b"), T_.INT).alias("b_int"),
        C(c("i"), T_.BOOLEAN).alias("i_bool"),
        (c("y") + c("i")).alias("y_plus_i"), (c("y") > 1).alias("y_gt_1"),
        (c("h") * c("x")).alias("h_times_x"),
        E.Coalesce(C(c("si"), T_.INT), E.lit(0)).alias("si_or_0"),
        E.In(c("i"), [1, 2, None]).alias("i_in"))


def casts_ingest(df, E=PE, T_=T):
    """C4: the rows whose si parses as LONG, grouped by sdt as a DATE: the
    sum of sd as a DOUBLE, COUNT(*), and the rows where l does not come
    back from its text (0)."""
    C, c = E.Cast, E.col
    back = E.EqualNullSafe(C(C(c("l"), T_.STRING), T_.LONG), c("l"))
    return df.filter(C(c("si"), T_.LONG).is_not_null()).select(
        C(c("sdt"), T_.DATE).alias("dt"), C(c("sd"), T_.DOUBLE).alias("v"),
        E.If(back, E.lit(0), E.lit(1)).alias("lost")).group_by("dt").agg(
        E.sum_("v").alias("sv"), E.count().alias("c"),
        E.sum_("lost").alias("lost"))


#: C1-C3 (an output row per input row) and C4 (grouped)
CAST_ROW_QUERIES = {f.__name__: f for f in (
    casts_parse, casts_format, casts_numeric)}
CAST_AGG_QUERIES = {f.__name__: f for f in (casts_ingest,)}
CAST_QUERIES = {**CAST_ROW_QUERIES, **CAST_AGG_QUERIES}


# ---------------------------------------------------------------------------
# the held dates and hashes (phase 22)

DATE_SCHEMA = Schema.of(ts=T.TIMESTAMP, d=T.DATE, i=T.INT, x=T.DOUBLE,
                        l=T.LONG, s=T.STRING, f=T.FLOAT, m=T.INT, k=T.LONG)
#: tests/test_timezone.py :27 and :39
DST_EDGES = (1205056800, 1225612800, 1615712400, 1636276800)
DATE_ZONES = ("America/Los_Angeles", "Asia/Kolkata", "Australia/Lord_Howe")
SESSION_ZONE = "America/Los_Angeles"
#: tests/test_hashing_sketches.py :25
HASH_WORDS = ["", "a", "tpu", "hello world", "x" * 40, None,
              "\u65e5\u672c\u8a9e\u30c6\u30ad\u30b9\u30c8"]
DATE_DIM_ROWS = 1 << 16
_INT_MIN, _LONG_MIN = -2**31, -2**63


def _long_words() -> List[str]:
    """64 rows of 33-200 UTF-8 bytes (ASCII, 2- and 3-byte characters)."""
    rng = np.random.RandomState(17)
    alphabet = [chr(c) for c in range(0x20, 0x7F)] + ["\u00e9", "\u65e5"]
    out = []
    for target in np.linspace(33, 200, 64).astype(int):
        w = ""
        while len(w.encode()) < target:
            w += alphabet[rng.randint(len(alphabet))]
        out.append(w)
    return out


DATE_POOL = HASH_WORDS + _long_words()


def date_columns(n: int, seed: int = 8
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(values, validity) per column, ``s`` as int32 codes into
    ``DATE_POOL``; a null slot holds zero."""
    rng = np.random.RandomState(seed)
    secs = rng.randint(-631152000, 3786912000, n).astype(np.int64)
    near = rng.rand(n) < 0.25
    secs[near] = (np.array(DST_EDGES, np.int64)[rng.randint(0, 4, n)]
                  + rng.randint(-7200, 7200, n))[near]
    data = {
        "ts": secs * 1_000_000 + rng.randint(0, 10**6, n),
        "d": rng.randint(-30000, 30000, n).astype(np.int32),
        "i": rng.randint(-50, 50, n).astype(np.int32),
        "x": rng.randn(n) * 100,
        "l": rng.randint(-2**60, 2**60, n, dtype=np.int64),
        "s": np.where(rng.rand(n) < 0.25,
                      len(HASH_WORDS) + rng.randint(0, 64, n),
                      rng.randint(0, len(HASH_WORDS), n)).astype(np.int32),
        "f": rng.randn(n).astype(np.float32),
        "m": rng.randint(_INT_MIN, 2**31, n, dtype=np.int64).astype(np.int32),
        "k": np.arange(n, dtype=np.int64),
    }
    data["d"][:3] = [11016, -25509, 0][:n]
    data["x"][:5] = [np.nan, np.inf, -np.inf, 0.0, -0.0][:n]
    data["f"][:5] = [np.nan, 0.0, -0.0, np.inf, -np.inf][:n]
    mins = rng.rand(n) < 0.001
    mins[5:7] = True
    data["m"][mins], data["l"][mins], data["i"][mins] = _INT_MIN, _LONG_MIN, -1
    validity = {c: np.ones(n, np.bool_) for c in DATE_SCHEMA.names}
    validity["ts"] = rng.rand(n) >= 0.1
    for c in ("d", "i", "x", "l", "f", "m"):
        validity[c][rng.choice(n, n // 8, replace=False)] = False
    present = np.array([w is not None for w in DATE_POOL])
    validity["s"] = present[data["s"]]
    for c in DATE_SCHEMA.names:
        if c != "s":
            data[c] = np.where(validity[c], data[c],
                               np.zeros((), data[c].dtype))
    return data, validity


def date_batches(data: Dict[str, np.ndarray],
                 validity: Dict[str, np.ndarray], device,
                 batch_rows: int = 1 << 20) -> List[ColumnarBatch]:
    """``date_columns``' columns as device batches of ``batch_rows``."""
    out = []
    for o in range(0, len(data["k"]), batch_rows):
        cut = {c: (data[c][o:o + batch_rows], validity[c][o:o + batch_rows])
               for c in DATE_SCHEMA.names}
        cut["s"] = pool_strings(*cut["s"], DATE_POOL)
        out.append(batch_from_numpy(cut, DATE_SCHEMA, device))
    return out


DATE_DIM_SCHEMA = Schema.of(ts=T.TIMESTAMP, dv=T.LONG)


def date_dimension(data: Dict[str, np.ndarray],
                   validity: Dict[str, np.ndarray],
                   rows: int = DATE_DIM_ROWS, seed: int = 9
                   ) -> Dict[str, np.ndarray]:
    """A dimension of ``rows`` distinct timestamps, half drawn from the
    table's valid ``ts``, half from its range; ``dv`` a LONG payload."""
    rng = np.random.RandomState(seed)
    have = np.unique(data["ts"][validity["ts"]])
    take = have[rng.choice(len(have), min(rows // 2, len(have)),
                           replace=False)]
    other = rng.randint(-631152000, 3786912000, rows).astype(np.int64) \
        * 1_000_000 + 7
    ts = np.unique(np.concatenate([take, other]))[:rows]
    rng.shuffle(ts)
    return {"ts": ts, "dv": rng.randint(-10**6, 10**6, len(ts))}


def date_dimension_batch(dim: Dict[str, np.ndarray],
                         device) -> ColumnarBatch:
    return batch_from_numpy(dim, DATE_DIM_SCHEMA, device)


def _fns(E):
    """The DSL module ``E`` with the names of its arithmetic, conditional,
    datetime and hashing modules."""
    ns = {}
    for sub in ("arithmetic", "conditional", "datetime", "hashing"):
        ns.update(vars(importlib.import_module(f"{E.__name__}.{sub}")))
    ns.update(vars(E))
    return types.SimpleNamespace(**ns)


def dates_tz_shift(df, E=PE, T_=T):
    """D1: from_utc_timestamp and to_utc_timestamp in three zones."""
    F, c = _fns(E), E.col
    out = [c("k")]
    for j, tz in enumerate(DATE_ZONES):
        out += [F.from_utc_timestamp(c("ts"), tz).alias(f"local{j}"),
                F.to_utc_timestamp(c("ts"), tz).alias(f"utc{j}")]
    return df.select(*out)


def dates_session(df, E=PE, T_=T):
    """D2: year, month and hour of ts and ts as a DATE, in the session
    zone (the caller's session sets it)."""
    F, c = _fns(E), E.col
    return df.select(c("k"), F.Year(c("ts")).alias("y"),
                     F.Month(c("ts")).alias("mo"),
                     F.Hour(c("ts")).alias("h"),
                     F.Cast(c("ts"), T_.DATE).alias("day"))


def dates_local_hour(df, E=PE, T_=T):
    """D2: GROUP BY the session zone's hour with COUNT(*)."""
    F, c = _fns(E), E.col
    return df.select(F.Hour(c("ts")).alias("h")).group_by("h").agg(
        E.count().alias("n"))


def date_exprs(E=PE, T_=T) -> list:
    """D3: tests/test_math_datetime.py's DATE_EXPRS (:71-77), then the rest
    of the datetime module."""
    F, c = _fns(E), E.col
    d, ts, i = c("d"), c("ts"), c("i")
    return [
        F.Year(d), F.Month(d), F.DayOfMonth(d), F.DayOfWeek(d),
        F.DayOfYear(d), F.Quarter(d), F.Year(ts), F.Month(ts), F.Hour(ts),
        F.Minute(ts), F.Second(ts), F.DateAdd(d, i),
        F.DateSub(d, E.lit(30)), F.DateDiff(d, E.lit(0, T_.DATE)),
        F.AddMonths(d, i), F.LastDay(d),
        F.WeekOfYear(d),
        F.MakeDate(F.Year(d), F.Month(d) + 1, F.DayOfMonth(d)),
        F.TruncDate(d, "YEAR"), F.TruncDate(d, "QUARTER"),
        F.TruncDate(d, "MONTH"), F.TruncDate(d, "WEEK"),
        F.NextDay(d, "TUE"), F.MonthsBetween(d, F.DateAdd(d, i)),
        F.UnixSeconds(ts), F.UnixMillis(ts), F.UnixMicros(ts),
        F.SecondsToTimestamp(i), F.MillisToTimestamp(i),
        F.MicrosToTimestamp(F.UnixMicros(ts)), F.UnixDate(d),
        F.DateFromUnixDate(i)]


def dates_functions(df, E=PE, T_=T):
    """D3 in one select."""
    return df.select(E.col("k"), *[e.alias(f"r{j}") for j, e in
                                   enumerate(date_exprs(E, T_))])


def dates_hashes(df, E=PE, T_=T):
    """D4: xxhash64(i, l, x, s), hash(i, s), hive_hash(i, l, x, s, ts),
    xxhash64 of the FLOAT and of the TIMESTAMP column."""
    F, c = _fns(E), E.col
    return df.select(
        c("k"), F.XxHash64(c("i"), c("l"), c("x"), c("s")).alias("xx"),
        F.Murmur3Hash(c("i"), c("s")).alias("mm"),
        F.HiveHash(c("i"), c("l"), c("x"), c("s"), c("ts")).alias("hv"),
        F.XxHash64(c("f")).alias("xf"), F.XxHash64(c("ts")).alias("xt"))


def dates_group_ts(df, E=PE, T_=T):
    """D4: GROUP BY ts with COUNT(*)."""
    return df.group_by("ts").agg(E.count().alias("n"))


def dates_order_ts(df, E=PE, T_=T):
    """D4: ORDER BY ts, k (nulls first)."""
    return df.select(E.col("ts"), E.col("k")).order_by("ts", "k")


def dates_join_ts(df, dim, E=PE, T_=T):
    """D4: the equi-join on ts against ``date_dimension``, then COUNT(*)
    and the sums of dv and k."""
    return df.join(dim, "ts").agg(E.count().alias("n"),
                                  E.sum_("dv").alias("sdv"),
                                  E.sum_("k").alias("sk"))


def arith_exprs(E=PE, T_=T) -> list:
    """D5: %, unary minus, div (zero divisors, MIN div -1), abs, nullif,
    nvl2, greatest and least over INT, LONG and DOUBLE."""
    F, c = _fns(E), E.col
    i, m, l, x, k = c("i"), c("m"), c("l"), c("x"), c("k")
    return [
        F.Remainder(m, i), F.Remainder(l, i), F.Remainder(x, E.lit(7.5)),
        F.UnaryMinus(m), F.UnaryMinus(l), F.UnaryMinus(x),
        F.IntegralDivide(m, i), F.IntegralDivide(l, i),
        F.Abs(m), F.Abs(l), F.Abs(x),
        F.NullIf(i, E.lit(0)), F.NullIf(x, E.lit(0.0)), F.Nvl2(x, i, m),
        F.Greatest(i, m), F.Least(i, m), F.Greatest(l, k), F.Least(l, k),
        F.Greatest(x, E.lit(0.0)), F.Least(x, E.lit(1.5))]


def dates_arith(df, E=PE, T_=T):
    """D5 in one select."""
    return df.select(E.col("k"), *[e.alias(f"a{j}") for j, e in
                                   enumerate(arith_exprs(E, T_))])


#: D1-D5: an output row per input row (in the session zone: D2's), the
#: grouped ones, and the join (which also takes the dimension)
DATE_ROW_QUERIES = {f.__name__: f for f in (
    dates_tz_shift, dates_session, dates_functions, dates_hashes,
    dates_arith)}
DATE_AGG_QUERIES = {f.__name__: f for f in (
    dates_local_hour, dates_group_ts, dates_order_ts)}
DATE_QUERIES = {**DATE_ROW_QUERIES, **DATE_AGG_QUERIES,
                "dates_join_ts": dates_join_ts}
