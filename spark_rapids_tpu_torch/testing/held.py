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
over millions of Python strings.
"""
from __future__ import annotations

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
    width = max(len(t) for t in _TAIL_BYTES)
    table = np.zeros((TAIL_CODES, width), np.uint8)
    lengths = np.zeros(TAIL_CODES, np.int64)
    for i, t in enumerate(_TAIL_BYTES):
        table[i, :len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    row_len = np.where(valid, lengths[codes], 0)
    offsets = np.zeros(len(codes) + 1, np.int64)
    np.cumsum(row_len, out=offsets[1:])
    keep = np.arange(width) < row_len[:, None]
    return offsets.astype(np.int32), table[codes][keep], valid


def tail_batches(data: Dict[str, np.ndarray],
                 validity: Dict[str, np.ndarray], device,
                 batch_rows: int = 1 << 20) -> List[ColumnarBatch]:
    """``tail_columns``' columns as device batches of ``batch_rows``."""
    n = len(data["k"])
    out = []
    for o in range(0, n, batch_rows):
        cut = {c: (data[c][o:o + batch_rows], validity[c][o:o + batch_rows])
               for c in TAIL_SCHEMA.names}
        cut["s"] = tail_strings(*cut["s"])
        out.append(batch_from_numpy(cut, TAIL_SCHEMA, device))
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
