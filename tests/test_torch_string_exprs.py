"""The port's string expressions, and IF / CASE WHEN over strings, through
GpuSession on the CPU against the JAX package on the same tables.

The cases: every expression of tests/test_strings.py (``EXPRS`` :53-73,
its filter pipeline :99-104) over ``strings_df`` (120 rows in batches of
40, 2 partitions; ``held.string_columns(120)`` draws it row for row),
every function of tests/test_string_functions.py (:37-72) over its
table, the other string functions the port exports (LEFT, RIGHT,
OCTET_LENGTH, BIT_LENGTH, TRANSLATE, EMPTY2NULL, variadic CONCAT), and
the held string queries S1-S5 of ``testing/held.py`` at 420 rows.  Where
the JAX package's own tests hold its device path to its CPU oracle
(``spark.rapids.sql.enabled=false``), the port is held to the oracle,
which answers in well under a second.  The string IF and CASE WHEN have
no such test there: the port is held to the reference's device path,
its expressions evaluated eagerly over a batch (``select_strings``), and
the grouped S5 also to the oracle.  Where the device path and the oracle
differ (UPPER / LOWER beyond Latin-1: the device keeps those scripts, the
oracle maps them), the port gives the device path's rows, pinned here.
Exact throughout.

The planner: a pattern outside the dialect (tests/test_torch_regex.py),
a non-literal STARTSWITH / ENDSWITH / CONTAINS pattern, a non-ASCII pad,
CONCAT_WS over a non-string and an input outside a signature raise
NotImplementedError with the reference's reason; TRANSLATE with
non-ASCII arguments raises where it is built.  A string IF, a CASE WHEN
and every string function have no program form, so a chain with one
runs op by op; a filter on CONTAINS over a scan still plans and runs.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu.expressions as JE
import spark_rapids_tpu.expressions.strings as JES
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.batch import Schema as JaxSchema
from spark_rapids_tpu.expressions.core import EvalContext as JaxContext
from tests.test_queries import _normalize
from tests.test_strings import strings_df

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions import program as P
from spark_rapids_tpu_torch.expressions.core import EvalContext
from spark_rapids_tpu_torch.testing import held

ORACLE = {"spark.rapids.sql.enabled": "false"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(n=120, batch_rows=40):
    """The held string table as Arrow batches (what both packages
    upload)."""
    data, validity = held.string_columns(n)
    return [b.to_arrow() for b in held.string_batches(data, validity, "cpu",
                                                      batch_rows)]


TABLES = _tables()


def _jax_df(sess, tables, parts):
    return sess.create_dataframe([JaxBatch.from_arrow(t) for t in tables],
                                 num_partitions=parts)


def _port_df(tables, parts):
    return GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in tables], num_partitions=parts)


def _check(build, tables=TABLES, parts=2, ordered=True):
    """build(df, E) in both packages: the oracle's rows, then the port's."""
    want = build(_jax_df(TpuSession(ORACLE), tables, parts), JE).collect()
    got = build(_port_df(tables, parts), PE).collect()
    if not ordered:
        got, want = _normalize(got), _normalize(want)
    assert len(got) == len(want) > 0
    assert got == want
    return got


def test_string_columns_are_strings_df():
    rows = strings_df(TpuSession(ORACLE)).collect()
    mine = [r[:3] for t in TABLES for r in ColumnarBatch.from_arrow(
        t, "cpu").rows()]
    assert _normalize(mine) == _normalize(rows)


@pytest.mark.parametrize("k", range(19), ids=lambda k: f"r{k}")
def test_string_exprs(k):
    """tests/test_strings.py test_string_exprs, each of EXPRS."""
    _check(lambda df, E: df.select(E.col("s"), E.col("t"), E.col("n"),
                                   held.string_exprs(E)[k]))


def test_string_filter_pipeline():
    def build(df, E):
        s = E.col("s")
        return df.filter(E.Not(E.IsNull(s)) & E.Contains(s, E.lit("e"))
                         ).select(s, E.Length(s).alias("len"),
                                  E.Upper(E.Substring(s, E.lit(1), E.lit(4))
                                          ).alias("pre"))
    _check(build)


def test_general_like_over_strings_df():
    _check(lambda df, E: df.select(E.col("s"),
                                   E.Like(E.col("s"), "a_b%c").alias("r")))


# tests/test_string_functions.py's table: VALS, and t
VALS = held.STRING_VALS


def _fn_table():
    t = [("T" + (v or "")) if i % 3 else None for i, v in enumerate(VALS)]
    return {"s": list(VALS), "t": t}


def _fn_check(build):
    data = _fn_table()
    jb = JaxBatch.from_pydict(data, JaxSchema.of(s=JT.STRING, t=JT.STRING))
    want = build(TpuSession(ORACLE).create_dataframe([jb], num_partitions=1),
                 JE).collect()
    pb = ColumnarBatch.from_pydict(data, Schema.of(s=T.STRING, t=T.STRING),
                                   "cpu")
    got = build(GpuSession(device="cpu").create_dataframe(
        [pb], num_partitions=1), PE).collect()
    assert got == want and len(got) == len(VALS)


FUNCTIONS = [
    lambda E: E.LTrim(E.col("s")), lambda E: E.RTrim(E.col("s")),
    lambda E: E.Reverse(E.col("s")), lambda E: E.InitCap(E.col("s")),
    lambda E: E.Ascii(E.col("s")),
    lambda E: E.StringReplace(E.col("s"), "a", "XY"),
    lambda E: E.StringReplace(E.col("s"), "ab", ""),
    lambda E: E.StringReplace(E.col("s"), ".", "--"),
    lambda E: E.StringReplace(E.col("s"), "aa", "b"),
    lambda E: E.StringInstr(E.col("s"), "b"),
    lambda E: E.StringInstr(E.col("s"), "zzz"),
    lambda E: E.StringInstr(E.col("s"), ""),
    lambda E: E.StringLocate("a", E.col("s"), 3),
    lambda E: E.StringLocate("a", E.col("s"), 0),
    lambda E: E.StringRepeat(E.col("s"), 3),
    lambda E: E.StringRepeat(E.col("s"), 0),
    lambda E: E.Lpad(E.col("s"), 8, "*"), lambda E: E.Lpad(E.col("s"), 3, "xy"),
    lambda E: E.Rpad(E.col("s"), 8, "*"), lambda E: E.Rpad(E.col("s"), 0, "z"),
]
FN_IDS = ["ltrim", "rtrim", "reverse", "initcap", "ascii", "replace",
          "replace-del", "replace-dot", "replace-aa", "instr", "instr-miss",
          "instr-empty", "locate3", "locate0", "repeat3", "repeat0", "lpad",
          "lpad-trunc", "rpad", "rpad0"]


@pytest.mark.parametrize("make", FUNCTIONS, ids=FN_IDS)
def test_string_fn(make):
    _fn_check(lambda df, E: df.select(E.col("s"), make(E).alias("r")))


def test_concat_ws():
    _fn_check(lambda df, E: df.select(
        E.col("s"), E.col("t"),
        E.ConcatWs("-", E.col("s"), E.col("t")).alias("r"),
        E.ConcatWs("", E.col("s"), E.col("t"), E.col("s")).alias("r2")))


def _s(E):
    """The module with each package's string classes (the JAX package's
    top level leaves some out)."""
    return JES if E is JE else E


OTHERS = {
    "left": lambda E: _s(E).Left(E.col("s"), 3),
    "left0": lambda E: _s(E).Left(E.col("s"), -1),
    "right": lambda E: _s(E).Right(E.col("s"), 2),
    "right0": lambda E: _s(E).Right(E.col("s"), 0),
    "octet_length": lambda E: _s(E).OctetLength(E.col("s")),
    "bit_length": lambda E: _s(E).BitLength(E.col("s")),
    "translate": lambda E: _s(E).Translate(E.col("s"), "a. ", "A_"),
    "translate_map": lambda E: _s(E).Translate(E.col("s"), "ae", "AE"),
    "empty2null": lambda E: _s(E).Empty2Null(E.col("s")),
    "concat": lambda E: _s(E).Concat(E.col("s"), E.lit("|"), E.col("t")),
    "concat_one": lambda E: _s(E).Concat(E.col("t")),
    "length": lambda E: E.Length(E.col("s")),
    "trim": lambda E: E.Trim(E.col("s")),
    "contains_null_pattern": lambda E: E.Contains(
        E.col("s"), E.lit(None, JT.STRING if E is JE else T.STRING)),
}


@pytest.mark.parametrize("name", OTHERS)
def test_other_functions(name):
    _fn_check(lambda df, E: df.select(E.col("s"), OTHERS[name](E).alias("r")))


@pytest.mark.parametrize("name", list(held.STRING_QUERIES))
def test_held_string_queries(name):
    """S1-S5 at 420 rows (ten times each pool's period) in 3 partitions."""
    tables = _tables(420, 100)
    _check(held.STRING_QUERIES[name], tables, parts=3,
           ordered=name in held.STRING_ROW_QUERIES)


# -- IF and CASE WHEN over strings: the reference's device path -----------------

def _cond_exprs(E):
    n, s, t = E.col("n"), E.col("s"), E.col("t")
    return [E.If(n > 5, s, t),
            E.If(E.IsNull(s), E.lit("null s"), s),
            E.CaseWhen([(n < 0, s), (n < 5, t)], E.lit("z")),
            E.CaseWhen([(n < 0, s), (n > 9, E.Upper(t))]),
            E.CaseWhen([(n < 3, t)], s)]


def _values(col, n):
    if isinstance(col, DeviceColumn):
        return col.to_pylist()
    off = np.asarray(col.offsets)
    data = np.asarray(col.data).tobytes()
    valid = np.asarray(col.validity)
    return [data[off[i]:off[i + 1]].decode() if valid[i] else None
            for i in range(n)]


@pytest.mark.parametrize("k", range(5))
def test_string_conditionals_against_the_device_path(k):
    """Each expression evaluated over one batch by the reference's
    device-path ``eval`` (eagerly) and by the port's."""
    data, validity = held.string_columns(120)
    pb = held.string_batches(data, validity, "cpu")[0]
    jb = JaxBatch.from_arrow(pb.to_arrow())
    je = _cond_exprs(JE)[k].bind(jb.schema)
    pe = _cond_exprs(PE)[k].bind(pb.schema)
    want = _values(je.eval(JaxContext(jb)), 120)
    got = _values(pe.eval(EvalContext(pb)), 120)
    assert got == want
    assert any(v is not None for v in got)


@pytest.mark.parametrize("k", range(5))
def test_string_conditionals_grouped(k):
    _check(lambda df, E: df.select(_cond_exprs(E)[k].alias("v")).group_by(
        "v").agg(E.count().alias("c")), ordered=False)


def test_fixed_width_case_when():
    n = lambda E: E.col("n")  # noqa: E731
    _check(lambda df, E: df.select(
        E.CaseWhen([(n(E) < 0, n(E)), (n(E) < 5, E.lit(100))],
                   E.lit(-1)).alias("a"),
        E.CaseWhen([(n(E) > 8, n(E) * 2)]).alias("b")))


# -- where the device path and the oracle differ --------------------------------

def test_case_maps_beyond_latin1_keep_the_device_rows():
    """UPPER / LOWER map ASCII and Latin-1 only (the reference's device
    rule): Greek and Cyrillic, and U+00FF, pass through, where the oracle
    (Python's str.upper) maps them.  The port gives the device rows."""
    vals = ["ααβ", "Ωmega", "привет", "ÿes", "Über", None]
    pb = ColumnarBatch.from_pydict({"s": vals}, Schema.of(s=T.STRING), "cpu")
    df = GpuSession(device="cpu").create_dataframe([pb])
    got = df.select(PE.Upper(PE.col("s")).alias("u"),
                    PE.Lower(PE.col("s")).alias("l")).collect()
    assert got == [("ααβ", "ααβ"), ("ΩMEGA", "Ωmega"), ("привет", "привет"),
                   ("ÿES", "ÿes"), ("ÜBER", "über"), (None, None)]
    jb = JaxBatch.from_pydict({"s": vals}, JaxSchema.of(s=JT.STRING))
    oracle = TpuSession(ORACLE).create_dataframe([jb]).select(
        JE.Upper(JE.col("s")).alias("u")).collect()
    assert oracle[0] == ("ΑΑΒ",) and got[0][0] == "ααβ"
    jcol = JE.Upper(JE.col("s")).bind(jb.schema).eval(JaxContext(jb))
    assert _values(jcol, len(vals)) == [u for u, _ in got]


def test_case_map_across_a_row_ending_in_0xc3():
    """The byte before a row's first byte is the buffer's: a row after one
    that ends in 0xC3 maps its first byte as Latin-1, in the port as in
    the reference's device path."""
    raw = [b"x\xc3", b"\xa9b", b"\xc3", b"\x89z"]
    col = DeviceColumn.from_strings(raw)
    pb = ColumnarBatch((col,), 4, Schema.of(s=T.STRING))
    got = PE.Upper(PE.col("s")).bind(pb.schema).eval(EvalContext(pb))
    off, data, _ = got.string_buffers()
    rows = [data[off[i]:off[i + 1]].tobytes() for i in range(4)]
    assert rows == [b"X\xc3", b"\x89B", b"\xc3", b"\x89Z"]
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar.column import DeviceColumn as JaxColumn
    offs = np.cumsum([0] + [len(r) for r in raw]).astype(np.int32)
    jcol = JaxColumn(jnp.asarray(np.frombuffer(b"".join(raw), np.uint8)),
                     jnp.ones(4, bool), JT.STRING, jnp.asarray(offs))
    jb = JaxBatch((jcol,), 4, JaxSchema.of(s=JT.STRING))
    want = JE.Upper(JE.col("s")).bind(jb.schema).eval(JaxContext(jb))
    wd = np.asarray(want.data).tobytes()
    assert rows == [wd[offs[i]:offs[i + 1]] for i in range(4)]


# -- the planner and the program ------------------------------------------------

def _df():
    return _port_df(TABLES, 2)


@pytest.mark.parametrize("build,reason", [
    (lambda df: df.select(PE.Contains(PE.col("s"), PE.col("t"))),
     "non-literal match patterns"),
    (lambda df: df.select(PE.StartsWith(PE.col("s"), PE.col("t"))),
     "non-literal match patterns"),
    (lambda df: df.select(PE.Lpad(PE.col("s"), 5, "é")), "non-ASCII pad"),
    (lambda df: df.select(PE.Rpad(PE.col("s"), 5, "€")), "non-ASCII pad"),
    (lambda df: df.select(PE.ConcatWs("-", PE.col("s"), PE.col("n"))),
     "concat_ws over non-string"),
    (lambda df: df.select(PE.Length(PE.col("n"))),
     "outside the supported signature"),
    (lambda df: df.select(PE.Upper(PE.col("n"))),
     "outside the supported signature"),
    (lambda df: df.filter(PE.RLike(PE.col("n"), "a")),
     "outside the supported signature"),
], ids=["contains", "startswith", "lpad", "rpad", "concat_ws", "length",
        "upper", "rlike"])
def test_planner_raises_with_the_reference_reason(build, reason):
    with pytest.raises(NotImplementedError, match=reason):
        build(_df()).collect()


def test_translate_non_ascii_raises_where_built():
    with pytest.raises(NotImplementedError, match="non-ASCII translate"):
        PE.Translate(PE.col("s"), "é", "e")


def test_no_xla_bucket_bounds():
    """The reference's repeat bound (64) and pad bound (65,536) are its
    buckets': the port runs past both."""
    rows = _df().select(PE.StringRepeat(PE.col("s"), 65).alias("r"),
                        PE.Rpad(PE.col("s"), 70_000, "-").alias("p")
                        ).collect()
    assert rows[0] == ("apple" * 65, "apple" + "-" * 69_995)


def test_filter_contains_plans_and_runs_op_by_op():
    df = _df().filter(PE.Contains(PE.col("s"), PE.lit("e")) & (PE.col("n") > 2))
    plan = df.explain()
    assert "GpuFilter" in plan and "CONTAINS" in plan, plan
    want = _check(lambda d, E: d.filter(E.Contains(E.col("s"), E.lit("e"))
                                        & (E.col("n") > 2)))
    assert df.collect() == want


@pytest.mark.parametrize("e", [
    PE.If(PE.col("n") > 1, PE.col("s"), PE.col("t")),
    PE.CaseWhen([(PE.col("n") > 1, PE.col("s"))], PE.lit("z")),
    PE.CaseWhen([(PE.col("n") > 1, PE.col("n"))], PE.lit(0)),
    PE.Contains(PE.col("s"), PE.lit("a")), PE.Length(PE.col("s")),
    PE.Upper(PE.col("s")), PE.Like(PE.col("s"), "a%"),
    PE.RLike(PE.col("s"), "a+"), PE.ConcatWs(",", PE.col("s")),
], ids=repr)
def test_string_and_conditional_expressions_do_not_lower(e):
    schema = held.STRING_SCHEMA
    bound = e.bind(schema)
    assert not P.lowerable(bound, schema.dtypes, value=True)
    assert not P.lowerable(bound, schema.dtypes)
