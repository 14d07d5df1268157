"""The fused stage segment of the port on the CPU (plan/fused.py, the
program of expressions/program.py and the plain version of
kernels/fused.py), against the port's own per-op evaluation and the JAX
package.

* Each instruction: an expression lowered to a program and run by the
  plain interpreter equals its per-op ``Expression.eval`` bit for bit, and
  the JAX package's evaluation value for value, over numpy-seeded columns
  with 10% nulls, NaN, -0.0, int32 and int64 overflow and decimal scales
  0, 2 and 4.
* q6, q6 with a count and q1 through ``GpuSession(device="cpu")`` with
  ``spark.rapids.sql.tpu.fuseStages`` on and off, against the JAX
  package's ``TpuSession`` under its default fusion (50,000 lineitem rows
  in 3 partitions, the shape of tests/test_torch_q6.py): counts and keys
  exact, sums within 1e-12 relative, because the fused global sums add in
  another order than the per-op compaction and masked sum.
* Segments sit where the reference's ``fuse_segments`` puts them
  (tests/test_fused.py:53); a chain with a string comparison, or over the
  kernel's limits, breaks; an empty partition, an empty batch and an
  all-filtered batch give the identity partial (global) or no rows
  (grouped).
"""
import datetime

import numpy as np
import pytest
import torch

import spark_rapids_tpu.expressions as RE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.expressions.core import EvalContext as JaxContext
from spark_rapids_tpu.testing import tpch as jax_tpch

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import (arrow_to_batch,
                                                   batch_from_numpy)
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions import program as P
from spark_rapids_tpu_torch.expressions.core import EvalContext
from spark_rapids_tpu_torch.kernels import fused as FK
from spark_rapids_tpu_torch.plan.execs.basic import (GpuFilterExec,
                                                     GpuProjectExec)
from spark_rapids_tpu_torch.plan.fused import GpuFusedSegmentExec
from spark_rapids_tpu_torch.testing import tpch as port_tpch
from tests.test_torch_q6 import q6_shape

N = 4_001
N_ROWS = 50_000
BATCH_ROWS = N_ROWS // 4 + 1
F64_RTOL = 1e-12
FUSE = "spark.rapids.sql.tpu.fuseStages"


def _schema(T):
    return [("i", T.INT), ("j", T.INT), ("l", T.LONG), ("m", T.LONG),
            ("x", T.DOUBLE), ("y", T.DOUBLE), ("b", T.BOOLEAN),
            ("c", T.BOOLEAN), ("d0", T.DecimalType(10, 0)),
            ("d2", T.DecimalType(12, 2)), ("d4", T.DecimalType(14, 4)),
            ("dt", T.DATE)]


@pytest.fixture(scope="module")
def table():
    """Seeded columns, 10% nulls each; int32 and int64 values near their
    limits (sums and products overflow), NaN, -0.0 and 0.0 among the
    doubles, decimals whose rescaled compares tie."""
    rng = np.random.RandomState(6)
    i32 = np.iinfo(np.int32)
    i64 = np.iinfo(np.int64)

    def ints(lo, hi, edge, dtype):
        v = rng.randint(lo, hi, N).astype(dtype)
        pick = rng.rand(N) < 0.2
        v[pick] = rng.choice(np.array(edge, dtype=dtype), pick.sum())
        return v

    def doubles():
        v = np.round(rng.uniform(-4, 4, N), 1)
        special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e308])
        pick = rng.rand(N) < 0.25
        v[pick] = rng.choice(special, pick.sum())
        return v
    d2 = rng.randint(-500, 500, N).astype(np.int64)
    values = {
        "i": ints(-9, 9, [i32.max, i32.min, i32.max - 1, 46341], np.int32),
        "j": ints(-9, 9, [i32.max, 1, -1, 46341], np.int32),
        "l": ints(-9, 9, [i64.max, i64.min, 3037000500], np.int64),
        "m": ints(-9, 9, [i64.max, 2, -1, 3037000500], np.int64),
        "x": doubles(), "y": doubles(),
        "b": rng.rand(N) < 0.5, "c": rng.rand(N) < 0.5,
        "d0": rng.randint(-5, 5, N).astype(np.int64),
        "d2": d2,
        # half of d4 equals d2 at scale 4
        "d4": np.where(rng.rand(N) < 0.5, d2 * 100,
                       rng.randint(-50_000, 50_000, N)).astype(np.int64),
        "dt": rng.randint(8000, 8010, N).astype(np.int32),
    }
    schema = Schema(*zip(*_schema(PT)))
    batch = batch_from_numpy(
        {k: (v, rng.rand(N) >= 0.1) for k, v in values.items()}, schema,
        "cpu")
    return batch.to_arrow()


def _dec(E, T, p, s, v):
    return E.lit(v, T.DecimalType(p, s))


CASES = {
    # LOAD, CONST, and int32 / int64 arithmetic that wraps
    "add_int32_wraps": lambda E, T: E.col("i") + E.col("j"),
    "sub_int32_literal": lambda E, T: E.col("i") - E.lit(7),
    "mul_int32_wraps": lambda E, T: E.col("i") * E.col("j"),
    "mul_int64_wraps": lambda E, T: E.col("l") * E.col("m"),
    "add_int_to_long": lambda E, T: E.col("i") + E.col("l"),
    "sub_date": lambda E, T: E.col("dt") - E.col("dt"),
    # WIDEN and double arithmetic
    "add_int_to_double": lambda E, T: E.col("i") + E.col("x"),
    "mul_long_to_double": lambda E, T: E.col("l") * E.col("y"),
    "double_mul_add": lambda E, T: E.col("x") * E.col("y") + E.col("x"),
    "double_sub_literal": lambda E, T: E.lit(1.0) - E.col("x"),
    # CAST_DEC_F64 at scales 0, 2 and 4, and q1's expressions
    "cast_dec0": lambda E, T: E.Cast(E.col("d0"), T.DOUBLE),
    "cast_dec2": lambda E, T: E.Cast(E.col("d2"), T.DOUBLE),
    "cast_dec4": lambda E, T: E.Cast(E.col("d4"), T.DOUBLE),
    "q1_charge": lambda E, T: (E.Cast(E.col("d2"), T.DOUBLE)
                               * (E.lit(1.0) - E.Cast(E.col("d4"), T.DOUBLE))
                               * (E.lit(1.0) + E.Cast(E.col("d0"),
                                                      T.DOUBLE))),
    # comparisons: ints, longs, doubles (NaN, -0.0), dates, bools, and
    # decimals through RESCALE
    "lt_int": lambda E, T: E.col("i") < E.col("j"),
    "le_int_long": lambda E, T: E.col("i") <= E.col("l"),
    "gt_double": lambda E, T: E.GreaterThan(E.col("x"), E.col("y")),
    "ge_double": lambda E, T: E.col("x") >= E.col("y"),
    "eq_double": lambda E, T: E.col("x") == E.col("y"),
    "lt_int_double": lambda E, T: E.col("i") < E.col("x"),
    "eq_date_literal": lambda E, T: E.col("dt") == E.lit(8004, T.DATE),
    "lt_bool": lambda E, T: E.col("b") < E.col("c"),
    "lt_dec2_dec4": lambda E, T: E.col("d2") < E.col("d4"),
    "eq_dec2_dec4": lambda E, T: E.col("d2") == E.col("d4"),
    "ge_dec0_literal": lambda E, T: E.col("d0") >= _dec(E, T, 12, 2, 150),
    # AND (three-valued), IS_NULL, IF
    "and_bools": lambda E, T: E.col("b") & E.col("c"),
    "and_compares": lambda E, T: (E.col("i") < E.col("j"))
    & (E.col("x") > E.col("y")),
    "is_null_double": lambda E, T: E.IsNull(E.col("x")),
    "if_ints": lambda E, T: E.If(E.col("b"), E.col("i"), E.col("j")),
    "if_widens_false_branch": lambda E, T: E.If(E.col("i") < E.col("j"),
                                                E.col("x"), E.col("l")),
    "if_is_null": lambda E, T: E.If(E.IsNull(E.col("x")), E.lit(1),
                                    E.lit(0)),
}


def _lower_one(e, batch):
    """One expression as a program's only output, run by the plain
    interpreter: (data, validity)."""
    b = P.ProgramBuilder(batch.schema.dtypes)
    cols = [P.Column(dt, ordinal=i)
            for i, dt in enumerate(batch.schema.dtypes)]
    prog = b.finish(None, [b.value(e, cols)], [])
    outs, idx, count = FK.fused_compact(prog, prog.words(), batch.columns,
                                        batch.num_rows, need_map=False)
    assert idx is None and count == batch.num_rows
    return outs[0]


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.parametrize("case", list(CASES))
def test_instruction_matches_eval_and_reference(table, case):
    pb = arrow_to_batch(table, "cpu")
    e = CASES[case](PE, PT).bind(pb.schema)
    assert P.lowerable(e, pb.schema.dtypes, value=True)
    data, valid = _lower_one(e, pb)
    want = e.eval(EvalContext(pb))
    assert data.dtype == want.data.dtype
    assert torch.equal(valid, want.validity)
    assert torch.equal(_bits(data), _bits(want.data))   # nulls hold 0 too
    assert valid.any()
    jb = JaxBatch.from_arrow(table)
    ref = CASES[case](RE, JT).bind(jb.schema).eval(JaxContext(jb))
    rvals, rvalid = ref.to_numpy(N)
    assert np.array_equal(valid.numpy(), rvalid)
    got = data.numpy()[rvalid]
    exp = np.asarray(rvals)[rvalid].astype(got.dtype)
    if got.dtype == np.float64:
        assert np.array_equal(got, exp, equal_nan=True)
    else:
        assert np.array_equal(got, exp)


@pytest.mark.parametrize("case", ["lt_dec2_dec4", "and_compares",
                                  "if_is_null"])
def test_filter_program_keeps_what_the_filter_keeps(table, case):
    """A predicate as the program's filter: the kept rows and their
    computed outputs are the per-op filter's, in row order."""
    pb = arrow_to_batch(table, "cpu")
    pred = CASES[case](PE, PT).bind(pb.schema)
    if pred.dtype != PT.BOOLEAN:
        pred = PE.EqualTo(pred, PE.lit(1))
    out = (PE.col("x") * PE.col("y")).bind(pb.schema)
    b = P.ProgramBuilder(pb.schema.dtypes)
    cols = [P.Column(dt, ordinal=i) for i, dt in enumerate(pb.schema.dtypes)]
    prog = b.finish(b.value(pred, cols), [b.value(out, cols)], [])
    assert prog.n_pred <= len(prog.code)
    outs, idx, count = FK.fused_compact(prog, prog.words(), pb.columns, N,
                                        need_map=True)
    p = pred.eval(EvalContext(pb))
    want_idx = torch.nonzero(p.data & p.validity).flatten()
    assert count == want_idx.numel() > 0
    assert torch.equal(idx.long(), want_idx)
    o = out.eval(EvalContext(pb))
    assert torch.equal(_bits(outs[0][0]), _bits(o.data[want_idx]))
    assert torch.equal(outs[0][1], o.validity[want_idx])


def test_unlowerable_expressions_break_the_chain():
    dtypes = [PT.STRING, PT.INT, PT.LONG, PT.DecimalType(12, 2)]
    s, i, l, d = (PE.BoundReference(k, dt, n) for k, (dt, n) in
                  enumerate(zip(dtypes, "sild")))
    assert P.lowerable(s, dtypes)                       # passes through
    assert not P.lowerable(s, dtypes, value=True)
    assert not P.lowerable(PE.EqualTo(s, PE.lit("D")), dtypes)
    assert not P.lowerable(PE.IsNull(s), dtypes)
    assert not P.lowerable(d + d, dtypes)               # decimal arithmetic
    assert not P.lowerable(PE.If(PE.IsNull(i), i, l), dtypes)   # narrowing
    assert P.lowerable(PE.If(PE.IsNull(i), l, i), dtypes)


def test_program_keeps_only_what_its_results_read(table):
    """Dead values go, with their loads and literals; the filter's
    instructions come first; registers are reused after a last read."""
    pb = arrow_to_batch(table, "cpu")
    b = P.ProgramBuilder(pb.schema.dtypes)
    cols = [P.Column(dt, ordinal=i) for i, dt in enumerate(pb.schema.dtypes)]

    def value(e):
        return b.value(e.bind(pb.schema), cols)
    value(PE.col("x") * PE.lit(3.5))                       # dead
    out = value((PE.col("i") + PE.lit(2)) * (PE.col("j") + PE.lit(2)))
    keep = value(PE.col("l") < PE.lit(4))
    prog = b.finish(keep, [out], [])
    names = pb.schema.names
    assert [names[o] for o in prog.loads] == ["l", "i", "j"]
    assert sorted(prog.literals) == [2, 4]
    assert prog.n_pred == 3 and prog.code[2][0] == P.LT
    assert prog.n_regs == 4 and len(prog.code) == 9   # 2 is shared


def test_wrapper_takes_the_plain_version_only_on_the_cpu(table):
    """A program given tensors that are not on the CPU goes to the kernel
    and raises there: it never falls back to the plain version."""
    pb = arrow_to_batch(table, "cpu")
    e = CASES["q1_charge"](PE, PT).bind(pb.schema)
    b = P.ProgramBuilder(pb.schema.dtypes)
    cols = [P.Column(dt, ordinal=i) for i, dt in enumerate(pb.schema.dtypes)]
    prog = b.finish(None, [b.value(e, cols)], [])
    meta = prog.words().to("meta")
    with pytest.raises(ValueError, match="expected cuda"):
        FK.fused_compact(prog, meta, pb.columns, N, need_map=False)
    with pytest.raises(ValueError, match="expected cuda"):
        FK.fused_global(prog, meta, pb.columns, N)

# ---------------------------------------------------------------------------
# q6 and q1 end to end


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _q6_count(m, df):
    E, T = (RE, JT) if m is jax_tpch else (PE, PT)
    return q6_shape(df, E, T, with_count=True)


QUERIES = {"q6": lambda m, df: m.q6(df), "q6_count": _q6_count,
           "q1": lambda m, df: m.q1(df)}


@pytest.fixture(scope="module")
def lineitem():
    """The reference's lineitem batches as Arrow tables."""
    return [b.to_arrow() for b in jax_tpch.gen_lineitem(
        N_ROWS, batch_rows=BATCH_ROWS)]


@pytest.fixture(scope="module")
def reference_rows(lineitem):
    """query -> its rows from the JAX package's TpuSession under its
    default fusion, sorted by the first column; each run once a module."""
    cache = {}

    def rows(query):
        if query not in cache:
            jdf = TpuSession().create_dataframe(
                [JaxBatch.from_arrow(t) for t in lineitem], num_partitions=3)
            cache[query] = _by_first(QUERIES[query](jax_tpch, jdf).collect())
        return cache[query]
    return rows


def _by_first(rows):
    return sorted(rows, key=lambda r: (r[0] is not None, r[0]))


def _port_df(tables, fuse="true", num_partitions=3):
    sess = GpuSession({FUSE: fuse}, device="cpu")
    return sess.create_dataframe([arrow_to_batch(t, "cpu") for t in tables],
                                 num_partitions=num_partitions)


def _assert_rows_close(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for gv, rv in zip(g, r):
            if rv is None or isinstance(rv, (int, np.integer)):
                assert gv == rv
            else:
                assert gv == pytest.approx(rv, rel=F64_RTOL)


@pytest.mark.parametrize("fuse", ["true", "false"])
@pytest.mark.parametrize("query", list(QUERIES))
def test_query_matches_reference(lineitem, reference_rows, query, fuse):
    df = QUERIES[query](port_tpch, _port_df(lineitem, fuse))
    assert ("GpuFusedSegment" in df.explain()) == (fuse == "true")
    got = _by_first(df.collect())
    _assert_rows_close(got, reference_rows(query))
    if query == "q1":
        assert [r[0] for r in got] == list(range(1, 8))


def _segments(tree: str, prefix: str):
    """Each fused segment of a tree string and the execs of its chain."""
    out = []
    for line in tree.splitlines():
        s = line.strip()
        if s.startswith(prefix + "FusedSegment["):
            out.append([])
        elif s.startswith("* ") and out:
            out[-1].append(s[2:].split("[")[0].replace(prefix, ""))
    return out


@pytest.mark.parametrize("query", ["q6", "q1"])
def test_segments_placed_as_the_reference_places_them(lineitem, query):
    tables = lineitem
    jdf = TpuSession().create_dataframe(
        [JaxBatch.from_arrow(t) for t in tables], num_partitions=3)
    ref = _segments(QUERIES[query](jax_tpch, jdf).physical_plan()
                    .tree_string(), "Tpu")
    got = _segments(QUERIES[query](port_tpch, _port_df(tables)).explain(),
                    "Gpu")
    assert got == ref == [["HashAggregate", "Filter", "Project"]]


def test_string_comparison_stays_per_op():
    """q72's cd_marital_status = 'D' has no instruction: the filter runs
    op by op, and the partial aggregate above it is a segment alone (it
    sits under the exchange)."""
    n = 3_000
    rng = np.random.RandomState(72)
    schema = Schema(("cd_dep_count", "cd_marital_status"),
                    (PT.INT, PT.STRING))
    statuses = ["D", "M", "S", "W", "U"]
    data = {"cd_dep_count": rng.randint(0, 5, n).astype(np.int32),
            "cd_marital_status": [statuses[k]
                                  for k in rng.randint(0, 5, n)]}
    rows = {}
    for fuse in ("true", "false"):
        df = GpuSession({FUSE: fuse, "spark.rapids.sql.batchSizeRows":
                         "1000"}, device="cpu").create_dataframe(
            batch_from_numpy(data, schema, "cpu").to_arrow(),
            num_partitions=3)
        q = (df.filter((PE.col("cd_marital_status") == PE.lit("D"))
                       & (PE.col("cd_dep_count") > 0))
             .group_by("cd_dep_count").agg(PE.count().alias("n")))
        plan = q.physical_plan()
        rows[fuse] = sorted(q.collect())
        if fuse == "true":
            seg = plan.children[0].children[0].children[0]
            assert isinstance(seg, GpuFusedSegmentExec)
            assert [type(c).__name__ for c in seg.chain] == [
                "GpuHashAggregateExec"]
            assert isinstance(seg.children[0], GpuFilterExec)
    dep = data["cd_dep_count"]
    keep = (np.array(data["cd_marital_status"]) == "D") & (dep > 0)
    want = sorted((int(k), int(c)) for k, c in zip(
        *np.unique(dep[keep], return_counts=True)))
    assert rows["true"] == rows["false"] == want


def test_chain_over_the_kernel_limits_breaks(lineitem):
    """33 computed columns over a filter: the two-op program has more
    outputs than the kernel takes, so the projection runs op by op (the
    filter below it still fuses with the pruning projection), with the
    per-op rows."""
    price = PE.Cast(PE.col("l_extendedprice"), PT.DOUBLE)
    cols = [(price * PE.lit(float(k))).alias(f"p{k}")
            for k in range(P.MAX_OUTPUTS + 1)]

    def q(fuse):
        return (_port_df(lineitem[:1], fuse, 1)
                .filter(PE.col("l_quantity") < PE.lit(
                    2400, PT.DecimalType(12, 2)))
                .select(*cols))
    plan = q("true").physical_plan()
    assert isinstance(plan, GpuProjectExec)
    assert isinstance(plan.children[0], GpuFusedSegmentExec)
    assert [type(n) for n in plan.children[0].chain] == [GpuFilterExec,
                                                         GpuProjectExec]
    assert q("true").collect() == q("false").collect()


@pytest.mark.parametrize("shape", ["empty_partitions", "all_filtered"])
def test_identity_partial_for_no_rows(lineitem, shape):
    """A global segment over an empty partition, an empty batch or an
    all-filtered batch gives the identity partial (counts 0, sums null);
    a grouped one gives no rows."""
    if shape == "empty_partitions":   # 4 batches in 6 partitions
        tables, parts, lo, hi = lineitem, 6, (1994, 1, 1), (1995, 1, 1)
    else:
        tables, parts, lo, hi = (lineitem + [lineitem[0].slice(0, 0)], 3,
                                 (2030, 1, 1), (2031, 1, 1))
    dec = PT.DecimalType(12, 2)
    price = PE.Cast(PE.col("l_extendedprice"), PT.DOUBLE)

    def filtered(fuse):
        return _port_df(tables, fuse, parts).filter(
            (PE.col("l_shipdate") >= PE.lit(_days(*lo), PT.DATE))
            & (PE.col("l_shipdate") < PE.lit(_days(*hi), PT.DATE))
            & (PE.col("l_discount") >= PE.lit(5, dec)))

    def query(fuse):
        return filtered(fuse).agg(
            PE.sum_(price).alias("s"), PE.count().alias("n"),
            PE.count("l_tax").alias("nt"), PE.avg(price).alias("a"))
    seg = query("true").physical_plan().children[0].children[0]
    assert isinstance(seg, GpuFusedSegmentExec) and seg.segment.is_global
    partials = [b for p in range(seg.num_partitions())
                for b in seg.execute_partition(p)]
    assert len(partials) >= parts
    empty = [b for b in partials if int(b.columns[2].data[0]) == 0]
    assert len(empty) >= (2 if shape == "empty_partitions"
                          else len(partials))
    for b in empty:
        assert b.num_rows == 1
        for c, dt in zip(b.columns, b.schema.dtypes):
            # a count is 0 and valid, a sum null
            assert c.to_pylist() == ([0] if dt == PT.LONG else [None])
    got = query("true").collect()
    _assert_rows_close(got, query("false").collect())
    if shape == "all_filtered":
        assert got == [(None, 0, 0, None)]
        grouped = filtered("true").group_by("l_linenumber").agg(
            PE.count().alias("n"))
        assert "GpuFusedSegment" in grouped.explain()
        assert grouped.collect() == []
