"""The q72 slice's expressions against the JAX package's, on the CPU:
``GreaterThan`` (ints, doubles with NaN, dates, strings), ``IsNull``,
``If`` (a null predicate, null branches, int and double results, a false
branch cast to the true branch's type), and string comparisons against a
string literal, on the same columns.  Each result is compared value for
value and null for null.
"""
import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.expressions as RE
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.expressions.core import EvalContext as JaxContext

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.expressions.core import EvalContext

N = 97
STRINGS = ["D", "", "ab", "ab\x00", "Dz", "C", ">10000", "é", "\xff", "d"]


@pytest.fixture(scope="module")
def table():
    rng = np.random.RandomState(72)

    def masked(v, frac=0.15):
        return pa.array(v, mask=rng.rand(N) < frac)
    dbl = rng.uniform(-3, 3, N).round(1)
    dbl[rng.rand(N) < 0.1] = np.nan
    dbl[rng.rand(N) < 0.1] = -0.0
    return pa.table({
        "a": masked(rng.randint(-5, 6, N).astype(np.int32)),
        "b": masked(rng.randint(-5, 6, N).astype(np.int32)),
        "x": masked(dbl),
        "y": masked(rng.uniform(-3, 3, N).round(1)),
        "l": masked(rng.randint(-5, 6, N).astype(np.int64)),
        "s": pa.array([STRINGS[i] for i in rng.randint(0, len(STRINGS), N)],
                      mask=rng.rand(N) < 0.15),
        "t": pa.array([STRINGS[i] for i in rng.randint(0, len(STRINGS), N)]),
    })


def _both(table, build):
    """(port values, reference values) of one expression, None for null."""
    pb = arrow_to_batch(table, "cpu")
    got = build(PE).bind(pb.schema).eval(EvalContext(pb)).to_pylist()
    jb = JaxBatch.from_arrow(table)
    ref = build(RE).bind(jb.schema).eval(JaxContext(jb))
    vals, valid = ref.to_numpy(table.num_rows)
    want = [v if ok else None for v, ok in zip(vals.tolist(), valid)]
    return got, want


CASES = {
    "int_gt_int": lambda E: E.GreaterThan(E.col("a"), E.col("b")),
    "int_gt_literal": lambda E: E.col("a") > E.lit(1),
    "double_gt_nan": lambda E: E.GreaterThan(E.col("x"), E.col("y")),
    "int_gt_double": lambda E: E.GreaterThan(E.col("a"), E.col("x")),
    "long_gt_int_plus": lambda E: E.col("l") > (E.col("a") + E.lit(5)),
    "is_null_int": lambda E: E.IsNull(E.col("a")),
    "is_null_string": lambda E: E.IsNull(E.col("s")),
    "if_int": lambda E: E.If(E.IsNull(E.col("a")), E.lit(1), E.lit(0)),
    "if_null_predicate": lambda E: E.If(E.GreaterThan(E.col("a"),
                                                      E.col("b")),
                                        E.col("a"), E.col("b")),
    "if_double_branches": lambda E: E.If(E.col("a") < E.lit(0),
                                         E.col("x"), E.col("y")),
    "if_casts_false_branch": lambda E: E.If(E.IsNull(E.col("l")),
                                            E.col("a"), E.col("l")),
    "string_eq_literal": lambda E: E.col("s") == E.lit("D"),
    "string_eq_column": lambda E: E.EqualTo(E.col("s"), E.col("t")),
    "string_gt_column": lambda E: E.GreaterThan(E.col("s"), E.col("t")),
    "string_lt_literal": lambda E: E.col("t") < E.lit("ab\x00"),
    "string_ge_literal": lambda E: E.col("s") >= E.lit(">10000"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_expression_matches_reference(table, case):
    got, want = _both(table, CASES[case])
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        if isinstance(w, float) and np.isnan(w):
            assert isinstance(g, float) and np.isnan(g)
        else:
            assert g == w
    assert any(v is not None for v in got)


def test_if_result_type_and_string_if():
    """If takes the true branch's type (sum over an int If is a long, as
    q72 sums them); a string If selects each row's branch (the string
    assembly kernel's select, with the branch's nulls)."""
    from spark_rapids_tpu_torch import types as T
    t = pa.table({"a": pa.array([1, None, 3], pa.int32()),
                  "s": pa.array(["x", "y", None])})
    pb = arrow_to_batch(t, "cpu")
    e = PE.If(PE.IsNull(PE.col("a")), PE.lit(1), PE.lit(0)).bind(pb.schema)
    assert e.dtype == T.INT and PE.sum_(e).dtype == T.LONG
    s = PE.If(PE.IsNull(PE.col("a")), PE.lit("null a"), PE.col("s"))
    out = s.bind(pb.schema).eval(EvalContext(pb))
    assert s.bind(pb.schema).dtype == T.STRING
    assert out.to_pylist() == ["x", "null a", None]
    with pytest.raises(TypeError, match="string with a string"):
        (PE.col("s") == PE.lit(1)).bind(pb.schema).eval(EvalContext(pb))
