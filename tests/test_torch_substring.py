"""SUBSTRING, OR and NOT of the port against the JAX package's, on the CPU.

``kernels/strings.py`` ``substring_plain`` (what the ``substring`` wrapper
runs on CPU tensors) against ``spark_rapids_tpu.kernels.strings``
``substring_chars``, and the port's ``Substring``, ``Or`` and ``Not``
against the reference's expressions, on the same numpy-made inputs: UTF-8
strings of one- to four-byte characters with 10% nulls, a lone
continuation byte, empty strings; ``pos`` in {-70, -3, -1, 0, 1, 2, 5,
100}, ``len`` in {-1, 0, 1, 3, 5, 2**30, 2**31 - 1, absent}, as literals
and as per-row columns; a column whose offsets start past 0.  Every
comparison is exact on the live rows: their bytes, and the validity.
chip_smoke.py holds the CUDA kernel against ``substring_plain`` on the
card.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as RE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.column import DeviceColumn as JaxColumn
from spark_rapids_tpu.expressions.core import EvalContext as JaxContext
from spark_rapids_tpu.kernels.strings import substring_chars

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.core import EvalContext
from spark_rapids_tpu_torch.kernels import strings as SK

POSITIONS = (-70, -3, -1, 0, 1, 2, 5, 100)
LENGTHS = (-1, 0, 1, 3, 5, 2**30, 2**31 - 1, None)
# one-, two-, three- and four-byte characters, and a lone continuation
# byte (malformed: it counts as no character start)
PIECES = [b"a", b"Z", "é".encode(), "€".encode(),
          "\U0001f600".encode(), b"\x80"]
N = 700


def _raw_strings(seed: int, n: int = N):
    """n UTF-8 byte strings of 0-20 pieces, 10% None, and the edges."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if rng.rand() < 0.1:
            out.append(None)
        else:
            k = rng.randint(0, 21)
            out.append(b"".join(PIECES[j] for j in
                                rng.randint(0, len(PIECES), k)))
    return out + [b"", b"\x80", b"\x80a", "éé".encode(), None,
                  b"abcdef"]


def _jax_column(raw):
    """The reference's STRING column of ``raw`` (capacity a power of two,
    the padding rows empty)."""
    n = len(raw)
    cap = 1 << max(n - 1, 1).bit_length()
    lengths = [0 if v is None else len(v) for v in raw]
    offsets = np.zeros(cap + 1, np.int32)
    offsets[1:n + 1] = np.cumsum(lengths)
    offsets[n + 1:] = offsets[n]
    data = b"".join(v for v in raw if v is not None)
    nbytes = max(len(data), 1)
    buf = np.zeros(1 << (nbytes - 1).bit_length(), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    valid = np.zeros(cap, bool)
    valid[:n] = [v is not None for v in raw]
    return JaxColumn(jnp.asarray(buf), jnp.asarray(valid), JT.STRING,
                     jnp.asarray(offsets))


def _rows(offsets, data, valid, n):
    offsets = np.asarray(offsets)
    data = np.asarray(data)
    return [bytes(data[offsets[i]:offsets[i + 1]]) if valid[i] else None
            for i in range(n)]


def _port_rows(col: DeviceColumn):
    return _rows(col.offsets.numpy(), col.data.numpy(), col.validity.numpy(),
                 col.num_rows)


def _reference(jcol, n, pos, length):
    """substring_chars' live rows; pos and length per row."""
    cap = jcol.capacity
    p = np.zeros(cap, np.int32)
    ln = np.zeros(cap, np.int32)
    p[:n], ln[:n] = pos, length
    out = substring_chars(jcol, n, jnp.asarray(p), jnp.asarray(ln))
    return _rows(out.offsets, out.data, np.asarray(jcol.validity), n)


def _arg(v, n):
    """A literal's one-value tensor (absent length: NO_LENGTH)."""
    return torch.tensor([SK.NO_LENGTH if v is None else v], dtype=torch.int32)


@pytest.fixture(scope="module")
def column():
    raw = _raw_strings(3)
    return raw, DeviceColumn.from_strings(raw), _jax_column(raw)


@pytest.mark.parametrize("length", LENGTHS, ids=str)
def test_substring_plain_matches_reference(column, length):
    """Every pos against one literal length (absent: 2**30)."""
    raw, col, jcol = column
    n = len(raw)
    ln = SK.NO_LENGTH if length is None else length
    for pos in POSITIONS:
        got = SK.substring(col, _arg(pos, n), _arg(length, n))
        assert torch.equal(got.validity, col.validity)
        assert got.offsets[0] == 0
        want = _reference(jcol, n, np.full(n, pos), np.full(n, ln))
        assert _port_rows(got) == want, (pos, length)


def test_substring_per_row_columns_and_a_sliced_column(column):
    """pos and len as per-row columns drawn from every case; the same on
    a slice whose offsets start past 0 (the reference gets the slice's
    rows rebased)."""
    raw, col, _ = column
    rng = np.random.RandomState(11)
    lengths = [SK.NO_LENGTH if v is None else v for v in LENGTHS]
    for lo, hi in ((0, len(raw)), (37, len(raw) - 5)):
        part = col.slice_rows(lo, hi)
        n = hi - lo
        if lo:
            assert int(part.offsets[0]) > 0
        pos = rng.choice(POSITIONS, n).astype(np.int32)
        ln = rng.choice(lengths, n).astype(np.int32)
        got = SK.substring(part, torch.from_numpy(pos), torch.from_numpy(ln))
        want = _reference(_jax_column(raw[lo:hi]), n, pos, ln)
        assert _port_rows(got) == want
        assert int(got.offsets[-1]) == sum(len(v) for v in want if v)


def test_int32_max_length_wraps_as_the_reference():
    """len = 2**31 - 1: from pos 1 the whole string; from pos 2 (or -2,
    the fourth of five characters) the reference's s0 + len wraps negative
    and gives the empty string (Spark gives the tail); the port keeps the
    reference's result.  From -5 and -70, s0 <= 0 and nothing wraps."""
    raw = [b"hello", "héllo".encode()]
    col = DeviceColumn.from_strings(raw)
    jcol = _jax_column(raw)
    big = 2**31 - 1
    for pos, want in ((1, raw), (2, [b"", b""]), (-2, [b"", b""]),
                      (-5, raw), (-70, raw)):
        got = SK.substring(col, _arg(pos, 2), _arg(big, 2))
        assert _port_rows(got) == want
        assert _reference(jcol, 2, np.full(2, pos), np.full(2, big)) == want


def test_empty_column():
    col = DeviceColumn.from_strings([])
    got = SK.substring(col, _arg(1, 0), _arg(5, 0))
    assert got.num_rows == 0 and got.offsets.tolist() == [0]


def _expr_table():
    """Valid UTF-8 strings (no lone byte: Arrow's strings are UTF-8), and
    int columns for pos and len with nulls."""
    rng = np.random.RandomState(5)
    raw = [v for v in _raw_strings(9, 400) if v is None or b"\x80" not in v]
    n = len(raw)
    strings = [None if v is None else v.decode() for v in raw]
    pos = rng.choice(POSITIONS, n).astype(np.int32)
    ln = rng.choice([v for v in LENGTHS if v is not None], n).astype(np.int64)
    return pa.table({
        "s": pa.array(strings, pa.string()),
        "p": pa.array(pos, mask=rng.rand(n) < 0.1),
        "l": pa.array(ln, mask=rng.rand(n) < 0.1),
        "b": pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.2),
        "c": pa.array(rng.rand(n) < 0.5, mask=rng.rand(n) < 0.2)})


EXPRESSIONS = {
    "literals": lambda E: E.Substring(E.col("s"), 2, 3),
    "no_length": lambda E: E.Substring(E.col("s"), -3),
    "zip_prefix": lambda E: E.Substring(E.col("s"), 1, 5),
    "columns": lambda E: E.Substring(E.col("s"), E.col("p"), E.col("l")),
    "nested": lambda E: E.Substring(E.Substring(E.col("s"), 2), -4, 2),
}


@pytest.fixture(scope="module")
def expr_table():
    t = _expr_table()
    return t, arrow_to_batch(t, "cpu"), JaxBatch.from_arrow(t)


@pytest.mark.parametrize("case", list(EXPRESSIONS))
def test_substring_expression_matches_reference(expr_table, case):
    """Substring.eval against the reference's: the live rows' strings and
    the validity (the string's alone, a null pos or len included)."""
    _, pb, jb = expr_table
    got = EXPRESSIONS[case](PE).bind(pb.schema).eval(EvalContext(pb))
    ref = EXPRESSIONS[case](RE).bind(jb.schema).eval(JaxContext(jb))
    n = pb.num_rows
    rvalid = np.asarray(ref.validity)[:n]
    assert np.array_equal(got.validity.numpy(), rvalid)
    assert got.to_pylist() == [
        None if not rvalid[i] else
        bytes(np.asarray(ref.data)[int(ref.offsets[i]):
                                   int(ref.offsets[i + 1])]).decode()
        for i in range(n)]


BOOLEANS = {
    "or": lambda E: E.col("b") | E.col("c"),
    "not": lambda E: ~E.col("b"),
    "ne_strings": lambda E: E.Substring(E.col("s"), 1, 2)
    != E.Substring(E.col("s"), 2, 2),
    "not_or_not": lambda E: ~(~E.col("b") | E.IsNull(E.col("c"))),
}


@pytest.mark.parametrize("case", list(BOOLEANS))
def test_or_not_match_reference(expr_table, case):
    """Three-valued OR and NOT over bools with nulls, and != (NOT of
    EqualTo) on strings: value and validity, exact, null slots zero."""
    _, pb, jb = expr_table
    got = BOOLEANS[case](PE).bind(pb.schema).eval(EvalContext(pb))
    ref = BOOLEANS[case](RE).bind(jb.schema).eval(JaxContext(jb))
    vals, valid = ref.to_numpy(pb.num_rows)
    assert np.array_equal(got.validity.numpy(), valid)
    assert np.array_equal(got.data.numpy(), np.asarray(vals, bool) & valid)
    assert not got.data[~got.validity].any()
    assert valid.any() and (~valid).any()


def test_dsl_builds_not_equal_or_and_not():
    e = PE.col("a") != PE.lit(1)
    assert isinstance(e, PE.Not) and isinstance(e.child, PE.EqualTo)
    assert isinstance(PE.col("a") | PE.col("b"), PE.Or)
    assert isinstance(~PE.col("a"), PE.Not)


def test_substring_prunes_to_the_columns_it_reads(expr_table):
    """Column pruning reaches through Substring: a projection of one
    substring scans only the columns it reads."""
    from spark_rapids_tpu_torch.api.session import GpuSession
    t, pb, _ = expr_table
    e = PE.Substring(PE.col("s"), PE.col("p"), 2)
    df = GpuSession(device="cpu").create_dataframe(t).select(e.alias("x"))
    plan = df.physical_plan()
    assert plan.children[0].schema.names == ("s", "p")
    want = e.bind(pb.schema).eval(EvalContext(pb)).to_pylist()
    assert df.collect() == [(v,) for v in want]


def test_wrapper_takes_the_plain_version_only_on_the_cpu(column):
    """Tensors that are not on the CPU go to the kernel and raise there:
    the wrapper never runs the plain version for them."""
    _, col, _ = column
    meta = DeviceColumn(col.data.to("meta"), col.validity.to("meta"),
                        col.dtype, col.offsets.to("meta"))
    one = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        SK.substring(meta, one, one)
    with pytest.raises(TypeError, match="int32"):
        SK.substring(col, torch.ones(3, dtype=torch.int64),
                     _arg(1, col.num_rows))
