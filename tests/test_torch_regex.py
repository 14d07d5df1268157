"""The port's regex engine, DFA kernel and RLIKE / LIKE against the JAX
package's, on the CPU.

``spark_rapids_tpu_torch/regex/`` is the port's own copy of
``spark_rapids_tpu/regex/``: its DFA tables (transitions, accepting
states, start, mode) must equal the reference's bit for bit for every
pattern of tests/test_regex.py ``PATTERNS`` (:29) in both modes and for
its LIKE patterns, and every ``UNSUPPORTED`` pattern (:45-57) must be
refused by both, and by the port's planner with NotImplementedError (the
reference's planner falls back to its CPU).  ``dfa_match``'s plain
version (what the wrapper runs on CPU tensors) must equal the
reference's ``dfa_match`` kernel function over ``STRINGS`` (:37) with
nulls and a slice; the RLIKE and LIKE DataFrame cases of
tests/test_regex.py (:138-158) run through GpuSession against the JAX
package's CPU oracle, which that file holds its device path to.  Exact.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu import regex as JR
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.batch import Schema as JaxSchema
from spark_rapids_tpu.columnar.column import DeviceColumn as JaxColumn
from spark_rapids_tpu.kernels import strings as JS
from spark_rapids_tpu.regex.automata import MAX_DFA_STATES
from tests.test_regex import PATTERNS, STRINGS, UNSUPPORTED

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import regex as PR
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import strings as SK
from spark_rapids_tpu_torch.testing import held

ORACLE = {"spark.rapids.sql.enabled": "false"}
LIKE_EXTRAS = ["a_b", "axbyc", "100%", "ab", "a%bxc", "xy"]
CAP = 64
MAX_LEN = 64


def _same(port, ref):
    assert np.array_equal(port.table, ref.table)
    assert port.table.dtype == ref.table.dtype
    assert np.array_equal(port.accept, ref.accept)
    assert (port.start, port.mode, port.pattern) == (ref.start, ref.mode,
                                                     ref.pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_tables_equal_the_reference(pattern):
    for mode in ("search", "full"):
        _same(PR.compile_regex(pattern, mode), JR.compile_regex(pattern, mode))
    assert PR.to_python_pattern(pattern) == JR.to_python_pattern(pattern)


@pytest.mark.parametrize("pattern", held.LIKE_PATTERNS + ["%", "", "a\\%b"])
def test_like_tables_equal_the_reference(pattern):
    _same(PR.compile_like(pattern), JR.compile_like(pattern))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_host_dfa_matches_python_re(pattern):
    """The port's copy against Python's re, as tests/test_regex.py holds
    the reference's."""
    search = PR.compile_regex(pattern, "search")
    full = PR.compile_regex(pattern, "full")
    pp = PR.to_python_pattern(pattern)
    for s in STRINGS:
        b = s.encode("utf-8")
        assert search.match_host(b) == (re.search(pp, s, re.ASCII)
                                        is not None), (pattern, s)
        assert full.match_host(b) == (re.fullmatch(pp, s, re.ASCII)
                                      is not None), (pattern, s)


@pytest.mark.parametrize("pattern", UNSUPPORTED)
def test_unsupported_patterns_raise_through_the_planner(pattern):
    assert not PR.is_supported(pattern) and not JR.is_supported(pattern)
    with pytest.raises(PR.RegexUnsupported):
        PR.compile_regex(pattern)
    with pytest.raises(NotImplementedError,
                       match="outside the supported regex dialect"):
        _port_source().select(PE.RLike(PE.col("s"), pattern)).collect()


def test_unsupported_like_raises_through_the_planner():
    """A LIKE whose DFA passes the state budget (192) is refused too."""
    pattern = "%a" + "_" * 12 + "b%"
    with pytest.raises(JR.RegexUnsupported):
        JR.compile_like(pattern)
    with pytest.raises(PR.RegexUnsupported):
        PR.compile_like(pattern)
    with pytest.raises(NotImplementedError, match="regex dialect"):
        _port_source().filter(PE.Like(PE.col("s"), pattern)).collect()


def _jax_column(raw):
    n = len(raw)
    lengths = [0 if v is None else len(v) for v in raw]
    offsets = np.zeros(CAP + 1, np.int32)
    offsets[1:n + 1] = np.cumsum(lengths)
    offsets[n + 1:] = offsets[n]
    data = b"".join(v for v in raw if v is not None)
    buf = np.zeros(4096, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    valid = np.zeros(CAP, bool)
    valid[:n] = [v is not None for v in raw]
    return JaxColumn(jnp.asarray(buf), jnp.asarray(valid), JT.STRING,
                     jnp.asarray(offsets))


#: the reference's kernel function, compiled once: every table is padded
#: to the state budget (the rows past a DFA's states are never reached)
J_DFA = jax.jit(JS.dfa_match, static_argnums=(4, 5))


def _padded(dfa):
    table = np.zeros((MAX_DFA_STATES, 256), np.int32)
    accept = np.zeros(MAX_DFA_STATES, bool)
    table[:dfa.table.shape[0]] = dfa.table
    accept[:dfa.accept.shape[0]] = dfa.accept
    return jnp.asarray(table), jnp.asarray(accept)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_match_plain_equals_the_reference_kernel(pattern):
    raw = [s.encode() for s in STRINGS + LIKE_EXTRAS] + [None, b"x" * 60]
    col = DeviceColumn.from_strings(raw)
    for mode in ("search", "full"):
        dfa = PR.compile_regex(pattern, mode)
        tables = SK.dfa_tables(dfa.table, dfa.accept, "cpu")
        for part, rows in ((col, raw), (col.slice_rows(3, len(raw) - 2),
                                        raw[3:len(raw) - 2])):
            got = SK.dfa_match(part, *tables, dfa.start)
            ref = JR.compile_regex(pattern, mode)
            want = J_DFA(_jax_column(rows), len(rows), *_padded(ref),
                         ref.start, MAX_LEN)
            assert np.array_equal(got.numpy(),
                                  np.asarray(want)[:len(rows)]), mode


# -- the DataFrame cases of tests/test_regex.py ----------------------------------

def _values(extra=()):
    return list(STRINGS) + list(extra) + [None, None]


def _port_source(extra=()):
    b = ColumnarBatch.from_pydict({"s": _values(extra)},
                                  Schema.of(s=T.STRING), "cpu")
    return GpuSession(device="cpu").create_dataframe([b], num_partitions=1)


def _jax_source(extra=()):
    b = JaxBatch.from_pydict({"s": _values(extra)},
                             JaxSchema.of(s=JT.STRING))
    return TpuSession(ORACLE).create_dataframe([b], num_partitions=1)


def _check(build, extra=()):
    want = build(_jax_source(extra), JE).collect()
    got = build(_port_source(extra), PE).collect()
    assert got == want and len(got) > 0
    return got


@pytest.mark.parametrize("pattern", held.RLIKE_PATTERNS)
def test_rlike_differential(pattern):
    _check(lambda df, E: df.select(E.col("s"),
                                   E.RLike(E.col("s"), pattern).alias("m")))


def test_rlike_on_filter():
    _check(lambda df, E: df.filter(E.RLike(E.col("s"), "[a-d]+c")))


@pytest.mark.parametrize("pattern", held.LIKE_PATTERNS)
def test_general_like_differential(pattern):
    _check(lambda df, E: df.select(E.col("s"),
                                   E.Like(E.col("s"), pattern).alias("m")),
           extra=LIKE_EXTRAS)


def test_rlike_over_projected_string():
    _check(lambda df, E: df.select(
        E.col("s"), E.RLike(E.Upper(E.col("s")), "[A-Z]{3}").alias("m")))


def test_dollar_matches_before_trailing_newline():
    c = PR.compile_regex("abc$", "search")
    assert c.match_host(b"abc") and c.match_host(b"abc\n")
    assert not c.match_host(b"abc\n\n") and not c.match_host(b"abcx")
    _check(lambda df, E: df.select(E.col("s"),
                                   E.RLike(E.col("s"), "d$").alias("m")),
           extra=["abc\n", "abc", "abc\n\n"])


def test_like_host_dfa_semantics():
    cases = [("a%", "abc", True), ("a%", "ba", False), ("%c", "abc", True),
             ("_b_", "abc", True), ("_b_", "ab", False),
             ("a\\%b", "a%b", True), ("a\\%b", "axb", False),
             ("%", "", True), ("_", "", False), ("", "", True),
             ("", "x", False), ("a_%", "ab", True), ("a_%", "a", False)]
    for pattern, s, want in cases:
        assert PR.compile_like(pattern).match_host(s.encode()) == want


def test_state_budget_equals_the_reference():
    from spark_rapids_tpu_torch.regex.automata import MAX_DFA_STATES as port
    assert port == MAX_DFA_STATES == 192


def test_dfa_tables_cached_per_device():
    """An RLIKE builds its uint8 tables once for a device."""
    e = PE.RLike(PE.col("s"), "(ab|cd)+").bind(Schema.of(s=T.STRING))
    b = ColumnarBatch.from_pydict({"s": ["abcd", "x", None]},
                                  Schema.of(s=T.STRING), "cpu")
    from spark_rapids_tpu_torch.expressions.core import EvalContext
    first = e.eval(EvalContext(b))
    tables = dict(e._tables)
    second = e.eval(EvalContext(b))
    assert torch.equal(first.data, second.data) and first.data.tolist() == [
        True, False, False]
    assert e._tables["cpu"][0] is tables["cpu"][0]
