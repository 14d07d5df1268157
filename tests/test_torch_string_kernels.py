"""The port's string-function kernels' plain versions against the JAX
package's ``spark_rapids_tpu/kernels/strings.py``, on the CPU, exactly.

On CPU tensors every wrapper of K1 (``string_row_scan``: char_length,
the literal tests, first_occurrence_char, the trims), K2
(``string_dfa_match``), K3 (``string_assemble``: concat, concat_ws,
select, pad, repeat, replace, reverse, translate with deletions) and K4
(``string_case_map``: upper, lower, initcap, translate without) runs its
plain PyTorch version, which must give the reference function's rows
(bytes and validity) on the same input: the string pools of
tests/test_strings.py, test_string_functions.py and test_regex.py, and
seeded random UTF-8 of one- to four-byte characters with lone
continuation bytes, runs of 0x20, rows ending in 0xC3, empty strings and
10% nulls; a column whose offsets start past 0 against the reference over
its rows; n = 0.  The reference runs at one padded size (CAP rows, BCAP
bytes), so that each of its functions compiles once: eagerly, the
assembling ones (concat, concat_ws, pad, repeat, replace, reverse) under
``jax.jit``, whose compile of the whole function takes a tenth of the
eager compiles of its ops.
chip_smoke.py holds the CUDA kernels against these plain versions on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.column import DeviceColumn as JaxColumn
from spark_rapids_tpu.kernels import strings as JS
from spark_rapids_tpu.regex import compile_regex as jax_compile_regex
from spark_rapids_tpu.regex.automata import MAX_DFA_STATES

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels import strings as SK
from spark_rapids_tpu_torch.regex import compile_like, compile_regex

CAP = 1024
BCAP = 1 << 15
OUT_BCAP = 1 << 17
MAX_LEN = 64          # the reference's string bucket: every row is shorter

WORDS = ["apple", "Banana", "", "cherry pie", "  padded  ", "MiXeD",
         "über", "日本語", "a", "zz top", "CHERRY", "ap%ple"]
VALS = ["hello world", "  padded  ", "", "a", "ababab", "The Quick brown",
        "x,y,z", "aaa", "Mixed CASE text", None, "tab\there", "ünïcode",
        "ends with space ", " leading", "a.b.c.d", "no-match", None,
        "ααβ", "repeatrepeat", "...dots..."]
STRINGS = ["", "a", "abc", "xabcx", "aaab", "ab", "acd", "abd", "12",
           "12345", "user@site.com", "color", "colour", "  hello  ",
           "foobaz", "barbaz", ".*", "héllo", "hello\nabc", "abc\r", "aBc",
           "deadBEEF", "ααα", "abcd", "café", "zzz", "abcabc", "cdcd",
           "aad", "+42", "0x1F", "abe", "ace", "bcd", "a_b", "axbyc", "100%", "ab",
           "a%bxc", "xy"]
# one- to four-byte characters, Latin-1 letters, a lone continuation byte,
# 0xC3 alone (so that a row may end in it), spaces
PIECES = [b"a", b"Z", b"q", b" ", b"  ", "é".encode(), "Ü".encode(),
          "€".encode(), "\U0001f600".encode(), b"\x80", b"\xc3", b"\xa9",
          b"aa", b"ab", "÷".encode(), "×".encode()]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random(seed: int, n: int):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if rng.rand() < 0.1:
            out.append(None)
            continue
        row = b"".join(PIECES[j] for j in
                       rng.randint(0, len(PIECES), rng.randint(0, 13)))
        out.append(row[:MAX_LEN - 1])
    return out


def _pools():
    return [None if v is None else v.encode()
            for v in WORDS + VALS + STRINGS]


CASES = {"pools": _pools(), "random": _random(7, 600),
         "edges": [b"x\xc3", b"\xa9b", b"\xc3", b"\x89", b"", None,
                   b"\x80\x80a", b"   ", b" a b ", b"\xc3\xa9\xc3", b"aaa",
                   b"aaaa"]}


def _jax_column(raw):
    n = len(raw)
    lengths = [0 if v is None else len(v) for v in raw]
    offsets = np.zeros(CAP + 1, np.int32)
    offsets[1:n + 1] = np.cumsum(lengths)
    offsets[n + 1:] = offsets[n]
    data = b"".join(v for v in raw if v is not None)
    buf = np.zeros(BCAP, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    valid = np.zeros(CAP, bool)
    valid[:n] = [v is not None for v in raw]
    return JaxColumn(jnp.asarray(buf), jnp.asarray(valid), JT.STRING,
                     jnp.asarray(offsets))


def _rows(offsets, data, valid, n):
    offsets, data, valid = map(np.asarray, (offsets, data, valid))
    return [bytes(data[offsets[i]:offsets[i + 1]]) if valid[i] else None
            for i in range(n)]


def _port_rows(col: DeviceColumn):
    return _rows(col.offsets.numpy(), col.data.numpy(), col.validity.numpy(),
                 col.num_rows)


def _jax_rows(col, n, validity=None):
    return _rows(col.offsets, col.data,
                 col.validity if validity is None else validity, n)


def _inputs(case: str, sliced: bool):
    """(port column, reference column, rows): a slice drops 5 rows at each
    end, so its offsets start past 0."""
    raw = CASES[case]
    col = DeviceColumn.from_strings(raw)
    if sliced:
        col = col.slice_rows(5, len(raw) - 5)
        raw = raw[5:len(raw) - 5]
        assert int(col.offsets[0]) > 0
    return col, _jax_column(raw), len(raw)


INPUTS = [("pools", False), ("random", False), ("random", True),
          ("edges", False)]
IDS = [f"{c}{'-sliced' if s else ''}" for c, s in INPUTS]


@pytest.fixture(params=INPUTS, ids=IDS)
def inputs(request):
    return _inputs(*request.param)


#: the reference's assembling functions, compiled once each (their bytes
#: and sizes static)
J_CONCAT = jax.jit(JS.concat_strings)
J_CONCAT_WS = jax.jit(JS.concat_ws, static_argnums=(1,))
J_SELECT = jax.jit(JS.select_strings)
J_PAD = jax.jit(JS.pad_chars, static_argnums=(3, 4, 5))
J_REPEAT = jax.jit(JS.repeat_string, static_argnums=(3,))
J_REPLACE = jax.jit(JS.replace_literal, static_argnums=(2, 3, 4))
J_REVERSE = jax.jit(JS.reverse_chars)
#: every DFA padded to the state budget, so that one compile serves all
J_DFA = jax.jit(JS.dfa_match, static_argnums=(4, 5))


def _full(n, v):
    a = np.zeros(CAP, np.int32)
    a[:n] = v
    return jnp.asarray(a)


# -- K1 -----------------------------------------------------------------------

def test_char_length(inputs):
    col, jcol, n = inputs
    got = SK.char_length(col)
    want = np.asarray(JS.char_length(jcol, n))[:n]
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_byte_length(inputs):
    col, jcol, n = inputs
    assert np.array_equal(SK.byte_length(col).numpy(),
                          np.asarray(JS.byte_length(jcol))[:n])


@pytest.mark.parametrize("pattern", [b"", b"a", b"ab", b"aa", b" ",
                                     "é".encode(), b"\xa9", b"\xc3",
                                     b"zz top", b"no-such"])
def test_literal_tests(inputs, pattern):
    col, jcol, n = inputs
    for port, ref in ((SK.contains_literal,
                       lambda c, p: JS.contains_literal(c, p, n)),
                      (SK.startswith_literal, JS.startswith_literal),
                      (SK.endswith_literal, JS.endswith_literal)):
        got = port(col, pattern)
        assert got.dtype == torch.bool
        want = np.asarray(ref(jcol, pattern))[:n]
        assert np.array_equal(got.numpy(), want), port.__name__


@pytest.mark.parametrize("pattern", [b"", b"a", b"ab", b"\x80", b"\xa9",
                                     "é".encode(), b" "])
@pytest.mark.parametrize("start", [-2, 1, 3])
def test_first_occurrence_char(inputs, pattern, start):
    """Only hits at lead bytes count (a lone continuation byte's is
    skipped); an empty pattern gives the start where it fits."""
    col, jcol, n = inputs
    got = SK.first_occurrence_char(col, pattern, start)
    want = JS.first_occurrence_char(jcol, pattern, n,
                                    start_char=_full(n, start))
    assert np.array_equal(got.numpy(), np.asarray(want)[:n])


@pytest.mark.parametrize("fn", ["trim_ws", "ltrim_ws", "rtrim_ws"])
def test_trims(inputs, fn):
    col, jcol, n = inputs
    got = getattr(SK, fn)(col)
    assert int(got.offsets[0]) == 0
    assert _port_rows(got) == _jax_rows(getattr(JS, fn)(jcol, n), n)


# -- K2 -----------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["[a-z]+", r"\d{2,4}", "(ab|cd)+",
                                     "^a.*d$", "é+", "a.c", "^$", r"\s"])
def test_dfa_match(inputs, pattern):
    col, jcol, n = inputs
    dfa = compile_regex(pattern, "search")
    got = SK.dfa_match(col, *SK.dfa_tables(dfa.table, dfa.accept, "cpu"),
                       dfa.start)
    ref = jax_compile_regex(pattern, "search")
    table = np.zeros((MAX_DFA_STATES, 256), np.int32)
    accept = np.zeros(MAX_DFA_STATES, bool)
    table[:ref.num_states], accept[:ref.num_states] = ref.table, ref.accept
    want = J_DFA(jcol, n, jnp.asarray(table), jnp.asarray(accept), ref.start,
                 MAX_LEN)
    assert np.array_equal(got.numpy(), np.asarray(want)[:n])


def test_dfa_tables_narrow_and_check():
    dfa = compile_like("a_b%c")
    table, accept = SK.dfa_tables(dfa.table, dfa.accept, "cpu")
    assert table.dtype == torch.uint8 and accept.dtype == torch.uint8
    assert np.array_equal(table.numpy(), dfa.table)
    big = np.zeros((256, 256), np.int32)
    with pytest.raises(ValueError, match="1-255 states"):
        SK.dfa_tables(big, np.zeros(256, bool), "cpu")


# -- K3 -----------------------------------------------------------------------

def _other(raw, seed):
    rng = np.random.RandomState(seed)
    return [raw[i] for i in rng.permutation(len(raw))]


def test_concat(inputs):
    col, jcol, n = inputs
    raw = _jax_rows(jcol, n)
    other = _other(raw, 1)
    got = SK.concat_strings([col, DeviceColumn.from_strings(other)])
    want = J_CONCAT(jcol, _jax_column(other), n)
    assert _port_rows(got) == _jax_rows(want, n)


@pytest.mark.parametrize("sep", [b"-", b"", b"<=>"])
def test_concat_ws(inputs, sep):
    col, jcol, n = inputs
    raw = _jax_rows(jcol, n)
    others = [_other(raw, 2), _other(raw, 3)]
    got = SK.concat_ws([col] + [DeviceColumn.from_strings(o)
                                for o in others], sep)
    want = J_CONCAT_WS([jcol] + [_jax_column(o) for o in others], sep, n)
    assert bool(got.validity.all())
    assert _port_rows(got) == _jax_rows(want, n)


def test_select(inputs):
    col, jcol, n = inputs
    raw = _jax_rows(jcol, n)
    other = _other(raw, 4)
    mask = np.random.RandomState(5).rand(n) < 0.5
    choice = torch.from_numpy(np.where(mask, 0, 1).astype(np.int32))
    got = SK.select_strings(choice, [col, DeviceColumn.from_strings(other)])
    m = np.zeros(CAP, bool)
    m[:n] = mask
    want = J_SELECT(jnp.asarray(m), jcol, _jax_column(other), n)
    assert _port_rows(got) == _jax_rows(want, n)


def test_select_of_many_and_none():
    """A choice past the inputs is a null row; three inputs at once."""
    cols = [DeviceColumn.from_strings(v) for v in
            (["a", "b", None, "d"], ["w", None, "y", "z"], ["1", "2", "3",
                                                            None])]
    choice = torch.tensor([2, 1, 3, 0], dtype=torch.int32)
    got = SK.select_strings(choice, cols)
    assert got.to_pylist() == ["1", None, None, "d"]


@pytest.mark.parametrize("target,pad,left", [
    (8, b"*", True), (3, b"xy", True), (8, b"*", False), (0, b"z", False),
    (5, b"", True), (-2, b"ab", False), (12, b"abc", False)])
def test_pad(inputs, target, pad, left):
    """Truncate to the target characters (a lone continuation byte before
    the first character start is kept), pad with the ASCII pattern."""
    col, jcol, n = inputs
    got = SK.pad_chars(col, target, pad, left)
    want, _ = J_PAD(jcol, n, _full(n, target), pad, left, OUT_BCAP)
    assert _port_rows(got) == _jax_rows(want, n)


@pytest.mark.parametrize("times", [3, 1, 0, -1])
def test_repeat(inputs, times):
    col, jcol, n = inputs
    got = SK.repeat_string(col, times)
    want, _ = J_REPEAT(jcol, n, _full(n, times), OUT_BCAP)
    assert _port_rows(got) == _jax_rows(want, n)


@pytest.mark.parametrize("search,replace", [
    (b"aa", b"b"), (b"a", b"XY"), (b"ab", b""), (b" ", b"__"),
    ("é".encode(), b"e"), (b"\xc3", b"C")])
def test_replace(inputs, search, replace):
    """Greedy non-overlapping hits from the left: "aa" -> "b" over "aaa"
    is "ba"."""
    col, jcol, n = inputs
    got = SK.replace_literal(col, search, replace)
    want = J_REPLACE(jcol, n, search, replace, MAX_LEN)
    assert _port_rows(got) == _jax_rows(want, n, jcol.validity)


def test_replace_pins_the_countdown_rule():
    col = DeviceColumn.from_strings([b"aaa", b"aaaa", b"baaab"])
    assert SK.replace_literal(col, b"aa", b"b").to_pylist() == [
        "ba", "bb", "bbab"]


def test_reverse(inputs):
    """A row's leading continuation bytes are one character anchored at
    the row's start."""
    col, jcol, n = inputs
    got = SK.reverse_chars(col)
    assert _port_rows(got) == _jax_rows(J_REVERSE(jcol, n), n)


def test_reverse_pins_lone_continuation_bytes():
    col = DeviceColumn.from_strings([b"\x80\x81a\xc3\xa9", b"ab\x80"])
    assert _port_rows(SK.reverse_chars(col)) == [b"\xc3\xa9a\x80\x81",
                                                 b"b\x80a"]


@pytest.mark.parametrize("src,dst", [("ab ", "x"), ("a", ""),
                                     ("lo", "01"), ("aa", "bc")])
def test_translate(inputs, src, dst):
    """The byte map, then the mapped-away bytes deleted (K3), or the map
    alone (K4); against the reference's LUT and ``_compact_bytes``."""
    col, jcol, n = inputs
    table, drop = SK._byte_tables(src, dst)
    got = SK.translate_bytes(col, table, drop)
    lut = jnp.asarray(np.frombuffer(table, np.uint8))
    mapped = JaxColumn(lut[jcol.data.astype(jnp.int32)], jcol.validity,
                       jcol.dtype, jcol.offsets)
    dropped = jnp.asarray(np.frombuffer(drop, np.uint8) != 0)
    want = JS._compact_bytes(mapped, ~dropped[jcol.data.astype(jnp.int32)],
                             n) if any(drop) else mapped
    assert _port_rows(got) == _jax_rows(want, n, jcol.validity)


# -- K4 -----------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["upper_ascii", "lower_ascii",
                                "initcap_ascii"])
def test_case_maps(inputs, fn):
    col, jcol, n = inputs
    got = getattr(SK, fn)(col)
    assert got.offsets is col.offsets
    ref = getattr(JS, fn)
    want = ref(jcol, n) if fn == "initcap_ascii" else ref(jcol)
    assert _port_rows(got) == _jax_rows(want, n)


def test_case_map_reads_the_byte_before_across_rows():
    """A row whose first byte follows a 0xC3 that ended the row before is
    mapped as Latin-1, as in the reference's buffer; in a slice the first
    live byte reads 0."""
    raw = [b"x\xc3", b"\xa9b", b"\xc3", b"\x89z"]
    col = DeviceColumn.from_strings(raw)
    up = _port_rows(SK.upper_ascii(col))
    low = _port_rows(SK.lower_ascii(col))
    assert up == [b"X\xc3", b"\x89B", b"\xc3", b"\x89Z"]
    assert low == [b"x\xc3", b"\xa9b", b"\xc3", b"\xa9z"]
    assert up == _jax_rows(JS.upper_ascii(_jax_column(raw)), 4)
    assert low == _jax_rows(JS.lower_ascii(_jax_column(raw)), 4)
    part = col.slice_rows(1, 4)
    assert _port_rows(SK.upper_ascii(part)) == [b"\xa9B", b"\xc3", b"\x89Z"]


# -- empty inputs and the CUDA path ---------------------------------------------

def test_zero_rows():
    col = DeviceColumn.from_strings([])
    assert SK.char_length(col).shape == (0,)
    assert SK.contains_literal(col, b"a").shape == (0,)
    assert SK.first_occurrence_char(col, b"a").shape == (0,)
    dfa = compile_regex("a+")
    assert SK.dfa_match(col, *SK.dfa_tables(dfa.table, dfa.accept,
                                            "cpu")).shape == (0,)
    for out in (SK.trim_ws(col), SK.concat_strings([col, col]),
                SK.concat_ws([col], b","), SK.pad_chars(col, 3, b"*", True),
                SK.repeat_string(col, 2), SK.replace_literal(col, b"a", b"b"),
                SK.reverse_chars(col), SK.upper_ascii(col),
                SK.select_strings(torch.zeros(0, dtype=torch.int32),
                                  [col])):
        assert out.num_rows == 0 and out.offsets.tolist() == [0]


def test_plain_versions_count_no_launch():
    before = dict(_lib.LAUNCHES)
    col = DeviceColumn.from_strings(["ab", None, "cab"])
    SK.char_length(col)
    SK.concat_ws([col, col], b"-")
    SK.upper_ascii(col)
    dfa = compile_regex("ab")
    SK.dfa_match(col, *SK.dfa_tables(dfa.table, dfa.accept, "cpu"))
    assert dict(_lib.LAUNCHES) == before
