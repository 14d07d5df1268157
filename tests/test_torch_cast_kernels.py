"""The port's string cast kernels' plain versions against the JAX package's
``spark_rapids_tpu/kernels/cast_strings.py``, on the CPU.

On CPU tensors every wrapper of C1 (``string_parse``: parse_integral,
parse_double, parse_date, parse_bool) and C2 (``string_format``:
long_to_string, date_to_string, bool_to_string) runs its plain PyTorch
version, which must give the reference function's values and flags, or
rows, on the same input: every text pool of tests/test_cast_strings.py
(:17-48) with a 300-digit ``000...01`` and a 400-byte run of spaces
beside them (no byte window is left), seeded random texts (signs,
whitespace, dots, exponents, over-long digit runs, the bounds of LONG and
one past them, non-ASCII bytes, empty rows, 10% nulls), the same on a
column whose offsets start past 0, and n = 0.  Integral, date and bool
parses and every formatted row are exact.  The double parse is bit for
bit but where the reference's value comes from XLA's power, which is one
ulp off at 10**23 and 10**210 and flushes every subnormal power (10**-308
and below) to 0.0: there each row must be explained, the port's value the
mantissa times the correctly rounded power and the reference's the
mantissa times XLA's.  Named tests pin both splits: the 15-significant-
digit rule, where the port gives the reference device path's value (not
Python's ``float``), and the power, where it gives the oracle's.

The reference runs at one padded size (CAP rows, BCAP bytes, a MAX_LEN
byte window), each function under ``jax.jit`` once.  chip_smoke.py holds
the CUDA kernels against these plain versions on the card.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.column import DeviceColumn as JaxColumn
from spark_rapids_tpu.expressions import datetime as JD
from spark_rapids_tpu.kernels import cast_strings as JCS
from tests.test_cast_strings import (BOOL_STRINGS, DATE_STRINGS,
                                     FLOAT_STRINGS, INT_STRINGS)

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions import datetime as PD
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels import cast_strings as CS

CAP = 1024
BCAP = 1 << 16
MAX_LEN = 512         # the reference's byte window: every row is shorter

LONG_ROWS = ["0" * 299 + "1", " " * 400, " " * 150 + "-" + "0" * 250 + "7",
             "0" * 290 + ".5e-3", "1" * 300]
POOLS = {"int": INT_STRINGS, "double": FLOAT_STRINGS, "date": DATE_STRINGS,
         "bool": BOOL_STRINGS}
PARSES = {"int": (JCS.parse_integral, CS.parse_integral),
          "double": (JCS.parse_double, CS.parse_double),
          "date": (JCS.parse_date, CS.parse_date),
          "bool": (JCS.parse_bool, CS.parse_bool)}

#: the exponents at which XLA's power on the CPU is not float(f"1e{k}")
XLA_POWER_OFF = {23, 210} | set(range(-323, -307))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_texts(seed: int, n: int):
    """Texts of every kind the parses tell apart, as bytes (None: null)."""
    rng = np.random.RandomState(seed)
    ws = [b"", b"", b" ", b"\t", b"\n ", b"\x00", b"\x1f "]
    junk = [b"\xc3\xa9", b"\xff", b"\xd9\xa1", b"x", b"-", b"+", b".", b"e",
            b" "]
    words = [b"inf", b"-Infinity", b"+INF", b"NaN", b"-nan", b"true",
             b"No", b"T", b"yes", b"0", b"1", b"maybe", b"infinit"]
    out = [str(v).encode() for v in (-2**63, 2**63 - 1, -2**63 - 1, 2**63,
                                     -2**63 + 1, 2**63 - 2)]

    def digits(lo, hi):
        return "".join(map(str, rng.randint(0, 10, rng.randint(lo, hi))))

    while len(out) < n:
        if rng.rand() < 0.1:
            out.append(None)
            continue
        kind = rng.randint(8)
        sign = [b"", b"-", b"+"][rng.randint(3)]
        if kind == 0:      # an integer, maybe with a fraction
            body = digits(1, 22).encode()
            if rng.rand() < 0.3:
                body += b"." + digits(0, 5).encode()
        elif kind == 1:    # a double with an exponent
            body = (digits(0, 25) + "." * rng.randint(0, 2) + digits(0, 25)
                    + "eE"[rng.randint(2)] + "+-"[rng.randint(2)]
                    * rng.randint(0, 2) + digits(0, 11)).encode()
        elif kind == 2:    # leading zeros in front of a fraction
            body = ("0" * rng.randint(0, 30) + "." + "0" * rng.randint(0, 30)
                    + digits(1, 20)).encode()
        elif kind == 3:    # a date
            y, m, d = rng.randint(0, 10001), rng.randint(0, 14), \
                rng.randint(0, 33)
            body = [f"{y:04d}-{m}-{d}", f"{y:04d}-{m:02d}-{d:02d}",
                    f"{y:04d}", f"{y:04d}-{m}", f"{y}-{m}-{d}x",
                    f"{y:04d}--{m}"][rng.randint(6)].encode()
            sign = b""
        elif kind == 4:
            body = words[rng.randint(len(words))]
            sign = b""
        elif kind == 5:    # junk spliced into digits
            body = (digits(0, 6).encode() + junk[rng.randint(len(junk))]
                    + digits(0, 6).encode())
        elif kind == 6:    # a short mantissa near XLA's odd powers
            e = [23, 210, -310, -320, 22, 24, -307,
                 int(rng.randint(-330, 331))][rng.randint(8)]
            body = f"{digits(1, 4)}e{e}".encode()
        else:
            body = b""
        out.append(ws[rng.randint(len(ws))] + sign + body
                   + ws[rng.randint(len(ws))])
    return out[:n]


CASES = {"pools": None, "random": _random_texts(16, 700),
         "empty": []}


def _texts(case: str, kind: str):
    if case == "pools":
        return [None if v is None else v.encode()
                for v in POOLS[kind] + LONG_ROWS]
    return CASES[case]


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


@functools.lru_cache(maxsize=None)
def _jit(fn):
    return jax.jit(fn, static_argnums=1)


def _reference(kind: str, raw):
    vals, ok = _jit(PARSES[kind][0])(_jax_column(raw), MAX_LEN)
    return np.asarray(vals)[:len(raw)], np.asarray(ok)[:len(raw)]


def _port_column(raw, sliced: bool) -> DeviceColumn:
    """A slice keeps 5 rows of padding at each end: offsets past 0."""
    if not sliced:
        return DeviceColumn.from_strings(raw)
    pad = [b"pad", None, b"12", b"", b"x"]
    col = DeviceColumn.from_strings(pad + list(raw) + pad)
    out = col.slice_rows(5, 5 + len(raw))
    assert int(out.offsets[0]) > 0
    return out


_WS = bytes(range(0x21))


def _mantissa_exponent(text: bytes):
    """The reference's 15-significant-digit rule in Python: a numeric
    double text's (negative, mantissa, decimal exponent)."""
    tok = text.strip(_WS).decode()
    neg = tok.startswith("-")
    body = tok.lstrip("+-")
    mant_s, exp_s = re.fullmatch(r"([^eE]*)(?:[eE](.*))?", body).groups()
    exp = int(exp_s) if exp_s else 0
    mant, nsig, e_adj, after = 0, 0, 0, False
    for ch in mant_s:
        if ch == ".":
            after = True
            continue
        d = int(ch)
        if mant == 0 and d == 0:
            e_adj -= after
        elif nsig < CS.SIG_DIGITS:
            mant, nsig = mant * 10 + d, nsig + 1
            e_adj -= after
        elif not after:
            e_adj += 1
    return neg, mant, exp + e_adj


def _explained(text: bytes, port: float, ref: float) -> bool:
    """A double row where the two differ: its exponent is one where XLA's
    power is off; the port's value is the mantissa times the correctly
    rounded power, the reference's the mantissa times XLA's."""
    neg, mant, e = _mantissa_exponent(text)
    e = max(-CS.POW10_SPAN, min(CS.POW10_SPAN, e))
    sign = -1.0 if neg else 1.0
    xla = float(jnp.power(jnp.float64(10.0), jnp.float64(e)))
    return (e in XLA_POWER_OFF and port == sign * (mant * float(f"1e{e}"))
            and ref == sign * float(jnp.float64(mant) * jnp.float64(xla)))


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(PARSES))
def test_parse_matches_the_reference(kind, case, sliced):
    """Values and flags exactly (doubles bit for bit, every other
    difference explained by XLA's power); no launch is counted."""
    raw = _texts(case, kind)
    before = dict(_lib.LAUNCHES)
    vals, ok = PARSES[kind][1](_port_column(raw, sliced))
    assert dict(_lib.LAUNCHES) == before
    assert vals.dtype == CS._PARSE_DTYPES[list(PARSES).index(kind)]
    assert ok.dtype == torch.bool and ok.shape == (len(raw),)
    want_vals, want_ok = _reference(kind, raw)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    got = vals.numpy()
    if kind != "double":
        np.testing.assert_array_equal(got, want_vals)
        return
    differ = np.flatnonzero(got.view(np.int64) != want_vals.view(np.int64))
    for i in differ:
        assert want_ok[i] and _explained(raw[i], got[i], want_vals[i]), \
            (raw[i], got[i], want_vals[i])


def test_long_rows_parse_whole():
    """No byte window: the 300-digit and 400-byte rows parse in full."""
    col = DeviceColumn.from_strings(LONG_ROWS)
    vals, ok = CS.parse_integral(col)
    assert ok.tolist() == [True, False, True, False, False]
    assert vals.tolist()[:3] == [1, 0, -7]
    d, dok = CS.parse_double(col)
    assert dok.tolist() == [True, False, True, True, True]
    assert d.tolist()[2:5] == [-7.0, 5 * float("1e-4"),
                               float("1" * 15) * float("1e285")]


def _random_longs(seed: int, n: int):
    """The extremes, then every length of digits, then the full range."""
    rng = np.random.RandomState(seed)
    m = max(n, 16)
    v = rng.randint(-2**63, 2**63 - 1, m, dtype=np.int64)
    v[:8] = [-2**63, 2**63 - 1, 0, -1, 1, 9, -10, 10**18]
    v[8:m // 2] //= 10 ** rng.randint(0, 19, m // 2 - 8)
    return v[:n]


def _random_days(seed: int, n: int):
    """Years 1-9999 and past both ends."""
    rng = np.random.RandomState(seed)
    d = rng.randint(-800_000, 3_000_000, max(n, 8)).astype(np.int32)
    d[:6] = [-719162, -719163, 2932896, 2932897, 0, -1]
    return d[:n]


FORMATS = {
    "long": (JCS.long_to_string, CS.long_to_string, _random_longs),
    "date": (JCS.date_to_string, CS.date_to_string, _random_days),
    "bool": (JCS.bool_to_string, CS.bool_to_string,
             lambda seed, n: np.random.RandomState(seed).rand(n) < 0.5),
}


def _rows(offsets, data, valid, n):
    offsets, data, valid = map(np.asarray, (offsets, data, valid))
    return [bytes(data[offsets[i]:offsets[i + 1]]) if valid[i] else None
            for i in range(n)]


@pytest.mark.parametrize("n", [700, 0])
@pytest.mark.parametrize("kind", list(FORMATS))
def test_format_matches_the_reference(kind, n):
    """Rows (bytes and validity) exactly; the port's offsets start at 0
    and a null row is empty; no launch is counted."""
    ref, port, draw = FORMATS[kind]
    vals = draw(17, n)
    valid = np.random.RandomState(18).rand(n) >= 0.1
    pad = np.zeros(CAP, vals.dtype)
    pad[:n] = vals
    pvalid = np.zeros(CAP, bool)
    pvalid[:n] = valid
    want = jax.jit(ref)(jnp.asarray(pad), jnp.asarray(pvalid))
    before = dict(_lib.LAUNCHES)
    got = port(torch.from_numpy(vals), torch.from_numpy(valid))
    assert dict(_lib.LAUNCHES) == before
    assert got.offsets.dtype == torch.int32 and int(got.offsets[0]) == 0
    lengths = (got.offsets[1:] - got.offsets[:-1]).numpy()
    assert not lengths[~got.validity.numpy()].any()
    assert _rows(got.offsets, got.data, got.validity, n) == \
        _rows(want.offsets, want.data, want.validity, n)


def test_format_answers_in_python():
    """Independently of both packages: str() and date.isoformat()."""
    import datetime
    v = _random_longs(19, 300)
    got = CS.long_to_string(torch.from_numpy(v),
                            torch.ones(300, dtype=torch.bool))
    assert got.to_pylist() == [str(int(x)) for x in v]
    days = _random_days(20, 300)
    got = CS.date_to_string(torch.from_numpy(days),
                            torch.ones(300, dtype=torch.bool)).to_pylist()
    epoch = datetime.date(1970, 1, 1).toordinal()
    for d, g in zip(days.tolist(), got):
        try:
            want = datetime.date.fromordinal(epoch + d).isoformat()
        except ValueError:
            want = None
        assert g == want


def test_civil_date_conversions_match_the_reference():
    days = np.concatenate([np.arange(-800_000, 3_100_000, 997),
                           [-719162, -719163, 2932896, 0, -1, 59, 60]])
    y, m, d = PD._civil_from_days(torch.from_numpy(days))
    jy, jm, jd = JD._civil_from_days(jnp.asarray(days), jnp)
    for a, b in ((y, jy), (m, jm), (d, jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = PD._days_from_civil(y, m, d)
    np.testing.assert_array_equal(back.numpy(), days)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JD._days_from_civil(jy, jm, jd, jnp)))


# -- the pinned splits --------------------------------------------------------

#: text -> (the reference device path's value, the oracle's (Python's
#: float), the port's): the 15-significant-digit rule
FIFTEEN_DIGITS = {
    "12345678901234567890": (1.23456789012345e19, 1.2345678901234567e19),
    "1.7976931348623157e308": (1.7976931348623101e308,
                               1.7976931348623157e308),
    "0.1234567890123456789": (0.12345678901234501, 0.12345678901234568),
    "9007199254740993": (9007199254740990.0, 9007199254740992.0),
}


@pytest.mark.parametrize("text", list(FIFTEEN_DIGITS))
def test_double_fifteen_digit_rule_follows_the_device_path(text):
    """The port gives the reference kernel's value (its 15-digit rule),
    which is within the reference tests' 1e-9 of the oracle's."""
    device, oracle = FIFTEEN_DIGITS[text]
    ref, _ = _reference("double", [text.encode()])
    assert float(ref[0]) == device
    assert float(text) == oracle
    vals, ok = CS.parse_double(DeviceColumn.from_strings([text]))
    assert bool(ok[0]) and float(vals[0]) == device != oracle
    assert abs(device - oracle) <= 1e-9 * abs(oracle)


#: text -> (the device path's value, the oracle's, the port's)
XLA_POWER = {
    "1e23": (1.0000000000000001e23, 1e23, 1e23),
    "1e210": (float(jnp.power(jnp.float64(10.0), jnp.float64(210.0))),
              1e210, 1e210),
    "1e-310": (0.0, 1e-310, 1e-310),
    "2.5e-320": (0.0, 2.5e-320, 25 * float("1e-321")),
}


@pytest.mark.parametrize("text", list(XLA_POWER))
def test_double_power_gives_the_oracle_where_xla_is_off(text):
    """XLA's power is one ulp off at 10**23 and 10**210 and flushes a
    subnormal power to 0.0; the port takes 10**e from the correctly
    rounded table: the oracle's value, and for 2.5e-320 the mantissa 25
    times the subnormal 1e-321, which is not the oracle's either."""
    device, oracle, port = XLA_POWER[text]
    ref, _ = _reference("double", [text.encode()])
    assert float(ref[0]) == device != oracle
    assert float(text) == oracle
    vals, ok = CS.parse_double(DeviceColumn.from_strings([text]))
    assert bool(ok[0]) and float(vals[0]) == port
    assert (port == oracle) == (text != "2.5e-320")


def test_power_table_is_correctly_rounded():
    table = CS.pow10_table("cpu")
    assert table.shape == (2 * CS.POW10_SPAN + 1,)
    assert table[0] == 0.0 and table[-1] == float("inf")
    assert table[CS.POW10_SPAN].item() == 1.0
    assert [table[k + CS.POW10_SPAN].item() for k in (23, -310, 308)] == \
        [1e23, 1e-310, 1e308]


# -- the wrappers -------------------------------------------------------------

def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError, match="string column"):
        CS.parse_integral(DeviceColumn.from_pylist([1, 2], T.INT))
    with pytest.raises(TypeError, match="string_format"):
        CS.long_to_string(torch.zeros(3, dtype=torch.int32),
                          torch.ones(3, dtype=torch.bool))
    with pytest.raises(TypeError, match="string_format"):
        CS.date_to_string(torch.zeros(3, dtype=torch.int32),
                          torch.ones(2, dtype=torch.bool))
