"""The plain versions of this slice's four kernels against the JAX
package's kernel functions, on the CPU.

T1 ``utc_to_local`` and T2 ``local_to_utc`` (``kernels/timezone.py``)
against ``spark_rapids_tpu/kernels/timezone.py`` ``utc_to_local_micros``
(:74) and ``local_to_utc_micros`` (:84), and the port's copy of
``zone_table`` (:30) against the reference's, in five zones (half-hour
and no DST, Lord Howe's 30-minute DST, the US and European rules, UTC):
random instants over 1900-2100, every transition and the microseconds
around it (the gaps and overlaps of T2), and the ends of the table.  H1
``xxhash64`` and H2 ``hive_hash`` (``kernels/hash.py``) against the
reference's ``xxhash64`` (:529) and ``hive_hash`` (:696) over BOOLEAN,
BYTE, SHORT, INT, DATE, LONG, TIMESTAMP, Decimal64, FLOAT and DOUBLE
(NaN, +-0.0, +-inf, the integer extremes) and strings of 0-200 bytes, 10% nulls, chained over several columns.  All exact.  (A
subnormal double is left out here: XLA's CPU reads it as 0.0, see
tests/test_torch_hashing.py ``test_subnormal_double_hashes_its_bits``.)

The reference runs at one padded size (CAP rows; a zone's table padded
to TABLE_CAP entries by instants past every value, each holding the last
offset, which changes no result), each function under ``jax.jit`` once.
chip_smoke.py holds the CUDA kernels against these plain versions on the
card.
"""
import decimal
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import hash as JHK
from spark_rapids_tpu.kernels import timezone as JTZ

from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels import hash as HK
from spark_rapids_tpu_torch.kernels import timezone as TZ

CAP = 2048            # rows of a hash case
SHIFT_CAP = 8192      # instants of a shift case: every transition's edges
TABLE_CAP = 512
ZONES = ("America/Los_Angeles", "Asia/Kolkata", "Australia/Lord_Howe",
         "Europe/Berlin", "UTC")
STRING_MAX = 256


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("tz", ZONES)
def test_zone_table_is_the_reference_table(tz):
    got, want = TZ.zone_table(tz), JTZ.zone_table(tz)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == np.int64
    assert np.array_equal(got[1], want[1]) and got[1].dtype == np.int32


def _instants(tz: str, seed: int = 0) -> np.ndarray:
    """SHIFT_CAP int64 microseconds: each transition and around it (-1 h, -1 s,
    -1 us, 0, +1 us, +1 s, +1 h, also read as a wall time), the table's
    ends, then random instants over 1900-2100."""
    trans, offs = TZ.zone_table(tz)
    rng = np.random.RandomState(seed)
    edges = []
    for t, o in zip(trans[1:].tolist(), offs[1:].tolist()):
        for base in (t, t + o):
            for d in (-3_600_000_000, -1_000_000, -1, 0, 1, 1_000_000,
                      3_600_000_000):
                edges.append(base * 1_000_000 + d)
    edges += [-2208988800 * 1_000_000 - 1, 4102444800 * 1_000_000 + 5,
              -1, 0, 1]
    edges = np.array(edges, np.int64)
    assert len(edges) < SHIFT_CAP
    rest = rng.randint(-2208988800, 4102444800, SHIFT_CAP - len(edges)) \
        * 1_000_000 + rng.randint(0, 10**6, SHIFT_CAP - len(edges))
    return np.concatenate([edges, rest]).astype(np.int64)


def _padded(tz: str):
    trans, offs = JTZ.zone_table(tz)
    pad = TABLE_CAP - len(trans)
    far = np.iinfo(np.int64).max // 4 + np.arange(pad, dtype=np.int64)
    return (jnp.asarray(np.concatenate([trans, far])),
            jnp.asarray(np.concatenate([offs, np.repeat(offs[-1:], pad)])))


@functools.lru_cache(maxsize=None)
def _jit(fn):
    return jax.jit(fn)


@pytest.mark.parametrize("tz", ZONES)
@pytest.mark.parametrize("which", ["utc_to_local", "local_to_utc"])
def test_shift_plain_matches_reference(which, tz):
    x = _instants(tz, seed=len(tz))
    ref = {"utc_to_local": JTZ.utc_to_local_micros,
           "local_to_utc": JTZ.local_to_utc_micros}[which]
    want = np.asarray(_jit(ref)(jnp.asarray(x), *_padded(tz)))
    port = {"utc_to_local": TZ.utc_to_local_micros,
            "local_to_utc": TZ.local_to_utc_micros}[which]
    got = port(torch.from_numpy(x), tz).numpy()
    assert np.array_equal(got, want), np.flatnonzero(got != want)[:5]


def test_device_table_is_cached_per_zone_and_device():
    a = TZ.device_table("Asia/Kolkata", "cpu")
    assert TZ.device_table("Asia/Kolkata", torch.device("cpu")) is a
    assert TZ.device_table("Europe/Berlin", "cpu") is not a
    assert a.entries == len(TZ.zone_table("Asia/Kolkata")[0])
    assert torch.equal(a.wall_old_end, a.transitions + a.prev_off.long())


def _utf8_row(rng, length: int) -> str:
    """A row of exactly ``length`` UTF-8 bytes: ASCII and 'é' (bytes
    >= 0x80)."""
    w = ""
    while len(w.encode()) < length:
        room = length - len(w.encode())
        w += "\u00e9" if room >= 2 and rng.rand() < 0.3 else chr(
            rng.randint(0x20, 0x7F))
    return w


def _hash_table(seed: int, n: int = CAP) -> pa.Table:
    """Every fixed-width kind and a string column, 10% nulls each."""
    rng = np.random.RandomState(seed)
    valid = lambda: rng.rand(n) >= 0.1   # noqa: E731

    def arr(vals, typ):
        return pa.array(vals, typ, mask=~valid())

    i32 = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    i32[:3] = [-2**31, 2**31 - 1, 0]
    i64 = rng.randint(-2**63, 2**63 - 1, n, dtype=np.int64)
    i64[:3] = [-2**63, 2**63 - 1, -1]
    f64 = rng.randn(n) * 1e3
    f64[:6] = [np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-300]
    f32 = rng.randn(n).astype(np.float32)
    f32[:5] = [np.nan, 0.0, -0.0, np.inf, -np.inf]
    lengths = rng.randint(0, 201, n)
    lengths[:11] = [0, 3, 4, 7, 8, 31, 32, 33, 63, 64, 200]
    words = [_utf8_row(rng, k) for k in lengths]
    return pa.table({
        "b": arr(rng.rand(n) < 0.5, pa.bool_()),
        "y": arr(rng.randint(-128, 128, n).astype(np.int8), pa.int8()),
        "h": arr(rng.randint(-2**15, 2**15, n).astype(np.int16), pa.int16()),
        "i": arr(i32, pa.int32()),
        "dt": arr(rng.randint(-800_000, 3_000_000, n).astype(np.int32),
                  pa.int32()).cast(pa.date32()),
        "l": arr(i64, pa.int64()),
        "ts": arr(i64 // 1000, pa.int64()).cast(pa.timestamp("us", "UTC")),
        "dec": arr([decimal.Decimal(int(v)).scaleb(-2) for v in i64 // 1000],
                   pa.decimal128(18, 2)),
        "f": arr(f32, pa.float32()),
        "x": arr(f64, pa.float64()),
        "s": pa.array(words, pa.string(), mask=~valid()),
    })


HASH_CASES = {
    "fixed": ("b", "y", "h", "i", "dt", "l", "ts", "f", "x"),
    "strings": ("s", "i", "s"),
    "mixed": ("i", "l", "x", "s", "ts", "f"),
    "decimal64": ("dec", "l"),
}


def _reference_hash(name: str, table: pa.Table) -> np.ndarray:
    cols = list(JaxBatch.from_arrow(table, capacity=CAP).columns)
    if name == "xxhash64":
        fn = functools.partial(JHK.xxhash64, string_max_bytes=STRING_MAX)
    else:
        fn = functools.partial(JHK.hive_hash, string_max_bytes=STRING_MAX)
    return np.asarray(_jit(fn)(cols))[:table.num_rows]


@pytest.mark.parametrize("name, case", [
    (name, case) for name in ("xxhash64", "hive_hash")
    for case in sorted(HASH_CASES)
    if not (name == "hive_hash" and case == "decimal64")])   # hive: no decimal
def test_hash_plain_matches_reference(name, case):
    table = _hash_table(seed=len(case)).select(list(dict.fromkeys(
        HASH_CASES[case])))
    table = pa.table([table.column(c) for c in HASH_CASES[case]],
                     names=[f"c{j}" for j in range(len(HASH_CASES[case]))])
    want = _reference_hash(name, table)
    cols = list(arrow_to_batch(table, "cpu").columns)
    got = getattr(HK, name)(cols).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want), np.flatnonzero(got != want)[:5]
