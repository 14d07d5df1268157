"""The port's hash expressions (``hash``, ``xxhash64``, ``hive_hash``)
through GpuSession on the CPU, against the JAX package's CPU oracle
(``spark.rapids.sql.enabled=false``, the reference's Python row hashes)
on the same Arrow tables, and against the copied Python oracles of
``testing/hashes.py``.

The cases: tests/test_hashing_sketches.py :39-49 and :127-137 (xxhash64,
murmur3 and hive over its ``_df`` table: INT with nulls, LONG in
+-2**60, DOUBLE, the word pool with "" and a 21-byte UTF-8 row), FLOAT
(NaN, +-0.0, +-inf) and TIMESTAMP inputs, strings of 0, 3, 4, 7, 8, 31,
32, 33, 63, 64 and 200 bytes (every tail of XXH64's stripes, words and
bytes), a null row passing the running hash through, and the decimal
inputs the reference refuses.  Every hash is exact.
"""
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.expressions import hashing as JH

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import hash as HK
from spark_rapids_tpu_torch.testing import hashes as PH

ORACLE = {"spark.rapids.sql.enabled": "false"}
WORDS = ["", "a", "tpu", "hello world", "x" * 40, None,
         "日本語テキスト"]
LENGTHS = (0, 3, 4, 7, 8, 31, 32, 33, 63, 64, 200)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _df_tables(n=400):
    """tests/test_hashing_sketches.py ``_df`` (:23-36) as Arrow tables of
    128 rows, with ``f`` FLOAT and ``ts`` TIMESTAMP beside."""
    rng = np.random.RandomState(3)
    data = {
        "i": [int(v) if v % 7 else None
              for v in rng.randint(-10**6, 10**6, n)],
        "l": rng.randint(-2**60, 2**60, n).tolist(),
        "d": [float(v) for v in rng.uniform(-5, 5, n)],
        "s": [WORDS[v % len(WORDS)] for v in rng.randint(0, 100, n)],
        "g": rng.randint(0, 4, n).tolist(),
    }
    f = rng.randn(n).astype(np.float32)
    f[:5] = [np.nan, 0.0, -0.0, np.inf, -np.inf]
    ts = rng.randint(-631152000, 3786912000, n) * 1_000_000 + \
        rng.randint(0, 10**6, n)
    data["f"] = [None if k % 9 == 4 else float(v) for k, v in enumerate(f)]
    data["ts"] = [None if k % 10 == 3 else int(v) for k, v in enumerate(ts)]
    types = {"i": pa.int32(), "l": pa.int64(), "d": pa.float64(),
             "s": pa.string(), "g": pa.int32(), "f": pa.float32(),
             "ts": pa.timestamp("us", tz="UTC")}
    table = pa.table({k: pa.array(v, types[k]) for k, v in data.items()})
    return [table.slice(o, 128) for o in range(0, n, 128)]


TABLES = _df_tables()


def _both(build, tables=TABLES, parts=2):
    jdf = TpuSession(ORACLE).create_dataframe(
        [JaxBatch.from_arrow(t) for t in tables], num_partitions=parts)
    pdf = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in tables], num_partitions=parts)
    want = sorted(map(tuple, build(jdf, JE, JH).collect()), key=repr)
    got = sorted((tuple(map(_host, r)) for r in build(pdf, PE, PE).collect()),
                 key=repr)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):   # NaN equals NaN
        assert all(a == b or a != a and b != b for a, b in zip(g, w)), (g, w)
    return got


def _host(v):
    """A TIMESTAMP as the JAX package collects it: its microseconds."""
    if isinstance(v, datetime.datetime):
        return (v - _EPOCH_UTC) // datetime.timedelta(microseconds=1)
    return v


def test_xxhash64_expression_differential():
    _both(lambda df, E, H: df.select(
        H.XxHash64(E.col("i"), E.col("l"), E.col("d"), E.col("s"))
        .alias("h"), E.col("l")))


def test_murmur3_expression_differential():
    _both(lambda df, E, H: df.select(
        H.Murmur3Hash(E.col("i"), E.col("s")).alias("h"), E.col("l")))


def test_hive_hash_differential():
    _both(lambda df, E, H: df.select(
        H.HiveHash(E.col("i"), E.col("l"), E.col("d"), E.col("s"))
        .alias("h"), E.col("i")))


@pytest.mark.parametrize("col", ["f", "ts"])
@pytest.mark.parametrize("fn", ["XxHash64", "Murmur3Hash", "HiveHash"])
def test_float_and_timestamp_inputs(fn, col):
    """FLOAT hashes its bits (-0.0 as 0.0, NaN canonical), TIMESTAMP as a
    LONG; the port's rows also equal the copied Python oracles."""
    rows = _both(lambda df, E, H: df.select(
        getattr(H, fn)(E.col(col), E.col("i")).alias("h"), E.col(col),
        E.col("i")))
    oracle = {"XxHash64": PH.py_xxhash64_row, "Murmur3Hash":
              PH.py_murmur3_row, "HiveHash": PH.py_hive_hash_row}[fn]
    dtype = T.FLOAT if col == "f" else T.TIMESTAMP
    for h, v, i in rows:
        assert h == oracle([v, i], [dtype, T.INT]), (v, i)


def test_hash_is_never_null_and_takes_a_seed():
    df = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(t, "cpu") for t in TABLES])
    rows = df.select(PE.xxhash64("i"), PE.hash("i"), PE.hive_hash("i"),
                     PE.Murmur3Hash(PE.col("i"), seed=7)).collect()
    assert all(v is not None for r in rows for v in r)
    nulls = [r for r in rows if r[2] == 0]
    assert nulls and all(r[0] == 42 and r[1] == 42 for r in nulls)
    assert {r[3] for r in nulls} == {7}


def _strings(length: int, n: int = 24):
    """n rows of exactly ``length`` UTF-8 bytes (ASCII and 'é', whose bytes
    are >= 0x80), row 5 null."""
    rng = np.random.RandomState(length)
    rows = []
    for k in range(n):
        w = ""
        while len(w.encode()) < length:
            room = length - len(w.encode())
            w += "\u00e9" if room >= 2 and rng.rand() < 0.3 else chr(
                rng.randint(0x20, 0x7F))
        assert len(w.encode()) == length
        rows.append(None if k == 5 else w)
    return rows


@pytest.mark.parametrize("length", LENGTHS)
def test_string_lengths(length):
    """Every string length XXH64 treats apart (stripes, 8-byte words, one
    4-byte word, single bytes), bytes >= 0x80 (Hive's signed bytes), on a
    column whose offsets start past 0, chained after an INT: the port's
    three hashes against the copied oracles and the JAX package's."""
    rows = _strings(length)
    ints = list(range(len(rows)))
    col = DeviceColumn.from_strings(["pad"] + rows).slice_rows(1,
                                                               len(rows) + 1)
    ic = DeviceColumn.from_numpy(np.array(ints, np.int32), T.INT)
    got = {"xx": HK.xxhash64([ic, col]).tolist(),
           "mm": HK.murmur3_hash([ic, col]).tolist(),
           "hv": HK.hive_hash([ic, col]).tolist()}
    for r, (k, s) in enumerate(zip(ints, rows)):
        v = [k, None if s is None else s.encode("utf-8")]
        assert got["xx"][r] == PH.py_xxhash64_row(v, [T.INT, T.STRING])
        assert got["mm"][r] == PH.py_murmur3_row(v, [T.INT, T.STRING])
        assert got["hv"][r] == PH.py_hive_hash_row(v, [T.INT, T.STRING])
    table = pa.table({"k": pa.array(ints, pa.int32()),
                      "s": pa.array(rows, pa.string())})
    _both(lambda df, E, H: df.select(
        E.col("k"), H.XxHash64(E.col("k"), E.col("s")).alias("xx"),
        H.Murmur3Hash(E.col("k"), E.col("s")).alias("mm"),
        H.HiveHash(E.col("k"), E.col("s")).alias("hv")), [table], parts=1)


def test_decimal_inputs():
    """A Decimal128 input to xxhash64 and any decimal input to hive_hash
    raise, as the reference's kernels do; murmur3 takes both."""
    d64 = DeviceColumn.from_pylist([1, None, -5], T.DecimalType(10, 2))
    d128 = DeviceColumn.from_pylist([1, None, -5], T.DecimalType(30, 2))
    assert HK.xxhash64([d64]).shape == (3,)
    HK.murmur3_hash([d128])
    with pytest.raises(NotImplementedError, match="xxhash64"):
        HK.xxhash64([d128])
    for c in (d64, d128):
        with pytest.raises(NotImplementedError, match="hive_hash"):
            HK.hive_hash([c])


def test_subnormal_double_hashes_its_bits():
    """Pinned: the reference's device path reads a subnormal double as 0.0
    (XLA's CPU flushes it in ``x == 0.0``), so it hashes 5e-324 as 0.0;
    its oracle, Java and the port hash the value's own bits."""
    table = [pa.table({"x": pa.array([5e-324, 0.0], pa.float64())})]
    build = lambda df, E, H: df.select(   # noqa: E731
        H.XxHash64(E.col("x")).alias("xx"),
        H.Murmur3Hash(E.col("x")).alias("mm"),
        H.HiveHash(E.col("x")).alias("hv"))
    port = _both(build, table, parts=1)
    got = GpuSession(device="cpu").create_dataframe(
        [arrow_to_batch(table[0], "cpu")])
    assert build(got, PE, PE).collect()[0] == tuple(
        f([5e-324], [T.DOUBLE]) for f in (PH.py_xxhash64_row,
                                          PH.py_murmur3_row,
                                          PH.py_hive_hash_row))
    device = build(TpuSession({}).create_dataframe(
        [JaxBatch.from_arrow(table[0])]), JE, JH).collect()
    assert device[0] == device[1] != build(got, PE, PE).collect()[0]
    assert len(port) == 2
