"""Decimal128 keys in the port on the CPU: the sort key words (K2), the
murmur3 hash (K3), the group boundaries, the join's build words and the
range router over them.

K2's and K3's plain versions are held bit for bit against the JAX
package's ``kernels/sort.py`` ``_decimal128_data_keys`` and
``kernels/hash.py`` ``murmur3_hash`` over the edge values 0, +-1, +-255,
+-256, +-2**63, +-10**37, +-(10**38 - 1) and nulls, each JAX function run
at one padded size of 32 rows so that it compiles once; K3 also against
the JAX package's pure-Python ``py_murmur3_row`` (BigInteger.toByteArray
and murmur3).  ``tests/test_decimal128.py``'s key cases (:123 the sort,
:130 the group and join keys, :169 the hash) run against the JAX package's
CPU oracle, exact and, for the sort, in order.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.batch import Schema as JaxSchema
from spark_rapids_tpu.kernels import hash as JH
from spark_rapids_tpu.kernels import sort as JS
from spark_rapids_tpu.kernels.sort import SortOrder as JaxOrder

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import hash as PH
from spark_rapids_tpu_torch.kernels import join as PJ
from spark_rapids_tpu_torch.kernels import sort as PS
from spark_rapids_tpu_torch.kernels.groupby import _rows_equal_prev
from spark_rapids_tpu_torch.kernels.partition import (hash_partition,
                                                      range_partition)
from spark_rapids_tpu_torch.kernels.sort import SortOrder
from tests.test_torch_decimal128 import assert_rows, dec_dfs, port_rows

EDGES = [0, 1, -1, 255, -255, 256, -256, 2**63, -2**63, 10**37, -10**37,
         10**38 - 1, -(10**38 - 1), None]
PAD = 32        # the one size every JAX call sees
DT = (T.DecimalType(38, 2), JT.DecimalType(38, 2))


def _values(extra_seed=None):
    vals = list(EDGES)
    rng = np.random.RandomState(extra_seed or 0)
    while len(vals) < PAD:
        v = int(rng.randint(-2**62, 2**62)) * int(rng.randint(1, 2**40))
        vals.append(v if len(vals) % 5 else None)
    return vals


def _cols(vals):
    port = DeviceColumn.from_pylist(vals, DT[0], "cpu")
    jax = JaxBatch.from_pydict({"v": vals}, JaxSchema(("v",), (DT[1],)))
    return port, jax.columns[0]


def _u64_bits(a) -> list:
    return np.asarray(a).astype(np.uint64).view(np.int64).tolist()


@pytest.mark.parametrize("asc", [True, False])
def test_sort_key_words_match_reference(asc):
    """K2's plain version: the JAX package's two order words, bit for bit,
    nulls 0; order_words puts the null word before them."""
    vals = _values()
    port, jax = _cols(vals)
    got = PS.decimal128_sort_keys_plain(port, SortOrder(asc))
    want = JS._decimal128_data_keys(jax, JaxOrder(asc))
    assert got[0].tolist() == _u64_bits(want[0])[:PAD]
    assert got[1].tolist() == _u64_bits(want[1])[:PAD]
    words = PS.order_words(port, SortOrder(asc, nulls_first=False))
    assert torch.equal(words[1:], got)
    assert words[0].tolist() == [int(v is None) for v in vals]


def test_sort_key_words_order_int128():
    """The two words, compared as unsigned (high word first), order the
    values as Python ints: the sort and the router agree with int128."""
    vals = [v for v in _values(1) if v is not None]
    port, _ = _cols(vals)
    w = PS.decimal128_sort_keys_plain(port, SortOrder(True))
    u = (w.numpy().view(np.uint64))
    order = np.lexsort((u[1], u[0]))
    assert [vals[i] for i in order] == sorted(vals)
    idx = PS.sort_indices(ColumnarBatch((port,), len(vals), Schema(
        ("v",), (DT[0],))), [0], [SortOrder(False)])
    assert [vals[i] for i in idx.tolist()] == sorted(vals, reverse=True)
    bounds = torch.stack([w[:, i] for i in order[[5, 20]]])
    route_order, counts = range_partition(w, bounds, 3)
    routed = [vals[i] for i in route_order.tolist()]
    lo, hi = sorted(vals)[5], sorted(vals)[20]
    assert counts.tolist() == [sum(v < lo for v in vals),
                               sum(lo <= v < hi for v in vals),
                               sum(v >= hi for v in vals)]
    assert routed[:counts[0]] == [v for v in vals if v < lo]


@pytest.mark.parametrize("seed", [42, 0x5F3759DF])
def test_hash_matches_reference(seed):
    """K3's plain version against the JAX package's murmur3_hash, alone
    and chained after an INT column, and against its Python oracle."""
    vals = _values()
    port, jax = _cols(vals)
    ints = list(range(-16, 16))
    pi = DeviceColumn.from_pylist(ints, T.INT, "cpu")
    ji = JaxBatch.from_pydict({"i": ints}, JaxSchema(("i",), (JT.INT,)))
    got = PH.murmur3_hash([port], seed).tolist()
    assert got == np.asarray(JH.murmur3_hash([jax], seed)).tolist()[:PAD]
    chained = PH.murmur3_hash([pi, port], seed).tolist()
    assert chained == np.asarray(JH.murmur3_hash(
        [ji.columns[0], jax], seed)).tolist()[:PAD]
    for v, h in zip(vals, got):
        assert h == java_murmur3(v, seed)
        # the JAX package's Python oracle takes -2**63's bit_length (64) for
        # Java's bitLength() (63), so it hashes 9 bytes where Java (and both
        # packages' kernels) hash 8 (ROADMAP queue 3)
        if v != -2**63:
            assert h == JH.py_murmur3_row([v], [DT[1]], seed)
    assert java_murmur3(-2**63, seed) != JH.py_murmur3_row(
        [-2**63], [DT[1]], seed)


def to_byte_array(v: int) -> bytes:
    """Java's BigInteger.toByteArray(): bitLength() excludes the sign bit
    (for a negative value it is the bit length of ~v)."""
    bits = (v if v >= 0 else ~v).bit_length()
    return v.to_bytes(bits // 8 + 1, "big", signed=True)


def java_murmur3(v, seed=42) -> int:
    """Spark's hash of a Decimal128 value (None: the seed)."""
    if v is None:
        h = seed & 0xFFFFFFFF
        return h - 2**32 if h >= 2**31 else h
    return _hash_bytes(to_byte_array(v), seed)


def _hash_bytes(b: bytes, seed: int) -> int:
    m = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m

    def mix(h, k):
        k = rotl((k * 0xCC9E2D51) & m, 15) * 0x1B873593 & m
        return (rotl(h ^ k, 13) * 5 + 0xE6546B64) & m
    h = seed & m
    aligned = len(b) // 4 * 4
    for i in range(0, aligned, 4):
        h = mix(h, int.from_bytes(b[i:i + 4], "little"))
    for x in b[aligned:]:
        h = mix(h, (x - 256 if x >= 128 else x) & m)
    h ^= len(b)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    h ^= h >> 16
    return h - 2**32 if h >= 2**31 else h


def test_decimal128_hash_device_matches_python():
    """tests/test_decimal128.py:169 on the port's hash (BigInteger bytes)."""
    vals = [0, 1, -1, 255, -256, 10**20, -(10**20), 1 << 100, -(1 << 100),
            10**37, -(10**37), None]
    dt = T.DecimalType(38, 0)
    h = PH.murmur3_hash([DeviceColumn.from_pylist(vals, dt, "cpu")])
    for i, v in enumerate(vals):
        if v is not None:
            assert int(h[i]) == JH.py_murmur3_row(
                [v], [JT.DecimalType(38, 0)]) == java_murmur3(v), v


def test_hash_partition_routes_as_reference():
    """A Decimal128 key shuffles: pmod of the reference's hash."""
    vals = _values()
    port, jax = _cols(vals)
    b = ColumnarBatch((port,), PAD, Schema(("v",), (DT[0],)))
    reordered, counts = hash_partition(b, [0], 5)
    want = np.mod(np.asarray(JH.murmur3_hash([jax]))[:PAD], 5)
    assert counts.tolist() == np.bincount(want, minlength=5).tolist()
    order = np.argsort(want, kind="stable")
    assert reordered.columns[0].to_pylist() == [vals[i] for i in order]


def test_group_boundaries_and_join_words():
    """Equal values (a null slot holding garbage too) compare equal; the
    join's build words are K2's two words."""
    vals = [5, 5, None, None, -5, 10**37, 10**37]
    col = DeviceColumn.from_pylist(vals, DT[0], "cpu")
    col.data[2] = torch.tensor([7, 9])        # garbage under a null
    assert _rows_equal_prev(col).tolist() == [True, False, True, False,
                                              False, True]
    words, valid = PJ.key_words_plain([col], [None])
    k2 = PS.decimal128_sort_keys_plain(col, SortOrder(True))
    assert torch.equal(words[valid], k2.t()[valid])
    assert valid.tolist() == [v is not None for v in vals]


@pytest.mark.parametrize("asc", [True, False])
def test_decimal128_sort(asc):
    """tests/test_decimal128.py:123, in order (the row index breaks ties
    so the order is total)."""
    pdf, jdf = dec_dfs()
    q = (lambda df, E, O: df.order_by(("a", O(asc)), ("k", O(True)),
                                      ("b", O(True)), ("c", O(True))))
    assert_rows(port_rows(q(pdf, PE, SortOrder)),
                q(jdf, JE, JaxOrder).collect(), ordered=True)


def test_decimal128_group_and_join_keys():
    """tests/test_decimal128.py:130: a left join on a Decimal128 key and a
    GROUP BY of one."""
    pl, jl = dec_dfs(n=120)
    pr, jr = dec_dfs(n=60, seed=12, parts=1)

    def join(l, r, E):
        return l.join(r.select(E.col("a").alias("a2"),
                               E.col("k").alias("k2")),
                      on=([E.col("a")], [E.col("a2")]), how="left")
    assert_rows(port_rows(join(pl, pr, PE)), join(jl, jr, JE).collect())
    pdf, jdf = dec_dfs()
    assert_rows(port_rows(pdf.group_by("a").agg(PE.count().alias("n"))),
                jdf.group_by("a").agg(JE.count().alias("n")).collect())
