"""The port's string columns and string kernels against the JAX package's,
on the CPU.

Arrow round trip, gather, concat and slice, murmur3, sort_indices and
group_rows over STRING columns: on CPU tensors each wrapper runs its plain
PyTorch version, which must equal the reference on the same seeded input.
Everything here is exact: strings, offsets, hashes, permutations and
groups.  chip_smoke.py holds the CUDA kernels against these plain
versions on the card.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import groupby as jgb
from spark_rapids_tpu.kernels import hash as jhash
from spark_rapids_tpu.kernels import selection as jsel
from spark_rapids_tpu.kernels import sort as jsort

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels import hash as H
from spark_rapids_tpu_torch.kernels import selection as S
from spark_rapids_tpu_torch.kernels import sort as SK
from spark_rapids_tpu_torch.shuffle.transport import slice_batch

# one- to three-byte UTF-8 (bytes >= 0x80), NUL, and a shared prefix
ALPHABET = ["a", "b", "z", "\x00", "é", "ÿ", "中", "Brand#", "€"]
EDGES = ["ab", "ab\x00", "ab\x00\x00", "abc", "", None, "ÿ", "\x7f",
         "Brand#18", "Brand#188"]


def _strings(rng, n: int, null_frac: float = 0.1, max_parts: int = 6):
    out = []
    for _ in range(n):
        if rng.rand() < null_frac:
            out.append(None)
        else:
            k = rng.randint(0, max_parts + 1)
            out.append("".join(ALPHABET[j] for j in
                               rng.randint(0, len(ALPHABET), k)))
    return out + EDGES


def _table(seed: int, n: int = 600, distinct: int = 0):
    """A string column ``s`` (drawn from ``distinct`` values when given,
    so that groups repeat), an int column ``k`` and a double ``v``."""
    rng = np.random.RandomState(seed)
    if distinct:
        pool = _strings(rng, distinct)
        s = [pool[i] for i in rng.randint(0, len(pool), n)]
    else:
        s = _strings(rng, n)
    m = len(s)
    return pa.table({"s": pa.array(s, pa.string()),
                     "k": pa.array(rng.randint(0, 4, m).astype(np.int32),
                                   mask=rng.rand(m) < 0.1),
                     "v": pa.array(rng.uniform(-1, 1, m))})


def _both(table):
    return JaxBatch.from_arrow(table), arrow_to_batch(table, "cpu")


def _longest(table) -> int:
    return max(len(x.encode()) for x in table.column("s").to_pylist()
               if x is not None)


# -- Arrow ---------------------------------------------------------------------


@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("offset", [0, 7])
def test_arrow_round_trip_is_exact(large, offset):
    """utf8 and large_utf8 in, utf8 out, equal to the input and to the JAX
    package's round trip; a sliced Arrow array (its offsets start past 0)
    comes in rebased."""
    table = _table(seed=1 + offset)
    if large:
        table = table.set_column(0, "s", table.column("s").cast(
            pa.large_string()))
    table = table.slice(offset)
    got = arrow_to_batch(table, "cpu")
    s = got.column("s")
    assert got.schema.dtype_of("s") == PT.STRING
    assert s.data.dtype == torch.uint8 and s.offsets.dtype == torch.int32
    assert int(s.offsets[0]) == 0
    lengths = (s.offsets[1:] - s.offsets[:-1]).numpy()
    assert not lengths[~s.validity.numpy()].any()   # a null row is empty
    want = table.set_column(0, "s", table.column("s").cast(pa.string()))
    assert got.to_arrow().equals(want)
    assert got.to_arrow().equals(JaxBatch.from_arrow(table).to_arrow())


def test_null_slot_with_bytes_loses_them():
    """Arrow lets a null slot own bytes; the port's null row is empty."""
    valid = pa.array([True, False, True]).buffers()[1]
    arr = pa.Array.from_buffers(pa.string(), 3, [
        valid, pa.py_buffer(np.array([0, 2, 4, 5], np.int32)),
        pa.py_buffer(b"abcde")])
    col = arrow_to_batch(pa.table({"s": arr}), "cpu").columns[0]
    assert col.offsets.tolist() == [0, 2, 2, 3]
    assert col.to_pylist() == ["ab", None, "e"]


def test_from_pydict_and_from_strings():
    b = ColumnarBatch.from_pydict({"s": ["x", None, "中"], "k": [1, 2, None]},
                                  Schema.of(s=PT.STRING, k=PT.INT), "cpu")
    assert b.rows() == [("x", 1), (None, 2), ("中", None)]
    c = DeviceColumn.from_strings(["x", None, "中"])
    assert c.offsets.tolist() == [0, 1, 1, 4]
    assert torch.equal(c.data, b.columns[0].data)
    with pytest.raises(ValueError, match="offsets"):
        DeviceColumn(c.data, c.validity, PT.STRING, c.offsets[:-1])

# -- gather, concat and slice -------------------------------------------------


@pytest.mark.parametrize("case", ["permutation", "repeats_and_out_of_range",
                                  "empty"])
def test_string_gather_matches_reference(case):
    table = _table(seed=3)
    jb, pb = _both(table)
    n = table.num_rows
    rng = np.random.RandomState(4)
    idx = {"permutation": rng.permutation(n),
           "repeats_and_out_of_range": rng.randint(-3, n + 3, 2 * n),
           "empty": np.zeros(0, np.int64)}[case].astype(np.int32)
    m = len(idx)
    ref = jsel.gather_column(jb.columns[0], np.asarray(idx), np.int32(m),
                             out_capacity=max(m, 1),
                             out_byte_capacity=8 * 2 * n * 8)
    got = S.gather_columns([pb.columns[0], pb.columns[1]],
                           torch.from_numpy(idx))
    assert got[0].to_pylist() == ref.to_pylist(m)
    assert got[1].to_pylist() == [table.column("k")[int(i)].as_py()
                                  if 0 <= i < n else None for i in idx]
    assert int(got[0].offsets[0]) == 0


def test_string_slice_and_concat_match_reference():
    """Shuffle blocks are views (their offsets do not start at 0); concat
    rebases them, as the reference's concat_batches_device does."""
    table = _table(seed=5)
    jb, pb = _both(table)
    n = table.num_rows
    cuts = [0, 1, 1, 90, 300, n]
    blocks = [slice_batch(pb, a, b - a) for a, b in zip(cuts, cuts[1:])]
    assert int(blocks[2].columns[0].offsets[0]) > 0
    for blk, a in zip(blocks, cuts):
        assert blk.rows() == pb.rows()[a:a + blk.num_rows]
    order = [4, 0, 2, 1, 3]
    got = S.concat_batches_device([blocks[i] for i in order])
    ref_parts = [JaxBatch.from_arrow(table.slice(cuts[i],
                                                 cuts[i + 1] - cuts[i]))
                 for i in order]
    ref, _ = jsel.concat_batches_device(ref_parts, out_capacity=n)
    assert got.to_arrow().equals(ref.to_arrow())
    assert got.columns[0].offsets.tolist() == S.concat_column_plain(
        [blocks[i].columns[0] for i in order]).offsets.tolist()
    assert int(got.columns[0].offsets[-1]) == got.columns[0].data.shape[0]

# -- murmur3 --------------------------------------------------------------------


def test_string_murmur3_spark_known_values():
    """Spark: hash('ABC') = -757602832 (tests/test_kernels.py:32), and an
    empty string is not a null."""
    col = DeviceColumn.from_strings(["ABC", "", None])
    assert H.murmur3_hash([col]).tolist() == [-757602832, 142593372, 42]


@pytest.mark.parametrize("with_ints", [False, True])
def test_string_murmur3_matches_reference(with_ints):
    """Words, sign-extended tail bytes (UTF-8 >= 0x80), nulls; alone and
    chained between an int and a double column."""
    table = _table(seed=6)
    jb, pb = _both(table)
    keys = [1, 0, 2] if with_ints else [0]
    ref = np.asarray(jhash.murmur3_hash([jb.columns[i] for i in keys],
                                        string_max_bytes=_longest(table)))
    got = H.murmur3_hash([pb.columns[i] for i in keys])
    np.testing.assert_array_equal(got.numpy(), ref[:table.num_rows])
    _, part = H.murmur3_partition([pb.columns[i] for i in keys], 16)
    np.testing.assert_array_equal(
        part.numpy(), np.asarray(jhash.pmod(ref, 16))[:table.num_rows])

# -- sort_indices ---------------------------------------------------------------


@pytest.mark.parametrize("ascending,nulls_first", [(True, True),
                                                   (True, False),
                                                   (False, True),
                                                   (False, False)])
def test_string_sort_indices_matches_reference(ascending, nulls_first):
    """Spark's binaryCompare: unsigned bytes, a prefix first ("ab" before
    "ab\\0"); repeated values keep their order (the sort is stable)."""
    table = _table(seed=7, distinct=40)
    jb, pb = _both(table)
    order = SK.SortOrder(ascending, nulls_first)
    ref = np.asarray(jsort.sort_indices(
        jb, [0], [jsort.SortOrder(ascending, nulls_first)]))
    got = SK.sort_indices(pb, [0], [order])
    np.testing.assert_array_equal(got.numpy(), ref[:table.num_rows])


def test_string_sort_two_keys_and_binary_order():
    table = _table(seed=8, distinct=25)
    jb, pb = _both(table)
    ref = np.asarray(jsort.sort_indices(
        jb, [1, 0], [jsort.SortOrder(False), jsort.SortOrder(True, False)]))
    got = SK.sort_indices(pb, [1, 0], [SK.SortOrder(False),
                                       SK.SortOrder(True, False)])
    np.testing.assert_array_equal(got.numpy(), ref[:table.num_rows])
    edge = DeviceColumn.from_strings(["ab\x00", "abc", "ab", "ab\x00\x00",
                                      "ÿ", "z"])
    b = ColumnarBatch((edge,), 6, Schema(("s",), (PT.STRING,)))
    assert SK.sort_indices(b, [0], [SK.SortOrder()]).tolist() == \
        [2, 0, 3, 1, 5, 4]


def test_string_sort_keys_are_big_endian_chunks():
    col = DeviceColumn.from_strings(["abcdefghi", None, "", "\xff"])
    chunks, lengths = SK.string_sort_keys(col, 9)
    assert chunks.shape == (2, 4)
    assert lengths.tolist() == [9, 0, 0, 2]
    assert chunks[0, 0].item() == int.from_bytes(b"abcdefgh", "big")
    assert chunks[1, 0].item() == int.from_bytes(b"i" + b"\0" * 7, "big")
    assert chunks[0, 3].item() == int.from_bytes(b"\xc3\xbf" + b"\0" * 6,
                                                 "big") - 2**64
    assert not chunks[:, 1:3].any()

# -- group_rows -----------------------------------------------------------------


@pytest.mark.parametrize("keys", [[0], [1, 0]])
def test_string_group_rows_matches_reference(keys):
    """Null strings form one group, "" another; "ab" and "ab\\0" differ."""
    table = _table(seed=9, n=800, distinct=30)
    jb, pb = _both(table)
    ref = jgb.group_rows(jb, keys)
    got = G.group_rows(pb, keys)
    g = int(ref.num_groups)
    assert got.num_groups == g
    n = table.num_rows
    np.testing.assert_array_equal(
        got.starts.numpy(), np.flatnonzero(np.asarray(ref.boundary)[:n]))
    ref_keys = jgb.group_keys_output(ref, keys)
    got_keys = G.group_keys_output(got, keys)
    for gc, rc in zip(got_keys, ref_keys):
        assert gc.to_pylist() == rc.to_pylist(g)
    s = got_keys[keys.index(0)].to_pylist()
    if keys == [0]:
        assert s.count(None) == 1 and s.count("") == 1
        assert "ab" in s and "ab\x00" in s


def test_string_rows_equal_prev_plain():
    col = DeviceColumn.from_strings(["a", "a", None, None, "", "", "ab",
                                     "ab\x00", "é", "é"])
    assert G.string_rows_equal_prev(col).tolist() == [
        True, False, True, False, True, False, False, False, True]


def test_string_wrappers_never_fall_back_off_the_cpu():
    """Off the CPU the string paths take their CUDA kernels, which raise
    for anything but a CUDA tensor; only CUDA launches count."""
    col = DeviceColumn.from_strings(["a", "bc", None])
    meta = DeviceColumn(col.data.to("meta"), col.validity.to("meta"),
                        PT.STRING, col.offsets.to("meta"))
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    for call in (lambda: S.gather_columns([meta], idx),
                 lambda: S.concat_column([meta, meta]),
                 lambda: H.murmur3_hash([meta]),
                 lambda: SK.string_sort_keys(meta, 2),
                 lambda: G.string_rows_equal_prev(meta)):
        with pytest.raises(ValueError, match="expected cuda"):
            call()
    assert not any(_lib.LAUNCHES.get(k) for k in (
        "gather_strings", "concat_strings", "hash_string",
        "string_sort_keys", "string_rows_equal_prev"))
