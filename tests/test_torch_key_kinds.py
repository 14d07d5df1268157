"""The last key kinds of the port on the CPU, against the JAX package:
BYTE and SHORT keys, and the split-tolerant string grouping key (K3).

BYTE and SHORT sort (both directions, nulls first and last) and hash
(the values of ``tests/test_kernels.py:38-39``, sign-extended to int as
Spark does) as the reference's ``sort_indices`` :200 and ``murmur3_hash``
:237 do, and the pure-Python Spark oracle beside; they group, join, and
take MIN / MAX and VARIANCE as the reference's CPU oracle
(``spark.rapids.sql.enabled=false``) does, over the tail's table
(``testing/held.py`` ``tail_columns(700, 3)``, tests/test_agg_tail.py's
``_data``, with ``h`` SHORT) and the 256-row BYTE dimension.  K3's plain
version is the reference's ``_string_hash_key`` :183 bit for bit at
``max_bytes`` 7, 14 and 64 (the chunk counts 1, 2 and 10), and a partial
aggregate whose string hash is forced to collide (the plain version
patched to a constant) still gives the reference's final rows: a
collision splits a group, never merges two.  The JAX kernels run at one
size (64 rows).

Tolerance: exact; the variances within 1e-9 relative (tests/test_queries.py
``_eq_val``).
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import hash as jhash
from spark_rapids_tpu.kernels import sort as jsort
from tests.test_queries import _eq_val, _normalize

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels import hash as H
from spark_rapids_tpu_torch.kernels import sort as S
from spark_rapids_tpu_torch.testing import held

ORACLE = {"spark.rapids.sql.enabled": "false"}
RANGES = {"byte": (pa.int8(), -128, 127), "short": (pa.int16(), -32768,
                                                    32767)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six pytest workers' torch thread pools contend: one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _narrow_table(kind: str, n: int = 64, seed: int = 3) -> pa.Table:
    """n values over the type's range, its extremes, -1 and 0 first and
    duplicates, 15% null."""
    typ, lo, hi = RANGES[kind]
    rng = np.random.RandomState(seed)
    v = rng.randint(lo, hi + 1, n)
    v[:4] = [lo, hi, -1, 0]
    v[4:12] = v[12:20]
    mask = rng.rand(n) < 0.15
    mask[:4] = False
    return pa.table({"k": pa.array(v, typ, mask=mask)})


@pytest.mark.parametrize("kind", list(RANGES))
def test_narrow_keys_sort_as_the_reference(kind):
    table = _narrow_table(kind)
    jb, pb = JaxBatch.from_arrow(table), arrow_to_batch(table, "cpu")
    for asc, nulls_first in ((True, True), (True, False), (False, True),
                             (False, False)):
        want = np.asarray(jsort.sort_indices(
            jb, [0], [jsort.SortOrder(asc, nulls_first)],
            string_max_bytes=8))[:table.num_rows]
        got = S.sort_indices(pb, [0], [S.SortOrder(asc, nulls_first)])
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{kind} {asc} {nulls_first}")


@pytest.mark.parametrize("kind,vals", [
    ("short", [0, 1, -1, 32767, -32768, None]),
    ("byte", [0, 1, -1, 127, -128, None])])
def test_narrow_keys_hash_as_spark(kind, vals):
    """tests/test_kernels.py:38-39: the port's murmur3 equals the
    reference's and the pure-Python Spark oracle's (hashInt of the value
    sign-extended to int; a null keeps the seed)."""
    typ = RANGES[kind][0]
    table = pa.table({"k": pa.array(vals, typ)})
    got = H.murmur3_hash([arrow_to_batch(table, "cpu").columns[0]])
    jb = JaxBatch.from_arrow(table)
    want = np.asarray(jhash.murmur3_hash([jb.columns[0]]))[:len(vals)]
    np.testing.assert_array_equal(got.numpy(), want)
    jt = jb.schema.dtypes[0]
    assert got.tolist() == [jhash.py_murmur3_row([v], [jt]) for v in vals]
    part = H.murmur3_partition([arrow_to_batch(table, "cpu").columns[0]],
                               16)[1]
    assert part.tolist() == [h % 16 for h in got.tolist()]


def _tail(sess, make, n=700):
    data, validity = held.tail_columns(n, 3)
    batches = held.tail_batches(data, validity, "cpu", 200, with_short=True)
    df = sess.create_dataframe([make(b) for b in batches], num_partitions=3)
    dim = sess.create_dataframe([make(held.byte_dimension("cpu"))])
    return df, dim


def _same(got, want, ordered: bool):
    if not ordered:
        got, want = _normalize(got), _normalize(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_eq_val(a, b) for a, b in zip(g, w)), \
            (g, w)


@pytest.mark.parametrize("conf", [None, {"spark.sql.shuffle.partitions": "5",
                                         "spark.rapids.sql.tpu.fuseStages":
                                         "false"}],
                         ids=["default", "unfused_5_parts"])
@pytest.mark.parametrize("name", list(held.TAIL_KEY_QUERIES))
def test_narrow_key_queries_match_oracle(name, conf):
    """GROUP BY b and h (ordered by them), MIN / MAX / VARIANCE of b by
    k, and the inner join on b against the BYTE dimension."""
    build = held.TAIL_KEY_QUERIES[name]
    jdf, jdim = _tail(TpuSession(ORACLE),
                      lambda b: JaxBatch.from_arrow(b.to_arrow()))
    pdf, pdim = _tail(GpuSession(conf, device="cpu"), lambda b: b)
    if name == "join_on_byte":
        got, want = build(pdf, pdim).collect(), build(jdf, jdim, JE).collect()
    else:
        got, want = build(pdf).collect(), build(jdf, JE).collect()
    _same(got, want, ordered=name in ("group_by_byte", "group_by_short"))
    assert got and (name != "group_by_byte" or got[0][0] is None)


@pytest.mark.parametrize("kind", list(RANGES))
def test_narrow_join_keys_match_oracle(kind):
    """Every join type on a BYTE or a SHORT key, against the oracle."""
    left, right = _narrow_table(kind, 60, 4), _narrow_table(kind, 30, 5)
    left = left.append_column("lv", pa.array(np.arange(60, dtype=np.int64)))
    right = right.append_column("rv", pa.array(np.arange(30,
                                                         dtype=np.int64)))
    port, ora = GpuSession(device="cpu"), TpuSession(ORACLE)
    for how in ("inner", "left", "right", "full", "left_semi", "left_anti"):
        got = port.create_dataframe(left, num_partitions=2).join(
            port.create_dataframe(right), "k", how=how).collect()
        want = ora.create_dataframe(
            [JaxBatch.from_arrow(left)], num_partitions=2).join(
            ora.create_dataframe([JaxBatch.from_arrow(right)]), "k",
            how=how).collect()
        _same(got, want, ordered=False)


def _strings(n: int = 64, seed: int = 7) -> pa.Table:
    """Strings of 0-70 bytes (UTF-8, bytes >= 0x80 among them) with the
    binaryCompare edges and nulls."""
    rng = np.random.RandomState(seed)
    edges = ["", "a", "ab", "ab\x00", "ab\x00\x00", "é" * 20, "\x7f"]
    vals = edges + ["".join(chr(c) for c in rng.randint(
        0x20, 0x250, rng.randint(0, 36))) for _ in range(n - len(edges))]
    mask = rng.rand(n) < 0.1
    mask[:len(edges)] = False
    return pa.table({"s": pa.array(vals, pa.string(), mask=mask)})


@pytest.mark.parametrize("max_bytes", [7, 14, 64])
def test_string_hash_key_plain_is_the_reference(max_bytes):
    """K3's plain version against ``_string_hash_key``, bit for bit, at
    the reference's chunk count ceil(max_bytes / 7) (strings longer than
    it fold only their first chunks, in both)."""
    table = _strings()
    want = np.asarray(jsort._string_hash_key(
        JaxBatch.from_arrow(table).columns[0], max_bytes))[:table.num_rows]
    col = arrow_to_batch(table, "cpu").columns[0]
    got = S.string_hash_key(col, S.hash_chunks(max_bytes))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int64))
    assert S.hash_chunks(max_bytes) == max(1, -(-max_bytes // 7))


def test_forced_hash_collisions_split_groups_and_never_merge(monkeypatch):
    """Every string hashing alike: the partial step's sort keeps the
    input order, so equal strings that are not adjacent form several
    groups; the byte compare at the boundaries keeps two strings apart;
    the final rows are still the reference's."""
    table = _strings(64, 9)
    table = pa.concat_tables([table, table.slice(0, 20)])
    batch = arrow_to_batch(table, "cpu")
    exact = G.group_rows(batch, [0])
    monkeypatch.setattr(S, "string_hash_key_plain",
                        lambda c, n: torch.zeros(c.num_rows,
                                                 dtype=torch.int64))
    split = G.group_rows(batch, [0], allow_split_groups=True)
    assert split.num_groups > exact.num_groups
    # within each split group every row holds the same string
    sorted_vals = split.sorted_batch.to_arrow().column(0).to_pylist()
    starts = split.starts.tolist() + [batch.num_rows]
    for a, b in zip(starts[:-1], starts[1:]):
        assert len(set(map(repr, sorted_vals[a:b]))) == 1
    data, validity = held.tail_columns(700, 3)
    port = GpuSession(device="cpu").create_dataframe(
        held.tail_batches(data, validity, "cpu", 200), num_partitions=3)
    ora = TpuSession(ORACLE).create_dataframe(
        [JaxBatch.from_arrow(b.to_arrow())
         for b in held.tail_batches(data, validity, "cpu", 200)],
        num_partitions=3)

    def q(df, E):
        return df.group_by("s").agg(
            E.count().alias("n"), E.sum_("v").alias("sv"),
            E.min_("x").alias("mx"), E.max_("b").alias("mb"),
            E.first("v").alias("fv"))
    _same(q(port, PE).collect(), q(ora, JE).collect(), ordered=False)
