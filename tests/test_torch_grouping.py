"""The port's grouping kernels against the JAX package's, on the CPU.

murmur3 and pmod, hash_partition, sort_indices, and group_rows with the
segmented sums and counts: on CPU tensors each wrapper runs its plain
PyTorch version, which must equal the reference function on the same
seeded input.  Hashes, partition order and counts, sort permutations,
group keys and counts are exact; f64 segmented sums agree within 1e-12
relative (the packages add in different orders).  chip_smoke.py holds
the CUDA kernels against these plain versions on the card.
"""
import decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import groupby as jgb
from spark_rapids_tpu.kernels import hash as jhash
from spark_rapids_tpu.kernels import partition as jpart
from spark_rapids_tpu.kernels import sort as jsort

from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels import groupby as G
from spark_rapids_tpu_torch.kernels import hash as H
from spark_rapids_tpu_torch.kernels import partition as P
from spark_rapids_tpu_torch.kernels import reduction as R
from spark_rapids_tpu_torch.kernels import sort as S

F64_RTOL = 1e-12
SPECIAL_DOUBLES = [0.0, -0.0, float("nan"), -float("nan"), float("inf"),
                   -float("inf"), 1.5, -1.5]


def _array(kind: str, rng, n: int, null_frac: float, distinct: int):
    """One seeded Arrow column of a key type: int, long, date, dec (a
    Decimal64, decimal(18,2)), bool or double (with -0.0, NaN and
    infinities)."""
    mask = rng.rand(n) < null_frac
    if kind == "bool":
        return pa.array(rng.rand(n) < 0.5, mask=mask)
    if kind == "double":
        vals = rng.randint(-distinct, distinct, n) / 4.0
        special = rng.rand(n) < 0.2
        vals[special] = rng.choice(SPECIAL_DOUBLES, special.sum())
        return pa.array(vals, mask=mask)
    ints = rng.randint(-distinct, distinct, n)
    if kind == "int":
        return pa.array(ints.astype(np.int32), mask=mask)
    if kind == "date":
        return pa.array((ints + 10_000).astype(np.int32),
                        mask=mask).cast(pa.date32())
    if kind == "long":
        return pa.array(ints.astype(np.int64) * (2**40 + 3), mask=mask)
    return pa.array([decimal.Decimal(int(x) * 1_000_003).scaleb(-2)
                     for x in ints], pa.decimal128(18, 2), mask=mask)


def _table(kinds, n=1_000, seed=0, null_frac=0.1, distinct=50):
    rng = np.random.RandomState(seed)
    cols = {f"k{i}": _array(k, rng, n, null_frac, distinct)
            for i, k in enumerate(kinds)}
    cols["v"] = pa.array(rng.uniform(-1e3, 1e3, n), mask=rng.rand(n) < 0.1)
    cols["w"] = pa.array(rng.randint(-2**62, 2**62, n, dtype=np.int64))
    return pa.table(cols)


def _both(table):
    return JaxBatch.from_arrow(table), arrow_to_batch(table, "cpu")


def _bits(a: np.ndarray) -> np.ndarray:
    """Doubles as their bits, so NaN compares equal to itself."""
    return a.view(np.int64) if a.dtype == np.float64 else a


def _assert_same_columns(got_cols, ref_cols, n: int):
    for gc, rc in zip(got_cols, ref_cols, strict=True):
        np.testing.assert_array_equal(gc.validity.numpy(),
                                      np.asarray(rc.validity)[:n])
        np.testing.assert_array_equal(_bits(gc.data.numpy()),
                                      _bits(np.asarray(rc.data)[:n]))

# -- murmur3 and pmod ---------------------------------------------------------


def test_murmur3_spark_known_values():
    """Spark: hash(0) = 933211791, hash(1) = -559580957, hash(1L) =
    -1712319331 (Murmur3_x86_32, seed 42; tests/test_kernels.py:17-40)."""
    t = pa.table({"i": pa.array([0, 1], pa.int32()),
                  "l": pa.array([1, 1], pa.int64())})
    b = arrow_to_batch(t, "cpu")
    assert H.murmur3_hash([b.columns[0]]).tolist() == [933211791, -559580957]
    assert H.murmur3_hash([b.columns[1]]).tolist()[0] == -1712319331


@pytest.mark.parametrize("kinds", [["int"], ["long"], ["date"], ["dec"],
                                   ["double"], ["bool"],
                                   ["int", "double", "long", "dec", "date",
                                    "bool"]])
def test_murmur3_matches_reference(kinds):
    table = _table(kinds, seed=len(kinds) + len(kinds[0]), null_frac=0.2)
    jb, pb = _both(table)
    keys = list(range(len(kinds)))
    ref = np.asarray(jhash.murmur3_hash([jb.columns[i] for i in keys]))
    got = H.murmur3_hash([pb.columns[i] for i in keys])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref[:table.num_rows])
    # a null row passes the seed through: an all-null row hashes to 42
    nulls = np.all([~pb.columns[i].validity.numpy() for i in keys], axis=0)
    assert (got.numpy()[nulls] == 42).all()


@pytest.mark.parametrize("num_partitions", [1, 7, 16, 200])
def test_pmod_matches_reference(num_partitions):
    h = np.random.RandomState(num_partitions).randint(
        -2**31, 2**31, 4_000, dtype=np.int64).astype(np.int32)
    h[:4] = [-2**31, -1, 0, 2**31 - 1]
    ref = np.asarray(jhash.pmod(jnp.asarray(h), num_partitions))
    got = H.pmod(torch.from_numpy(h), num_partitions)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min() >= 0 and got.max() < num_partitions
    _, part = H.murmur3_partition(
        [arrow_to_batch(_table(["int"]), "cpu").columns[0]], num_partitions)
    assert part.dtype == torch.int32 and part.max() < num_partitions

# -- hash_partition -----------------------------------------------------------


@pytest.mark.parametrize("kinds,num_partitions", [(["int"], 16),
                                                  (["long", "double"], 5),
                                                  (["dec"], 1),
                                                  (["int"], 1_000)])
def test_hash_partition_matches_reference(kinds, num_partitions):
    table = _table(kinds, n=2_500, seed=7)
    jb, pb = _both(table)
    keys = list(range(len(kinds)))
    ref, ref_counts = jpart.hash_partition(jb, keys, num_partitions)
    got, counts = P.hash_partition(pb, keys, num_partitions)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    assert got.num_rows == table.num_rows
    _assert_same_columns(got.columns, ref.columns, table.num_rows)

# -- sort_indices -------------------------------------------------------------


def _sort_both(table, key_cols, orders):
    jb, pb = _both(table)
    ref = np.asarray(jsort.sort_indices(
        jb, key_cols, [jsort.SortOrder(o.ascending, o.nulls_first)
                       for o in orders]))[:table.num_rows]
    got = S.sort_indices(pb, key_cols, orders)
    assert got.dtype == torch.int32
    return ref, got.numpy()


@pytest.mark.parametrize("kind", ["int", "long", "double", "bool"])
@pytest.mark.parametrize("ascending,nulls_first", [(True, True),
                                                   (True, False),
                                                   (False, True),
                                                   (False, False)])
def test_sort_indices_matches_reference(kind, ascending, nulls_first):
    table = _table([kind], n=1_500, seed=3)
    ref, got = _sort_both(table, [0], [S.SortOrder(ascending, nulls_first)])
    np.testing.assert_array_equal(got, ref)


def test_sort_two_keys_and_stability():
    """Two keys of few distinct values: most rows tie, so the permutation
    is the same only if the sort is stable."""
    table = _table(["date", "dec"], n=3_000, seed=11, distinct=3)
    orders = [S.SortOrder(False), S.SortOrder(True, False)]
    ref, got = _sort_both(table, [0, 1], orders)
    np.testing.assert_array_equal(got, ref)
    sb = S.sort_batch(arrow_to_batch(table, "cpu"), [0, 1], orders)
    assert sb.to_arrow().equals(table.take(pa.array(ref)))

# -- group_rows and the segmented reductions ----------------------------------


def _assert_sums(got_v, got_ok, ref_v, ref_ok):
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)
    np.testing.assert_allclose(got_v.numpy()[ref_ok], ref_v[ref_ok],
                               rtol=F64_RTOL)
    assert not got_v.numpy()[~ref_ok].any()   # null groups sum to zero


@pytest.mark.parametrize("kinds", [["int"], ["double"], ["long", "date"]])
def test_group_rows_and_segment_sums_match_reference(kinds):
    """Keys with nulls (a null group), -0.0 beside 0.0 and NaNs of both
    signs; the value column is all null in the groups of key 7."""
    table = _table(kinds, n=2_000, seed=5, null_frac=0.05, distinct=8)
    k0 = table.column(0).to_numpy(zero_copy_only=False)
    if kinds == ["int"]:
        v = table.column("v").to_pylist()
        table = table.set_column(
            len(kinds), "v", pa.array([None if k == 7 else x
                                       for k, x in zip(k0, v)], pa.float64()))
    jb, pb = _both(table)
    keys = list(range(len(kinds)))
    vi, wi = len(kinds), len(kinds) + 1
    ref_layout = jgb.group_rows(jb, keys)
    layout = G.group_rows(pb, keys)
    g = int(ref_layout.num_groups)
    assert layout.num_groups == g and layout.starts.shape == (g,)
    _assert_same_columns(G.group_keys_output(layout, keys),
                         jgb.group_keys_output(ref_layout, keys), g)
    sums = G.SegmentSums(layout)
    ref_sb = ref_layout.sorted_batch
    v_ref, ok_ref = jgb.seg_sum(ref_sb.columns[vi], ref_layout, jnp.float64)
    v_got, ok_got = G.seg_sum(layout.sorted_batch.columns[vi], sums,
                              torch.float64)
    _assert_sums(v_got, ok_got, np.asarray(v_ref)[:g], np.asarray(ok_ref)[:g])
    if kinds == ["int"]:
        assert not ok_got.all()   # the all-null group's SUM is null
    w_ref, _ = jgb.seg_sum(ref_sb.columns[wi], ref_layout, jnp.int64)
    w_got, _ = G.seg_sum(layout.sorted_batch.columns[wi], sums, torch.int64)
    np.testing.assert_array_equal(w_got.numpy(), np.asarray(w_ref)[:g])
    for ref_fn, got_fn in [
            (lambda: jgb.seg_count_valid(ref_sb.columns[vi], ref_layout),
             lambda: G.seg_count_valid(layout.sorted_batch.columns[vi],
                                       sums)),
            (lambda: jgb.seg_count_star(ref_layout),
             lambda: G.seg_count_star(sums))]:
        rn, _ = ref_fn()
        gn, gok = got_fn()
        assert gok.all()
        np.testing.assert_array_equal(gn.numpy(), np.asarray(rn)[:g])


@pytest.mark.parametrize("starts", [[0], [0, 1, 2, 3], [0, 5, 6, 4_000]])
def test_segmented_sum_plain(starts):
    """Segment edges at the first and the last row, one-row segments, and
    one long segment; an all-null segment is 0 with a false flag."""
    rng = np.random.RandomState(len(starts))
    n = 4_100
    data = torch.from_numpy(rng.uniform(-1, 1, n))
    valid = torch.from_numpy(rng.rand(n) < 0.9)
    valid[starts[-1]:] = False
    st = torch.tensor(starts, dtype=torch.int32)
    total, ok, nvalid, rows = R.segmented_sum(data, valid, st)
    bounds = starts + [n]
    for s in range(len(starts)):
        lo, hi = bounds[s], bounds[s + 1]
        m = valid[lo:hi]
        assert rows[s] == hi - lo and nvalid[s] == int(m.sum())
        assert ok[s] == bool(m.any())
        np.testing.assert_allclose(total[s].item(),
                                   data[lo:hi][m].sum().item(), rtol=F64_RTOL,
                                   atol=1e-300)


def test_grouping_wrappers_never_fall_back_off_the_cpu():
    """Tensors off the CPU take the CUDA path, which raises for anything
    but a CUDA tensor; only CUDA launches count."""
    meta_i = torch.empty(8, dtype=torch.int32, device="meta")
    for num_partitions in (4, 1_000):   # one radix pass, then two
        with pytest.raises(ValueError, match="expected cuda"):
            P.partition_order(meta_i, num_partitions)
    with pytest.raises(ValueError, match="expected cuda"):
        R.segmented_sum(torch.empty(8, dtype=torch.float64, device="meta"),
                        torch.empty(8, dtype=torch.bool, device="meta"),
                        meta_i)
    col = arrow_to_batch(_table(["int"], n=8), "cpu").columns[0]
    meta_col = type(col)(col.data.to("meta"), col.validity.to("meta"),
                         col.dtype)
    with pytest.raises(ValueError, match="expected cuda"):
        H.murmur3_hash([meta_col])
    with pytest.raises(ValueError, match="expected cuda"):
        S._sort_indices_cuda([meta_col], [S.SortOrder()])
    assert not any(_lib.LAUNCHES.get(k) for k in
                   ("murmur3", "partition", "sort", "segmented_sum"))
