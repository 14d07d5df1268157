"""The port's inner join against the JAX package's, on the CPU.

``join_gather_maps`` must give the same (left, right) pairs as the
reference's, in the same order: stream rows in order, each row's matches
in build order.  Null keys never match, duplicated build keys fan out, NaN
matches NaN and -0.0 matches 0.0; on several keys (the reference's
``_probe_multi``) a null in any key matches nothing, an int key matches a
long one by value and strings match byte for byte, a stream string longer
than every build string included.  ``apply_gather_maps`` then gives the
same rows, string columns included.  On CPU tensors the wrappers run their
plain versions; chip_smoke.py holds the CUDA kernels against them on the
card.  What the port leaves out raises NotImplementedError.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.batch import Schema as JaxSchema
from spark_rapids_tpu.kernels import join as jjoin

from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels import join as J

SPECIAL_DOUBLES = [0.0, -0.0, float("nan"), -float("nan"), 1.5, -2.25,
                   float("inf")]


def _keys(kind: str, rng, n: int, distinct: int, null_frac: float):
    mask = rng.rand(n) < null_frac
    if kind == "double":
        return pa.array(rng.choice(SPECIAL_DOUBLES, n), mask=mask)
    v = rng.randint(0, distinct, n)
    if kind == "int":
        return pa.array(v.astype(np.int32), mask=mask)
    return pa.array(v.astype(np.int64) * (2**35 + 1), mask=mask)


def _sides(kind: str, seed: int, n_left: int, n_right: int,
           distinct: int, null_frac: float = 0.1, offset: int = 0):
    """A stream table (key, an int payload, a string payload) and a build
    table (key, a string payload); ``offset`` shifts the build keys so
    that few or none match."""
    rng = np.random.RandomState(seed)
    left = pa.table({"lk": _keys(kind, rng, n_left, distinct, null_frac),
                     "lp": pa.array(np.arange(n_left, dtype=np.int32)),
                     "ls": pa.array([f"l{i % 7}é" for i in range(n_left)])})
    rk = _keys(kind, rng, n_right, distinct, null_frac)
    if offset:
        rk = pa.compute.add(rk, pa.scalar(offset, rk.type))
    right = pa.table({"rk": rk,
                      "rs": pa.array([None if i % 5 == 0 else f"Brand#{i}"
                                      for i in range(n_right)], pa.string())})
    return left, right


def _left_reference(left, right, keys):
    """The reference's left-join maps, its out-of-range right index (OOB)
    written as -1."""
    jl, jr = JaxBatch.from_arrow(left), JaxBatch.from_arrow(right)
    cap = max(left.num_rows * max(right.num_rows, 1), 1)
    longest = max([len(v.encode()) for t in (left, right)
                   for c in t.columns if pa.types.is_string(c.type)
                   for v in c.to_pylist() if v is not None] + [1])
    li, ri, count, _ = jjoin.join_gather_maps(jl, keys, jr, keys, "left",
                                              cap, string_max_bytes=longest)
    c = int(count)
    ri = np.asarray(ri)[:c].astype(np.int64)
    return np.asarray(li)[:c], np.where((ri < 0) | (ri >= right.num_rows),
                                        -1, ri)


def _reference_maps(left, right):
    jl, jr = JaxBatch.from_arrow(left), JaxBatch.from_arrow(right)
    cap = max(left.num_rows * right.num_rows, 1)
    li, ri, count, _ = jjoin.join_gather_maps(jl, [0], jr, [0], "inner", cap)
    c = int(count)
    return jl, jr, np.asarray(li)[:c], np.asarray(ri)[:c]


CASES = {
    # kind, seed, left rows, right rows, distinct keys, build key offset
    "int_duplicates_and_nulls": ("int", 1, 700, 300, 60, 0),
    "long_duplicates_and_nulls": ("long", 2, 500, 400, 90, 0),
    "double_nan_and_signed_zero": ("double", 3, 300, 120, 0, 0),
    "no_match_at_all": ("int", 4, 400, 200, 50, 1_000),
    "one_build_row": ("int", 5, 300, 1, 3, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_join_gather_maps_match_reference(case):
    kind, seed, nl, nr, distinct, offset = CASES[case]
    left, right = _sides(kind, seed, nl, nr, distinct, offset=offset)
    _, _, ref_li, ref_ri = _reference_maps(left, right)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, ri, count = J.join_gather_maps(pl, [0], pr, [0], "inner")
    assert li.dtype == ri.dtype == torch.int32
    assert count == len(ref_li) == li.shape[0]
    np.testing.assert_array_equal(li.numpy(), ref_li)
    np.testing.assert_array_equal(ri.numpy(), ref_ri)
    if case == "no_match_at_all":
        assert count == 0
    if kind == "double":   # NaN = NaN and -0.0 = 0.0 did match
        lk = left.column("lk").to_numpy(zero_copy_only=False)
        assert np.isnan(lk[li.numpy()]).any()
        assert (np.signbit(lk[li.numpy()]) & (lk[li.numpy()] == 0)).any()


def test_apply_gather_maps_matches_reference():
    """The joined rows, left columns then right ones, string payloads
    gathered through both maps."""
    left, right = _sides("int", 6, 400, 150, 40)
    jl, jr, ref_li, ref_ri = _reference_maps(left, right)
    c = len(ref_li)
    names = ("lk", "lp", "ls", "rk", "rs")
    jschema = JaxSchema(names, tuple(jl.schema.dtypes) + tuple(jr.schema.dtypes))
    ref, _ = jjoin.apply_gather_maps(jl, jr, np.asarray(ref_li, np.int32),
                                     np.asarray(ref_ri, np.int32),
                                     np.int32(c), jschema, "inner",
                                     max(c, 1), {2: 64 * c, 4: 64 * c})
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, ri, _ = J.join_gather_maps(pl, [0], pr, [0], "inner")
    schema = Schema(names, pl.schema.dtypes + pr.schema.dtypes)
    got = J.apply_gather_maps(pl, pr, li, ri, schema)
    assert got.num_rows == c
    assert got.rows() == list(zip(*ref.to_pydict().values()))


def test_int_stream_joins_long_build_by_value():
    pl = arrow_to_batch(pa.table({"k": pa.array([1, -5, 7, None],
                                                pa.int32())}), "cpu")
    pr = arrow_to_batch(pa.table({"k": pa.array([7, -5, 2**40, -5, None],
                                                pa.int64())}), "cpu")
    li, ri, count = J.join_gather_maps(pl, [0], pr, [0], "inner")
    assert (li.tolist(), ri.tolist(), count) == ([1, 1, 2], [1, 3, 0], 3)


def test_build_side_sorts_nulls_last():
    col = DeviceColumn.from_numpy(np.array([3, 1, 2, 1], np.int32),
                                  arrow_to_batch(pa.table({"k": pa.array(
                                      [0], pa.int32())}), "cpu").schema
                                  .dtypes[0],
                                  np.array([True, True, False, True]))
    b = arrow_to_batch(pa.table({"k": pa.array([3, 1, None, 1],
                                               pa.int32())}), "cpu")
    build = J.build_side(b, 0)
    assert build.perm.tolist() == [1, 3, 0, 2]
    assert build.key_valid.tolist() == [True, True, True, False]
    assert (build.keys[:3] ^ J._SIGN64).tolist() == [1, 1, 3]
    assert torch.equal(J.build_keys(col, build.perm)[0], build.keys)


@pytest.mark.parametrize("how", ["left", "left_semi", "left_anti", "full"])
def test_other_join_types_raise(how):
    """The left, semi, anti and full joins are ported and give the
    reference's maps (the semi and anti joins: the kept stream rows, no
    right map; the full join: the left-driven pairs, then the unmatched
    build rows with left index -1); the existence join's probe raises."""
    left, right = _sides("int", 7, 20, 10, 5)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    if how == "left":
        li, ri, count = J.join_gather_maps(pl, [0], pr, [0], how)
        ref_li, ref_ri = _left_reference(left, right, [0])
        np.testing.assert_array_equal(li.numpy(), ref_li)
        np.testing.assert_array_equal(ri.numpy(), ref_ri)
        assert (ri == -1).any() and count == len(ref_li)
        return
    if how in ("left_semi", "left_anti"):
        li, ri, count = J.join_gather_maps(pl, [0], pr, [0], how)
        ref_li = _left_only_reference(left, right, [0], how)
        np.testing.assert_array_equal(li.numpy(), ref_li)
        assert count == len(ref_li) == li.shape[0] > 0
        assert ri.shape == (0,)
        return
    li, ri, count = J.join_gather_maps(pl, [0], pr, [0], how)
    jl, jr = JaxBatch.from_arrow(left), JaxBatch.from_arrow(right)
    ref_li, ref_ri, ref_count, _ = jjoin.join_gather_maps(
        jl, [0], jr, [0], how, left.num_rows * right.num_rows
        + left.num_rows + right.num_rows)
    c = int(ref_count)
    ref_li, ref_ri = (np.asarray(m)[:c].astype(np.int64)
                      for m in (ref_li, ref_ri))
    ref_li = np.where(ref_li >= left.num_rows, -1, ref_li)
    ref_ri = np.where(ref_ri >= right.num_rows, -1, ref_ri)
    np.testing.assert_array_equal(li.numpy(), ref_li)
    np.testing.assert_array_equal(ri.numpy(), ref_ri)
    assert count == c and (ri == -1).any()
    with pytest.raises(NotImplementedError, match="existence"):
        J.join_gather_maps(pl, [0], pr, [0], "existence")


def _left_only_reference(left, right, keys, how):
    """The reference's semi or anti map: its kept left rows (its right map
    is all out of range)."""
    jl, jr = JaxBatch.from_arrow(left), JaxBatch.from_arrow(right)
    longest = max([len(v.encode()) for t in (left, right)
                   for c in t.columns if pa.types.is_string(c.type)
                   for v in c.to_pylist() if v is not None] + [1])
    li, ri, count, _ = jjoin.join_gather_maps(
        jl, keys, jr, keys, how, max(left.num_rows, 1),
        string_max_bytes=longest)
    c = int(count)
    ri = np.asarray(ri)[:c].astype(np.int64)
    assert ((ri < 0) | (ri >= right.num_rows)).all()
    return np.asarray(li)[:c]


MAXL = 2**63 - 1
SEMI_CASES = {
    # kind, seed, left rows, right rows, distinct keys, build key offset
    "int_duplicates_and_nulls": ("int", 41, 600, 200, 80, 0),
    "double_nan_and_signed_zero": ("double", 42, 300, 60, 0, 0),
    "no_match_at_all": ("int", 43, 200, 80, 30, 1_000),
}


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
@pytest.mark.parametrize("case", list(SEMI_CASES))
def test_semi_anti_one_key_match_reference(case, how):
    """The single-key semi and anti probes and the left-only expand: each
    kept stream row once, in order; a null key is dropped by the semi join
    and kept by the anti join."""
    kind, seed, nl, nr, distinct, offset = SEMI_CASES[case]
    left, right = _sides(kind, seed, nl, nr, distinct, offset=offset)
    ref_li = _left_only_reference(left, right, [0], how)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    assert J.join_path(pl, [0], pr, [0], how) == "single"
    li, ri, count = J.join_gather_maps(pl, [0], pr, [0], how)
    assert li.dtype == torch.int32 and ri.shape == (0,)
    np.testing.assert_array_equal(li.numpy(), ref_li)
    assert count == len(ref_li)
    nulls = set(np.flatnonzero(pa.compute.is_null(left.column(
        "lk")).to_numpy(zero_copy_only=False)).tolist())
    assert nulls and (nulls <= set(li.tolist()) if how == "left_anti"
                      else not nulls & set(li.tolist()))
    if case == "no_match_at_all":
        assert count == (0 if how == "left_semi" else nl)


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_semi_anti_long_max_key_match_reference(how):
    """Long.MAX_VALUE keys (tests/test_joins.py:138): no sentinel
    collides with a real key."""
    left = pa.table({"k": pa.array([MAXL, 5, None, MAXL - 1, -MAXL - 1],
                                   pa.int64())})
    right = pa.table({"k": pa.array([MAXL, None, 7, -MAXL - 1],
                                    pa.int64())})
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, _, _ = J.join_gather_maps(pl, [0], pr, [0], how)
    np.testing.assert_array_equal(li.numpy(), _left_only_reference(
        left, right, [0], how))
    assert li.tolist() == ([0, 4] if how == "left_semi" else [1, 2, 3])


SEMI_MULTI_CASES = {
    # left kinds, right kinds, seed, left rows, right rows, distinct
    "three_ints": (("int", "int", "int"), ("int", "int", "int"), 51, 600,
                   250, 4),
    "int_string": (("int", "string"), ("int", "string"), 52, 500, 200, 4),
    "string_alone": (("string",), ("string",), 53, 300, 40, 0),
    "int_long_double": (("int", "long", "double"), ("long", "long",
                                                    "double"), 54, 400,
                        300, 3),
}


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
@pytest.mark.parametrize("case", list(SEMI_MULTI_CASES))
def test_semi_anti_several_keys_match_reference(case, how):
    """The several-key semi and anti probes (q14a's three int keys, string
    keys, an int key against a long one, doubles with NaN and -0.0): a
    null in any key matches nothing."""
    lkinds, rkinds, seed, nl, nr, distinct = SEMI_MULTI_CASES[case]
    rng = np.random.RandomState(seed)
    left = pa.table({f"k{i}": _multi_column(k, rng, nl, distinct, 0.1)
                     for i, k in enumerate(lkinds)})
    right = pa.table({f"k{i}": _multi_column(k, rng, nr, distinct, 0.1)
                      for i, k in enumerate(rkinds)})
    keys = list(range(len(lkinds)))
    ref_li = _left_only_reference(left, right, keys, how)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    assert J.join_path(pl, keys, pr, keys, how) == "multi"
    li, ri, count = J.join_gather_maps(pl, keys, pr, keys, how)
    assert ri.shape == (0,) and count == len(ref_li) > 0
    np.testing.assert_array_equal(li.numpy(), ref_li)
    any_null = np.zeros(nl, bool)
    for c in left.columns:
        any_null |= pa.compute.is_null(c).to_numpy(zero_copy_only=False)
    kept = np.zeros(nl, bool)
    kept[li.numpy()] = True
    assert (kept[any_null] if how == "left_anti"
            else ~kept[any_null]).all()


def _edge_sides(case: str):
    """(int, string) sides of the semi / anti edge cases."""
    lk, ls = [1, 2, None, 4, 1], ["a", "b", "a", None, "a"]
    rk, rs = [1, 4, 2, None], ["a", None, "c", "b"]
    if case == "empty_build":
        rk, rs = [], []
    elif case == "empty_stream":
        lk, ls = [], []
    elif case == "all_null_keys":
        lk, ls = [None] * 5, [None, "a", None, "b", None]
        rk, rs = [None, None, 1], ["a", None, "a"]
    left = pa.table({"k": pa.array(lk, pa.int32()),
                     "s": pa.array(ls, pa.string())})
    right = pa.table({"k": pa.array(rk, pa.int32()),
                      "s": pa.array(rs, pa.string())})
    return left, right


SEMI_EDGES = {
    # case: (semi rows, anti rows) on the int key, then on (int, string)
    "both_sides": (([0, 1, 3, 4], [2]), ([0, 4], [1, 2, 3])),
    "empty_build": (([], [0, 1, 2, 3, 4]), ([], [0, 1, 2, 3, 4])),
    "empty_stream": (([], []), ([], [])),
    "all_null_keys": (([], [0, 1, 2, 3, 4]), ([], [0, 1, 2, 3, 4])),
}


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
@pytest.mark.parametrize("case", list(SEMI_EDGES))
def test_semi_anti_edges_match_reference(case, how):
    """An empty build (the semi join keeps nothing, the anti join every
    row, null keys included), an empty stream and keys that are all null,
    on one key and on two."""
    left, right = _edge_sides(case)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    for keys, want in zip(([0], [0, 1]), SEMI_EDGES[case]):
        li, ri, count = J.join_gather_maps(pl, keys, pr, keys, how)
        expect = want[0] if how == "left_semi" else want[1]
        assert (li.tolist(), ri.tolist(), count) == (expect, [],
                                                     len(expect))
        if left.num_rows and right.num_rows:
            np.testing.assert_array_equal(li.numpy(), _left_only_reference(
                left, right, keys, how))


STRING_POOL = ["", "ab", "ab\x00", "abcdefgh", "abcdefghi", "é" * 5,
               "\xff", "Brand#12", "a"]


def _multi_column(kind: str, rng, n: int, distinct: int, null_frac: float,
                  pool=STRING_POOL):
    mask = rng.rand(n) < null_frac
    if kind == "string":
        return pa.array([None if m else pool[i] for m, i in
                         zip(mask, rng.randint(0, len(pool), n))],
                        pa.string())
    if kind == "double":
        return pa.array(rng.choice(SPECIAL_DOUBLES, n), mask=mask)
    v = rng.randint(0, distinct, n)
    if kind == "int":
        return pa.array(v.astype(np.int32), mask=mask)
    return pa.array(v.astype(np.int64), mask=mask)


def _multi_reference(left, right, nkeys):
    jl, jr = JaxBatch.from_arrow(left), JaxBatch.from_arrow(right)
    cap = max(left.num_rows * right.num_rows, 1)
    longest = max([len(v.encode()) for t in (left, right)
                   for c in t.columns if pa.types.is_string(c.type)
                   for v in c.to_pylist() if v is not None] + [1])
    keys = list(range(nkeys))
    li, ri, count, _ = jjoin.join_gather_maps(jl, keys, jr, keys, "inner",
                                              cap, string_max_bytes=longest)
    c = int(count)
    return np.asarray(li)[:c], np.asarray(ri)[:c]


MULTI_CASES = {
    # (left kinds, right kinds), seed, left rows, right rows, distinct
    "int_int": (("int", "int"), ("int", "int"), 11, 600, 300, 12),
    "int_long": (("int", "long"), ("long", "long"), 12, 500, 250, 10),
    "double_nan_and_signed_zero": (("double", "int"), ("double", "int"), 13,
                                   300, 150, 3),
    "string_alone": (("string",), ("string",), 14, 400, 120, 0),
    "int_string": (("int", "string"), ("int", "string"), 15, 500, 200, 4),
}


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_multi_key_join_gather_maps_match_reference(case):
    lkinds, rkinds, seed, nl, nr, distinct = MULTI_CASES[case]
    rng = np.random.RandomState(seed)
    left = pa.table({f"k{i}": _multi_column(k, rng, nl, distinct, 0.1)
                     for i, k in enumerate(lkinds)})
    right = pa.table({f"k{i}": _multi_column(k, rng, nr, distinct, 0.1)
                      for i, k in enumerate(rkinds)})
    ref_li, ref_ri = _multi_reference(left, right, len(lkinds))
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    keys = list(range(len(lkinds)))
    assert J.join_path(pl, keys, pr, keys, "inner") == "multi"
    li, ri, count = J.join_gather_maps(pl, keys, pr, keys, "inner")
    assert li.dtype == ri.dtype == torch.int32
    assert count == len(ref_li) == li.shape[0] > 0
    np.testing.assert_array_equal(li.numpy(), ref_li)
    np.testing.assert_array_equal(ri.numpy(), ref_ri)
    # a null in either key of a pair never matched
    for t, ix in ((left, li), (right, ri)):
        for c in t.columns:
            assert c.take(pa.array(ix.numpy())).null_count == 0


def _edge_tables(case: str):
    """Two-key (int, string) sides for the edge cases."""
    if case == "longer_stream_strings":
        lk = [1, 1, 1, 1, 2, 2, 1]
        ls = ["abc", "abc\x00\x00\x00\x00\x00\x00\x00\x00", "abc" + "x" * 20,
              "abd", "", "\x00", "ab"]
        rk, rs = [1, 1, 2, 1], ["abc", "ab", "", "abc"]
    elif case == "no_match":
        lk, ls = [1, 2, 3, None], ["a", "b", "c", "a"]
        rk, rs = [1, 2, 3, 1], ["b", "c", "a", None]
    elif case == "one_build_row":
        lk, ls = [5, 5, 4, 5, None], ["x", "x", "x", "y", "x"]
        rk, rs = [5], ["x"]
    else:   # empty build
        lk, ls = [1, 2], ["a", "b"]
        rk, rs = [], []
    left = pa.table({"k": pa.array(lk, pa.int32()), "s": pa.array(ls)})
    right = pa.table({"k": pa.array(rk, pa.int32()),
                      "s": pa.array(rs, pa.string())})
    return left, right


@pytest.mark.parametrize("case", ["longer_stream_strings", "no_match",
                                  "one_build_row", "empty_build"])
def test_multi_key_join_edges_match_reference(case):
    left, right = _edge_tables(case)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, ri, count = J.join_gather_maps(pl, [0, 1], pr, [0, 1], "inner")
    want = {"longer_stream_strings": ([0, 0, 4, 6], [0, 3, 2, 1]),
            "no_match": ([], []),
            "one_build_row": ([0, 1], [0, 0]), "empty_build": ([], [])}[case]
    assert (li.tolist(), ri.tolist(), count) == (*want, len(want[0]))
    if right.num_rows:
        ref_li, ref_ri = _multi_reference(left, right, 2)
        np.testing.assert_array_equal(li.numpy(), ref_li)
        np.testing.assert_array_equal(ri.numpy(), ref_ri)


def test_multi_key_string_key_cross_and_condition_raise():
    """Several keys and a string key now join (as the reference does), and
    the cross join gives every pair, left-major; a residual condition on
    the cross join, mismatched maps and an unknown type raise."""
    left, right = _sides("int", 8, 20, 10, 5)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, ri, count = J.join_gather_maps(pl, [0, 0], pr, [0, 0], "inner")
    want_li, want_ri, want = J.join_gather_maps(pl, [0], pr, [0], "inner")
    assert count == want
    assert torch.equal(li, want_li) and torch.equal(ri, want_ri)
    strings = pa.table({"rs": pa.array(["l1é", None, "l3é", "l1é"])})
    ps = arrow_to_batch(strings, "cpu")
    li, ri, count = J.join_gather_maps(pl, [2], ps, [0], "inner")
    ls = left.column("ls").to_pylist()
    assert [(ls[a], b) for a, b in zip(li.tolist(), ri.tolist())] == [
        (ls[a], b) for a in range(len(ls)) for b in (0, 3, 2)
        if ls[a] == strings.column("rs")[b].as_py()]
    with pytest.raises(NotImplementedError, match="int.*string|string.*int"):
        J.join_gather_maps(pl, [0], ps, [0], "inner")
    li, ri, count = J.join_gather_maps(pl, [], pr, [], "cross")
    nl, nr = pl.num_rows, pr.num_rows
    assert count == nl * nr
    assert li.tolist() == [a for a in range(nl) for _ in range(nr)]
    assert ri.tolist() == [b for _ in range(nl) for b in range(nr)]
    # conditional_join_maps is ported; it raises for a join type it has no
    # branch for and for maps that do not line up
    i32 = torch.zeros(3, dtype=torch.int32)
    ok = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="cross"):
        J.conditional_join_maps(i32, i32, ok, ok, ok, "cross")
    with pytest.raises(ValueError, match="differ in length"):
        J.conditional_join_maps(i32, i32[:2], ok, ok, ok, "inner")
    with pytest.raises(ValueError, match="unknown join type"):
        J.join_gather_maps(pl, [0], pr, [0], "outer")


def test_join_wrappers_never_fall_back_off_the_cpu():
    """Off the CPU the join steps take their CUDA kernels, which raise for
    anything but a CUDA tensor; only CUDA launches count."""
    left, right = _sides("int", 9, 20, 10, 5)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    build = J.build_side(pr, 0)
    meta = lambda t: t.to("meta")   # noqa: E731
    col = pl.columns[0]
    meta_col = DeviceColumn(meta(col.data), meta(col.validity), col.dtype)
    with pytest.raises(ValueError, match="expected cuda"):
        J.build_keys(meta_col, meta(build.perm))
    meta_build = J.JoinBuild(build.batch, 0, meta(build.perm),
                             meta(build.keys), meta(build.key_valid))
    with pytest.raises(ValueError, match="expected cuda"):
        J.join_probe(type(pl)((meta_col,), pl.num_rows, Schema(
            ("k",), (col.dtype,))), 0, meta_build)
    lo = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        J.join_expand(lo, torch.zeros(5, dtype=torch.int32, device="meta"),
                      3, meta_build)
    assert not any(_lib.LAUNCHES.get(k) for k in
                   ("join_build", "join_probe", "join_expand"))


# -- the left join and the conditional join maps --------------------------

COND_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "existence")


def _candidates(seed: int, nl: int, nr: int, pass_rate: float):
    """Candidate pairs as an inner expansion gives them (left rows in
    order, each with 0-4 right rows; a fifth of the left rows have none),
    a pass mask over the pairs of live rows, and live masks with a few
    dead rows."""
    rng = np.random.RandomState(seed)
    per = np.where(rng.rand(nl) < 0.2, 0, rng.randint(1, 5, nl))
    li = np.repeat(np.arange(nl, dtype=np.int32), per)
    ri = rng.randint(0, nr, li.shape[0]).astype(np.int32)
    left_live = rng.rand(nl) >= 0.05
    right_live = rng.rand(nr) >= 0.05
    passed = ((rng.rand(li.shape[0]) < pass_rate) & left_live[li]
              & right_live[ri])
    return li, ri, passed, left_live, right_live


@pytest.mark.parametrize("join_type", COND_TYPES)
def test_conditional_join_maps_match_reference(join_type):
    """Every branch of the reference's conditional_join_maps, at pass
    rates 0, 40% and 100%, with left rows that have no candidate and dead
    rows on both sides: the same (li, ri) in the same order (the
    reference's OOB written -1) and the same lmatched flags."""
    for seed, (nl, nr, rate) in enumerate(((300, 120, 0.4), (257, 64, 0.0),
                                           (190, 300, 1.0), (40, 1, 0.4))):
        li, ri, passed, llive, rlive = _candidates(seed, nl, nr, rate)
        cap = li.shape[0] + nl + nr
        rli, rri, rcount, _, rlm = jjoin.conditional_join_maps(
            li, ri, passed, llive, rlive, join_type, cap)
        c = int(rcount)
        oob = lambda a: np.where(np.asarray(a)[:c] == 2**31 - 1, -1,  # noqa
                                 np.asarray(a)[:c])
        got_li, got_ri, got_lm = J.conditional_join_maps(
            *(torch.from_numpy(a) for a in (li, ri, passed, llive, rlive)),
            join_type)
        assert got_li.dtype == got_ri.dtype == torch.int32
        np.testing.assert_array_equal(got_li.numpy(), oob(rli))
        np.testing.assert_array_equal(got_ri.numpy(), oob(rri))
        np.testing.assert_array_equal(got_lm.numpy(), np.asarray(rlm))
        if rate == 0.0 and join_type in ("inner", "left_semi"):
            assert got_li.shape[0] == 0


LEFT_CASES = {
    # kind, seed, left rows, right rows, distinct keys, build key offset
    "int_nulls_and_duplicates": ("int", 21, 400, 150, 60, 0),
    "double_nan_and_signed_zero": ("double", 22, 300, 90, 0, 0),
    "no_match_at_all": ("int", 23, 200, 80, 30, 1_000),
}


@pytest.mark.parametrize("case", list(LEFT_CASES))
def test_left_join_one_key_matches_reference(case):
    """The single-key left probe and expand: every stream row at least
    once, a row with no match (a null key included) null-extended."""
    kind, seed, nl, nr, distinct, offset = LEFT_CASES[case]
    left, right = _sides(kind, seed, nl, nr, distinct, offset=offset)
    ref_li, ref_ri = _left_reference(left, right, [0])
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, ri, count = J.join_gather_maps(pl, [0], pr, [0], "left")
    np.testing.assert_array_equal(li.numpy(), ref_li)
    np.testing.assert_array_equal(ri.numpy(), ref_ri)
    assert count == len(ref_li) >= nl
    nulls = np.flatnonzero(pa.compute.is_null(left.column("lk")).to_numpy(
        zero_copy_only=False))
    assert set(nulls) <= set(li[ri == -1].tolist())


@pytest.mark.parametrize("case", ["int_int", "int_string", "no_match"])
def test_left_join_two_keys_matches_reference(case):
    """The several-key left probe: (int, int) and (int, string) keys with
    nulls in either key."""
    kinds = {"int_int": ("int", "int"), "int_string": ("int", "string"),
             "no_match": ("int", "int")}[case]
    rng = np.random.RandomState(31)
    left = pa.table({f"k{i}": _multi_column(k, rng, 500, 8, 0.1)
                     for i, k in enumerate(kinds)})
    right = pa.table({f"k{i}": _multi_column(k, rng, 200, 8, 0.1)
                      for i, k in enumerate(kinds)})
    if case == "no_match":
        right = right.set_column(0, "k0", pa.compute.add(
            right.column("k0"), pa.scalar(100, pa.int32())))
    ref_li, ref_ri = _left_reference(left, right, [0, 1])
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, ri, count = J.join_gather_maps(pl, [0, 1], pr, [0, 1], "left")
    np.testing.assert_array_equal(li.numpy(), ref_li)
    np.testing.assert_array_equal(ri.numpy(), ref_ri)
    assert (ri == -1).any() and count == len(ref_li)
    if case == "no_match":
        assert li.tolist() == list(range(500)) and (ri == -1).all()


@pytest.mark.parametrize("keys", [[0], [0, 2]])
def test_left_join_against_an_empty_build(keys):
    """An empty build side: every stream row once, null-extended, on one
    key and on two (an int and a string)."""
    left, right = _sides("int", 24, 50, 10, 5)
    right = right.append_column("rs2", right.column("rs")).select(
        ["rk", "rs", "rs2"]).slice(0, 0)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    lkeys = [0, 2] if len(keys) == 2 else [0]
    rkeys = [0, 2] if len(keys) == 2 else [0]
    li, ri, count = J.join_gather_maps(pl, lkeys, pr, rkeys, "left")
    assert (li.tolist(), ri.tolist(), count) == (list(range(50)),
                                                 [-1] * 50, 50)
    names = ("lk", "lp", "ls", "rk", "rs", "rs2")
    schema = Schema(names, pl.schema.dtypes + pr.schema.dtypes)
    got = J.apply_gather_maps(pl, pr, li, ri, schema, "left")
    assert got.rows() == [r + (None, None, None)
                          for r in zip(*left.to_pydict().values())]


def test_apply_gather_maps_left_matches_reference():
    """The left join's rows: the right columns (a string among them) null
    where the stream row had no match, as the reference's gather of an
    out-of-range index gives them."""
    left, right = _sides("int", 25, 300, 60, 80)
    jl, jr = JaxBatch.from_arrow(left), JaxBatch.from_arrow(right)
    cap = left.num_rows * right.num_rows
    rli, rri, rcount, _ = jjoin.join_gather_maps(jl, [0], jr, [0], "left",
                                                 cap)
    c = int(rcount)
    names = ("lk", "lp", "ls", "rk", "rs")
    jschema = JaxSchema(names, tuple(jl.schema.dtypes)
                        + tuple(jr.schema.dtypes))
    ref, _ = jjoin.apply_gather_maps(jl, jr, rli, rri, rcount, jschema,
                                     "left", cap, {2: 64 * c, 4: 64 * c})
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    li, ri, _ = J.join_gather_maps(pl, [0], pr, [0], "left")
    got = J.apply_gather_maps(pl, pr, li, ri,
                              Schema(names, pl.schema.dtypes
                                     + pr.schema.dtypes), "left")
    want = list(zip(*ref.to_pydict().values()))
    assert got.rows() == want
    assert any(r[3] is None and r[4] is None for r in want)


def test_conditional_and_left_wrappers_never_fall_back_off_the_cpu():
    """Off the CPU the conditional join maps and the left probe take their
    CUDA kernels, which raise for anything but a CUDA tensor."""
    meta = lambda n, dt: torch.zeros(n, dtype=dt, device="meta")  # noqa
    i32, ok = meta(4, torch.int32), meta(4, torch.bool)
    with pytest.raises(ValueError, match="expected cuda"):
        J.conditional_join_maps(i32, i32, ok, meta(3, torch.bool),
                                meta(2, torch.bool), "left")
    left, right = _sides("int", 10, 20, 10, 5)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    build = J.build_side(pr, 0)
    col = pl.columns[0]
    meta_col = DeviceColumn(col.data.to("meta"), col.validity.to("meta"),
                            col.dtype)
    meta_build = J.JoinBuild(build.batch, 0, build.perm.to("meta"),
                             build.keys.to("meta"),
                             build.key_valid.to("meta"))
    with pytest.raises(ValueError, match="expected cuda"):
        J.join_probe(type(pl)((meta_col,), pl.num_rows, Schema(
            ("k",), (col.dtype,))), 0, meta_build, "left")
    assert not any(_lib.LAUNCHES.get(k) for k in
                   ("conditional_join_maps", "join_probe_left"))


# -- the semi and anti joins in the three execs --------------------------

EXEC_THR = "spark.rapids.sql.join.broadcastRowThreshold"
EXEC_CONFS = {
    # the exec each configuration must pick for the 150-row build side
    "broadcast": ({}, "broadcast"),
    "shuffled": ({EXEC_THR: "10", "spark.sql.shuffle.partitions": "4"},
                 "shuffled"),
    "adaptive": ({EXEC_THR: "100", "spark.sql.shuffle.partitions": "4"},
                 "adaptive"),
}


def _exec_tables():
    """A stream table of 300 rows in 3 batches and a build table of 150 in
    2, two int keys each with 12% nulls, payloads of every kind."""
    rng = np.random.RandomState(61)
    n, m = 300, 150

    def key(size, hi):
        return pa.array(rng.randint(0, hi, size).astype(np.int32),
                        mask=rng.rand(size) < 0.12)
    left = pa.table({"k": key(n, 20), "k2": key(n, 3),
                     "lv": pa.array(np.arange(n, dtype=np.int64)),
                     "ls": pa.array([f"s{i % 9}é" for i in range(n)])})
    right = pa.table({"rk": key(m, 25), "rk2": key(m, 3),
                      "rv": pa.array(np.arange(m, dtype=np.int64))})
    return ([left.slice(o, 100) for o in range(0, n, 100)],
            [right.slice(o, 75) for o in range(0, m, 75)])


def _exec_query(E, sess, make, how, nkeys, empty):
    lt, rt = _exec_tables()
    left = sess.create_dataframe([make(b) for b in lt], num_partitions=3)
    right = sess.create_dataframe([make(b) for b in rt], num_partitions=2)
    if empty:
        right = right.filter(E.col("rv") < E.lit(0))
    lk, rk = ["k", "k2"][:nkeys], ["rk", "rk2"][:nkeys]
    return left.join(right, on=([E.col(k) for k in lk],
                                [E.col(k) for k in rk]), how=how)


_EXEC_REF = {}


def _exec_reference(how, nkeys, empty):
    """The JAX session's rows of the join, sorted (once per case)."""
    import spark_rapids_tpu.expressions as RE
    from spark_rapids_tpu.api.session import TpuSession
    key = (how, nkeys, empty)
    if key not in _EXEC_REF:
        df = _exec_query(RE, TpuSession(), JaxBatch.from_arrow, how, nkeys,
                         empty)
        _EXEC_REF[key] = sorted(df.collect(), key=repr)
    return _EXEC_REF[key]


def _join_execs(node):
    from spark_rapids_tpu_torch.plan.execs.join import (
        GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec,
        GpuShuffledHashJoinExec)
    kinds = {GpuAdaptiveJoinExec: "adaptive",
             GpuBroadcastHashJoinExec: "broadcast",
             GpuShuffledHashJoinExec: "shuffled"}
    out = [kinds[type(node)]] if type(node) in kinds else []
    for c in node.children:
        out += _join_execs(c)
    return out


@pytest.mark.parametrize("exec_kind", list(EXEC_CONFS))
@pytest.mark.parametrize("nkeys", [1, 2])
@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_semi_anti_execs_match_jax_session(how, nkeys, exec_kind):
    """The broadcast, shuffled and adaptive execs give the JAX session's
    rows (the left columns alone, strings among them) on one key and on
    two, null keys in both."""
    import spark_rapids_tpu_torch.expressions as PE
    from spark_rapids_tpu_torch.api.session import GpuSession
    conf, kind = EXEC_CONFS[exec_kind]
    df = _exec_query(PE, GpuSession(conf, device="cpu"),
                     lambda b: arrow_to_batch(b, "cpu"), how, nkeys, False)
    plan = df.physical_plan()
    assert _join_execs(plan) == [kind]
    assert df.schema.names == ("k", "k2", "lv", "ls")
    from spark_rapids_tpu_torch.plan.engine import GpuEngine
    rows = sorted(GpuEngine().collect(plan), key=repr)
    assert rows == _exec_reference(how, nkeys, False)
    assert rows and len(rows) < 300


@pytest.mark.parametrize("exec_kind", list(EXEC_CONFS))
@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_semi_anti_execs_against_an_empty_build(how, exec_kind):
    """A build side filtered to nothing: the semi join emits no row, the
    anti join every stream row, null keys included, in every exec."""
    import spark_rapids_tpu_torch.expressions as PE
    from spark_rapids_tpu_torch.api.session import GpuSession
    conf, _ = EXEC_CONFS[exec_kind]
    df = _exec_query(PE, GpuSession(conf, device="cpu"),
                     lambda b: arrow_to_batch(b, "cpu"), how, 2, True)
    rows = sorted(df.collect(), key=repr)
    assert rows == _exec_reference(how, 2, True)
    assert len(rows) == (0 if how == "left_semi" else 300)


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_semi_anti_wrappers_never_fall_back_off_the_cpu(how):
    """Off the CPU the semi and anti probes (one key and several) and the
    left-only expand take their CUDA kernels, which raise for anything but
    a CUDA tensor; nothing counts as launched."""
    left, right = _sides("int", 11, 20, 10, 5)
    pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
    meta = lambda t: t.to("meta")   # noqa: E731
    col = pl.columns[0]
    meta_col = DeviceColumn(meta(col.data), meta(col.validity), col.dtype)
    stream = type(pl)((meta_col, meta_col), pl.num_rows, Schema(
        ("k", "k2"), (col.dtype, col.dtype)))
    one = J.build_side(pr, 0)
    two = J.build_side(pr, [0, 0])
    for build, keys in ((one, [0]), (two, [0, 1])):
        meta_build = J.JoinBuild(build.batch, build.key, meta(build.perm),
                                 meta(build.keys), meta(build.key_valid),
                                 build.chunks)
        with pytest.raises(ValueError, match="expected cuda"):
            J.join_probe(stream, keys, meta_build, how)
    offsets = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        J.join_expand(offsets[:0], offsets, 3, one, how)
    assert not any(_lib.LAUNCHES.get(k) for k in (
        "join_probe_semi", "join_probe_anti", "join_multi_probe_semi",
        "join_multi_probe_anti", "join_expand_left_only"))
