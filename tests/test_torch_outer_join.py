"""The port's right, full, cross and keyless (nested-loop) joins on the
CPU, against the JAX package.

Queries hold the port against the JAX package's CPU oracle
(``spark.rapids.sql.enabled=false``) over the shapes of the reference's
``tests/test_joins.py`` ``left_df`` :19 and ``right_df`` :35
(``testing/held.py`` ``join_columns``: 300 rows and 150, in batches of
100 and 60, 3 and 2 partitions): the right and full joins (:50), the
cross join (:63), empty sides (:104-111), the right and full joins with a
condition (:167-177), the nested-loop joins (:184-197) and the
conditional joins with empty sides (:226-239); right never broadcasts
(``tests/test_broadcast_join.py:29-35``); the out-of-core right and full
joins (``tests/test_out_of_core.py:144``) at a ``batchSizeRows`` of 512.
A right or full join whose stream spans several groups, with the build
rows passing only in the later ones, must null-extend no build row that
passes.  At the kernel level, the port's right, full and cross maps must
equal the reference's ``join_gather_maps`` exactly and in order (its
out-of-range index written as -1) on one key and on two, strings, nulls,
NaN and -0.0; the JAX kernels run at one padded size (64 stream rows
against 32), so that their compiled steps are shared.

Tolerance: exact (the joins move values; the aggregates over them sum
integers).
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as JE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels import join as jjoin
from tests.test_queries import _normalize
from tests.test_torch_out_of_core import _branches, _join, assert_ooc_equal

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.kernels import join as J
from spark_rapids_tpu_torch.plan.execs.basic import GpuFilterExec
from spark_rapids_tpu_torch.plan.execs.join import (GpuBroadcastHashJoinExec,
                                                    GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.testing import held

ORACLE = {"spark.rapids.sql.enabled": "false"}
SHUFFLED = {"spark.rapids.sql.join.broadcastRowThreshold": "0",
            "spark.sql.shuffle.partitions": "4"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six pytest workers' torch thread pools contend: one thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sides(n=300, small=-1):
    (ld, lv), (rd, rv) = held.join_columns(n, 5)
    return (held.join_batches(ld, lv, held.JOIN_LEFT_SCHEMA, "cpu", 100),
            held.join_batches(rd, rv, held.JOIN_RIGHT_SCHEMA, "cpu", 60,
                              rows=small))


def _frames(sess, make, lb, rb, lparts, rparts):
    return (sess.create_dataframe([make(b) for b in lb],
                                  num_partitions=lparts),
            sess.create_dataframe([make(b) for b in rb],
                                  num_partitions=rparts))


def _check(build, n=300, small=-1, lparts=3, rparts=2, conf=None):
    """build(E, left, right) -> DataFrame in either DSL: the port's rows
    against the oracle's, sorted; returns the port's plan."""
    lb, rb = _sides(n, small)
    want = build(JE, *_frames(TpuSession(ORACLE),
                              lambda b: JaxBatch.from_arrow(b.to_arrow()),
                              lb, rb, lparts, rparts)).collect()
    df = build(PE, *_frames(GpuSession(conf, device="cpu"), lambda b: b,
                            lb, rb, lparts, rparts))
    assert _normalize(df.collect()) == _normalize(want)
    return df.physical_plan()


def _lv_lt_rv(E):
    return E.col("lv") < E.col("rv")


@pytest.mark.parametrize("conf", [None, SHUFFLED], ids=["default", "4_parts"])
@pytest.mark.parametrize("how", ["right", "full"])
def test_right_and_full_joins_match_oracle(how, conf):
    plan = _check(lambda E, l, r: l.join(r, "k", how=how), conf=conf)
    assert isinstance(plan, GpuShuffledHashJoinExec)


def test_right_join_never_broadcasts():
    """The build of a right join is the side it null-extends: a build far
    under the broadcast threshold still plans a shuffled join."""
    plan = _check(lambda E, l, r: l.join(r, "k", how="right"))
    assert isinstance(plan, GpuShuffledHashJoinExec)
    assert not any(isinstance(c, GpuBroadcastHashJoinExec)
                   for c in plan.children)


@pytest.mark.parametrize("conf", [None, SHUFFLED],
                         ids=["broadcast", "single_partition"])
def test_cross_join_matches_oracle(conf):
    plan = _check(lambda E, l, r: l.join(r, on=([], []), how="cross"),
                  n=40, lparts=2, rparts=1, small=15, conf=conf)
    assert isinstance(plan, GpuBroadcastHashJoinExec if conf is None
                      else GpuShuffledHashJoinExec)
    assert plan.join_type == "cross"


def test_cross_join_with_condition_is_a_filter_over_the_product():
    plan = _check(lambda E, l, r: l.join(r, on=([], []), how="cross",
                                         condition=_lv_lt_rv(E)),
                  n=40, lparts=2, rparts=1, small=15)
    assert isinstance(plan, GpuFilterExec)
    assert plan.children[0].condition is None


def _empty(E, df, c):
    return df.filter(E.col(c) > E.lit(10**9))


@pytest.mark.parametrize("case", [
    "empty_stream_right", "empty_stream_full", "empty_build_right",
    "empty_build_full", "empty_build_left", "empty_build_anti"])
def test_empty_sides_match_oracle(case):
    side, how = case.split("_")[1], case.split("_")[2]
    how = {"anti": "left_anti"}.get(how, how)

    def build(E, l, r):
        if side == "stream":
            l = _empty(E, l, "lv")
        else:
            r = _empty(E, r, "rv")
        return l.join(r, "k", how=how)
    _check(build)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_join_types_with_condition_match_oracle(how):
    _check(lambda E, l, r: l.join(r, "k", how=how, condition=_lv_lt_rv(E)))


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_nested_loop_join_matches_oracle(how):
    plan = _check(lambda E, l, r: l.join(r, None, how=how,
                                         condition=_lv_lt_rv(E)),
                  n=80, lparts=2, rparts=1, small=40)
    assert isinstance(plan, GpuBroadcastHashJoinExec)


@pytest.mark.parametrize("how", ["right", "full"])
def test_nested_loop_right_and_full_collapse_to_one_partition(how):
    plan = _check(lambda E, l, r: l.join(r, None, how=how,
                                         condition=_lv_lt_rv(E)),
                  n=60, lparts=2, rparts=2, small=30)
    assert isinstance(plan, GpuShuffledHashJoinExec)
    assert plan.num_partitions() == 1


@pytest.mark.parametrize("how", ["left", "left_anti", "full"])
def test_conditional_join_with_empty_sides(how):
    _check(lambda E, l, r: l.join(_empty(E, r, "rv"), "k", how=how,
                                  condition=_lv_lt_rv(E)))


def test_keyless_join_without_condition_raises():
    """As the reference tags it (``will_not_work``): use a cross join."""
    lb, rb = _sides(40, 15)
    left, right = _frames(GpuSession(device="cpu"), lambda b: b, lb, rb, 2,
                          1)
    with pytest.raises(NotImplementedError,
                       match="keyless inner join without a condition"):
        left.join(right, None, how="inner").physical_plan()


def _group_tables():
    """A build of three rows of key 1 (rv 10, 20, 30) and one of key 2;
    a stream in three batches of four rows, whose first batch passes no
    build row, the second only rv 30 and the third rv 20 and 30; key 2
    and a null key match in no group."""
    stream = pa.table({
        "k": pa.array([1, 1, 2, None, 1, 1, 1, 2, 1, 1, None, 1],
                      pa.int32()),
        "lv": pa.array([40, 50, 60, 5, 25, 26, 27, 1, 15, 16, 3, None],
                       pa.int64())})
    build = pa.table({"k": pa.array([1, 1, 1, 3], pa.int32()),
                      "rv": pa.array([10, 20, 30, 7], pa.int64())})
    return stream, build


@pytest.mark.parametrize("condition", [True, False],
                         ids=["condition", "keys_only"])
@pytest.mark.parametrize("how", ["right", "full"])
def test_right_and_full_flags_span_the_stream_groups(how, condition):
    """The stream joins in three groups of at most batchSizeRows = 4
    rows against one build; a build row that passes only in a later
    group is not null-extended in an earlier one, and the unmatched build
    rows come once, after the last group."""
    stream, build = _group_tables()
    conf = {"spark.rapids.sql.batchSizeRows": "4"}

    def q(E, sess, make):
        s = sess.create_dataframe([make(stream.slice(o, 4))
                                   for o in (0, 4, 8)])
        b = sess.create_dataframe([make(build)])
        cond = _lv_lt_rv(E) if condition else None
        return s.join(b, "k", how=how, condition=cond)
    want = q(JE, TpuSession(ORACLE), JaxBatch.from_arrow).collect()
    df = q(PE, GpuSession(conf, device="cpu"),
           lambda t: arrow_to_batch(t, "cpu"))
    plan = df.physical_plan()
    got = list(plan.execute_partition(0))
    assert isinstance(plan, GpuShuffledHashJoinExec)
    assert dict(plan.branches) == {"streamed": 1} and len(got) >= 4
    batches = [list(zip(*(c.to_pylist() for c in b.to_arrow().columns)))
               for b in got]
    rows = [r for b in batches for r in b]
    assert _normalize(rows) == _normalize(want)
    # the unmatched build rows form the last batch, each once
    assert all(r[0] is None and r[1] is None for r in batches[-1])
    matched = {r[3] for r in rows if r[1] is not None and r[3] is not None}
    unmatched = [r[3] for r in rows if r[0] is None and r[1] is None]
    assert not matched & set(unmatched)
    assert sorted(unmatched) == sorted(
        rv for rv in (10, 20, 30, 7) if rv not in matched)
    if condition:
        assert matched == {20, 30}


@pytest.mark.parametrize("how", ["right", "full"])
def test_out_of_core_right_and_full_joins(how):
    """tests/test_out_of_core.py:144's join at batchSizeRows 512: every
    build partition above it joins bucket by bucket, each bucket's
    unmatched build rows after its last stream group."""
    plan = assert_ooc_equal(lambda w, s: _join(w, s, how))
    assert _branches(plan, GpuShuffledHashJoinExec).get("out_of_core") >= 1


# -- kernel level: the maps against the reference's -------------------------

def _kernel_case(case, rng):
    """(stream table, build table, key count) at one padded size."""
    nl, nr = 64, 32
    if case == "int":
        return (pa.table({"k": pa.array(rng.randint(0, 12, nl).astype(
                    np.int32), mask=rng.rand(nl) < 0.15)}),
                pa.table({"k": pa.array(rng.randint(0, 16, nr).astype(
                    np.int32), mask=rng.rand(nr) < 0.15)}), 1)
    if case == "double":
        vals = [0.0, -0.0, float("nan"), -float("nan"), 1.5, 2.5]
        return (pa.table({"k": pa.array(rng.choice(vals[:5], nl),
                                        mask=rng.rand(nl) < 0.1)}),
                pa.table({"k": pa.array(rng.choice(vals, nr),
                                        mask=rng.rand(nr) < 0.1)}), 1)
    words = ["", "a", "ab", "ab\x00", "é", "longer than eight"]
    return (pa.table({"k": pa.array(rng.randint(0, 4, nl).astype(np.int32),
                                    mask=rng.rand(nl) < 0.1),
                      "s": pa.array([words[i] for i in rng.randint(0, 5, nl)],
                                    mask=rng.rand(nl) < 0.1)}),
            pa.table({"k": pa.array(rng.randint(0, 5, nr).astype(np.int32),
                                    mask=rng.rand(nr) < 0.1),
                      "s": pa.array([words[i] for i in rng.randint(0, 6, nr)],
                                    mask=rng.rand(nr) < 0.1)}), 2)


def _reference_maps(left, right, keys, how):
    """The reference's maps, its out-of-range indices written as -1."""
    jl, jr = JaxBatch.from_arrow(left), JaxBatch.from_arrow(right)
    cap = left.num_rows * right.num_rows + left.num_rows + right.num_rows
    li, ri, count, _ = jjoin.join_gather_maps(jl, keys, jr, keys, how, cap,
                                              string_max_bytes=32)
    c = int(count)
    li, ri = (np.asarray(m)[:c].astype(np.int64) for m in (li, ri))
    return (np.where((li < 0) | (li >= left.num_rows), -1, li),
            np.where((ri < 0) | (ri >= right.num_rows), -1, ri))


def test_outer_and_cross_maps_match_reference():
    """Right and full on one int key (nulls, duplicates), on doubles (NaN
    and -0.0 match) and on (int, string); the cross join: the maps equal
    the reference's, in order (the left-driven pairs, then the unmatched
    build rows in build-row order)."""
    rng = np.random.RandomState(14)
    for case in ("int", "double", "int_string"):
        left, right, nkeys = _kernel_case(case, rng)
        keys = list(range(nkeys))
        pl, pr = arrow_to_batch(left, "cpu"), arrow_to_batch(right, "cpu")
        for how in ("right", "full", "cross"):
            if how == "cross" and case != "int":
                continue
            k = [] if how == "cross" else keys
            li, ri, count = J.join_gather_maps(pl, k, pr, k, how)
            want_li, want_ri = _reference_maps(left, right, k, how)
            assert count == len(want_li), (case, how)
            np.testing.assert_array_equal(li.numpy(), want_li,
                                          err_msg=f"{case} {how}")
            np.testing.assert_array_equal(ri.numpy(), want_ri,
                                          err_msg=f"{case} {how}")
            if how != "cross":      # unmatched build rows; null keys
                assert (li == -1).any(), (case, how)
                assert (ri == -1).any() == (how == "full"), (case, how)
