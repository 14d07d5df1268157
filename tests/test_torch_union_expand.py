"""UNION, EXPAND (ROLLUP) and the typed null literal of the port, on the
CPU, against the JAX package's TpuSession where a query is run.

A rollup over a key that is null in the data must keep its subtotal rows
apart from that key's null group (the grouping id does it); a union of
three frames takes its names from the first and its partitions from all
three; a string column made by a null literal has no bytes, concatenates
with real strings and hashes as a null.  The planner pushes a filter into
every child of a union, prunes through unions and expands, keeps a semi
or anti join's build to its keys, never pushes a filter into such a
build, and breaks a fused chain at an expand, a union and a projection
that makes a string.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expressions as RE
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.kernels.sort import SortOrder as JaxOrder

import spark_rapids_tpu_torch.expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.core import EvalContext, Literal
from spark_rapids_tpu_torch.kernels.hash import murmur3_hash
from spark_rapids_tpu_torch.kernels.selection import concat_column
from spark_rapids_tpu_torch.kernels.sort import SortOrder as PortOrder
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.execs.basic import (GpuFilterExec,
                                                     GpuUnionExec)
from spark_rapids_tpu_torch.plan.execs.misc import GpuExpandExec
from spark_rapids_tpu_torch.plan.fused import GpuFusedSegmentExec
from spark_rapids_tpu_torch.planner.optimizer import (prune_columns,
                                                      push_filters)
from tests.test_torch_q14a import check_rows_in_order


def _table(seed: int, n: int = 120):
    """(g string with nulls, k int with nulls, v double, w long)."""
    rng = np.random.RandomState(seed)
    g = [None if m else ["a", "bb", "ccc"][i] for m, i in
         zip(rng.rand(n) < 0.15, rng.randint(0, 3, n))]
    return pa.table({
        "g": pa.array(g, pa.string()),
        "k": pa.array(rng.randint(0, 4, n).astype(np.int32),
                      mask=rng.rand(n) < 0.2),
        "v": pa.array(np.round(rng.uniform(-5, 5, n), 2)),
        "w": pa.array(rng.randint(0, 100, n).astype(np.int64))})


def _frames(sess, make, seeds=(1,), parts=2):
    return [sess.create_dataframe(
        [make(t) for t in (lambda a: [a.slice(0, 60), a.slice(60)])(
            _table(s))], num_partitions=parts) for s in seeds]


def _port():
    return GpuSession(device="cpu")


def _port_make(b):
    return arrow_to_batch(b, "cpu")


def _rollup(E, order, df):
    return (df.rollup("g", "k")
            .agg(E.sum_("v").alias("sv"), E.count().alias("n"),
                 E.sum_("w").alias("sw"))
            .order_by(("g", order(True, True)), ("k", order(True, True)),
                      ("n", order(False))))


def test_rollup_over_keys_null_in_the_data():
    """rollup(g, k): the reference's rows in order; a subtotal row
    (g, NULL) stands apart from the group whose k is null in the data."""
    want = _rollup(RE, JaxOrder, _frames(TpuSession(),
                                         JaxBatch.from_arrow)[0]).collect()
    got = _rollup(PE, PortOrder, _frames(_port(), _port_make)[0]).collect()
    check_rows_in_order(got, want)
    keys = [r[:2] for r in got]
    # the grand total, the null g's subtotal and the (null, null) group
    assert keys.count((None, None)) == 3
    for g in ("a", "bb", "ccc"):
        assert keys.count((g, None)) == 2  # its subtotal and its null k
    assert [r[3] for r in got if r[:2] == (None, None)].count(120) == 1


def test_union_of_three():
    """Three frames of other names and partition counts: the first's
    names, every row, the partitions one child after another."""
    sess = _port()
    a, b, c = _frames(sess, _port_make, seeds=(1, 2, 3))
    b = b.select(PE.col("g").alias("g2"), "k", "v", "w")
    c = sess.create_dataframe([_port_make(_table(3))], num_partitions=1)
    u = a.union(b).union(c)
    assert u.schema.names == ("g", "k", "v", "w")
    plan = u.physical_plan()
    assert isinstance(plan, GpuUnionExec) and plan.num_partitions() == 5
    parts = [[r for batch in plan.execute_partition(i) for r in batch.rows()]
             for i in range(5)]
    want = [list(zip(*t.to_pydict().values())) for t in (
        _table(1).slice(0, 60), _table(1).slice(60), _table(2).slice(0, 60),
        _table(2).slice(60), _table(3))]
    assert parts == want
    jsess = TpuSession()
    ja, jb, jc = _frames(jsess, JaxBatch.from_arrow, seeds=(1, 2, 3))
    ref = ja.union(jb).union(jc).agg(RE.sum_("w"), RE.count()).collect()
    assert u.agg(PE.sum_("w"), PE.count()).collect() == ref
    with pytest.raises(TypeError, match="identical schemas"):
        a.union(a.select("g", "k"))


def test_null_literal_is_a_typed_all_null_column():
    batch = ColumnarBatch.from_pydict({"x": [1, 2, 3]}, Schema(
        ("x",), (T.INT,)), "cpu")
    ctx = EvalContext(batch)
    for dt in (T.INT, T.LONG, T.DOUBLE, T.BOOLEAN):
        c = Literal(None, dt).eval(ctx)
        assert c.dtype == dt and c.data.dtype == dt.torch_dtype
        assert c.to_pylist() == [None] * 3 and not c.data.any()
    s = Literal(None, T.STRING).eval(ctx)
    assert s.offsets.tolist() == [0, 0, 0, 0] and s.data.numel() == 0
    assert s.to_pylist() == [None] * 3
    untyped = Literal(None)
    assert untyped.dtype == T.NULL
    c = untyped.eval(ctx)
    assert c.data.dtype == torch.int8 and c.to_pylist() == [None] * 3


def test_string_null_literal_concats_and_hashes_as_null():
    """The null string column joins real string pieces (before, between
    and after them) and hashes as a null string does."""
    batch = ColumnarBatch.from_pydict({"x": [1, 2]}, Schema(
        ("x",), (T.INT,)), "cpu")
    nulls = Literal(None, T.STRING).eval(EvalContext(batch))
    real = DeviceColumn.from_strings(["ab", None, "é", ""])
    got = concat_column([nulls, real, nulls, real.slice_rows(1, 3), nulls])
    assert got.to_pylist() == [None, None, "ab", None, "é", "", None, None,
                               None, "é", None, None]
    like = DeviceColumn.from_strings([None, None])
    assert torch.equal(murmur3_hash([nulls]), murmur3_hash([like]))


def _tree(node):
    yield node
    if isinstance(node, GpuFusedSegmentExec):
        yield from node.chain
    for c in node.children:
        yield from _tree(c)


def test_filter_pushes_into_every_child_of_a_union():
    sess = _port()
    a, b = _frames(sess, _port_make, seeds=(1, 2))
    b = b.select(PE.col("g").alias("h"), PE.col("k").alias("j"), "v", "w")
    q = a.union(b).filter(PE.col("k") > PE.lit(1))
    pushed = push_filters(q.plan)
    assert isinstance(pushed, L.Union)

    def filters(p):
        return ([p] if isinstance(p, L.Filter) else []) + [
            f for c in p.children for f in filters(c)]
    # the second child's filter is renamed to its own "j", then taken
    # below its pass-through projection, where "j" is "k" again
    assert [len(filters(c)) for c in pushed.children] == [1, 1]
    assert isinstance(pushed.children[1], L.Project)
    rows = q.collect()
    assert rows and all(r[1] > 1 for r in rows)
    want = [r for t in (_table(1), _table(2))
            for r in zip(*t.to_pydict().values())
            if r[1] is not None and r[1] > 1]
    assert sorted(rows, key=repr) == sorted(want, key=repr)


def test_pruning_goes_through_unions_and_expands():
    """A union keeps the positions its parent reads (aligned by position
    in each child); a rollup's expand keeps the key copies, the grouping
    id and the aggregates' inputs."""
    sess = _port()
    a, b = _frames(sess, _port_make, seeds=(1, 2))
    b = b.select("w", "v", "k", "g").select(
        PE.col("g").alias("g"), PE.col("k").alias("k"),
        PE.col("v").alias("v"), PE.col("w").alias("w"))
    q = a.union(b).agg(PE.sum_("v"))
    pruned = prune_columns(q.plan)
    union = pruned.child
    assert isinstance(union, L.Union)
    assert [c.schema.names for c in union.children] == [("v",), ("v",)]
    r = a.rollup("g").agg(PE.sum_("v").alias("s"))
    expand = prune_columns(r.plan).child.child
    assert isinstance(expand, L.Expand)
    assert expand.schema.names == ("v", "_gk0", "_gid")
    got = sorted(r.collect(), key=repr)
    want = sorted(_rollup_g(), key=repr)
    check_rows_in_order(got, want)


def _rollup_g():
    t = _table(1).to_pydict()
    sums = {}
    for g, v in zip(t["g"], t["v"]):
        sums[(g,)] = sums.get((g,), 0.0) + v
    return [(g, s) for (g,), s in sums.items()] + [(None, sum(t["v"]))]


@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_semi_anti_build_keeps_its_keys_and_no_filter(how):
    """A semi or anti join's build carries its key alone, even where the
    stream has a column of the same name, and a filter above the join
    stays above it (it never reaches the build)."""
    sess = _port()
    a, b = _frames(sess, _port_make, seeds=(1, 2))
    q = (a.join(b, on=([PE.col("k")], [PE.col("k")]), how=how)
         .filter(PE.col("w") > PE.lit(50)))
    opt = prune_columns(push_filters(q.plan))
    assert isinstance(opt, L.Filter) and isinstance(opt.child, L.Join)
    assert opt.child.right.schema.names == ("k",)
    plan = q.physical_plan()
    join = next(n for n in _tree(plan) if getattr(n, "join_type", "") == how)
    assert join.children[1].schema.names == ("k",)
    assert not any(isinstance(n, GpuFilterExec) for n in _tree(
        join.children[1]))
    rows = q.collect()
    b_keys = {r[1] for r in zip(*_table(2).to_pydict().values())} - {None}
    want = [r for r in zip(*_table(1).to_pydict().values())
            if r[3] > 50 and ((r[1] in b_keys) == (how == "left_semi"))]
    assert sorted(rows, key=repr) == sorted(want, key=repr)


def test_fused_chains_break_at_expand_union_and_string_literal():
    """The legs' string literal projection runs op by op, the expand and
    the union are not in any segment; the partial aggregate above the
    expand is a segment of its own."""
    sess = _port()
    a, b = _frames(sess, _port_make, seeds=(1, 2))
    q = (a.with_column("tag", PE.lit("x")).union(
        b.with_column("tag", PE.lit("y")))
        .filter(PE.col("v") > PE.lit(0.0))
        .rollup("tag", "k").agg(PE.sum_("w").alias("sw")))
    plan = q.physical_plan()
    nodes = list(_tree(plan))
    segs = [n for n in nodes if isinstance(n, GpuFusedSegmentExec)]
    assert any(isinstance(n, GpuExpandExec) for n in nodes)
    for seg in segs:
        assert not any(isinstance(c, (GpuExpandExec, GpuUnionExec))
                       for c in seg.chain)
        for c in seg.chain:
            assert "lit('" not in repr(getattr(c, "exprs", ""))
    above = [s for s in segs if isinstance(s.children[0], GpuExpandExec)]
    assert len(above) == 1 and len(above[0].chain) == 1
    rows = q.collect()
    assert {r[0] for r in rows} == {"x", "y", None}
