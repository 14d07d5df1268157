"""Planner: logical plan -> physical exec tree.

Counterpart of ``spark_rapids_tpu/planner/overrides.py`` (``plan_query``
:1147, ``PlanMeta.convert`` :753 with ``Expand`` :808, ``Union`` :823 and
``Limit`` :826, ``_convert_join`` :945-1020, ``_convert_aggregate``
:1022-1042, ``_exchange`` :1044, ``_estimate_rows`` :1063,
``_plan_partitions`` :1090-1135, ``_insert_aqe_readers`` :1218,
``_tag_window`` :861-931, ``_convert_window`` :933-943) for
InMemoryRelation, Project, Filter, Aggregate, Join, Sort, Limit, Expand,
Union and Window.

- Over more than one partition an aggregate is split in two: a partial
  aggregate, an exchange (one partition for a global aggregate; a hash
  exchange on the group keys into ``spark.sql.shuffle.partitions`` for a
  grouped one), then the final aggregate.
- A join picks its strategy from the build (right) side's estimated rows,
  as the reference does, and carries its residual condition into whichever
  join it becomes.  Over a multi-partition stream side, a build of
  at most ``spark.rapids.sql.join.broadcastRowThreshold`` rows is a
  broadcast hash join, and one within 8x of it (with
  ``spark.rapids.sql.join.adaptive.enabled``) an adaptive join that
  decides at run time.  Any other join is a shuffled hash join, with a
  hash exchange on the keys under each side where either side has more
  than one partition.
- A union's partitions are its children's, one after another (its
  partition count is their sum); an expand runs each batch once per
  projection, and neither is a stage of a fused segment.
- A window over more than one partition reads a hash exchange on its
  partition keys into ``spark.sql.shuffle.partitions`` (a single-partition
  exchange where it has none), so that each task holds whole window
  partitions.  What the reference tags "will NOT work" and runs on its CPU
  raises NotImplementedError here with the same reason: a bounded RANGE
  frame over anything but one ascending INT, LONG or DATE key, FIRST /
  LAST / NTH_VALUE over strings, a function or input type not ported.
  One difference: the reference refuses a Window node whose expressions'
  specs differ by ``repr``, which holds the frame, so its frames of one
  (partition, order) pair run on its CPU; its exec reads each
  expression's own frame, and the port, which has no CPU fallback,
  compares only (partition_by, order_by).
- A global sort over more than one partition is a single-partition
  exchange under the sort (the shape of the reference's ``TpuSortExec``
  docstring, plan/execs/sort.py:43; its ``TpuRangeSortExec`` is not
  ported).  A limit takes the first rows across partitions.
- After conversion, with
  ``spark.rapids.sql.adaptive.coalescePartitions.enabled``, the hash
  exchange under a final aggregate is read through a coalesced reader, and
  the two under a shuffled join through two readers that share one spec.
- Then, with ``spark.rapids.sql.tpu.fuseStages`` (the default), each
  fusable chain of Project / Filter / partial aggregate becomes one fused
  segment (``plan/fused.py``, the reference's ``fuse_segments`` pass at
  :1163-1172).

Planning never asks an adaptive join or a coalesced reader for its
partition count: that would run the build side or the map side.  The
partition counts it needs come from ``_plan_partitions``, which answers
from the plan's shape.  A plan node the port has no exec for raises
NotImplementedError naming it: there is no CPU fallback.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions.aggregates import Count, Max, Min
from spark_rapids_tpu_torch.expressions.core import BoundReference
from spark_rapids_tpu_torch.expressions.window import (FirstValue, LastValue,
                                                       NthValue,
                                                       WindowFunction)
from spark_rapids_tpu_torch.kernels.sort import _kind
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.execs.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.plan.execs.base import GpuExec
from spark_rapids_tpu_torch.plan.execs.basic import (GpuFilterExec,
                                                     GpuProjectExec,
                                                     GpuUnionExec)
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuCoalescedShuffleReaderExec, GpuShuffleExchangeExec,
    GpuSinglePartitionExec, SharedCoalesceSpec)
from spark_rapids_tpu_torch.plan.execs.join import (
    GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.plan.execs.misc import GpuExpandExec
from spark_rapids_tpu_torch.plan.execs.scan import GpuInMemoryScanExec
from spark_rapids_tpu_torch.plan.execs.sort import GpuLimitExec, GpuSortExec
from spark_rapids_tpu_torch.plan.execs.window import (WINDOW_AGGREGATES,
                                                      GpuWindowExec, unwrap)
from spark_rapids_tpu_torch.plan.fused import fuse_segments
from spark_rapids_tpu_torch.planner.optimizer import (prune_columns,
                                                      push_filters)

_BROADCASTABLE = ("inner", "left", "left_semi", "left_anti", "cross",
                  "existence")


def _convert(p: L.LogicalPlan, conf: RapidsConf,
             device: torch.device) -> GpuExec:
    if isinstance(p, L.InMemoryRelation):
        return GpuInMemoryScanExec(p.partitions, p.schema)
    if isinstance(p, L.Project):
        return GpuProjectExec(p.exprs, _convert(p.child, conf, device),
                              p.schema)
    if isinstance(p, L.Filter):
        return GpuFilterExec(p.condition, _convert(p.child, conf, device))
    if isinstance(p, L.Aggregate):
        return _convert_aggregate(p, conf, device)
    if isinstance(p, L.Join):
        return _convert_join(p, conf, device)
    if isinstance(p, L.Sort):
        child = _convert(p.child, conf, device)
        if p.global_sort and _plan_partitions(child) > 1:
            child = GpuSinglePartitionExec(child)
        return GpuSortExec(p.orders, child)
    if isinstance(p, L.Limit):
        return GpuLimitExec(p.n, _convert(p.child, conf, device))
    if isinstance(p, L.Expand):
        return GpuExpandExec(p.projections, _convert(p.child, conf, device),
                             p.schema)
    if isinstance(p, L.Union):
        return GpuUnionExec(tuple(_convert(c, conf, device)
                                  for c in p.children), p.schema)
    if isinstance(p, L.Window):
        return _convert_window(p, conf, device)
    raise NotImplementedError(f"no exec for {type(p).__name__} in the port")


def _estimate_rows(p: L.LogicalPlan) -> int:
    """The reference's crude cardinality estimate for the join choice: a
    filter halves, an aggregate thirds, a limit caps, a join takes its
    larger side, a union sums its children."""
    if isinstance(p, L.InMemoryRelation):
        return sum(b.num_rows for part in p.partitions for b in part)
    if isinstance(p, L.Filter):
        return max(_estimate_rows(p.child) // 2, 1)
    if isinstance(p, L.Aggregate):
        return max(_estimate_rows(p.child) // 3, 1)
    if isinstance(p, L.Limit):
        return min(p.n, _estimate_rows(p.child))
    if isinstance(p, L.Join):
        return max(_estimate_rows(p.left), _estimate_rows(p.right))
    if isinstance(p, L.Union):
        return sum(_estimate_rows(c) for c in p.children)
    if p.children:
        return _estimate_rows(p.children[0])
    return 1 << 62


def _plan_partitions(node: GpuExec) -> int:
    """A node's partition count from the plan's shape alone: an adaptive
    join keeps at least its shuffle partitions whichever way it decides,
    a union sums its children's, a reader or a join delegates to its first
    child, and only a node that owns its partitioning (a scan, an
    exchange, a limit) is asked."""
    if isinstance(node, GpuAdaptiveJoinExec):
        return max(_plan_partitions(node.children[0]),
                   node.shuffle_partitions)
    if isinstance(node, GpuUnionExec):
        return sum(_plan_partitions(c) for c in node.children)
    if isinstance(node, (GpuCoalescedShuffleReaderExec,
                         GpuShuffledHashJoinExec, GpuBroadcastHashJoinExec)):
        return _plan_partitions(node.children[0])
    if node.children and \
            type(node).num_partitions is GpuExec.num_partitions:
        return _plan_partitions(node.children[0])
    return node.num_partitions()


def _convert_join(p: L.Join, conf: RapidsConf,
                  device: torch.device) -> GpuExec:
    left = _convert(p.left, conf, device)
    right = _convert(p.right, conf, device)
    nparts = conf.shuffle_partitions
    est = _estimate_rows(p.right)
    thr = conf.broadcast_row_threshold
    multi = _plan_partitions(left) > 1
    broadcastable = p.join_type in _BROADCASTABLE
    if broadcastable and multi and est <= thr:
        return GpuBroadcastHashJoinExec(left, right, p.left_keys,
                                        p.right_keys, p.join_type, p.schema,
                                        target_rows=conf.batch_size_rows,
                                        condition=p.condition)
    if (broadcastable and multi and p.left_keys and p.join_type != "cross"
            and est <= thr * 8 and conf.join_adaptive_enabled):
        return GpuAdaptiveJoinExec(
            left, right, p.left_keys, p.right_keys, p.join_type, p.schema,
            broadcast_threshold=thr, shuffle_partitions=nparts,
            target_rows=conf.batch_size_rows,
            aqe_coalesce=conf.aqe_coalesce_partitions, condition=p.condition)
    if p.join_type == "cross" or not p.left_keys:
        raise NotImplementedError(
            "the cross and nested-loop joins are not ported")
    # co-partition both sides on the join keys
    if _plan_partitions(left) > 1 or _plan_partitions(right) > 1:
        left = GpuShuffleExchangeExec(nparts, p.left_keys, left)
        right = GpuShuffleExchangeExec(nparts, p.right_keys, right)
    return GpuShuffledHashJoinExec(left, right, p.left_keys, p.right_keys,
                                   p.join_type, p.schema,
                                   target_rows=conf.batch_size_rows,
                                   condition=p.condition)


def _convert_aggregate(p: L.Aggregate, conf: RapidsConf,
                       device: torch.device) -> GpuExec:
    child = _convert(p.child, conf, device)
    if _plan_partitions(child) == 1:
        return GpuHashAggregateExec(p.group_exprs, p.agg_exprs, p.aggregates,
                                    child, p.schema, device, mode="complete")
    partial = GpuHashAggregateExec(p.group_exprs, p.agg_exprs, p.aggregates,
                                   child, p.schema, device, mode="partial")
    if p.group_exprs:
        # the partial output's leading columns are the keys _k0, _k1, ...
        key_refs = [BoundReference(i, e.dtype, f"_k{i}")
                    for i, e in enumerate(p.group_exprs)]
        exchange: GpuExec = GpuShuffleExchangeExec(conf.shuffle_partitions,
                                                   key_refs, partial)
    else:
        exchange = GpuSinglePartitionExec(partial)
    return GpuHashAggregateExec(p.group_exprs, p.agg_exprs, p.aggregates,
                                exchange, p.schema, device, mode="final")


#: the order keys a bounded RANGE frame searches (csrc/window.cu)
_RANGE_KEY_TYPES = (T.IntegerType, T.LongType, T.DateType)


def _window_input_ok(fn, dt: T.DataType) -> bool:
    """SUM / AVG over any integral, bool or float input, MIN / MAX over
    bool, INT, DATE, LONG, FLOAT and DOUBLE (``frame_extreme``'s types);
    no decimal or string."""
    if isinstance(dt, T.DecimalType) or dt.variable_width:
        return False
    if isinstance(fn, (Min, Max)):
        return dt.torch_dtype in (torch.bool, torch.int32, torch.int64,
                                  torch.float32, torch.float64)
    return dt.is_integral or dt.is_floating or isinstance(dt, T.BooleanType)


def _tag_window(p: L.Window) -> None:
    """Raise NotImplementedError, with the reference's reason, for what
    the window exec does not run."""
    spec = p.spec
    for what, exprs in (("partition", spec.partition_by),
                        ("order", [e for e, _ in spec.order_by])):
        for e in exprs:
            try:
                _kind(e.dtype)
            except (TypeError, NotImplementedError):
                raise NotImplementedError(
                    f"window {what} key {e!r} not supported yet") from None
    pair = (repr(spec.partition_by), repr(spec.order_by))
    for e in p.window_exprs:
        we = unwrap(e)
        if (repr(we.spec.partition_by), repr(we.spec.order_by)) != pair:
            raise NotImplementedError("mixed window specs in one Window node")
        fn, frame = we.function, we.spec.frame
        bounded_range = frame.kind == "range" and not (
            frame.is_unbounded_to_current() or frame.is_unbounded_both())
        ob = we.spec.order_by
        if bounded_range and not (
                len(ob) == 1 and ob[0][1].ascending
                and isinstance(ob[0][0].dtype, _RANGE_KEY_TYPES)):
            raise NotImplementedError(
                f"bounded range frame {frame} needs a single ascending "
                "fixed-width non-float order key")
        if isinstance(fn, (FirstValue, LastValue, NthValue)):
            if fn.child.dtype.variable_width:
                raise NotImplementedError(
                    f"{fn.name} over strings needs offset-aware frame "
                    "gathers (fixed-width inputs only)")
            continue
        if isinstance(fn, WindowFunction):
            continue
        if isinstance(fn, WINDOW_AGGREGATES) and (
                fn.input is None or isinstance(fn, Count)
                or _window_input_ok(fn, fn.input.dtype)):
            continue
        raise NotImplementedError(f"window function {fn!r} not supported")


def _convert_window(p: L.Window, conf: RapidsConf,
                    device: torch.device) -> GpuExec:
    _tag_window(p)
    child = _convert(p.child, conf, device)
    if _plan_partitions(child) > 1:
        child = (GpuShuffleExchangeExec(conf.shuffle_partitions,
                                        p.spec.partition_by, child)
                 if p.spec.partition_by else GpuSinglePartitionExec(child))
    return GpuWindowExec(p.window_exprs, child, p.schema)


def _insert_aqe_readers(root: GpuExec, conf: RapidsConf) -> GpuExec:
    """Wrap the hash exchange under each final aggregate in a coalesced
    reader, and the two under each shuffled join in two readers sharing
    one spec; runs after every structural decision of the planner."""
    if not conf.aqe_coalesce_partitions:
        return root

    def spec() -> SharedCoalesceSpec:
        return SharedCoalesceSpec(conf.batch_size_rows, conf.batch_size_bytes)

    def visit(node: GpuExec) -> None:
        kids = list(node.children)
        if (isinstance(node, GpuHashAggregateExec) and node.mode == "final"
                and isinstance(kids[0], GpuShuffleExchangeExec)):
            kids[0] = GpuCoalescedShuffleReaderExec(kids[0], spec())
        elif (isinstance(node, GpuShuffledHashJoinExec)
              and all(isinstance(k, GpuShuffleExchangeExec) for k in kids)):
            shared = spec()
            kids = [GpuCoalescedShuffleReaderExec(k, shared) for k in kids]
        node.children = tuple(kids)
        for k in node.children:
            visit(k)

    visit(root)
    return root


def plan_query(plan: L.LogicalPlan, conf: RapidsConf,
               device: torch.device) -> GpuExec:
    """Push filters down and prune columns, convert every node to its
    exec, insert the AQE readers, then fuse the stage segments."""
    if not conf.sql_enabled:
        raise NotImplementedError(
            "spark.rapids.sql.enabled=false runs the CPU oracle engine, "
            "which is not ported")
    root = _convert(prune_columns(push_filters(plan)), conf, device)
    root = _insert_aqe_readers(root, conf)
    return fuse_segments(root) if conf.fuse_stages else root
