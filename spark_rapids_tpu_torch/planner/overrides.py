"""Planner: logical plan -> physical exec tree.

Counterpart of ``spark_rapids_tpu/planner/overrides.py`` (``plan_query``
:1147, ``PlanMeta.convert`` :753, ``_convert_join`` :945,
``_convert_aggregate`` :1022-1042, ``_exchange`` :1044, ``_estimate_rows``
:1063) for InMemoryRelation, Project, Filter, Aggregate, Join and Sort.
Over more than one partition an aggregate is split in two: a partial
aggregate, an exchange (one partition for a global aggregate; a hash
exchange on the group keys into ``spark.sql.shuffle.partitions`` for a
grouped one), then the final aggregate.  A join whose build (right) side
is estimated at no more than ``spark.rapids.sql.join.broadcastRowThreshold``
rows, over a multi-partition stream side, is a broadcast hash join; the
reference's adaptive and shuffled joins are not ported and raise.  A
global sort over more than one partition is a single-partition exchange
under the sort (the shape of the reference's ``TpuSortExec`` docstring,
plan/execs/sort.py:43; its ``TpuRangeSortExec`` is not ported).  A plan
node the port has no exec for raises NotImplementedError naming it: there
is no CPU fallback.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions.core import BoundReference
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.execs.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.plan.execs.base import GpuExec
from spark_rapids_tpu_torch.plan.execs.basic import (GpuFilterExec,
                                                     GpuProjectExec)
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuShuffleExchangeExec, GpuSinglePartitionExec)
from spark_rapids_tpu_torch.plan.execs.join import GpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.plan.execs.scan import GpuInMemoryScanExec
from spark_rapids_tpu_torch.plan.execs.sort import GpuSortExec
from spark_rapids_tpu_torch.planner.optimizer import (prune_columns,
                                                      push_filters)


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
        if p.global_sort and child.num_partitions() > 1:
            child = GpuSinglePartitionExec(child)
        return GpuSortExec(p.orders, child)
    raise NotImplementedError(f"no exec for {type(p).__name__} in the port")


def _estimate_rows(p: L.LogicalPlan) -> int:
    """The reference's crude cardinality estimate for the broadcast
    choice: a filter halves, an aggregate thirds, a join takes its larger
    side."""
    if isinstance(p, L.InMemoryRelation):
        return sum(b.num_rows for part in p.partitions for b in part)
    if isinstance(p, L.Filter):
        return max(_estimate_rows(p.child) // 2, 1)
    if isinstance(p, L.Aggregate):
        return max(_estimate_rows(p.child) // 3, 1)
    if isinstance(p, L.Join):
        return max(_estimate_rows(p.left), _estimate_rows(p.right))
    if p.children:
        return _estimate_rows(p.children[0])
    return 1 << 62


def _convert_join(p: L.Join, conf: RapidsConf,
                  device: torch.device) -> GpuExec:
    left = _convert(p.left, conf, device)
    right = _convert(p.right, conf, device)
    broadcastable = p.join_type in ("inner", "left", "left_semi",
                                    "left_anti", "cross", "existence")
    est = _estimate_rows(p.right)
    thr = conf.broadcast_row_threshold
    multi = left.num_partitions() > 1
    if broadcastable and multi and est <= thr:
        return GpuBroadcastHashJoinExec(left, right, p.left_keys,
                                        p.right_keys, p.join_type, p.schema,
                                        target_rows=conf.batch_size_rows)
    if (broadcastable and multi and p.left_keys and p.join_type != "cross"
            and est <= thr * 8):
        raise NotImplementedError(
            f"the adaptive join (TpuAdaptiveJoinExec) is not ported: the "
            f"build side's estimate of {est} rows is above "
            f"spark.rapids.sql.join.broadcastRowThreshold={thr}")
    raise NotImplementedError(
        "the shuffled hash join (TpuShuffledHashJoinExec) is not ported: "
        "a join broadcasts only over a multi-partition stream side and a "
        f"build side of at most {thr} estimated rows")


def _convert_aggregate(p: L.Aggregate, conf: RapidsConf,
                       device: torch.device) -> GpuExec:
    child = _convert(p.child, conf, device)
    if child.num_partitions() == 1:
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


def plan_query(plan: L.LogicalPlan, conf: RapidsConf,
               device: torch.device) -> GpuExec:
    """Push filters down and prune columns, then convert every node to its
    exec."""
    if not conf.sql_enabled:
        raise NotImplementedError(
            "spark.rapids.sql.enabled=false runs the CPU oracle engine, "
            "which is not ported")
    return _convert(prune_columns(push_filters(plan)), conf, device)
