"""Planner: logical plan -> physical exec tree.

Counterpart of ``spark_rapids_tpu/planner/overrides.py`` (``plan_query``
:1147, ``PlanMeta.convert`` :753, ``_convert_aggregate`` :1022-1042,
``_exchange`` :1044) for InMemoryRelation, Project, Filter and Aggregate.
Over more than one partition an aggregate is split in two: a partial
aggregate, an exchange (one partition for a global aggregate; a hash
exchange on the group keys into ``spark.sql.shuffle.partitions`` for a
grouped one), then the final aggregate.  A plan node the port has no exec
for raises NotImplementedError naming it: there is no CPU fallback.
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
from spark_rapids_tpu_torch.plan.execs.scan import GpuInMemoryScanExec
from spark_rapids_tpu_torch.planner.optimizer import prune_columns


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
    raise NotImplementedError(f"no exec for {type(p).__name__} in the port")


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
    """Prune columns, then convert every node to its exec."""
    if not conf.sql_enabled:
        raise NotImplementedError(
            "spark.rapids.sql.enabled=false runs the CPU oracle engine, "
            "which is not ported")
    return _convert(prune_columns(plan), conf, device)
