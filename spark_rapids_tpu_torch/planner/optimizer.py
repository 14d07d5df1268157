"""Logical optimization applied before planning: column pruning.

Counterpart of ``spark_rapids_tpu/planner/optimizer.py`` (``prune_columns``
:38) for InMemoryRelation, Project, Filter and Aggregate: a scan carries
only the columns some ancestor references, through a Project of column
references on top of the relation (a zero-copy select in the exec).
Expressions are bound by ordinal, so pruning rebuilds the tree through
name-based unbinding; a plan with duplicate column names is left as is.
"""
from __future__ import annotations

from typing import Set

from spark_rapids_tpu_torch.expressions.core import (
    Alias, BoundReference, Col, Expression)
from spark_rapids_tpu_torch.plan import logical as L


def _unbind(e: Expression) -> Expression:
    if isinstance(e, BoundReference):
        return Col(e.name)
    if not e.children:
        return e
    return e.with_children(tuple(_unbind(c) for c in e.children))


def _names_unique(plan: L.LogicalPlan) -> bool:
    names = plan.schema.names
    if len(set(names)) != len(names):
        return False
    return all(_names_unique(c) for c in plan.children)


def _exprs_refs(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        out |= e.references()
    return out


def prune_columns(plan: L.LogicalPlan) -> L.LogicalPlan:
    if not _names_unique(plan):
        return plan
    return _prune(plan, set(plan.schema.names))


def _prune(p: L.LogicalPlan, required: Set[str]) -> L.LogicalPlan:
    if isinstance(p, L.InMemoryRelation):
        have = list(p.schema.names)
        keep = [n for n in have if n in required]
        if len(keep) == len(have) or not keep:
            return p
        return L.Project([Col(n) for n in keep], p)
    if isinstance(p, L.Project):
        kept = [(e, n) for e, n in zip(p.exprs, p.schema.names)
                if n in required] or [(p.exprs[0], p.schema.names[0])]
        child = _prune(p.child, _exprs_refs(e for e, _ in kept))
        return L.Project([_unbind(e).alias(n) for e, n in kept], child)
    if isinstance(p, L.Filter):
        child = _prune(p.child, set(required) | _exprs_refs([p.condition]))
        return L.Filter(_unbind(p.condition), child)
    if isinstance(p, L.Aggregate):
        child = _prune(p.child, _exprs_refs(list(p.group_exprs)
                                            + list(p.agg_exprs)))
        nkeys = len(p.group_exprs)
        names = p.schema.names
        return L.Aggregate(
            [_unbind(e) if isinstance(e, Alias)
             else _unbind(e).alias(names[i])
             for i, e in enumerate(p.group_exprs)],
            [_unbind(e) if isinstance(e, Alias)
             else _unbind(e).alias(names[nkeys + i])
             for i, e in enumerate(p.agg_exprs)],
            child)
    raise NotImplementedError(f"logical node {type(p).__name__} is not ported")
