"""Logical optimizations applied before planning: predicate pushdown, then
column pruning.

Counterpart of ``spark_rapids_tpu/planner/optimizer.py`` (``push_filters``
:67-191 with the union branch :142-154, ``_rebuild`` :189, ``prune_columns``
:38 with the union at :271 and the window at :281-290) for
InMemoryRelation, Project, Filter, Aggregate, Join, Sort, Limit, Expand,
Union and Window.  ``push_filters`` moves
each conjunct of a filter over an inner join into the side whose columns
it references (so q3's ``i_manufact_id = 28`` and ``d_moy = 11`` filter
the dimension tables before the joins), below a Project of pass-through
columns, and into every child of a Union (renamed by position), and merges
adjacent filters; a filter over any other join stays where it is, so none
crosses a left join's null side or reaches a semi or anti join's build,
and none crosses a Window: a filter below it would change the rows each
window sees, whatever columns it reads.
``prune_columns`` makes a scan carry only the columns some ancestor, a
join's residual condition included, references, through a Project of
column references on top of the relation (a zero-copy select in the
exec).  It goes further than the reference in two places: a Union keeps
only the positions its parent needs (a Project of column references over
each child keeps the positions aligned), an Expand only the output columns
its parent needs; and the build side of a semi or anti join keeps only its
keys and what the condition reads.  Expressions are bound
by ordinal, so both passes rebuild the tree through name-based
unbinding; a plan with duplicate column names is left as is.
"""
from __future__ import annotations

from typing import List, Set

from spark_rapids_tpu_torch.expressions.core import (
    Alias, BoundReference, Col, Expression)
from spark_rapids_tpu_torch.kernels.join import LEFT_ONLY
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


# -- predicate pushdown -------------------------------------------------------

def _split_conjuncts(e: Expression) -> List[Expression]:
    from spark_rapids_tpu_torch.expressions.predicates import And
    if isinstance(e, And):
        return _split_conjuncts(e.children[0]) + _split_conjuncts(
            e.children[1])
    return [e]


def _and_all(conjuncts: List[Expression]) -> Expression:
    from spark_rapids_tpu_torch.expressions.predicates import And
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = And(out, c)
    return out


def push_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Push filter conjuncts below inner joins, pass-through projects and
    other filters, toward the scans."""
    if not _names_unique(plan):
        return plan
    return _push(plan)


def _join(p: L.Join, left: L.LogicalPlan, right: L.LogicalPlan) -> L.Join:
    """``p`` over new children, its keys and condition unbound."""
    return L.Join(left, right, [_unbind(k) for k in p.left_keys],
                  [_unbind(k) for k in p.right_keys], p.join_type,
                  _unbind(p.condition) if p.condition is not None else None)


def _rename(e: Expression, mapping) -> Expression:
    if isinstance(e, (Col, BoundReference)):
        return Col(mapping.get(e.name, e.name))
    if not e.children:
        return e
    return e.with_children(tuple(_rename(c, mapping) for c in e.children))


def _push(plan: L.LogicalPlan) -> L.LogicalPlan:
    if isinstance(plan, L.Filter):
        child = plan.child
        conjuncts = [_unbind(c) for c in _split_conjuncts(plan.condition)]
        if isinstance(child, L.Join) and child.join_type == "inner":
            lnames = set(child.left.schema.names)
            rnames = set(child.right.schema.names)
            lpush, rpush, keep = [], [], []
            for c in conjuncts:
                refs = c.references()
                if refs and refs <= lnames:
                    lpush.append(c)
                elif refs and refs <= rnames:
                    rpush.append(c)
                else:
                    keep.append(c)
            if lpush or rpush:
                left = L.Filter(_and_all(lpush), child.left) if lpush \
                    else child.left
                right = L.Filter(_and_all(rpush), child.right) if rpush \
                    else child.right
                joined = _join(child, _push(left), _push(right))
                return L.Filter(_and_all(keep), joined) if keep else joined
        if isinstance(child, L.Project):
            # conjuncts over pass-through columns (a column or an alias of
            # one) go below the project
            passthrough = {}
            for e, n in zip(child.exprs, child.schema.names):
                inner = e.child if isinstance(e, Alias) else e
                if isinstance(inner, (BoundReference, Col)):
                    passthrough[n] = inner.name
            push, keep = [], []
            for c in conjuncts:
                refs = c.references()
                if refs and refs <= set(passthrough):
                    push.append(_rename(c, passthrough))
                else:
                    keep.append(c)
            if push:
                proj = L.Project([_unbind(e) for e in child.exprs],
                                 _push(L.Filter(_and_all(push),
                                                child.child)))
                return L.Filter(_and_all(keep), proj) if keep else proj
        if isinstance(child, L.Filter):
            merged = L.Filter(_and_all(conjuncts + [
                _unbind(c) for c in _split_conjuncts(child.condition)]),
                child.child)
            if not isinstance(child.child, (L.Filter, L.Join, L.Project,
                                            L.Union)):
                return L.Filter(merged.condition, _push(child.child))
            return _push(merged)
        if isinstance(child, L.Union):
            # a union's children name their columns their own way: each
            # conjunct is renamed by position for each child
            pushed = []
            for u in child.children:
                mapping = dict(zip(child.schema.names, u.schema.names))
                pushed.append(_push(L.Filter(_and_all(
                    [_rename(c, mapping) for c in conjuncts]), u)))
            return L.Union(pushed)
    return _rebuild(plan, [_push(c) for c in plan.children])


def _rebuild(plan: L.LogicalPlan, children) -> L.LogicalPlan:
    if all(n is o for n, o in zip(children, plan.children)):
        return plan
    if isinstance(plan, L.Filter):
        return L.Filter(_unbind(plan.condition), children[0])
    if isinstance(plan, L.Project):
        return L.Project([_unbind(e) for e in plan.exprs], children[0])
    if isinstance(plan, L.Join):
        return _join(plan, children[0], children[1])
    if isinstance(plan, L.Aggregate):
        return L.Aggregate([_unbind(e) for e in plan.group_exprs],
                           [_unbind(e) for e in plan.agg_exprs], children[0])
    if isinstance(plan, L.Sort):
        return L.Sort([(_unbind(e), o) for e, o in plan.orders], children[0],
                      plan.global_sort)
    if isinstance(plan, L.Limit):
        return L.Limit(plan.n, children[0])
    if isinstance(plan, L.Union):
        return L.Union(children)
    if isinstance(plan, L.Expand):
        return _expand(plan.projections, plan.schema.names, children[0])
    if isinstance(plan, L.Window):
        return L.Window([_unbind(e) for e in plan.window_exprs], children[0])
    raise NotImplementedError(f"logical node {type(plan).__name__} is not "
                              "ported")


def _expand(projections, names, child) -> L.Expand:
    return L.Expand([[_unbind(e) for e in proj] for proj in projections],
                    names, child)


# -- column pruning -----------------------------------------------------------

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
    if isinstance(p, L.Sort):
        child = _prune(p.child, set(required)
                       | _exprs_refs(e for e, _ in p.orders))
        return L.Sort([(_unbind(e), o) for e, o in p.orders], child,
                      p.global_sort)
    if isinstance(p, L.Limit):
        return L.Limit(p.n, _prune(p.child, required))
    if isinstance(p, L.Join):
        lnames, rnames = set(p.left.schema.names), set(p.right.schema.names)
        crefs = (p.condition.references() if p.condition is not None
                 else set())
        # a semi or anti join outputs the left columns alone: whatever the
        # parent needs by a right column's name is a left column
        rout = set() if p.join_type in LEFT_ONLY else set(required)
        left = _prune(p.left, ((set(required) | crefs) & lnames)
                      | _exprs_refs(p.left_keys))
        right = _prune(p.right, ((rout | crefs) & rnames)
                       | _exprs_refs(p.right_keys))
        return _join(p, left, right)
    if isinstance(p, L.Union):
        keep = [i for i, n in enumerate(p.schema.names)
                if n in required] or [0]
        children = []
        for c in p.children:
            want = tuple(c.schema.names[i] for i in keep)
            pc = _prune(c, set(want))
            if pc.schema.names != want:
                pc = L.Project([Col(n) for n in want], pc)
            children.append(pc)
        return L.Union(children)
    if isinstance(p, L.Expand):
        keep = [i for i, n in enumerate(p.schema.names)
                if n in required] or [0]
        projections = [[proj[i] for i in keep] for proj in p.projections]
        child = _prune(p.child, _exprs_refs(e for proj in projections
                                            for e in proj))
        return _expand(projections, [p.schema.names[i] for i in keep], child)
    if isinstance(p, L.Window):
        # the child keeps what the parent needs of its columns and every
        # column the window expressions read
        names = set(p.child.schema.names)
        child = _prune(p.child, (set(required) & names)
                       | _exprs_refs(p.window_exprs))
        return L.Window([_unbind(e) for e in p.window_exprs], child)
    raise NotImplementedError(f"logical node {type(p).__name__} is not ported")
