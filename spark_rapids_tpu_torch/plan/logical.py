"""Logical plan: what the user asked for, engine-agnostic.

Counterpart of ``spark_rapids_tpu/plan/logical.py`` (``InMemoryRelation``
:45, ``Project`` :189, ``Filter`` :205, ``Aggregate`` :222, ``Sort`` :251,
``Limit`` :269, ``Join`` :287, ``Expand`` :387, ``Union`` :464,
``Window`` :509).  Schemas resolve eagerly, so binding
errors surface when the plan is built.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.aggregates import find_aggregates
from spark_rapids_tpu_torch.expressions.core import (Alias, Expression,
                                                     output_name)
from spark_rapids_tpu_torch.kernels.join import JOIN_TYPES
from spark_rapids_tpu_torch.kernels.sort import SortOrder


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError


class InMemoryRelation(LogicalPlan):
    """Leaf: batches already on the device, in partitions."""

    def __init__(self, partitions: Sequence[List[ColumnarBatch]],
                 schema: Schema):
        self.partitions = list(partitions)
        self._schema = schema

    @property
    def schema(self):
        return self._schema


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.exprs = tuple(e.bind(child.schema) for e in exprs)
        self.child = child
        self.children = (child,)
        names = tuple(output_name(e, i) for i, e in enumerate(exprs))
        self._schema = Schema(names, tuple(e.dtype for e in self.exprs))

    @property
    def schema(self):
        return self._schema


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition.bind(child.schema)
        if not isinstance(self.condition.dtype, T.BooleanType):
            raise TypeError(f"filter condition must be boolean, got "
                            f"{self.condition.dtype!r}")
        self.child = child
        self.children = (child,)

    @property
    def schema(self):
        return self.child.schema


class Aggregate(LogicalPlan):
    """Aggregate: group_exprs are the keys (none: a global aggregate);
    agg_exprs are output expressions over aggregate calls."""

    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Expression], child: LogicalPlan):
        self.group_exprs = tuple(e.bind(child.schema) for e in group_exprs)
        self.agg_exprs = tuple(e.bind(child.schema) for e in agg_exprs)
        self.child = child
        self.children = (child,)
        exprs = list(group_exprs) + list(agg_exprs)
        bound = list(self.group_exprs) + list(self.agg_exprs)
        self._schema = Schema(
            tuple(output_name(e, i) for i, e in enumerate(exprs)),
            tuple(e.dtype for e in bound))
        self.aggregates = [a for e in self.agg_exprs
                           for a in find_aggregates(e)]

    @property
    def schema(self):
        return self._schema


class Sort(LogicalPlan):
    """ORDER BY: (expression, SortOrder) pairs, most significant first; a
    global sort orders all partitions as one."""

    def __init__(self, orders: Sequence[Tuple[Expression, SortOrder]],
                 child: LogicalPlan, global_sort: bool = True):
        self.orders = tuple((e.bind(child.schema), o) for e, o in orders)
        self.global_sort = global_sort
        self.child = child
        self.children = (child,)

    @property
    def schema(self):
        return self.child.schema


class Limit(LogicalPlan):
    """The first ``n`` rows, across partitions in order."""

    def __init__(self, n: int, child: LogicalPlan):
        if n < 0:
            raise ValueError(f"a limit needs n >= 0, got {n}")
        self.n = int(n)
        self.child = child
        self.children = (child,)

    @property
    def schema(self):
        return self.child.schema


class Join(LogicalPlan):
    """Equi-join on key expression pairs plus an optional residual
    condition; the output is the left columns, then the right ones (only
    the left ones for semi and anti joins, and an ``exists`` column for the
    existence join).  The condition binds against the pair schema, the
    left columns then the right ones, whatever the join type."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner",
                 condition: Optional[Expression] = None):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        if len(left_keys) != len(right_keys):
            raise ValueError("a join needs as many left keys as right keys")
        self.left = left
        self.right = right
        self.left_keys = tuple(e.bind(left.schema) for e in left_keys)
        self.right_keys = tuple(e.bind(right.schema) for e in right_keys)
        self.join_type = join_type
        self.children = (left, right)
        if join_type in ("left_semi", "left_anti"):
            self._schema = left.schema
        elif join_type == "existence":
            self._schema = Schema(left.schema.names + ("exists",),
                                  left.schema.dtypes + (T.BOOLEAN,))
        else:
            self._schema = self.pair_schema
        self.condition = (condition.bind(self.pair_schema)
                          if condition is not None else None)
        if self.condition is not None and \
                not isinstance(self.condition.dtype, T.BooleanType):
            raise TypeError(f"join condition must be boolean, got "
                            f"{self.condition.dtype!r}")

    @property
    def pair_schema(self) -> Schema:
        """The left columns, then the right ones: the schema a candidate
        pair presents to the condition."""
        return Schema(self.left.schema.names + self.right.schema.names,
                      self.left.schema.dtypes + self.right.schema.dtypes)

    @property
    def schema(self):
        return self._schema


class Expand(LogicalPlan):
    """Each input row emitted once per projection (Spark's ExpandExec), the
    substrate of ROLLUP.  Every projection gives one expression per output
    name, each output column of one type across the projections (a slot
    that is null in one projection is a typed null literal there)."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: LogicalPlan):
        if not projections or any(len(p) != len(names) for p in projections):
            raise ValueError("an expand needs projections of one expression "
                             "per output name")
        self.projections = tuple(tuple(e.bind(child.schema) for e in p)
                                 for p in projections)
        self.child = child
        self.children = (child,)
        dtypes = []
        for i, name in enumerate(names):
            dt = self.projections[0][i].dtype
            for p in self.projections[1:]:
                if p[i].dtype != dt:
                    raise TypeError(f"expand column {name}: {p[i].dtype!r} "
                                    f"against {dt!r}")
            dtypes.append(dt)
        self._schema = Schema(tuple(names), tuple(dtypes))

    @property
    def schema(self):
        return self._schema


class Union(LogicalPlan):
    """UNION ALL: the children's rows, the first child's column names; the
    children's column types must be equal, position by position."""

    def __init__(self, plans: Sequence[LogicalPlan]):
        if not plans:
            raise ValueError("a union needs at least one child")
        first = plans[0].schema
        for p in plans[1:]:
            if tuple(p.schema.dtypes) != tuple(first.dtypes):
                raise TypeError("UNION inputs must have identical schemas")
        self.children = tuple(plans)

    @property
    def schema(self):
        return self.children[0].schema


class Window(LogicalPlan):
    """Append window columns to the child's.  Every window expression
    shares one (partition_by, order_by); frames may differ (the session
    puts a window of another pair in a Window node of its own)."""

    def __init__(self, window_exprs: Sequence[Expression],
                 child: LogicalPlan):
        from spark_rapids_tpu_torch.expressions.window import (
            WindowExpression)
        self.window_exprs = tuple(e.bind(child.schema) for e in window_exprs)
        self.child = child
        self.children = (child,)
        names = list(child.schema.names)
        for e in self.window_exprs:
            names.append(output_name(e, len(names)))
        self._schema = Schema(tuple(names), tuple(child.schema.dtypes) + tuple(
            e.dtype for e in self.window_exprs))
        inner = [e.child if isinstance(e, Alias) else e
                 for e in self.window_exprs]
        if not inner or not all(isinstance(e, WindowExpression)
                                for e in inner):
            raise TypeError("a Window node takes window expressions")
        self.spec = inner[0].spec

    @property
    def schema(self):
        return self._schema
