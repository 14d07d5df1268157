"""Logical plan: what the user asked for, engine-agnostic.

Counterpart of ``spark_rapids_tpu/plan/logical.py`` (``InMemoryRelation``
:45, ``Project`` :189, ``Filter`` :205, ``Aggregate`` :222).  Schemas
resolve eagerly, so binding errors surface when the plan is built.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.expressions.aggregates import find_aggregates
from spark_rapids_tpu_torch.expressions.core import Expression, output_name


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

