"""User-facing session and DataFrame of the port.

Counterpart of ``spark_rapids_tpu/api/session.py`` (``TpuSession`` :95,
``create_dataframe`` :129, ``GroupedData`` :368 with
``_grouping_sets_agg`` :395-462, ``DataFrame`` :583, ``with_column`` :604,
``rollup`` :610, ``group_by`` :685, ``order_by`` :692, ``limit`` :704,
``union`` :707, ``join`` :744, ``collect`` :767, ``explain`` :824,
``_extract_windows`` :33), cut to the surface of the ported queries:
filter, select and with_column (window expressions included), agg,
group_by(...).agg, rollup(...).agg, join (inner, left, left semi and left
anti, with a residual condition), union, order_by, limit, collect, count
and explain (the physical plan's tree).  ``cube`` and ``grouping_id()``
are not ported.

A session runs on the card unless the caller names another device:
``GpuSession(device=None)`` takes ``cuda`` and raises where there is none.
It never falls back to the CPU by itself; the tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import (arrow_to_batch,
                                                   batch_from_numpy)
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions.core import (Alias, Col, Expression,
                                                     Literal, col, lit)
from spark_rapids_tpu_torch.kernels.sort import SortOrder
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.engine import GpuEngine
from spark_rapids_tpu_torch.planner.overrides import plan_query


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device must exist to be used."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU")
        if dev.index is None:   # tensors report "cuda:0", not "cuda"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_expr(e) -> Expression:
    if isinstance(e, Expression):
        return e
    if isinstance(e, str):
        return col(e)
    return lit(e)


def _extract_windows(exprs: List[Expression], plan: L.LogicalPlan
                     ) -> Tuple[List[Expression], L.LogicalPlan]:
    """Spark's ExtractWindowExpressions: every window expression anywhere
    in a projection list (``over(...) + 1`` included) becomes a column of
    a Window node under the projection.  Identical windows (by repr) share
    one column ``__w<i>``; the windows of one (partition_by, order_by)
    share one Window node, and the nodes of different pairs stack in the
    order the pairs first appear.  Returns the projections, each window
    replaced by a reference to its column, and the new child."""
    from spark_rapids_tpu_torch.expressions.window import WindowExpression

    found: List[Expression] = []

    def scan(e):
        if isinstance(e, WindowExpression):
            found.append(e)
            return
        for c in e.children:
            scan(c)

    for e in exprs:
        scan(e)
    if not found:
        return exprs, plan
    names: Dict[str, str] = {}
    groups: Dict[Tuple[str, str], List[Expression]] = {}
    for w in found:
        if repr(w) in names:
            continue
        names[repr(w)] = f"__w{len(names)}"
        key = (repr(w.spec.partition_by), repr(w.spec.order_by))
        groups.setdefault(key, []).append(w)
    for ws in groups.values():
        plan = L.Window([w.alias(names[repr(w)]) for w in ws], plan)

    def rewrite(e):
        if isinstance(e, WindowExpression):
            return col(names[repr(e)])
        kids = tuple(rewrite(c) for c in e.children)
        if all(n is o for n, o in zip(kids, e.children)):
            return e
        return e.with_children(kids)

    return [rewrite(e) for e in exprs], plan


class GpuSession:
    def __init__(self, conf: Optional[Dict[str, str]] = None, device=None):
        self.conf = RapidsConf(conf)
        if not self.conf.sql_enabled:
            raise NotImplementedError(
                "spark.rapids.sql.enabled=false runs the CPU oracle engine, "
                "which is not ported")
        self.device = resolve_device(device)

    def create_dataframe(self, data, schema: Optional[Schema] = None,
                         num_partitions: int = 1) -> "DataFrame":
        """data: a list of ColumnarBatches on the session's device, a
        pyarrow Table, or a dict of numpy columns with its Schema.  Host
        data is cut into batches of spark.rapids.sql.batchSizeRows rows;
        batches go to partitions round-robin."""
        if isinstance(data, list):
            if not data or not all(isinstance(b, ColumnarBatch) for b in data):
                raise TypeError("a list must hold at least one ColumnarBatch")
            batches = data
            schema = batches[0].schema
            for b in batches:
                if b.schema != schema:
                    raise TypeError("batches differ in schema")
                if b.device != self.device:
                    raise ValueError(f"batch on {b.device}, session on "
                                     f"{self.device}")
        elif isinstance(data, dict):
            if schema is None:
                raise TypeError("dict data needs a Schema")
            n = len(next(iter(data.values())))
            step = self.conf.batch_size_rows
            batches = [batch_from_numpy(
                {k: np.asarray(v)[lo:lo + step] for k, v in data.items()},
                schema, self.device) for lo in range(0, max(n, 1), step)]
        elif isinstance(data, (pa.Table, pa.RecordBatch)):
            table = (pa.Table.from_batches([data])
                     if isinstance(data, pa.RecordBatch) else data)
            step = self.conf.batch_size_rows
            batches = [arrow_to_batch(table.slice(lo, step), self.device)
                       for lo in range(0, max(table.num_rows, 1), step)]
            schema = batches[0].schema
        else:
            raise TypeError(f"cannot make a DataFrame of {type(data).__name__}")
        parts: List[List[ColumnarBatch]] = [[] for _ in range(num_partitions)]
        for i, b in enumerate(batches):
            parts[i % num_partitions].append(b)
        return DataFrame(L.InMemoryRelation(parts, schema), self)


class GroupedData:
    """``df.group_by(keys...)``; ``agg`` builds the grouped Aggregate (no
    keys: the global one).  ``grouping_sets``, from ``rollup``, lists the
    key ordinals each grouping set keeps."""

    def __init__(self, df: "DataFrame", keys, grouping_sets=None):
        self.df = df
        self.keys = [_to_expr(k) for k in keys]
        self.grouping_sets = grouping_sets

    def agg(self, *aggs) -> "DataFrame":
        if self.grouping_sets is not None:
            return self._grouping_sets_agg([_to_expr(a) for a in aggs])
        return DataFrame(L.Aggregate(self.keys, [_to_expr(a) for a in aggs],
                                     self.df.plan), self.df.session)

    def _grouping_sets_agg(self, aggs) -> "DataFrame":
        """Spark's plan of grouping sets: an Expand keeps the original
        columns (the aggregates read them un-nulled) and adds a copy
        ``_gk<i>`` of each key, null where the set leaves the key out, and
        the grouping id ``_gid`` (LONG, a bit set for each key left out,
        the first key the most significant); the Aggregate groups on the
        copies, named as the keys, and ``_gid``, which keeps a subtotal row
        apart from a group whose key is null in the data; a projection
        drops ``_gid``."""
        child = self.df.plan
        names = []
        for k in self.keys:
            if not isinstance(k, Col):
                raise NotImplementedError("rollup keys must be columns")
            names.append(k.name)
        nkeys = len(names)
        out_names = (list(child.schema.names)
                     + [f"_gk{i}" for i in range(nkeys)] + ["_gid"])
        projections = []
        for included in self.grouping_sets:
            gid = sum(1 << (nkeys - 1 - i) for i in range(nkeys)
                      if i not in included)
            proj = [col(n) for n in child.schema.names]
            proj += [col(n) if i in included
                     else Literal(None, child.schema.dtype_of(n))
                     for i, n in enumerate(names)]
            proj.append(Literal(gid, T.LONG))
            projections.append(proj)
        expanded = L.Expand(projections, out_names, child)
        group_keys = ([Alias(col(f"_gk{i}"), n) for i, n in enumerate(names)]
                      + [col("_gid")])
        agg = L.Aggregate(group_keys, aggs, expanded)
        keep = [col(n) for n in agg.schema.names if n != "_gid"]
        return DataFrame(L.Project(keep, agg), self.df.session)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: GpuSession):
        self.plan = plan
        self.session = session

    @property
    def schema(self) -> Schema:
        return self.plan.schema

    def select(self, *exprs) -> "DataFrame":
        projections, plan = _extract_windows([_to_expr(e) for e in exprs],
                                             self.plan)
        return DataFrame(L.Project(projections, plan), self.session)

    def filter(self, condition) -> "DataFrame":
        return DataFrame(L.Filter(_to_expr(condition), self.plan),
                         self.session)

    def with_column(self, name: str, expr) -> "DataFrame":
        """Every column but ``name``, then ``expr`` as ``name``, last."""
        exprs = [col(n) for n in self.schema.names if n != name]
        return self.select(*exprs, _to_expr(expr).alias(name))

    def rollup(self, *keys) -> "GroupedData":
        """ROLLUP: the grouping sets (k1..kn), (k1..kn-1), ..., ()."""
        sets = [frozenset(range(i)) for i in range(len(keys), -1, -1)]
        return GroupedData(self, keys, grouping_sets=sets)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL, by position; the names are this frame's."""
        return DataFrame(L.Union([self.plan, other.plan]), self.session)

    def group_by(self, *keys) -> "GroupedData":
        return GroupedData(self, keys)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, ()).agg(*aggs)

    def order_by(self, *orders) -> "DataFrame":
        """ORDER BY: each order is a column (ascending) or an (expression,
        SortOrder) pair, most significant first."""
        parsed = [(_to_expr(o[0]), o[1]) if isinstance(o, tuple)
                  else (_to_expr(o), SortOrder(True)) for o in orders]
        return DataFrame(L.Sort(parsed, self.plan), self.session)

    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self.plan), self.session)

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Equi-join on ``on``: a column name, a list of names common to
        both sides, or a (left keys, right keys) pair of expression lists;
        ``condition``, a residual predicate over the left columns and the
        right ones.  The inner, left, left semi and left anti joins
        run."""
        if on is None:
            lkeys, rkeys = [], []
        elif isinstance(on, str):
            lkeys = rkeys = [col(on)]
        elif isinstance(on, (list, tuple)) and on and isinstance(on[0], str):
            lkeys = rkeys = [col(k) for k in on]
        else:
            lkeys, rkeys = on
        return DataFrame(L.Join(self.plan, other.plan, lkeys, rkeys, how,
                                condition), self.session)

    def physical_plan(self):
        return plan_query(self.plan, self.session.conf, self.session.device)

    def explain(self) -> str:
        """The physical plan as a tree, one exec a line; a fused segment
        shows as ``GpuFusedSegment[...]`` with its chain under it."""
        return self.physical_plan().tree_string()

    def collect(self) -> List[tuple]:
        return GpuEngine().collect(self.physical_plan())

    def count(self) -> int:
        from spark_rapids_tpu_torch.expressions.aggregates import count
        return self.agg(count()).collect()[0][0]
