"""User-facing session and DataFrame of the port.

Counterpart of ``spark_rapids_tpu/api/session.py`` (``TpuSession`` :95,
``create_dataframe`` :129, ``GroupedData`` :368, ``DataFrame`` :583,
``group_by`` :685, ``order_by`` :692, ``limit`` :704, ``join`` :744,
``collect`` :767, ``explain`` :824), cut to the q6, q1, q3, q25 and q72
surface: filter, select, agg, group_by(...).agg, join (inner and left,
with a residual condition), order_by, limit, collect, count and explain
(the physical plan's tree).

A session runs on the card unless the caller names another device:
``GpuSession(device=None)`` takes ``cuda`` and raises where there is none.
It never falls back to the CPU by itself; the tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch.columnar.arrow import (arrow_to_batch,
                                                   batch_from_numpy)
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions.core import Expression, col, lit
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
    keys: the global one)."""

    def __init__(self, df: "DataFrame", keys):
        self.df = df
        self.keys = [_to_expr(k) for k in keys]

    def agg(self, *aggs) -> "DataFrame":
        return DataFrame(L.Aggregate(self.keys, [_to_expr(a) for a in aggs],
                                     self.df.plan), self.df.session)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: GpuSession):
        self.plan = plan
        self.session = session

    @property
    def schema(self) -> Schema:
        return self.plan.schema

    def select(self, *exprs) -> "DataFrame":
        return DataFrame(L.Project([_to_expr(e) for e in exprs], self.plan),
                         self.session)

    def filter(self, condition) -> "DataFrame":
        return DataFrame(L.Filter(_to_expr(condition), self.plan),
                         self.session)

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
        right ones.  The inner and the left join run."""
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
