"""Columnar batch: the unit of work flowing between execs.

Counterpart of ``spark_rapids_tpu/columnar/batch.py`` (``Schema`` :30,
``ColumnarBatch`` :57).  ``num_rows`` is a host int and every column holds
exactly that many rows (see column.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


@dataclasses.dataclass(frozen=True)
class Schema:
    names: Tuple[str, ...]
    dtypes: Tuple[T.DataType, ...]

    def __post_init__(self):
        if len(self.names) != len(self.dtypes):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.dtypes)} dtypes")

    def __len__(self):
        return len(self.names)

    def index_of(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"no column named {name!r}; have {self.names}")

    def dtype_of(self, name: str) -> T.DataType:
        return self.dtypes[self.index_of(name)]

    def __repr__(self):
        inner = ", ".join(f"{n}:{d!r}" for n, d in zip(self.names, self.dtypes))
        return f"Schema({inner})"

    @staticmethod
    def of(**kv: T.DataType) -> "Schema":
        return Schema(tuple(kv.keys()), tuple(kv.values()))


@dataclasses.dataclass
class ColumnarBatch:
    columns: Tuple[DeviceColumn, ...]
    num_rows: int
    schema: Schema

    def __post_init__(self):
        for name, c in zip(self.schema.names, self.columns):
            if c.num_rows != self.num_rows:
                raise ValueError(f"column {name!r} has {c.num_rows} rows, "
                                 f"batch has {self.num_rows}")

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def column(self, name: str) -> DeviceColumn:
        return self.columns[self.schema.index_of(name)]

    def select(self, names: Sequence[str]) -> "ColumnarBatch":
        idxs = [self.schema.index_of(n) for n in names]
        return ColumnarBatch(
            tuple(self.columns[i] for i in idxs), self.num_rows,
            Schema(tuple(names), tuple(self.schema.dtypes[i] for i in idxs)))

    @staticmethod
    def from_arrow(table, device) -> "ColumnarBatch":
        from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
        return arrow_to_batch(table, device)

    @staticmethod
    def from_pydict(data: Dict[str, list], schema: Schema,
                    device) -> "ColumnarBatch":
        """Host Python lists (None is null) -> one device batch; strings as
        str, decimals as their unscaled ints (``ColumnarBatch.from_pydict``
        :110 of the reference)."""
        import pyarrow as pa

        from spark_rapids_tpu_torch.columnar.arrow import (arrow_to_batch,
                                                           sql_type_to_arrow)
        cols = []
        for n, d in zip(schema.names, schema.dtypes):
            if isinstance(d, T.DecimalType):
                cols.append(DeviceColumn.from_pylist(data[n], d, device))
            else:
                cols.append(arrow_to_batch(pa.table(
                    {n: pa.array(data[n], sql_type_to_arrow(d))}),
                    device).columns[0])
        rows = len(next(iter(data.values()))) if data else 0
        return ColumnarBatch(tuple(cols), rows, schema)

    def to_arrow(self):
        from spark_rapids_tpu_torch.columnar.arrow import batch_to_arrow
        return batch_to_arrow(self)

    def rows(self) -> List[tuple]:
        """Host rows as Python values (None for null), in row order."""
        cols = [c.to_pylist() for c in self.to_arrow().columns]
        return list(zip(*cols)) if cols else []
