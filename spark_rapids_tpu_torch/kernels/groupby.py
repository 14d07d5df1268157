"""Group-by: sort-based grouping, then segmented reductions.

Counterpart of ``spark_rapids_tpu/kernels/groupby.py`` for fixed-width
keys: ``normalize_key_column`` :33, ``group_rows`` :97 with
``_rows_equal_prev`` :47, ``seg_sum`` :166, ``seg_count_valid`` :151,
``seg_count_star`` :159, ``group_keys_output`` :284 and
``finalize_agg_column`` :293.  Spark's grouping rules hold: null keys form
one group, -0.0 groups with 0.0, and all NaNs group together (keys are
normalized before the sort and the compare).  Groups come out in key sort
order (ASC NULLS FIRST); Spark leaves the order unspecified.

Columns have exact sizes, so a layout keeps each group's first row (the
ported ``compaction_map`` of the boundary flags, whose count is the one
device->host read of a grouping) instead of per-row segment ids over a
padded capacity.  The sort (``kernels/sort.py``), the gather and the
compaction (``kernels/selection.py``) and the segmented sum
(``kernels/reduction.py``) are the kernels; the boundary flags are plain
elementwise PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels.reduction import segmented_sum
from spark_rapids_tpu_torch.kernels.selection import (compaction_map,
                                                      gather_batch,
                                                      gather_columns)
from spark_rapids_tpu_torch.kernels.sort import SortOrder, sort_indices


def normalize_key_column(col: DeviceColumn) -> DeviceColumn:
    """Normalize double keys so a bit compare is Spark's group equality."""
    if not isinstance(col.dtype, T.DoubleType):
        return col
    d = col.data
    d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype, device=d.device),
                    d)
    d = torch.where(torch.isnan(d), torch.full((), float("nan"),
                                               dtype=d.dtype,
                                               device=d.device), d)
    return DeviceColumn(d, col.validity, col.dtype)


def _rows_equal_prev(col: DeviceColumn) -> torch.Tensor:
    """bool [n - 1]: row i + 1 equals row i in this column (null == null).
    Null slots hold zero and double keys are normalized, so comparing the
    bits is exact."""
    data = col.data
    if isinstance(col.dtype, T.DoubleType):
        data = data.view(torch.int64)
    return (data[1:] == data[:-1]) & (col.validity[1:] == col.validity[:-1])


@dataclasses.dataclass
class GroupedLayout:
    """A batch sorted by its keys, and where each group starts."""

    sorted_batch: ColumnarBatch
    starts: torch.Tensor    # int32 [num_groups], the first row of each group
    num_groups: int


def group_rows(batch: ColumnarBatch,
               key_cols: Sequence[int]) -> GroupedLayout:
    """Sort the rows by the keys (normalized) and delimit the groups."""
    cols = list(batch.columns)
    for ci in key_cols:
        cols[ci] = normalize_key_column(cols[ci])
    nb = ColumnarBatch(tuple(cols), batch.num_rows, batch.schema)
    n = nb.num_rows
    dev = nb.device
    if n == 0:
        return GroupedLayout(nb, torch.empty(0, dtype=torch.int32,
                                             device=dev), 0)
    idx = sort_indices(nb, key_cols, [SortOrder(True, True)] * len(key_cols))
    sb = gather_batch(nb, idx)
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        eq = torch.ones(n - 1, dtype=torch.bool, device=dev)
        for ci in key_cols:
            eq = eq & _rows_equal_prev(sb.columns[ci])
        boundary[1:] = ~eq
    starts, num_groups = compaction_map(boundary)
    return GroupedLayout(sb, starts, num_groups)


class ReductionCache:
    """Sum results of one aggregate step, one per input column and sum
    type, so that the SUM and COUNT_VALID slots of one aggregate share one
    launch: ``count_of`` takes the valid count of any sum already taken
    over the column."""

    def __init__(self):
        self._by_col: Dict[int, tuple] = {}

    def _reduce(self, data: torch.Tensor, validity: torch.Tensor) -> tuple:
        raise NotImplementedError

    def of(self, col: DeviceColumn, dtype: torch.dtype) -> tuple:
        # keep `col` alive beside its results: the key holds its id()
        entry = self._by_col.setdefault(id(col), (col, {}))[1]
        if dtype not in entry:
            entry[dtype] = self._reduce(col.data.to(dtype), col.validity)
        return entry[dtype]

    def count_of(self, col: DeviceColumn) -> tuple:
        entry = self._by_col.get(id(col), (col, {}))[1]
        if entry:
            return next(iter(entry.values()))
        return self.of(col, torch.float64 if col.data.dtype == torch.float64
                       else torch.int64)


class SegmentSums(ReductionCache):
    """segmented_sum results over one layout (see ReductionCache);
    COUNT_STAR reads the row counts of any of them."""

    def __init__(self, layout: GroupedLayout):
        super().__init__()
        self.layout = layout

    def _reduce(self, data: torch.Tensor, validity: torch.Tensor) -> tuple:
        return segmented_sum(data, validity, self.layout.starts)

    def rows(self) -> torch.Tensor:
        for _, entry in self._by_col.values():
            if entry:
                return next(iter(entry.values()))[3]
        # no sum taken yet: count over the first sorted column
        return self.count_of(self.layout.sorted_batch.columns[0])[3]


def seg_count_valid(col: DeviceColumn, sums: SegmentSums
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """COUNT(col): non-null values per group -> (int64, all valid)."""
    nvalid = sums.count_of(col)[2]
    return nvalid, torch.ones_like(nvalid, dtype=torch.bool)


def seg_count_star(sums: SegmentSums) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = sums.rows()
    return rows, torch.ones_like(rows, dtype=torch.bool)


def seg_sum(col: DeviceColumn, sums: SegmentSums, out_dtype: torch.dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SUM: nulls ignored, an all-null group is null, int64 wraps."""
    total, ok, _, _ = sums.of(col, out_dtype)
    return total, ok


def group_keys_output(layout: GroupedLayout,
                      key_cols: Sequence[int]) -> List[DeviceColumn]:
    """The first row of each group, for the key output columns."""
    return gather_columns([layout.sorted_batch.columns[ci]
                           for ci in key_cols], layout.starts)


def finalize_agg_column(values: torch.Tensor, validity: torch.Tensor,
                        dtype: T.DataType) -> DeviceColumn:
    """A [num_groups] segment-reduce result in canonical form: null slots
    hold zero."""
    values = values.to(dtype.torch_dtype)
    return DeviceColumn(torch.where(validity, values,
                                    torch.zeros((), dtype=values.dtype,
                                                device=values.device)),
                        validity, dtype)
