"""Group-by: sort-based grouping, then segmented reductions.

Counterpart of ``spark_rapids_tpu/kernels/groupby.py`` for fixed-width and
string keys: ``normalize_key_column`` :33, ``group_rows`` :97 with
``_rows_equal_prev`` :47 and ``_string_rows_equal_prev`` :74, ``seg_sum``
:166, ``seg_count_valid`` :151,
``seg_count_star`` :159, ``seg_m2_update`` :179, ``seg_m2_merge`` :200,
``seg_min`` :228, ``seg_max`` :256, ``group_keys_output`` :284 and
``finalize_agg_column`` :293.  Spark's grouping rules hold: null keys form
one group, -0.0 groups with 0.0, and all NaNs group together (keys are
normalized before the sort and the compare).  Groups come out in key sort
order (ASC NULLS FIRST); Spark leaves the order unspecified.

Columns have exact sizes, so a layout keeps each group's first row (the
ported ``compaction_map`` of the boundary flags, whose count is the one
device->host read of a grouping) instead of per-row segment ids over a
padded capacity.  The sort (``kernels/sort.py``), the gather and the
compaction (``kernels/selection.py``) and the segmented sum, extreme and
M2 (``kernels/reduction.py``) are the kernels; the M2 of a group takes its
sum and count from the step's ``SegmentSums``, so the SUM, M2 and
COUNT_VALID slots of one variance share one ``segmented_sum`` launch.  A fixed-width key's boundary
flags are plain elementwise PyTorch; a string key's come from the
adjacent-row compare of ``csrc/strings.cu`` (``string_rows_equal_prev``).
The split-tolerant one-pass string grouping key of the reference
(``_string_hash_key``, kernels/sort.py:183) is not ported: a string key
sorts on all its chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.reduction import (segmented_extreme,
                                                      segmented_m2,
                                                      segmented_sum)
from spark_rapids_tpu_torch.kernels.selection import (compaction_map,
                                                      gather_batch,
                                                      gather_columns)
from spark_rapids_tpu_torch.kernels.sort import SortOrder, sort_indices


def normalize_key_column(col: DeviceColumn) -> DeviceColumn:
    """Normalize double keys so a bit compare is Spark's group equality;
    other keys, strings too, pass through."""
    if not isinstance(col.dtype, T.DoubleType):
        return col
    d = col.data
    d = torch.where(d == 0.0, torch.zeros((), dtype=d.dtype, device=d.device),
                    d)
    d = torch.where(torch.isnan(d), torch.full((), float("nan"),
                                               dtype=d.dtype,
                                               device=d.device), d)
    return DeviceColumn(d, col.validity, col.dtype)


def string_rows_equal_prev_plain(col: DeviceColumn) -> torch.Tensor:
    """Lengths, then the bytes in a [n, longest] tile (zero past the end);
    a null row has length 0."""
    lengths = col.offsets[1:] - col.offsets[:-1]
    tile = col.byte_tile(int(lengths.max()) if col.num_rows else 0)
    v = col.validity
    same = (lengths[1:] == lengths[:-1]) & (tile[1:] == tile[:-1]).all(1)
    return (v[1:] == v[:-1]) & (~v[1:] | same)


def _string_rows_equal_prev_cuda(col: DeviceColumn) -> torch.Tensor:
    _lib.require_cuda("string_rows_equal_prev", col.offsets, col.data,
                      col.validity)
    n = col.num_rows
    eq = torch.empty(max(n - 1, 0), dtype=torch.bool, device=col.device)
    _lib.check(_lib.lib().srt_string_rows_equal_prev(
        _lib.ptr(col.offsets), _lib.ptr(col.data), _lib.ptr(col.validity), n,
        _lib.ptr(eq), _lib.stream(col.device)), "string_rows_equal_prev")
    if n > 1:
        _lib.LAUNCHES["string_rows_equal_prev"] += 1
    return eq


def string_rows_equal_prev(col: DeviceColumn) -> torch.Tensor:
    """bool [n - 1]: row i + 1 equals row i of a string column (same
    length and bytes; null == null)."""
    if col.device.type == "cpu":
        return string_rows_equal_prev_plain(col)
    return _string_rows_equal_prev_cuda(col)


def _rows_equal_prev(col: DeviceColumn) -> torch.Tensor:
    """bool [n - 1]: row i + 1 equals row i in this column (null == null).
    Null slots hold zero and double keys are normalized, so comparing the
    bits is exact."""
    if col.is_string:
        return string_rows_equal_prev(col)
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


def seg_m2_update(col: DeviceColumn, sums: SegmentSums
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M2 = sum of (x - group mean)^2 over the valid rows (two passes: the
    mean from the group's sum and count) -> (float64, nvalid > 0)."""
    total, ok, nvalid, _ = sums.of(col, torch.float64)
    return segmented_m2("update", col.data, col.validity, sums.layout.starts,
                        total, nvalid), ok


def seg_m2_merge(m2col: DeviceColumn, scol: DeviceColumn,
                 ncol: DeviceColumn, sums: SegmentSums
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chan's merge of partial (M2, sum, count) rows: M2 = sum_i M2_i +
    n_i (mean_i - mean)^2 -> (float64, n > 0).  A partial whose M2 is null
    has n_i = 0 and s_i = 0 (null slots hold zero), so the sums over the
    companions' own validity equal the reference's sums over M2's."""
    total = sums.of(scol, torch.float64)[0]
    n = sums.of(ncol, torch.int64)[0]
    m2 = segmented_m2("merge", m2col.data, m2col.validity,
                      sums.layout.starts, total, n, scol.data, ncol.data)
    return m2, n > 0


def seg_min(col: DeviceColumn, sums: SegmentSums
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spark MIN per group: NaN only for a group whose valid values are all
    NaN; null for a group with no valid value."""
    return segmented_extreme(col.data, col.validity, sums.layout.starts,
                             True)


def seg_max(col: DeviceColumn, sums: SegmentSums
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spark MAX per group: NaN where any valid value is NaN."""
    return segmented_extreme(col.data, col.validity, sums.layout.starts,
                             False)


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
