"""Sort kernels: stable multi-key lexicographic argsort, Spark ordering.

Counterpart of ``spark_rapids_tpu/kernels/sort.py`` (``SortOrder`` :32,
``sort_indices`` :200, ``sort_batch`` :241) for fixed-width keys, with the
key builders ``_data_key_fixed`` :101, ``_null_key`` :117 and
``f64_total_order_u64`` :52 (its non-TPU branch).  Ordering follows Spark's
SortExec: ASC NULLS FIRST by default (DESC NULLS LAST), NULLS FIRST/LAST
absolute, doubles in Java's total order (-0.0 < 0.0, NaN above +Inf), and
the sort is stable.  Columns hold exactly ``num_rows`` rows, so the
reference's liveness key for padding rows has no counterpart.

On CUDA tensors ``sort_indices`` runs the LSD radix passes of
``csrc/sort.cu`` and counts one launch per call; on CPU tensors it runs
the plain version: the same keys, as order-preserving signed int64 (the
CPU has no uint64 compare), each applied with a stable ``torch.sort``
from the least significant key up.  String, struct and decimal128 keys
are not ported.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.selection import gather_batch

# key kinds of csrc/sort.cu, and their key widths in bytes
_INT32, _INT64, _F64, _BOOL = 0, 1, 2, 3
_KEY_BYTES = {_INT32: 4, _INT64: 8, _F64: 8, _BOOL: 1}
_F64_MAGNITUDE = 0x7FFFFFFFFFFFFFFF


class SortOrder:
    """Direction + null placement of one sort key."""

    def __init__(self, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.ascending = ascending
        # Spark default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = nulls_first if nulls_first is not None else ascending

    def __repr__(self):
        return (f"{'ASC' if self.ascending else 'DESC'} "
                f"NULLS {'FIRST' if self.nulls_first else 'LAST'}")


def _kind(dtype: T.DataType) -> int:
    if isinstance(dtype, (T.IntegerType, T.DateType)):
        return _INT32
    if isinstance(dtype, (T.LongType, T.DecimalType)):
        return _INT64
    if isinstance(dtype, T.DoubleType):
        return _F64
    if isinstance(dtype, T.BooleanType):
        return _BOOL
    raise NotImplementedError(f"sort key of {dtype!r} is not ported")

# ---------------------------------------------------------------------------
# plain version


def data_key_plain(col: DeviceColumn, order: SortOrder) -> torch.Tensor:
    """int64 key whose signed order is the reference's uint64 key order
    (the uint64 key is this key with its sign bit flipped)."""
    kind = _kind(col.dtype)
    if kind == _F64:
        bits = col.data.view(torch.int64)
        k = torch.where(bits < 0, bits ^ _F64_MAGNITUDE, bits)
    else:
        k = col.data.to(torch.int64)
    if not order.ascending:
        k = ~k
    # null rows get a constant so they never perturb less-significant keys
    return torch.where(col.validity, k, torch.zeros((), dtype=torch.int64,
                                                    device=k.device))


def null_key_plain(col: DeviceColumn, order: SortOrder) -> torch.Tensor:
    return col.validity if order.nulls_first else ~col.validity


def sort_indices_plain(columns: Sequence[DeviceColumn],
                       orders: Sequence[SortOrder]) -> torch.Tensor:
    n = columns[0].num_rows
    perm = torch.arange(n, dtype=torch.int64, device=columns[0].device)
    keys: List[torch.Tensor] = []   # least significant first
    for c, o in zip(reversed(list(columns)), reversed(list(orders))):
        keys += [data_key_plain(c, o), null_key_plain(c, o).to(torch.int8)]
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm.to(torch.int32)

# ---------------------------------------------------------------------------
# kernel


def _sort_indices_cuda(columns: Sequence[DeviceColumn],
                       orders: Sequence[SortOrder]) -> torch.Tensor:
    _lib.require_cuda("sort", *(t for c in columns
                                for t in (c.data, c.validity)))
    lib = _lib.lib()
    n = columns[0].num_rows
    dev = columns[0].device
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    s = _lib.stream(dev)
    k = len(columns)
    nulls = torch.empty(k, dtype=torch.int64, device=dev)
    valid = (ctypes.c_void_p * k)(*(c.validity.data_ptr() for c in columns))
    _lib.check(lib.srt_null_counts(k, ctypes.cast(valid, ctypes.c_void_p), n,
                                   _lib.ptr(nulls), s), "sort")
    # the one device->host read of a sort: which columns take a null pass
    has_nulls = nulls.tolist()
    ntiles = -(-n // lib.srt_sort_tile())
    nb = 1 << lib.srt_max_radix_bits()
    width = max(_KEY_BYTES[_kind(c.dtype)] for c in columns)
    key_a = torch.empty(n * width, dtype=torch.uint8, device=dev)
    key_b = torch.empty(n * width, dtype=torch.uint8, device=dev)
    hist = torch.empty(nb * ntiles, dtype=torch.int32, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    ids = None
    for i in reversed(range(k)):
        c, o = columns[i], orders[i]
        out = torch.empty(n, dtype=torch.int32, device=dev)
        tmp = torch.empty(n, dtype=torch.int32, device=dev)
        _lib.check(lib.srt_sort_column(
            _kind(c.dtype), _lib.ptr(c.data), _lib.ptr(c.validity),
            int(not o.ascending), int(o.nulls_first), int(has_nulls[i] > 0),
            _lib.ptr(ids) if ids is not None else None, n, _lib.ptr(key_a),
            _lib.ptr(key_b), _lib.ptr(out), _lib.ptr(tmp), _lib.ptr(hist),
            _lib.ptr(totals), s), "sort")
        ids = out
    _lib.LAUNCHES["sort"] += 1
    return ids


def sort_indices(batch: ColumnarBatch, key_cols: Sequence[int],
                 orders: Sequence[SortOrder]) -> torch.Tensor:
    """Stable argsort of the batch's rows by the given key columns (most
    significant first): int32 row ids in sorted order."""
    if not key_cols or len(key_cols) != len(orders):
        raise ValueError("sort_indices needs one SortOrder per key column, "
                         "and at least one key")
    columns = [batch.columns[c] for c in key_cols]
    for c in columns:
        _kind(c.dtype)
    if batch.num_rows >= 2**31:
        raise ValueError("sort_indices: int32 row ids need n < 2**31")
    if columns[0].device.type == "cpu":
        return sort_indices_plain(columns, orders)
    return _sort_indices_cuda(columns, orders)


def sort_batch(batch: ColumnarBatch, key_cols: Sequence[int],
               orders: Sequence[SortOrder]) -> ColumnarBatch:
    return gather_batch(batch, sort_indices(batch, key_cols, orders))
