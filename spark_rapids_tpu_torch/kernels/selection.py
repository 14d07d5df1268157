"""Row-selection kernels: stream compaction, gather and concat.

Counterpart of ``spark_rapids_tpu/kernels/selection.py`` (``compaction_map``
:65, ``gather_column`` :84, ``gather_batch`` :191,
``concat_batches_device`` :429), fixed-width columns only.  Each function
here is a wrapper: on CUDA tensors it launches the hand-written kernel in
``csrc/selection.cu`` and counts the launch; on CPU tensors it runs the
plain PyTorch version beside it, which the tests hold against the
reference.  Outputs have exact sizes: a compaction returns ``count`` row
ids, not a padded map.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib

# ---------------------------------------------------------------------------
# compaction


def compaction_map_plain(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Exclusive prefix sum of the mask, then a scatter of the row ids."""
    n = mask.shape[0]
    m = mask.to(torch.int32)
    dest = torch.cumsum(m, 0, dtype=torch.int32) - m
    count = int(m.sum())
    rows = torch.arange(n, dtype=torch.int32, device=mask.device)
    out = torch.empty(count + 1, dtype=torch.int32, device=mask.device)
    # unselected rows land in the spare slot `count`, which is dropped
    out.scatter_(0, torch.where(mask, dest, count).long(), rows)
    return out[:count], count


def _compaction_map_cuda(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _lib.require_cuda("compaction_map", mask)
    lib = _lib.lib()
    n = mask.shape[0]
    ntiles = -(-n // lib.srt_compaction_tile())
    dev = mask.device
    tile_counts = torch.empty(max(ntiles, 1), dtype=torch.int32, device=dev)
    tile_offsets = torch.empty(ntiles + 1, dtype=torch.int32, device=dev)
    s = _lib.stream(dev)
    _lib.check(lib.srt_compaction_count(_lib.ptr(mask), n,
                                        _lib.ptr(tile_counts),
                                        _lib.ptr(tile_offsets), s),
               "compaction_map")
    _lib.LAUNCHES["compaction_map"] += 1
    # the one device->host read of a filter: the exact output size
    count = int(tile_offsets[ntiles].item())
    out = torch.empty(count, dtype=torch.int32, device=dev)
    if count:
        _lib.check(lib.srt_compaction_scatter(_lib.ptr(mask), n,
                                              _lib.ptr(tile_offsets),
                                              _lib.ptr(out), s),
                   "compaction_map")
    return out, count


def compaction_map(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Stable stream compaction: bool ``mask[n]`` -> (int32 row ids of the
    set rows in row order, their count)."""
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError(f"compaction_map needs a 1-d bool mask, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if mask.shape[0] >= 2**31:
        raise ValueError("compaction_map: int32 row ids need n < 2**31")
    if mask.device.type == "cpu":
        return compaction_map_plain(mask)
    return _compaction_map_cuda(mask)

# ---------------------------------------------------------------------------
# gather


def gather_columns_plain(cols: Sequence[DeviceColumn],
                         indices: torch.Tensor) -> List[DeviceColumn]:
    out = []
    for c in cols:
        inb = (indices >= 0) & (indices < c.num_rows)
        if c.num_rows == 0:
            valid = torch.zeros_like(inb)
            data = torch.zeros(indices.shape, dtype=c.data.dtype,
                               device=c.device)
        else:
            safe = torch.where(inb, indices, 0).long()
            valid = inb & c.validity[safe]
            data = torch.where(valid, c.data[safe],
                               torch.zeros((), dtype=c.data.dtype,
                                           device=c.device))
        out.append(DeviceColumn(data, valid, c.dtype))
    return out


def _gather_columns_cuda(cols: Sequence[DeviceColumn],
                         indices: torch.Tensor) -> List[DeviceColumn]:
    _lib.require_cuda("gather", indices,
                      *(t for c in cols for t in (c.data, c.validity)))
    lib = _lib.lib()
    m = indices.shape[0]
    dev = indices.device
    out = [DeviceColumn(torch.empty(m, dtype=c.data.dtype, device=dev),
                        torch.empty(m, dtype=torch.bool, device=dev), c.dtype)
           for c in cols]
    step = lib.srt_max_gather_cols()
    s = _lib.stream(dev)
    for lo in range(0, len(cols), step):
        src, dst = cols[lo:lo + step], out[lo:lo + step]
        k = len(src)
        arrays = [(ctypes.c_void_p * k)(*(getattr(c, f).data_ptr()
                                          for c in group))
                  for group, f in ((src, "data"), (src, "validity"),
                                   (dst, "data"), (dst, "validity"))]
        widths = (ctypes.c_int * k)(*(c.data.element_size() for c in src))
        _lib.check(lib.srt_gather(k, *(ctypes.cast(a, ctypes.c_void_p)
                                       for a in arrays),
                                  ctypes.cast(widths, ctypes.c_void_p),
                                  src[0].num_rows, _lib.ptr(indices), m, s),
                   "gather")
        if m:
            _lib.LAUNCHES["gather"] += 1
    return out


def gather_columns(cols: Sequence[DeviceColumn],
                   indices: torch.Tensor) -> List[DeviceColumn]:
    """Gather rows of same-length columns by an int32 row-id map; a row id
    outside [0, n) gives a null row with zero data."""
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise TypeError(f"gather needs 1-d int32 indices, got "
                        f"{indices.dtype} {tuple(indices.shape)}")
    if not cols:
        return []
    if len({c.num_rows for c in cols}) != 1:
        raise ValueError("gather: columns differ in length")
    if indices.device.type == "cpu":
        return gather_columns_plain(cols, indices)
    return _gather_columns_cuda(cols, indices)


def gather_batch(batch: ColumnarBatch,
                 indices: torch.Tensor) -> ColumnarBatch:
    """Gather every column of a batch in one launch (16 columns a launch)."""
    cols = gather_columns(batch.columns, indices)
    return ColumnarBatch(tuple(cols), indices.shape[0], batch.schema)

# ---------------------------------------------------------------------------
# concat


def concat_column_plain(pieces: Sequence[DeviceColumn]) -> DeviceColumn:
    valid = torch.cat([p.validity for p in pieces])
    data = torch.cat([p.data for p in pieces])
    data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                device=data.device))
    return DeviceColumn(data, valid, pieces[0].dtype)


def _concat_column_cuda(pieces: Sequence[DeviceColumn]) -> DeviceColumn:
    _lib.require_cuda("concat", *(t for p in pieces
                                  for t in (p.data, p.validity)))
    lib = _lib.lib()
    dev = pieces[0].device
    k = len(pieces)
    offsets = [0]
    for p in pieces:
        offsets.append(offsets[-1] + p.num_rows)
    total = offsets[-1]
    # one host->device copy: [k] data pointers, [k] validity pointers, the
    # k + 1 row offsets
    desc = torch.tensor([p.data.data_ptr() for p in pieces]
                        + [p.validity.data_ptr() for p in pieces] + offsets,
                        dtype=torch.int64).to(dev)
    data = torch.empty(total, dtype=pieces[0].data.dtype, device=dev)
    valid = torch.empty(total, dtype=torch.bool, device=dev)
    _lib.check(lib.srt_concat(_lib.ptr(desc),
                              ctypes.c_void_p(desc.data_ptr() + 16 * k), k,
                              data.element_size(), _lib.ptr(data),
                              _lib.ptr(valid), total, _lib.stream(dev)),
               "concat")
    if total:
        _lib.LAUNCHES["concat"] += 1
    return DeviceColumn(data, valid, pieces[0].dtype)


def concat_column(pieces: Sequence[DeviceColumn]) -> DeviceColumn:
    """Concatenate k pieces of one column into one, in one launch."""
    if not pieces:
        raise ValueError("concat needs at least one piece")
    if len({p.dtype for p in pieces}) != 1:
        raise TypeError("concat: pieces differ in type")
    if pieces[0].device.type == "cpu":
        return concat_column_plain(pieces)
    return _concat_column_cuda(pieces)


def concat_batches_device(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate same-schema batches, one concat launch per column."""
    if not batches:
        raise ValueError("concat needs at least one batch")
    schema = batches[0].schema
    if any(b.schema != schema for b in batches):
        raise TypeError("concat: batches differ in schema")
    cols = tuple(concat_column([b.columns[i] for b in batches])
                 for i in range(len(schema)))
    return ColumnarBatch(cols, sum(b.num_rows for b in batches), schema)
