"""Row-selection kernels: stream compaction, gather and concat.

Counterpart of ``spark_rapids_tpu/kernels/selection.py`` (``compaction_map``
:65, ``gather_column`` :84 with its string branch :160-186,
``gather_batch`` :191, ``gather_batch_checked`` :308 as a join's
null-extending gather, ``concat_batches_device`` :429), fixed-width and
string columns; a fixed-width row is 1, 2, 4, 8 or 16 bytes or a multiple
of 16 (a fixed-length array: HyperLogLog's registers), and any other
width raises.  Each function here is a wrapper: on CUDA tensors it
launches the hand-written kernel in ``csrc/selection.cu`` and counts the
launch; on CPU tensors it runs the plain PyTorch version beside it, which
the tests hold against the reference.  Outputs have exact sizes: a
compaction returns ``count`` row ids, not a padded map, and a string
gather or concat counts its bytes, reads the total back once and then
allocates them.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib

_INT32_BYTES = 2**31

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


def gather_string_plain(c: DeviceColumn,
                        indices: torch.Tensor) -> DeviceColumn:
    inb = (indices >= 0) & (indices < c.num_rows)
    if c.num_rows == 0:
        valid = torch.zeros_like(inb)
        safe = torch.zeros_like(indices, dtype=torch.int64)
        lengths = torch.zeros_like(safe)
    else:
        safe = torch.where(inb, indices, 0).long()
        valid = inb & c.validity[safe]
        lengths = (c.offsets[1:] - c.offsets[:-1]).to(torch.int64)[safe]
        lengths = torch.where(valid, lengths, 0)
    offsets = torch.zeros(indices.shape[0] + 1, dtype=torch.int64,
                          device=indices.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total >= _INT32_BYTES:
        raise ValueError("a string column holds < 2**31 bytes")
    # each output byte's row, and its place in the row's source bytes
    row = torch.repeat_interleave(
        torch.arange(indices.shape[0], device=indices.device), lengths)
    src = (c.offsets[safe[row]].to(torch.int64)
           + torch.arange(total, device=indices.device) - offsets[row])
    return DeviceColumn(c.data[src], valid, c.dtype, offsets.to(torch.int32))


def gather_columns_plain(cols: Sequence[DeviceColumn],
                         indices: torch.Tensor) -> List[DeviceColumn]:
    out = []
    for c in cols:
        if c.is_string:
            out.append(gather_string_plain(c, indices))
            continue
        inb = (indices >= 0) & (indices < c.num_rows)
        if c.num_rows == 0:
            valid = torch.zeros_like(inb)
            data = torch.zeros(indices.shape + c.data.shape[1:],
                               dtype=c.data.dtype, device=c.device)
        else:
            safe = torch.where(inb, indices, 0).long()
            valid = inb & c.validity[safe]
            data = torch.where(valid[:, None] if c.is_wide else valid,
                               c.data[safe],
                               torch.zeros((), dtype=c.data.dtype,
                                           device=c.device))
        out.append(DeviceColumn(data, valid, c.dtype))
    return out


def _row_bytes(data: torch.Tensor) -> int:
    """Bytes of one row of a fixed-width plane: 1, 2, 4, 8, 16 (a
    Decimal128's limbs) or a multiple of 16 (a fixed-length array's row,
    moved as 16-byte chunks).  Any other width raises: the kernels would
    not move it."""
    width = data.element_size() * (data.shape[1] if data.dim() == 2 else 1)
    if width not in (1, 2, 4, 8) and (width < 16 or width % 16):
        raise ValueError(f"a row of {width} bytes: the gather and concat "
                         "move 1, 2, 4 or 8 bytes or a multiple of 16")
    return width


def _ptr_array(tensors: Sequence[torch.Tensor]) -> ctypes.c_void_p:
    """A host array of the tensors' device pointers, for a C entry point."""
    arr = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    return ctypes.cast(arr, ctypes.c_void_p), arr   # keep arr alive


def _string_lanes(total_bytes: int, rows: int) -> int:
    """Threads per row of the byte copy, from the average length."""
    avg = total_bytes / max(rows, 1)
    return 1 if avg <= 16 else (8 if avg <= 64 else 32)


def _gather_group_cuda(src: Sequence[DeviceColumn], indices: torch.Tensor,
                       lib, s, counter: str) -> List[DeviceColumn]:
    """One gather launch over up to 16 columns; string columns then take
    the scan of their lengths, one read of their byte totals and the byte
    copy."""
    m = indices.shape[0]
    dev = indices.device
    # a string column's first plane is its offsets (lengths, then scanned)
    planes = [c.offsets if c.is_string else c.data for c in src]
    dst = [torch.empty(m + 1, dtype=torch.int32, device=dev) if c.is_string
           else torch.empty((m,) + c.data.shape[1:], dtype=c.data.dtype,
                            device=dev) for c in src]
    dst_valid = [torch.empty(m, dtype=torch.bool, device=dev) for _ in src]
    strings = [i for i, c in enumerate(src) if c.is_string]
    k = len(src)
    keep = [_ptr_array(ts) for ts in (planes, [c.validity for c in src], dst,
                                      dst_valid)]
    widths = (ctypes.c_int * k)(*(0 if c.is_string else _row_bytes(c.data)
                                  for c in src))
    ntiles = max(-(-m // lib.srt_scan_tile()), 1)
    tile_sums = torch.empty(len(strings) * ntiles if strings else 0,
                            dtype=torch.int64, device=dev)
    totals = torch.empty(len(strings), dtype=torch.int64, device=dev)
    _lib.check(lib.srt_gather(
        k, *(p for p, _ in keep), ctypes.cast(widths, ctypes.c_void_p),
        src[0].num_rows, _lib.ptr(indices), m,
        _lib.ptr(tile_sums) if strings else None,
        _lib.ptr(totals) if strings else None, s), "gather")
    if m:
        _lib.LAUNCHES[counter] += 1
    out = [DeviceColumn(d, v, c.dtype) if not c.is_string else None
           for c, d, v in zip(src, dst, dst_valid)]
    if not strings:
        return out
    # the one device->host read of a string gather: the byte totals
    nbytes = totals.tolist()
    if max(nbytes) >= _INT32_BYTES:
        raise ValueError("a string column holds < 2**31 bytes")
    data = [torch.empty(b, dtype=torch.uint8, device=dev) for b in nbytes]
    arrays = [_ptr_array(ts) for ts in (
        [src[i].offsets for i in strings], [src[i].data for i in strings],
        [dst[i] for i in strings], data)]
    _lib.check(lib.srt_gather_bytes(
        len(strings), *(p for p, _ in arrays), _lib.ptr(indices), m,
        _string_lanes(max(nbytes), m), s), "gather")
    if m:
        _lib.LAUNCHES["gather_strings"] += 1
    for i, d in zip(strings, data):
        out[i] = DeviceColumn(d, dst_valid[i], src[i].dtype, dst[i])
    return out


def _gather_columns_cuda(cols: Sequence[DeviceColumn],
                         indices: torch.Tensor,
                         counter: str) -> List[DeviceColumn]:
    _lib.require_cuda("gather", indices, *(
        t for c in cols for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
    lib = _lib.lib()
    step = lib.srt_max_gather_cols()
    s = _lib.stream(indices.device)
    out: List[DeviceColumn] = []
    for lo in range(0, len(cols), step):
        out += _gather_group_cuda(cols[lo:lo + step], indices, lib, s,
                                  counter)
    return out


def gather_columns(cols: Sequence[DeviceColumn], indices: torch.Tensor,
                   null_extend: bool = False) -> List[DeviceColumn]:
    """Gather rows of same-length columns by an int32 row-id map; a row id
    outside [0, n) gives a null row with zero data (a string row: length 0,
    null), and so does every row id when there are no source rows.
    ``null_extend`` marks a join's null-extending gather (``gather_batch_
    checked`` :308 of the reference): the same kernel, counted apart."""
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise TypeError(f"gather needs 1-d int32 indices, got "
                        f"{indices.dtype} {tuple(indices.shape)}")
    if not cols:
        return []
    if len({c.num_rows for c in cols}) != 1:
        raise ValueError("gather: columns differ in length")
    for c in cols:
        if not c.is_string:
            _row_bytes(c.data)
    if indices.device.type == "cpu":
        return gather_columns_plain(cols, indices)
    return _gather_columns_cuda(cols, indices, "gather_null_extend"
                                if null_extend else "gather")


def gather_batch(batch: ColumnarBatch,
                 indices: torch.Tensor) -> ColumnarBatch:
    """Gather every column of a batch in one launch (16 columns a launch)."""
    cols = gather_columns(batch.columns, indices)
    return ColumnarBatch(tuple(cols), indices.shape[0], batch.schema)

# ---------------------------------------------------------------------------
# concat


def concat_string_plain(pieces: Sequence[DeviceColumn]) -> DeviceColumn:
    """Each piece's bytes, and its offsets rebased onto the running byte
    count."""
    valid = torch.cat([p.validity for p in pieces])
    data = torch.cat([p.data[int(p.offsets[0]):int(p.offsets[-1])]
                      for p in pieces])
    lengths = torch.cat([(p.offsets[1:] - p.offsets[:-1]).to(torch.int64)
                         for p in pieces])
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                          device=valid.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    if int(offsets[-1]) >= _INT32_BYTES:
        raise ValueError("a string column holds < 2**31 bytes")
    return DeviceColumn(data, valid, pieces[0].dtype, offsets.to(torch.int32))


def concat_column_plain(pieces: Sequence[DeviceColumn]) -> DeviceColumn:
    if pieces[0].is_string:
        return concat_string_plain(pieces)
    valid = torch.cat([p.validity for p in pieces])
    data = torch.cat([p.data for p in pieces])
    data = torch.where(valid[:, None] if data.dim() == 2 else valid, data,
                       torch.zeros((), dtype=data.dtype, device=data.device))
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
    data = torch.empty((total,) + pieces[0].data.shape[1:],
                       dtype=pieces[0].data.dtype, device=dev)
    valid = torch.empty(total, dtype=torch.bool, device=dev)
    _lib.check(lib.srt_concat(_lib.ptr(desc),
                              ctypes.c_void_p(desc.data_ptr() + 16 * k), k,
                              _row_bytes(data), _lib.ptr(data),
                              _lib.ptr(valid), total, _lib.stream(dev)),
               "concat")
    if total:
        _lib.LAUNCHES["concat"] += 1
    return DeviceColumn(data, valid, pieces[0].dtype)


def _concat_string_cuda(pieces: Sequence[DeviceColumn]) -> DeviceColumn:
    _lib.require_cuda("concat", *(t for p in pieces
                                  for t in (p.data, p.validity, p.offsets)))
    lib = _lib.lib()
    dev = pieces[0].device
    k = len(pieces)
    rows = [0]
    for p in pieces:
        rows.append(rows[-1] + p.num_rows)
    total = rows[-1]
    # one host->device copy: [k] offsets, [k] validity and [k] data
    # pointers, then the k + 1 row offsets
    desc = torch.tensor([p.offsets.data_ptr() for p in pieces]
                        + [p.validity.data_ptr() for p in pieces]
                        + [p.data.data_ptr() for p in pieces] + rows,
                        dtype=torch.int64).to(dev)
    rows_ptr = ctypes.c_void_p(desc.data_ptr() + 24 * k)
    bases = torch.empty(k + 1, dtype=torch.int64, device=dev)
    s = _lib.stream(dev)
    _lib.check(lib.srt_concat_string_bases(_lib.ptr(desc), rows_ptr, k,
                                           _lib.ptr(bases), s), "concat")
    # the one device->host read of a string concat: its byte count
    nbytes = int(bases[k].item())
    if nbytes >= _INT32_BYTES:
        raise ValueError("a string column holds < 2**31 bytes")
    offsets = (torch.empty(total + 1, dtype=torch.int32, device=dev) if total
               else torch.zeros(1, dtype=torch.int32, device=dev))
    valid = torch.empty(total, dtype=torch.bool, device=dev)
    data = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    _lib.check(lib.srt_concat_strings(
        _lib.ptr(desc), rows_ptr, _lib.ptr(bases), k, _lib.ptr(offsets),
        _lib.ptr(valid), _lib.ptr(data), total, nbytes, s), "concat")
    if total:
        _lib.LAUNCHES["concat_strings"] += 1
    return DeviceColumn(data, valid, pieces[0].dtype, offsets)


def concat_column(pieces: Sequence[DeviceColumn]) -> DeviceColumn:
    """Concatenate k pieces of one column into one, in one launch (a string
    column: one read of its byte count, then its offsets, validity and
    bytes)."""
    if not pieces:
        raise ValueError("concat needs at least one piece")
    if len({p.dtype for p in pieces}) != 1:
        raise TypeError("concat: pieces differ in type")
    if not pieces[0].is_string:
        _row_bytes(pieces[0].data)
    if pieces[0].device.type == "cpu":
        return concat_column_plain(pieces)
    if pieces[0].is_string:
        return _concat_string_cuda(pieces)
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


def coalesce_to_one(batches: Sequence[ColumnarBatch]
                    ) -> Optional[ColumnarBatch]:
    """One batch of all the given ones: the batch itself when there is one,
    None when there is none (``coalesce_to_one``, plan/execs/coalesce.py:198
    of the reference)."""
    if not batches:
        return None
    return batches[0] if len(batches) == 1 else concat_batches_device(batches)
