"""String kernels: SUBSTRING over UTF-8 characters.

Counterpart of ``spark_rapids_tpu/kernels/strings.py`` ``substring_chars``
(:161), with the helpers it runs: ``char_length`` (:101),
``_compact_bytes`` (:141), ``_row_of_byte`` (:88) and ``_live_byte_mask``
(:95).  Spark's SUBSTRING counts characters, not bytes: ``pos`` is 1-based
(0 counts as 1, a negative ``pos`` counts from the end) and ``len < 0``
gives the empty string.  A character starts at every byte with
``(b & 0xC0) != 0x80``, counted byte by byte, a malformed sequence
included, so a lone continuation byte before a row's first character
start is never kept.  ``e0 = s0 + max(len, 0)`` wraps in 32 bits as the
reference's int32 sum does: ``len = 2**31 - 1`` with ``pos >= 2`` gives
the empty string there, where Spark gives the tail.

``substring`` is a wrapper: on CUDA tensors it launches the hand-written
kernel of ``csrc/strings.cu`` (a row pass that writes each row's kept
byte range, the scan of their lengths, one read of the byte total, then
the string gather's byte copy of ``csrc/selection.cu``) and counts one launch under ``substring``; on CPU tensors it
runs ``substring_plain``, the reference's algorithm in torch ops (every
byte's row and character rank, a mask, a compaction).  There is no
fallback from one to the other.  The output keeps the port's string
layout: offsets from 0, a null row of length 0.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.selection import (_INT32_BYTES,
                                                      _ptr_array,
                                                      _string_lanes)

COUNTER = "substring"
#: the length of a SUBSTRING without one (the reference's)
NO_LENGTH = 2**30


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 as a two's-complement sum wraps."""
    return ((x + 2**31) % 2**32) - 2**31


def _per_row(v: torch.Tensor, n: int) -> torch.Tensor:
    """n int64 values from a column of n values or one value."""
    return v.to(torch.int64).expand(n)


def substring_plain(col: DeviceColumn, pos: torch.Tensor,
                    length: torch.Tensor) -> DeviceColumn:
    """The reference's algorithm: each byte's row and character rank, the
    kept bytes ``s0c <= rank < e0c`` of a valid row, then compacted."""
    n = col.num_rows
    dev = col.device
    off = col.offsets.to(torch.int64)
    base = int(off[0]) if n else 0
    data = col.data[base:int(off[-1])] if n else col.data[:0]
    lengths = off[1:] - off[:-1]
    row = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    start = ((data & 0xC0) != 0x80).to(torch.int64)
    # leads[k]: the character starts among the first k bytes
    leads = torch.zeros(data.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(start, 0, out=leads[1:])
    before = leads[off[:-1] - base]
    chars = leads[off[1:] - base] - before
    rank = leads[1:] - 1 - before[row]
    s, ln = _per_row(pos, n), _per_row(length, n)
    s0 = torch.where(s > 0, s - 1, torch.where(s < 0, chars + s, 0))
    e0 = _wrap32(s0 + ln.clamp(min=0))
    s0c = torch.minimum(s0.clamp(min=0), chars)
    e0c = torch.minimum(e0.clamp(min=0), chars)
    keep = (rank >= s0c[row]) & (rank < e0c[row]) & col.validity[row]
    kept = torch.zeros(n, dtype=torch.int64, device=dev)
    kept.index_add_(0, row, keep.to(torch.int64))
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(kept, 0, out=offsets[1:])
    return DeviceColumn(data[keep], col.validity, col.dtype,
                        offsets.to(torch.int32))


def _substring_cuda(col: DeviceColumn, pos: torch.Tensor,
                    length: torch.Tensor) -> DeviceColumn:
    _lib.require_cuda("substring", col.offsets, col.data, col.validity, pos,
                      length)
    lib = _lib.lib()
    n = col.num_rows
    dev = col.device
    starts = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    totals = torch.empty(1, dtype=torch.int64, device=dev)
    s = _lib.stream(dev)
    _lib.check(lib.srt_substring_rows(
        _lib.ptr(col.offsets), _lib.ptr(col.data), _lib.ptr(col.validity), n,
        _lib.ptr(pos), int(pos.shape[0] != 1), _lib.ptr(length),
        int(length.shape[0] != 1), _lib.ptr(starts),
        _lib.ptr(offsets), _lib.ptr(tile_sums), _lib.ptr(totals), s),
        "substring")
    if n:
        _lib.LAUNCHES[COUNTER] += 1
    # the one device->host read of a substring: its byte total
    total = int(totals.item())
    if total >= _INT32_BYTES:
        raise ValueError("a string column holds < 2**31 bytes")
    data = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        # the string gather's byte copy, with no index: row r's bytes
        # start at starts[r]
        arrays = [_ptr_array([t]) for t in (starts, col.data, offsets, data)]
        _lib.check(lib.srt_gather_bytes(
            1, *(p for p, _ in arrays), None, n, _string_lanes(total, n), s),
            "substring")
    return DeviceColumn(data, col.validity, col.dtype, offsets)


def substring(col: DeviceColumn, pos: torch.Tensor,
              length: torch.Tensor) -> DeviceColumn:
    """SUBSTRING(col, pos, length) over UTF-8 characters: ``pos`` and
    ``length`` are int32 tensors of one value a row, or of one value for
    every row.  The result has the column's validity and offsets from 0;
    a null row is empty."""
    if not col.is_string:
        raise TypeError(f"substring takes a string column, got {col.dtype!r}")
    for name, v in (("pos", pos), ("length", length)):
        if v.dtype != torch.int32 or v.dim() != 1 or \
                v.shape[0] not in (1, col.num_rows):
            raise TypeError(f"substring: {name} must be int32 [1] or "
                            f"[{col.num_rows}], got {v.dtype} "
                            f"{tuple(v.shape)}")
    if col.device.type == "cpu":
        return substring_plain(col, pos, length)
    return _substring_cuda(col, pos, length)
