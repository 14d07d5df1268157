"""String kernels: SUBSTRING and the string functions over UTF-8 bytes.

Counterpart of ``spark_rapids_tpu/kernels/strings.py``.  Spark's string
functions count characters, not bytes: a character starts at every byte
with ``(b & 0xC0) != 0x80``, counted byte by byte, a malformed sequence
included, as the reference counts them.  Every function here is a
wrapper: on CUDA tensors it launches its hand-written kernel and counts
the launch; on CPU tensors it runs the plain PyTorch version beside it,
the reference's algorithm in torch ops.  There is no fallback from one to
the other.  An output that changes lengths keeps the port's string
layout: offsets from 0, a null row of length 0, sized exactly by
count-then-allocate (the reference's string bucket, byte capacities and
retry counts are XLA machinery and are not ported).

``substring`` (:161, with ``char_length`` :101, ``_compact_bytes`` :141,
``_row_of_byte`` :88, ``_live_byte_mask`` :95): Spark's SUBSTRING.
``pos`` is 1-based (0 counts as 1, a negative ``pos`` counts from the end)
and ``len < 0`` gives the empty string; a lone continuation byte before a
row's first character start is never kept.  ``e0 = s0 + max(len, 0)``
wraps in 32 bits as the reference's int32 sum does: ``len = 2**31 - 1``
with ``pos >= 2`` gives the empty string there, where Spark gives the
tail.  On the card: a row pass (``csrc/strings.cu``), the scan of the
kept lengths, one read of the byte total, then the string gather's byte
copy of ``csrc/selection.cu``; counted under ``substring``.

The string functions run four kernels of ``csrc/string_functions.cu``,
each with its own launch counter:

- K1 ``string_row_scan``: ``char_length``, ``contains_literal``,
  ``startswith_literal``, ``endswith_literal``, ``first_occurrence_char``
  and the kept ranges of ``trim_ws`` / ``ltrim_ws`` / ``rtrim_ws`` (whose
  bytes the string gather's byte copy moves, as SUBSTRING's);
- K2 ``string_dfa_match``: ``dfa_match``, a host-compiled DFA over each
  row's bytes (RLIKE, general LIKE);
- K3 ``string_assemble``: ``concat_strings``, ``concat_ws``,
  ``select_strings``, ``pad_chars``, ``repeat_string``,
  ``replace_literal``, ``reverse_chars`` and ``translate_bytes`` with
  deletions;
- K4 ``string_case_map``: ``upper_ascii``, ``lower_ascii``,
  ``initcap_ascii`` and ``translate_bytes`` without deletions, which keep
  each row's length: the output keeps the input's offsets, and its bytes
  are the input's buffer's size (the rows' bytes at their own
  positions).  UPPER and LOWER read the byte before in the buffer, as the
  reference's ``jnp.roll(d, 1).at[0].set(0)`` does: a row whose first
  byte follows a 0xC3 that ended the row before is mapped as Latin-1, and
  the column's first live byte (``offsets[0]``) reads 0.

``byte_length`` is a difference of offsets (plain torch on either
device).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
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


# ---------------------------------------------------------------------------
# The string functions (csrc/string_functions.cu)

ROW_SCAN = "string_row_scan"
DFA_MATCH = "string_dfa_match"
ASSEMBLE = "string_assemble"
CASE_MAP = "string_case_map"

# K1's modes, K3's ops and K4's modes: csrc/string_functions.cu has the
# same numbers
(CHAR_LENGTH, CONTAINS, STARTS_WITH, ENDS_WITH, LOCATE, TRIM, LTRIM,
 RTRIM) = range(8)
(CONCAT, CONCAT_WS, SELECT, PAD, REPEAT, REPLACE, REVERSE,
 TRANSLATE) = range(8)
UPPER, LOWER, INITCAP, BYTE_MAP = range(4)

#: K3 saturates a row's length here; an output of this many bytes raises
_MAX_ASSEMBLED = 2**31 - 1
_INF = 2**62


def _strings(*cols: DeviceColumn) -> None:
    for c in cols:
        if not c.is_string:
            raise TypeError(f"a string function takes string columns, got "
                            f"{c.dtype!r}")


def _bytes_on(raw: bytes, dev) -> torch.Tensor:
    return torch.tensor(list(raw), dtype=torch.uint8, device=dev)


def _opt_ptr(t):
    return None if t is None else _lib.ptr(t)


class _Bytes:
    """A column's rows as one byte range, for the plain versions: the
    bytes from offsets[0], the offsets rebased to 0, and each byte's row,
    place in its row and character-start flag; ``leads[k]`` counts the
    character starts among the first k bytes."""

    def __init__(self, col: DeviceColumn):
        dev = col.device
        off = col.offsets.to(torch.int64)
        self.base = int(off[0])
        self.off = off - self.base
        self.n = col.num_rows
        self.total = int(self.off[-1])
        self.data = col.data[self.base:self.base + self.total]
        self.lengths = self.off[1:] - self.off[:-1]
        self.row = torch.repeat_interleave(torch.arange(self.n, device=dev),
                                           self.lengths)
        self.pos = torch.arange(self.total, device=dev) - \
            self.off[:-1][self.row]
        self.lead = (self.data & 0xC0) != 0x80
        self.leads = torch.zeros(self.total + 1, dtype=torch.int64,
                                 device=dev)
        torch.cumsum(self.lead.to(torch.int64), 0, out=self.leads[1:])

    def chars(self) -> torch.Tensor:
        return self.leads[self.off[1:]] - self.leads[self.off[:-1]]

    def rank(self) -> torch.Tensor:
        """Each byte's character rank in its row (-1 before the row's
        first character start)."""
        return self.leads[1:] - 1 - self.leads[self.off[:-1]][self.row]

    def hits(self, pattern: bytes) -> torch.Tensor:
        """bool per byte: the pattern starts there, inside the row."""
        m = len(pattern)
        ok = self.pos + m <= self.lengths[self.row]
        idx = torch.arange(self.total, device=self.data.device)
        for i, b in enumerate(pattern):
            ok &= self.data[(idx + i).clamp(max=max(self.total - 1, 0))] == b
        return ok

    def per_row(self, flags: torch.Tensor) -> torch.Tensor:
        """int64 count of the set flags in each row."""
        out = torch.zeros(self.n, dtype=torch.int64, device=flags.device)
        return out.index_add_(0, self.row, flags.to(torch.int64))

    def row_min(self, values: torch.Tensor, empty: int) -> torch.Tensor:
        out = torch.full((self.n,), empty, dtype=torch.int64,
                         device=values.device)
        return out.scatter_reduce_(0, self.row, values, "amin")

    def row_max(self, values: torch.Tensor, empty: int) -> torch.Tensor:
        out = torch.full((self.n,), empty, dtype=torch.int64,
                         device=values.device)
        return out.scatter_reduce_(0, self.row, values, "amax")


def _offsets_of(lengths: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """int64 offsets of per-row lengths, and the total, which must stay
    below K3's limit."""
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                          device=lengths.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total >= _MAX_ASSEMBLED:
        raise ValueError("a string column holds < 2**31 - 1 bytes")
    return offsets, total


def _compact(b: _Bytes, col: DeviceColumn, keep: torch.Tensor,
             data=None) -> DeviceColumn:
    """The kept bytes of each row (``data``: mapped bytes in their
    place), new offsets from 0; the column's validity."""
    offsets, _ = _offsets_of(b.per_row(keep))
    src = b.data if data is None else data
    return DeviceColumn(src[keep], col.validity, T.STRING,
                        offsets.to(torch.int32))


def _gather_pieces(src: torch.Tensor, starts: torch.Tensor,
                   lengths: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Each row's output as a run of pieces of ``src``: ``starts`` and
    ``lengths`` int64 [rows, P] (a row's pieces in order).  Returns the
    bytes and the int32 offsets."""
    offsets, total = _offsets_of(lengths.sum(1))
    fs, fl = starts.reshape(-1), lengths.reshape(-1)
    at = torch.cumsum(fl, 0) - fl
    idx = torch.repeat_interleave(fs - at, fl) + \
        torch.arange(total, device=src.device)
    return src[idx], offsets.to(torch.int32)


# -- K1: string_row_scan ----------------------------------------------------

def _row_scan_cuda(col: DeviceColumn, mode: int, pattern: bytes = b"",
                   start0: int = 0):
    _lib.require_cuda(ROW_SCAN, col.offsets, col.data, col.validity)
    lib = _lib.lib()
    n, dev = col.num_rows, col.device
    pat = _bytes_on(pattern, dev) if pattern else None
    s = _lib.stream(dev)
    if mode < TRIM:
        ints = mode in (CHAR_LENGTH, LOCATE)
        out = torch.empty(n, dtype=torch.int32 if ints else torch.bool,
                          device=dev)
        _lib.check(lib.srt_string_row_scan(
            mode, _lib.ptr(col.offsets), _lib.ptr(col.data),
            _lib.ptr(col.validity), n, _opt_ptr(pat), len(pattern), start0,
            _lib.ptr(out) if ints else None, None if ints else _lib.ptr(out),
            None, None, None, s), ROW_SCAN)
        if n:
            _lib.LAUNCHES[ROW_SCAN] += 1
        return out
    starts = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    totals = torch.empty(1, dtype=torch.int64, device=dev)
    _lib.check(lib.srt_string_row_scan(
        mode, _lib.ptr(col.offsets), _lib.ptr(col.data),
        _lib.ptr(col.validity), n, None, 0, 0, _lib.ptr(offsets), None,
        _lib.ptr(starts), _lib.ptr(tile_sums), _lib.ptr(totals), s), ROW_SCAN)
    if n:
        _lib.LAUNCHES[ROW_SCAN] += 1
    # the one device->host read of a trim: its byte total
    total = int(totals.item())
    if total >= _INT32_BYTES:
        raise ValueError("a string column holds < 2**31 bytes")
    data = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        arrays = [_ptr_array([t]) for t in (starts, col.data, offsets, data)]
        _lib.check(lib.srt_gather_bytes(
            1, *(p for p, _ in arrays), None, n, _string_lanes(total, n), s),
            ROW_SCAN)
    return DeviceColumn(data, col.validity, col.dtype, offsets)


def char_length_plain(col: DeviceColumn) -> torch.Tensor:
    return _Bytes(col).chars().to(torch.int32)


def char_length(col: DeviceColumn) -> torch.Tensor:
    """int32 [n]: each row's characters (LENGTH)."""
    _strings(col)
    if col.device.type == "cpu":
        return char_length_plain(col)
    return _row_scan_cuda(col, CHAR_LENGTH)


def byte_length(col: DeviceColumn) -> torch.Tensor:
    """int32 [n]: each row's bytes (a difference of offsets)."""
    _strings(col)
    return col.offsets[1:] - col.offsets[:-1]


def contains_literal_plain(col: DeviceColumn, pattern: bytes) -> torch.Tensor:
    if not pattern:
        return torch.ones(col.num_rows, dtype=torch.bool, device=col.device)
    b = _Bytes(col)
    return b.per_row(b.hits(pattern)) > 0


def startswith_literal_plain(col: DeviceColumn,
                             pattern: bytes) -> torch.Tensor:
    return _edge_plain(col, pattern, at_end=False)


def endswith_literal_plain(col: DeviceColumn, pattern: bytes) -> torch.Tensor:
    return _edge_plain(col, pattern, at_end=True)


def _edge_plain(col: DeviceColumn, pattern: bytes,
                at_end: bool) -> torch.Tensor:
    b = _Bytes(col)
    m = len(pattern)
    ok = b.lengths >= m
    if m == 0 or b.total == 0:
        return ok
    first = (b.off[1:] - m) if at_end else b.off[:-1]
    idx = (first[:, None] + torch.arange(m, device=col.device)).clamp(
        0, b.total - 1)
    return ok & (b.data[idx] == _bytes_on(pattern, col.device)).all(1)


def _literal_test(mode: int, col: DeviceColumn, pattern: bytes,
                  plain) -> torch.Tensor:
    _strings(col)
    if col.device.type == "cpu":
        return plain(col, pattern)
    return _row_scan_cuda(col, mode, pattern)


def contains_literal(col: DeviceColumn, pattern: bytes) -> torch.Tensor:
    """bool [n]: the literal occurs in the row (an empty one always)."""
    return _literal_test(CONTAINS, col, pattern, contains_literal_plain)


def startswith_literal(col: DeviceColumn, pattern: bytes) -> torch.Tensor:
    return _literal_test(STARTS_WITH, col, pattern, startswith_literal_plain)


def endswith_literal(col: DeviceColumn, pattern: bytes) -> torch.Tensor:
    return _literal_test(ENDS_WITH, col, pattern, endswith_literal_plain)


def first_occurrence_char_plain(col: DeviceColumn, pattern: bytes,
                                start0: int) -> torch.Tensor:
    b = _Bytes(col)
    if not pattern:
        chars = b.chars()
        return torch.where(start0 <= chars, start0 + 1, 0).to(torch.int32)
    rank = b.rank()
    hit = b.hits(pattern) & b.lead & (rank >= start0)
    first = b.row_min(torch.where(hit, rank, _INF), _INF)
    return torch.where(first >= _INF, 0, first + 1).to(torch.int32)


def first_occurrence_char(col: DeviceColumn, pattern: bytes,
                          start_char: int = 1) -> torch.Tensor:
    """int32 [n]: the 1-based character index of the pattern's first
    occurrence that starts at a lead byte at or after character
    ``start_char`` (1-based; below 1 counts as 1), 0 if none; an empty
    pattern gives the start where it is at most the row's characters
    (INSTR, LOCATE)."""
    _strings(col)
    start0 = min(max(int(start_char) - 1, 0), 2**31 - 1)
    if col.device.type == "cpu":
        return first_occurrence_char_plain(col, pattern, start0)
    return _row_scan_cuda(col, LOCATE, pattern, start0)


def trim_plain(col: DeviceColumn, mode: int) -> DeviceColumn:
    b = _Bytes(col)
    inside = torch.where(b.data != 0x20, b.pos, _INF)
    first = b.row_min(inside, _INF)
    last = b.row_max(torch.where(b.data != 0x20, b.pos, -1), -1)
    keep = col.validity[b.row]
    if mode != RTRIM:
        keep = keep & (b.pos >= first[b.row])
    if mode != LTRIM:
        keep = keep & (b.pos <= last[b.row])
    return _compact(b, col, keep)


def _trim(col: DeviceColumn, mode: int) -> DeviceColumn:
    _strings(col)
    if col.device.type == "cpu":
        return trim_plain(col, mode)
    return _row_scan_cuda(col, mode)


def trim_ws(col: DeviceColumn) -> DeviceColumn:
    """TRIM: 0x20 stripped from both ends (Spark strips the space only)."""
    return _trim(col, TRIM)


def ltrim_ws(col: DeviceColumn) -> DeviceColumn:
    return _trim(col, LTRIM)


def rtrim_ws(col: DeviceColumn) -> DeviceColumn:
    return _trim(col, RTRIM)


# -- K2: string_dfa_match ---------------------------------------------------

def dfa_tables(table: np.ndarray, accept: np.ndarray,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A compiled DFA's int32 [S, 256] table and bool [S] accept, narrowed
    to uint8 on ``device`` (S <= 255: a state fits in a byte)."""
    if table.ndim != 2 or table.shape[1] != 256 or \
            not 1 <= table.shape[0] <= 255 or \
            accept.shape != (table.shape[0],):
        raise ValueError(f"a DFA of 1-255 states is [S, 256] with accept "
                         f"[S], got {table.shape} and {accept.shape}")
    if table.min() < 0 or table.max() >= table.shape[0]:
        raise ValueError("a DFA's transitions name its own states")
    return (torch.from_numpy(table.astype(np.uint8)).to(device),
            torch.from_numpy(accept.astype(np.uint8)).to(device))


def dfa_match_plain(col: DeviceColumn, table: torch.Tensor,
                    accept: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Every row steps through the table one byte position at a time, the
    rows ordered longest first so that each step touches only the rows
    still running."""
    n, dev = col.num_rows, col.device
    lengths = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    order = torch.argsort(lengths, descending=True, stable=True)
    starts = col.offsets[:-1].to(torch.int64)[order]
    running = np.sort((col.offsets[1:] - col.offsets[:-1]).cpu().numpy())
    flat = table.to(torch.int64).reshape(-1)
    state = torch.full((n,), start, dtype=torch.int64, device=dev)
    longest = int(running[-1]) if n else 0
    for j in range(longest):
        c = n - int(np.searchsorted(running, j, side="right"))
        byte = col.data[starts[:c] + j].to(torch.int64)
        state[:c] = flat[state[:c] * 256 + byte]
    out = torch.empty(n, dtype=torch.bool, device=dev)
    out[order] = accept[state] != 0
    return out


def _dfa_cuda(col: DeviceColumn, table: torch.Tensor, accept: torch.Tensor,
              start: int) -> torch.Tensor:
    _lib.require_cuda(DFA_MATCH, col.offsets, col.data, table, accept)
    lib = _lib.lib()
    n = col.num_rows
    out = torch.empty(n, dtype=torch.bool, device=col.device)
    _lib.check(lib.srt_string_dfa_match(
        _lib.ptr(col.offsets), _lib.ptr(col.data), n, _lib.ptr(table),
        _lib.ptr(accept), table.shape[0], start, _lib.ptr(out),
        _lib.stream(col.device)), DFA_MATCH)
    if n:
        _lib.LAUNCHES[DFA_MATCH] += 1
    return out


def dfa_match(col: DeviceColumn, table: torch.Tensor, accept: torch.Tensor,
              start: int = 0) -> torch.Tensor:
    """bool [n]: ``accept`` of the state the row's bytes lead to from
    ``start`` (``dfa_tables``' uint8 tables, on the column's device)."""
    _strings(col)
    if table.dtype != torch.uint8 or accept.dtype != torch.uint8 or \
            table.dim() != 2 or table.shape[1] != 256 or \
            accept.shape != (table.shape[0],) or \
            not 0 <= start < table.shape[0] <= 255:
        raise TypeError("dfa_match takes dfa_tables' uint8 [S, 256] table "
                        "and [S] accept, S <= 255")
    if col.device.type == "cpu":
        return dfa_match_plain(col, table, accept, start)
    return _dfa_cuda(col, table, accept, start)


# -- K3: string_assemble ----------------------------------------------------

def _assemble_cuda(op: int, cols: Sequence[DeviceColumn], n: int, dev,
                   choice=None, lit: bytes = b"", lit_len=None,
                   lit2_len: int = 0, arg: int = 0,
                   left: bool = False) -> DeviceColumn:
    tensors = [t for c in cols for t in (c.offsets, c.data, c.validity)]
    _lib.require_cuda(ASSEMBLE, *tensors,
                      *([] if choice is None else [choice]))
    lib = _lib.lib()
    desc = torch.tensor([t.data_ptr() for t in tensors],
                        dtype=torch.int64).to(dev)
    lit_t = _bytes_on(lit, dev) if lit else None
    lit_len = len(lit) if lit_len is None else lit_len
    args = (op, len(cols), _lib.ptr(desc), n, _opt_ptr(choice),
            _opt_ptr(lit_t), lit_len, lit2_len,
            max(min(int(arg), 2**62), -2**62), int(left))
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    totals = torch.empty(1, dtype=torch.int64, device=dev)
    s = _lib.stream(dev)
    _lib.check(lib.srt_string_assemble_count(
        *args, _lib.ptr(offsets), _lib.ptr(valid), _lib.ptr(tile_sums),
        _lib.ptr(totals), s), ASSEMBLE)
    if n:
        _lib.LAUNCHES[ASSEMBLE] += 1
    # the one device->host read of an assembly: its byte total
    total = int(totals.item())
    if total >= _MAX_ASSEMBLED:
        raise ValueError("a string column holds < 2**31 - 1 bytes")
    data = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        _lib.check(lib.srt_string_assemble_write(
            *args, _lib.ptr(offsets), _lib.ptr(data), s), ASSEMBLE)
    return DeviceColumn(data, valid, T.STRING, offsets)


def _rows_of(cols: Sequence[DeviceColumn]):
    """For the plain versions: the columns' bytes in one buffer, and each
    column's (row starts in it, row lengths), int64 [n]."""
    src, parts, base = [], [], 0
    for c in cols:
        off = c.offsets.to(torch.int64)
        src.append(c.data)
        parts.append((off[:-1] + base, off[1:] - off[:-1]))
        base += c.data.shape[0]
    return src, parts, base


def concat_strings_plain(cols: Sequence[DeviceColumn]) -> DeviceColumn:
    src, parts, _ = _rows_of(cols)
    valid = cols[0].validity
    for c in cols[1:]:
        valid = valid & c.validity
    starts = torch.stack([s for s, _ in parts], 1)
    lengths = torch.stack([torch.where(valid, ln, 0) for _, ln in parts], 1)
    data, offsets = _gather_pieces(torch.cat(src), starts, lengths)
    return DeviceColumn(data, valid, T.STRING, offsets)


def concat_ws_plain(cols: Sequence[DeviceColumn], sep: bytes) -> DeviceColumn:
    dev = cols[0].device
    src, parts, base = _rows_of(cols)
    src.append(_bytes_on(sep, dev))
    n = cols[0].num_rows
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    starts, lengths = [], []
    for c, (st, ln) in zip(cols, parts):
        starts += [torch.full_like(st, base), st]
        lengths += [torch.where(c.validity & seen, len(sep), 0),
                    torch.where(c.validity, ln, 0)]
        seen = seen | c.validity
    data, offsets = _gather_pieces(torch.cat(src), torch.stack(starts, 1),
                                   torch.stack(lengths, 1))
    return DeviceColumn(data, torch.ones(n, dtype=torch.bool, device=dev),
                        T.STRING, offsets)


def select_strings_plain(choice: torch.Tensor,
                         cols: Sequence[DeviceColumn]) -> DeviceColumn:
    src, parts, _ = _rows_of(cols)
    k = len(cols)
    live = (choice >= 0) & (choice < k)
    pick = torch.where(live, choice, 0).to(torch.int64)[None, :]
    valid = live & torch.stack([c.validity for c in cols]).gather(
        0, pick)[0]
    starts = torch.stack([s for s, _ in parts]).gather(0, pick)[0]
    lengths = torch.stack([ln for _, ln in parts]).gather(0, pick)[0]
    data, offsets = _gather_pieces(torch.cat(src), starts[:, None],
                                   torch.where(valid, lengths, 0)[:, None])
    return DeviceColumn(data, valid, T.STRING, offsets)


def pad_chars_plain(col: DeviceColumn, target: int, pad: bytes,
                    left: bool) -> DeviceColumn:
    b = _Bytes(col)
    dev = col.device
    tgt = max(int(target), 0)
    chars = b.chars()
    keep_chars = chars.clamp(max=tgt)
    npad = (tgt - chars).clamp(min=0) if pad else torch.zeros_like(chars)
    keep = b.per_row(b.rank() < keep_chars[b.row])
    npad = torch.where(col.validity, npad, 0)
    keep = torch.where(col.validity, keep, 0)
    _offsets_of(keep + npad)   # raises past the limit before the fill
    longest = int(npad.max()) if b.n else 0
    fill = (pad * (longest // max(len(pad), 1) + 1))[:longest]
    src = torch.cat([b.data, _bytes_on(fill, dev)])
    value = (b.off[:-1], keep)
    padding = (torch.full_like(keep, b.total), npad)
    pieces = (padding, value) if left else (value, padding)
    data, offsets = _gather_pieces(src, torch.stack([s for s, _ in pieces], 1),
                                   torch.stack([ln for _, ln in pieces], 1))
    return DeviceColumn(data, col.validity, T.STRING, offsets)


def repeat_string_plain(col: DeviceColumn, times: int) -> DeviceColumn:
    b = _Bytes(col)
    dev = col.device
    reps = min(max(int(times), 0), _MAX_ASSEMBLED)
    out_len = torch.where(col.validity, b.lengths * reps, 0)
    offsets, total = _offsets_of(out_len)
    row = torch.repeat_interleave(torch.arange(b.n, device=dev), out_len)
    within = torch.arange(total, device=dev) - offsets[:-1][row]
    src = b.off[:-1][row] + within % b.lengths[row].clamp(min=1)
    return DeviceColumn(b.data[src], col.validity, T.STRING,
                        offsets.to(torch.int32))


def replace_literal_plain(col: DeviceColumn, search: bytes,
                          replace: bytes) -> DeviceColumn:
    """The hits taken greedily from the left, as the reference's countdown
    scan takes them (:533-541), every row one byte position a step."""
    b = _Bytes(col)
    dev = col.device
    m, mr = len(search), len(replace)
    hit = b.hits(search) & col.validity[b.row]
    taken = torch.zeros(b.total, dtype=torch.bool, device=dev)
    order = torch.argsort(b.lengths, descending=True, stable=True)
    starts = b.off[:-1][order]
    running = np.sort(b.lengths.cpu().numpy())
    wait = torch.zeros(b.n, dtype=torch.int64, device=dev)
    for j in range(int(running[-1]) if b.n else 0):
        c = b.n - int(np.searchsorted(running, j, side="right"))
        at = starts[:c] + j
        take = hit[at] & (wait[:c] == 0)
        taken[at] = take
        wait[:c] = torch.where(take, m - 1, (wait[:c] - 1).clamp(min=0))
    cover = torch.zeros(b.total + 1, dtype=torch.int64, device=dev)
    at = torch.nonzero(taken).reshape(-1)
    cover.index_add_(0, at, torch.ones_like(at))
    cover.index_add_(0, at + m, -torch.ones_like(at))
    inside = (torch.cumsum(cover, 0)[:-1] > 0) & ~taken
    emit = torch.where(taken, mr, torch.where(inside, 0, 1))
    offsets, total = _offsets_of(b.per_row(emit))
    src = torch.cat([b.data, _bytes_on(replace, dev)])
    start = torch.where(taken, b.total, torch.arange(b.total, device=dev))
    data, _ = _gather_pieces(src, start[:, None], emit[:, None])
    return DeviceColumn(data, col.validity, T.STRING,
                        offsets.to(torch.int32))


def reverse_chars_plain(col: DeviceColumn) -> DeviceColumn:
    """Each byte's mirrored place: a character starts at the row's start
    and at every later lead byte, and moves whole."""
    b = _Bytes(col)
    dev = col.device
    first = (b.pos == 0) | b.lead
    cid = torch.cumsum(first.to(torch.int64), 0) - 1
    cs = torch.nonzero(first).reshape(-1)
    ce = torch.cat([cs[1:], torch.full((1,), b.total, device=dev)])
    row_start = b.off[:-1][b.row]
    row_end = b.off[1:][b.row]
    idx = torch.arange(b.total, device=dev)
    dest = row_start + (row_end - ce[cid]) + (idx - cs[cid])
    data = torch.empty_like(b.data)
    data[dest] = b.data
    return DeviceColumn(data, col.validity, T.STRING, b.off.to(torch.int32))


def _byte_tables(src: str, dst: str) -> Tuple[bytes, bytes]:
    """TRANSLATE's map and delete flags a byte value: the first occurrence
    of a character in ``src`` wins (Java's), one beyond ``dst``'s length
    is deleted.  ASCII only."""
    table = list(range(256))
    drop = [0] * 256
    seen = set()
    for i, ch in enumerate(src):
        if ch in seen:
            continue
        seen.add(ch)
        if i < len(dst):
            table[ord(ch)] = ord(dst[i])
        else:
            drop[ord(ch)] = 1
    return bytes(table), bytes(drop)


def translate_bytes_plain(col: DeviceColumn, table: bytes,
                          drop: bytes) -> DeviceColumn:
    if not any(drop):
        return case_map_plain(col, BYTE_MAP, table)
    b = _Bytes(col)
    dev = col.device
    mapped = _bytes_on(table, dev)[b.data.to(torch.int64)]
    keep = (_bytes_on(drop, dev)[b.data.to(torch.int64)] == 0) & \
        col.validity[b.row]
    return _compact(b, col, keep, mapped)


def _assemble(op, cols, plain, *plain_args, choice=None, **cuda_kw):
    _strings(*cols)
    if len({c.num_rows for c in cols}) != 1:
        raise ValueError(f"string_assemble: inputs of "
                         f"{[c.num_rows for c in cols]} rows")
    if cols[0].device.type == "cpu":
        return plain(*plain_args)
    return _assemble_cuda(op, cols, cols[0].num_rows, cols[0].device,
                          choice=choice, **cuda_kw)


def concat_strings(cols: Sequence[DeviceColumn]) -> DeviceColumn:
    """CONCAT: the rows joined, null where any input is null."""
    return _assemble(CONCAT, cols, concat_strings_plain, cols)


def concat_ws(cols: Sequence[DeviceColumn], sep: bytes) -> DeviceColumn:
    """CONCAT_WS: the valid inputs joined by ``sep``; never null."""
    return _assemble(CONCAT_WS, cols, concat_ws_plain, cols, sep, lit=sep)


def select_strings(choice: torch.Tensor,
                   cols: Sequence[DeviceColumn]) -> DeviceColumn:
    """Row r of ``cols[choice[r]]`` (int32 choice; ``len(cols)``: null),
    with that input's validity: a string IF, or a whole CASE WHEN."""
    if choice.dtype != torch.int32 or choice.shape != (cols[0].num_rows,):
        raise TypeError(f"select_strings: choice must be int32 "
                        f"[{cols[0].num_rows}], got {choice.dtype} "
                        f"{tuple(choice.shape)}")
    return _assemble(SELECT, cols, select_strings_plain, choice, cols,
                     choice=choice)


def pad_chars(col: DeviceColumn, target: int, pad: bytes,
              left: bool) -> DeviceColumn:
    """LPAD / RPAD by characters: truncate to ``target`` characters, pad
    with the ASCII ``pad`` repeated (an empty one only truncates; a
    negative target counts as 0)."""
    return _assemble(PAD, [col], pad_chars_plain, col, target, pad, left,
                     lit=pad, arg=target, left=left)


def repeat_string(col: DeviceColumn, times: int) -> DeviceColumn:
    """REPEAT: ``times`` copies (none for times <= 0)."""
    return _assemble(REPEAT, [col], repeat_string_plain, col, times,
                     arg=times)


def replace_literal(col: DeviceColumn, search: bytes,
                    replace: bytes) -> DeviceColumn:
    """REPLACE with literals: non-overlapping hits of ``search`` (not
    empty) taken greedily from the left, each replaced."""
    if not search:
        raise ValueError("replace_literal: the search literal is empty "
                         "(the expression returns its input)")
    return _assemble(REPLACE, [col], replace_literal_plain, col, search,
                     replace, lit=search + replace, lit_len=len(search),
                     lit2_len=len(replace))


def reverse_chars(col: DeviceColumn) -> DeviceColumn:
    """REVERSE by characters, each character's bytes kept in order."""
    return _assemble(REVERSE, [col], reverse_chars_plain, col)


def translate_bytes(col: DeviceColumn, table: bytes,
                    drop: bytes) -> DeviceColumn:
    """TRANSLATE over bytes: ``table`` maps each byte value, ``drop`` (256
    flags) deletes one.  Without a deletion the lengths stay: K4;
    otherwise K3."""
    if len(table) != 256 or len(drop) != 256:
        raise ValueError("translate_bytes takes 256-byte tables")
    if not any(drop):
        return _case_map(BYTE_MAP, col, table)
    return _assemble(TRANSLATE, [col], translate_bytes_plain, col, table,
                     drop, lit=table + drop)


# -- K4: string_case_map ----------------------------------------------------

def case_map_plain(col: DeviceColumn, mode: int,
                   table: bytes = b"") -> DeviceColumn:
    """Every byte of the buffer mapped, reading the byte before it (0 at
    the buffer's start and at the column's first live byte)."""
    d = col.data
    dev = col.device
    if mode == BYTE_MAP:
        out = _bytes_on(table, dev)[d.to(torch.int64)]
        return DeviceColumn(out, col.validity, col.dtype, col.offsets)
    prev = torch.roll(d, 1)
    if d.numel():
        prev[0] = 0
        base = int(col.offsets[0])
        if base < d.numel():
            prev[base] = 0
    if mode == UPPER:
        change = ((d >= 0x61) & (d <= 0x7A)) | (
            (prev == 0xC3) & (d >= 0xA0) & (d <= 0xBE) & (d != 0xB7))
        out = torch.where(change, d - 32, d)
    elif mode == LOWER:
        change = ((d >= 0x41) & (d <= 0x5A)) | (
            (prev == 0xC3) & (d >= 0x80) & (d <= 0x9E) & (d != 0x97))
        out = torch.where(change, d + 32, d)
    else:
        first = torch.zeros(d.numel(), dtype=torch.bool, device=dev)
        starts = col.offsets[:-1].to(torch.int64)
        first[starts[col.offsets[1:] > col.offsets[:-1]]] = True
        after = (prev == 0x20) | first
        up = torch.where((d >= 0x61) & (d <= 0x7A) & after, d - 32, d)
        out = torch.where((d >= 0x41) & (d <= 0x5A) & ~after, up + 32, up)
    return DeviceColumn(out, col.validity, col.dtype, col.offsets)


def _case_map_cuda(col: DeviceColumn, mode: int,
                   table: bytes) -> DeviceColumn:
    _lib.require_cuda(CASE_MAP, col.offsets, col.data)
    lib = _lib.lib()
    dev = col.device
    lut = _bytes_on(table, dev) if mode == BYTE_MAP else None
    out = torch.empty_like(col.data)
    _lib.check(lib.srt_string_case_map(
        mode, _lib.ptr(col.offsets), _lib.ptr(col.data), col.num_rows,
        _opt_ptr(lut), _lib.ptr(out), _lib.stream(dev)), CASE_MAP)
    if col.num_rows:
        _lib.LAUNCHES[CASE_MAP] += 1
    return DeviceColumn(out, col.validity, col.dtype, col.offsets)


def _case_map(mode: int, col: DeviceColumn,
              table: bytes = b"") -> DeviceColumn:
    _strings(col)
    if col.device.type == "cpu":
        return case_map_plain(col, mode, table)
    return _case_map_cuda(col, mode, table)


def upper_ascii(col: DeviceColumn) -> DeviceColumn:
    """UPPER over ASCII and Latin-1 (C3 xx pairs; other scripts pass)."""
    return _case_map(UPPER, col)


def lower_ascii(col: DeviceColumn) -> DeviceColumn:
    return _case_map(LOWER, col)


def initcap_ascii(col: DeviceColumn) -> DeviceColumn:
    """INITCAP: an ASCII letter after 0x20 or at a row's start upper, the
    other ASCII capitals lower."""
    return _case_map(INITCAP, col)
