"""Equi-join kernels: the inner join on one fixed-width key or on several
keys, strings among them.

Counterpart of ``spark_rapids_tpu/kernels/join.py`` (``join_path`` :134,
``_probe_single`` :154, ``_expand_single`` :226, ``_probe_multi`` :275,
``_expand_multi`` :420, ``join_probe`` :457, ``join_expand`` :484,
``join_gather_maps`` :496, ``apply_gather_maps`` :521) for the inner
join.  Spark's semantics hold: a null in any key never matches, NaN
matches NaN and -0.0 matches 0.0 (keys are normalized), an int key matches
a long key by value, strings match byte for byte, and the pairs come out
in stream-row order, each row's matches in build-row order, as the
reference's do.

The build side is sorted once per join (``build_side``).  On one
fixed-width key (the reference's 'single' path) it is the normalized key
ordered by the ported radix ``sort_indices``, nulls last, written as
uint64 order keys.  On several keys or a string key ('multi') it is
ordered by (any key null, the keys) and each sorted row's key tuple
becomes a row of uint64 order words (a string key: its big-endian 8-byte
chunks, then its length), where the reference sorts both sides together.
Each stream batch is then probed (``join_probe``: a lower and an upper
bound per row, the exclusive scan of the match counts, one blocking read
of the number of pairs) and expanded (``join_expand``: each row writes its
``(li, ri = perm[lo + j])`` pairs; both paths share it).  The maps have
exactly as many pairs as the join outputs, so there is no capacity retry;
``apply_gather_maps`` is the ported gather on each side.

On CUDA tensors each step launches its kernel of ``csrc/join.cu`` and
counts the launch; on CPU tensors it runs the plain PyTorch version
beside it.  The other join types (left, semi, anti, outer, existence),
the cross join and ``conditional_join_maps`` (:44) raise
NotImplementedError.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.groupby import normalize_key_column
from spark_rapids_tpu_torch.kernels.selection import gather_columns
from spark_rapids_tpu_torch.kernels.sort import (SortOrder, sort_indices,
                                                 string_chunks,
                                                 string_sort_keys_plain)

JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "cross", "existence")

# key kinds of csrc/join.cu
_INT32, _INT64, _F64, _BOOL, _STRING = 0, 1, 2, 3, 4
_SIGN64 = -2**63
_NULLS_LAST = SortOrder(True, False)


def _kind(dtype: T.DataType) -> int:
    if isinstance(dtype, (T.IntegerType, T.DateType)):
        return _INT32
    if isinstance(dtype, (T.LongType, T.DecimalType)):
        return _INT64
    if isinstance(dtype, T.DoubleType):
        return _F64
    if isinstance(dtype, T.BooleanType):
        return _BOOL
    if isinstance(dtype, T.StringType):
        return _STRING
    raise NotImplementedError(f"a join key of {dtype!r} is not ported")


def _check_key_types(lt: T.DataType, rt: T.DataType) -> None:
    """Both keys compare as one type: equal types, or int with long."""
    ints = (T.INT, T.LONG)
    if lt != rt and not (lt in ints and rt in ints):
        raise NotImplementedError(
            f"a join of a {lt!r} key with a {rt!r} key is not ported")
    _kind(lt)


def join_path(left: ColumnarBatch, left_keys: Sequence[int],
              right: ColumnarBatch, right_keys: Sequence[int],
              join_type: str) -> str:
    """The reference's kernel-path dispatch ('cross' | 'single' |
    'multi'); the inner join of both 'single' and 'multi' is ported."""
    if join_type == "cross":
        return "cross"
    if (join_type in ("inner", "left", "left_semi", "left_anti")
            and len(left_keys) == 1
            and not left.columns[left_keys[0]].is_string
            and not right.columns[right_keys[0]].is_string):
        return "single"
    return "multi"


def _require_ported(path: str, join_type: str) -> None:
    if path == "cross":
        raise NotImplementedError("the cross join is not ported")
    if join_type != "inner":
        raise NotImplementedError(f"the {join_type} join is not ported; "
                                  "only inner")


def conditional_join_maps(*args, **kwargs):
    """The residual-condition join of the reference (join.py:44)."""
    raise NotImplementedError("conditional_join_maps (a join with a residual "
                              "condition) is not ported")


@dataclasses.dataclass
class JoinBuild:
    """The build side of a join, sorted once: ``perm`` orders its rows by
    key (rows with a null key last); ``keys[i]`` and ``key_valid[i]`` are
    the order key and validity of row ``perm[i]``.  On one fixed-width key
    ``key`` is its ordinal and ``keys`` int64 [nb]; on several keys (the
    'multi' path) ``key`` is a tuple of ordinals, ``keys`` the int64 [nb,
    words] order words, and ``chunks`` holds each key's chunk count (None
    for a fixed-width key)."""

    batch: ColumnarBatch
    key: Union[int, Tuple[int, ...]]
    perm: torch.Tensor         # int32 [nb]
    keys: torch.Tensor         # int64: the kernel's uint64 order keys
    key_valid: torch.Tensor    # bool [nb]
    chunks: Tuple[Optional[int], ...] = ()

    @property
    def num_rows(self) -> int:
        return self.batch.num_rows

    @property
    def multi(self) -> bool:
        return isinstance(self.key, tuple)

# ---------------------------------------------------------------------------
# plain versions


def order_keys_plain(col: DeviceColumn) -> torch.Tensor:
    """The kernel's uint64 order keys, as their bits in int64: integers
    with the sign bit flipped, doubles in Java's total order after -0.0 ->
    0.0 and NaN -> the canonical NaN; 0 on a null row."""
    if col.data.dtype == torch.float64:
        bits = normalize_key_column(col).data.view(torch.int64)
        k = torch.where(bits < 0, ~bits, bits | _SIGN64)
    elif col.data.dtype == torch.bool:
        k = col.data.to(torch.int64)
    else:
        k = col.data.to(torch.int64) ^ _SIGN64
    return torch.where(col.validity, k, 0)


def build_keys_plain(col: DeviceColumn, perm: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    p = perm.long()
    return order_keys_plain(col)[p], col.validity[p]


def probe_plain(col: DeviceColumn, build: JoinBuild
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(int32 first match, int32 offsets [n + 1], pairs): a search of the
    valid prefix of the sorted build keys (signed order of key ^ sign bit
    = unsigned order of the key)."""
    valid_keys = build.keys[:int(build.key_valid.sum())] ^ _SIGN64
    k = order_keys_plain(col) ^ _SIGN64
    lo = torch.searchsorted(valid_keys, k, side="left")
    hi = torch.searchsorted(valid_keys, k, side="right")
    counts = torch.where(col.validity, hi - lo, 0)
    offsets = torch.zeros(col.num_rows + 1, dtype=torch.int64,
                          device=col.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    total = int(offsets[-1])
    lo = torch.where(col.validity, lo, 0)
    return lo.to(torch.int32), offsets.to(torch.int32), total


def expand_plain(lo: torch.Tensor, offsets: torch.Tensor, total: int,
                 perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    counts = (offsets[1:] - offsets[:-1]).long()
    row = torch.repeat_interleave(
        torch.arange(lo.shape[0], device=lo.device), counts)
    within = torch.arange(total, device=lo.device) - offsets[row].long()
    ri = perm.long()[lo.long()[row] + within]
    return row.to(torch.int32), ri.to(torch.int32)


def _all_valid(cols: Sequence[DeviceColumn]) -> torch.Tensor:
    valid = cols[0].validity
    for c in cols[1:]:
        valid = valid & c.validity
    return valid


def key_words_plain(cols: Sequence[DeviceColumn],
                    chunks: Sequence[Optional[int]],
                    perm: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 [n, words] order words as uint64 bits, bool [n] all keys
    valid) of rows ``perm`` (None: every row in order): per key its order
    key, or a string key's ``chunks`` big-endian 8-byte chunks and its
    full length; a row with a null key is all zero."""
    words: List[torch.Tensor] = []
    for c, nch in zip(cols, chunks):
        if c.is_string:
            ch, lengths = string_sort_keys_plain(c, 8 * nch)
            words += list(ch) + [lengths.to(torch.int64)]
        else:
            words.append(order_keys_plain(c))
    valid = _all_valid(cols)
    w = torch.stack(words, dim=1)
    if perm is not None:
        p = perm.long()
        w, valid = w[p], valid[p]
    return torch.where(valid[:, None], w, 0), valid


def probe_multi_plain(swords: torch.Tensor, svalid: torch.Tensor,
                      build: JoinBuild
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``probe_plain`` over word rows: every row, build and stream, gets
    its rank in the lexicographic order of the word rows (signed order of
    word ^ sign bit = unsigned order of the word), then the stream ranks
    are searched in the build's valid prefix."""
    nvalid = int(build.key_valid.sum())
    rows = torch.cat([build.keys[:nvalid], swords]) ^ _SIGN64
    _, rank = torch.unique(rows, dim=0, return_inverse=True)
    brank, srank = rank[:nvalid].contiguous(), rank[nvalid:].contiguous()
    lo = torch.searchsorted(brank, srank, side="left")
    hi = torch.searchsorted(brank, srank, side="right")
    counts = torch.where(svalid, hi - lo, 0)
    offsets = torch.zeros(swords.shape[0] + 1, dtype=torch.int64,
                          device=swords.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    lo = torch.where(svalid, lo, 0)
    return lo.to(torch.int32), offsets.to(torch.int32), int(offsets[-1])

# ---------------------------------------------------------------------------
# kernels


def _build_keys_cuda(col: DeviceColumn, perm: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("join_build", col.data, col.validity, perm)
    n = perm.shape[0]
    keys = torch.empty(n, dtype=torch.int64, device=perm.device)
    key_valid = torch.empty(n, dtype=torch.bool, device=perm.device)
    _lib.check(_lib.lib().srt_join_build_keys(
        _kind(col.dtype), _lib.ptr(col.data), _lib.ptr(col.validity),
        _lib.ptr(perm), n, _lib.ptr(keys), _lib.ptr(key_valid),
        _lib.stream(perm.device)), "join_build")
    if n:
        _lib.LAUNCHES["join_build"] += 1
    return keys, key_valid


def _probe_cuda(col: DeviceColumn, build: JoinBuild
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    _lib.require_cuda("join_probe", col.data, col.validity, build.keys,
                      build.key_valid)
    lib = _lib.lib()
    n = col.num_rows
    dev = col.device
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_join_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    _lib.check(lib.srt_join_probe(
        _kind(col.dtype), _lib.ptr(col.data), _lib.ptr(col.validity), n,
        _lib.ptr(build.keys), _lib.ptr(build.key_valid), build.num_rows,
        _lib.ptr(lo), _lib.ptr(offsets), _lib.ptr(tile_sums),
        _lib.ptr(total), _lib.stream(dev)), "join_probe")
    if n:
        _lib.LAUNCHES["join_probe"] += 1
    # the one device->host read of a probe: the number of pairs
    return lo, offsets, int(total.item())


def _key_col_arrays(cols: Sequence[DeviceColumn],
                    chunks: Sequence[Optional[int]]) -> tuple:
    """The ctypes arrays of csrc/join.cu's key columns: kinds, chunk
    counts, data, validity and offsets pointers (the arrays are kept alive
    by the returned tuple)."""
    k = len(cols)
    if k > _lib.lib().srt_join_max_keys():
        raise NotImplementedError(f"a join on {k} keys: at most "
                                  f"{_lib.lib().srt_join_max_keys()}")
    kinds = (ctypes.c_int * k)(*(_kind(c.dtype) for c in cols))
    nch = (ctypes.c_int * k)(*(n or 0 for n in chunks))
    data = (ctypes.c_void_p * k)(*(c.data.data_ptr() for c in cols))
    valid = (ctypes.c_void_p * k)(*(c.validity.data_ptr() for c in cols))
    offs = (ctypes.c_void_p * k)(*(c.offsets.data_ptr() if c.is_string
                                   else None for c in cols))
    arrays = (kinds, nch, data, valid, offs)
    return arrays, [ctypes.cast(a, ctypes.c_void_p) for a in arrays]


def _words(chunks: Sequence[Optional[int]]) -> int:
    return sum(1 if n is None else n + 1 for n in chunks)


def _string_longest_cuda(cols: Sequence[DeviceColumn]) -> List[int]:
    """The longest valid length of each string column: one blocking read
    for all of them."""
    dev = cols[0].device
    out = torch.empty(len(cols), dtype=torch.int64, device=dev)
    for j, c in enumerate(cols):
        _lib.check(_lib.lib().srt_string_max_length(
            _lib.ptr(c.offsets), _lib.ptr(c.validity), c.num_rows,
            _lib.ptr(out[j:]), _lib.stream(dev)), "join_multi_build")
    return out.tolist()


def _multi_build_cuda(cols: Sequence[DeviceColumn], perm: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Tuple[Optional[int], ...]]:
    _lib.require_cuda("join_multi_build", perm, *(
        t for c in cols for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
    strings = [c for c in cols if c.is_string]
    longest = iter(_string_longest_cuda(strings) if strings else [])
    chunks = tuple(string_chunks(next(longest)) if c.is_string else None
                   for c in cols)
    n, nw = perm.shape[0], _words(chunks)
    words = torch.empty((n, nw), dtype=torch.int64, device=perm.device)
    valid = torch.empty(n, dtype=torch.bool, device=perm.device)
    _keep, arrays = _key_col_arrays(cols, chunks)
    _lib.check(_lib.lib().srt_join_key_words(
        len(cols), *arrays, _lib.ptr(perm), n, nw, _lib.ptr(words),
        _lib.ptr(valid), _lib.stream(perm.device)), "join_multi_build")
    if n:
        _lib.LAUNCHES["join_multi_build"] += 1
    return words, valid, chunks


def _multi_probe_cuda(cols: Sequence[DeviceColumn], build: JoinBuild
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    _lib.require_cuda("join_multi_probe", build.keys, build.key_valid, *(
        t for c in cols for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
    lib = _lib.lib()
    n, dev = cols[0].num_rows, cols[0].device
    nw = build.keys.shape[1]
    swords = torch.empty((n, nw), dtype=torch.int64, device=dev)
    svalid = torch.empty(n, dtype=torch.bool, device=dev)
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_join_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    _keep, arrays = _key_col_arrays(cols, build.chunks)
    _lib.check(lib.srt_join_multi_probe(
        len(cols), *arrays, n, nw, _lib.ptr(swords), _lib.ptr(svalid),
        _lib.ptr(build.keys), _lib.ptr(build.key_valid), build.num_rows,
        _lib.ptr(lo), _lib.ptr(offsets), _lib.ptr(tile_sums),
        _lib.ptr(total), _lib.stream(dev)), "join_multi_probe")
    if n:
        _lib.LAUNCHES["join_multi_probe"] += 1
    # the one device->host read of a probe: the number of pairs
    return lo, offsets, int(total.item())


def _expand_cuda(lo: torch.Tensor, offsets: torch.Tensor, total: int,
                 perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("join_expand", lo, offsets, perm)
    dev = lo.device
    li = torch.empty(total, dtype=torch.int32, device=dev)
    ri = torch.empty(total, dtype=torch.int32, device=dev)
    if total:
        _lib.check(_lib.lib().srt_join_expand(
            _lib.ptr(lo), _lib.ptr(offsets), _lib.ptr(perm), lo.shape[0],
            _lib.ptr(li), _lib.ptr(ri), _lib.stream(dev)), "join_expand")
        _lib.LAUNCHES["join_expand"] += 1
    return li, ri

# ---------------------------------------------------------------------------
# the join


def _ordinals(keys: Union[int, Sequence[int]]) -> List[int]:
    return [keys] if isinstance(keys, int) else list(keys)


def _single(batch: ColumnarBatch, keys: Sequence[int]) -> bool:
    """The reference's 'single' path: one key, not a string."""
    return len(keys) == 1 and not batch.columns[keys[0]].is_string


def build_side(right: ColumnarBatch,
               right_keys: Union[int, Sequence[int]]) -> JoinBuild:
    """Sort the build rows by their normalized keys, rows with a null key
    last, and write the sorted order keys (one key) or order words
    (several keys, or a string key)."""
    keys = _ordinals(right_keys)
    if not keys:
        raise ValueError("a build side needs at least one key")
    cols = [normalize_key_column(right.columns[k]) for k in keys]
    for c in cols:
        _kind(c.dtype)
    n, dev = right.num_rows, cols[0].device
    if _single(right, keys):
        perm = (sort_indices(ColumnarBatch((cols[0],), n, Schema(
            ("k",), (cols[0].dtype,))), [0], [_NULLS_LAST]) if n
            else torch.empty(0, dtype=torch.int32, device=dev))
        return JoinBuild(right, keys[0], perm, *build_keys(cols[0], perm))
    perm = _multi_build_perm(cols)
    words, valid, chunks = build_words(cols, perm)
    return JoinBuild(right, tuple(keys), perm, words, valid, chunks)


def _multi_build_perm(cols: Sequence[DeviceColumn]) -> torch.Tensor:
    """The build's order: (any key null, the keys), the ported radix sort;
    equal tuples keep their row order."""
    n, dev = cols[0].num_rows, cols[0].device
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    valid = _all_valid(cols)
    null_key = DeviceColumn(~valid, torch.ones_like(valid), T.BOOLEAN)
    work = ColumnarBatch((null_key, *cols), n, Schema(
        tuple(f"k{i}" for i in range(len(cols) + 1)),
        (T.BOOLEAN,) + tuple(c.dtype for c in cols)))
    return sort_indices(work, list(range(len(cols) + 1)),
                        [_NULLS_LAST] * (len(cols) + 1))


def build_words(cols: Sequence[DeviceColumn], perm: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Tuple[Optional[int], ...]]:
    """(int64 [nb, words] order words, bool [nb] all keys valid, chunk
    counts) of the build rows in the order ``perm``; a string key takes as
    many chunks as its longest valid row needs."""
    if cols[0].device.type == "cpu":
        chunks = tuple(string_chunks(_longest_plain(c)) if c.is_string
                       else None for c in cols)
        return (*key_words_plain(cols, chunks, perm), chunks)
    return _multi_build_cuda(cols, perm)


def _longest_plain(col: DeviceColumn) -> int:
    lengths = torch.where(col.validity, col.offsets[1:] - col.offsets[:-1], 0)
    return int(lengths.max()) if col.num_rows else 0


def build_keys(col: DeviceColumn, perm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint64 order keys as int64 bits, validity) of the key column's rows
    in the order ``perm``."""
    if col.device.type == "cpu":
        return build_keys_plain(col, perm)
    return _build_keys_cuda(col, perm)


def join_probe(left: ColumnarBatch, left_keys: Union[int, Sequence[int]],
               build: JoinBuild) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(int32 first match per stream row, int32 offsets [n + 1] of its
    pairs, the number of pairs)."""
    keys = _ordinals(left_keys)
    bkeys = _ordinals(build.key)
    if len(keys) != len(bkeys):
        raise ValueError(f"{len(keys)} stream keys against {len(bkeys)} "
                         "build keys")
    for k, bk in zip(keys, bkeys):
        _check_key_types(left.columns[k].dtype,
                         build.batch.columns[bk].dtype)
    cols = [left.columns[k] for k in keys]
    if not build.multi:
        probe = probe_plain if cols[0].device.type == "cpu" else _probe_cuda
        lo, offsets, total = probe(cols[0], build)
    elif cols[0].device.type == "cpu":
        lo, offsets, total = probe_multi_plain(
            *key_words_plain(cols, build.chunks), build)
    else:
        lo, offsets, total = _multi_probe_cuda(cols, build)
    if total >= 2**31:
        raise ValueError(f"a join batch of {total} pairs: int32 row ids "
                         "need fewer than 2**31")
    return lo, offsets, total


def join_expand(lo: torch.Tensor, offsets: torch.Tensor, total: int,
                build: JoinBuild) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (left, right) int32 row-id maps of the pairs."""
    if lo.device.type == "cpu":
        return expand_plain(lo, offsets, total, build.perm)
    return _expand_cuda(lo, offsets, total, build.perm)


def join_gather_maps(left: ColumnarBatch, left_keys: Sequence[int],
                     right: ColumnarBatch, right_keys: Sequence[int],
                     join_type: str) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One-shot (li, ri, pairs) of a join: build, probe and expand."""
    if join_type not in JOIN_TYPES:
        raise ValueError(f"unknown join type {join_type!r}")
    if len(left_keys) != len(right_keys):
        raise ValueError("a join needs as many left keys as right keys")
    _require_ported(join_path(left, left_keys, right, right_keys, join_type),
                    join_type)
    build = build_side(right, right_keys)
    lo, offsets, total = join_probe(left, left_keys, build)
    li, ri = join_expand(lo, offsets, total, build)
    return li, ri, total


def apply_gather_maps(left: ColumnarBatch, right: ColumnarBatch,
                      li: torch.Tensor, ri: torch.Tensor, schema: Schema,
                      join_type: str = "inner") -> ColumnarBatch:
    """The joined batch: the left columns gathered by ``li``, then the
    right columns by ``ri`` (the ported gather, strings included)."""
    if join_type != "inner":
        raise NotImplementedError(f"the {join_type} join is not ported; "
                                  "only inner")
    cols = (gather_columns(left.columns, li)
            + gather_columns(right.columns, ri))
    return ColumnarBatch(tuple(cols), li.shape[0], schema)
