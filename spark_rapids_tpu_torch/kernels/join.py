"""Equi-join kernels: the single fixed-width-key inner join.

Counterpart of ``spark_rapids_tpu/kernels/join.py`` (``join_path`` :134,
``_probe_single`` :154, ``_expand_single`` :226, ``join_probe`` :457,
``join_expand`` :484, ``join_gather_maps`` :496, ``apply_gather_maps``
:521) for an inner join on one fixed-width key.  Spark's semantics hold:
a null key never matches, NaN matches NaN and -0.0 matches 0.0 (keys are
normalized), and the pairs come out in stream-row order, each row's
matches in build-row order, as the reference's do.

The build side is sorted once per query (``build_side``: the normalized
key ordered by the ported radix ``sort_indices``, nulls last); each
stream batch is then probed (``join_probe``: a lower and an upper bound
per row over the sorted keys, the exclusive scan of the match counts, and
one blocking read of the number of pairs) and expanded (``join_expand``:
each row writes its ``(li, ri = perm[lo + j])`` pairs).  The maps have
exactly as many pairs as the join outputs, so there is no capacity retry;
``apply_gather_maps`` is the ported gather on each side.

On CUDA tensors each step launches its kernel of ``csrc/join.cu`` and
counts the launch; on CPU tensors it runs the plain PyTorch version
beside it.  The other join types (left, semi, anti, outer, existence),
the multi-key and string-key join (``_probe_multi`` :275), the cross join
and ``conditional_join_maps`` (:44) raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.groupby import normalize_key_column
from spark_rapids_tpu_torch.kernels.selection import gather_columns
from spark_rapids_tpu_torch.kernels.sort import SortOrder, sort_indices

JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "cross", "existence")

# key kinds of csrc/join.cu
_INT32, _INT64, _F64, _BOOL = 0, 1, 2, 3
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
    'multi'); only the inner 'single' path is ported."""
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
    if path == "multi":
        raise NotImplementedError(
            "the multi-key and string-key join (_probe_multi) is not ported")


def conditional_join_maps(*args, **kwargs):
    """The residual-condition join of the reference (join.py:44)."""
    raise NotImplementedError("conditional_join_maps (a join with a residual "
                              "condition) is not ported")


@dataclasses.dataclass
class JoinBuild:
    """The build side of a join, sorted once: ``perm`` orders its rows by
    key (nulls last); ``keys[i]`` and ``key_valid[i]`` are the order key
    and validity of row ``perm[i]``."""

    batch: ColumnarBatch
    key: int
    perm: torch.Tensor         # int32 [nb]
    keys: torch.Tensor         # int64 [nb]: the kernel's uint64 order keys
    key_valid: torch.Tensor    # bool [nb]

    @property
    def num_rows(self) -> int:
        return self.batch.num_rows

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


def build_side(right: ColumnarBatch, right_key: int) -> JoinBuild:
    """Sort the build rows by their normalized key, nulls last, and write
    the sorted order keys."""
    col = normalize_key_column(right.columns[right_key])
    _kind(col.dtype)
    one = ColumnarBatch((col,), right.num_rows, Schema(("k",), (col.dtype,)))
    perm = (sort_indices(one, [0], [_NULLS_LAST]) if right.num_rows
            else torch.empty(0, dtype=torch.int32, device=col.device))
    return JoinBuild(right, right_key, perm, *build_keys(col, perm))


def build_keys(col: DeviceColumn, perm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint64 order keys as int64 bits, validity) of the key column's rows
    in the order ``perm``."""
    if col.device.type == "cpu":
        return build_keys_plain(col, perm)
    return _build_keys_cuda(col, perm)


def join_probe(left: ColumnarBatch, left_key: int, build: JoinBuild
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(int32 first match per stream row, int32 offsets [n + 1] of its
    pairs, the number of pairs)."""
    col = left.columns[left_key]
    _check_key_types(col.dtype, build.batch.columns[build.key].dtype)
    if col.device.type == "cpu":
        lo, offsets, total = probe_plain(col, build)
    else:
        lo, offsets, total = _probe_cuda(col, build)
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
    _require_ported(join_path(left, left_keys, right, right_keys, join_type),
                    join_type)
    build = build_side(right, right_keys[0])
    lo, offsets, total = join_probe(left, left_keys[0], build)
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
