"""Reductions: SUM, MIN / MAX, M2, the picks (FIRST / LAST, MAX_BY /
MIN_BY, string MIN / MAX) and the bitwise ones, whole-batch and
segmented.

``masked_sum`` is the counterpart of the reduction inside
``spark_rapids_tpu/plan/execs/aggregate.py:274`` (``_global_update``, ops
SUM and COUNT_VALID), which the reference leaves to XLA.
``segmented_sum`` is the counterpart of ``spark_rapids_tpu/kernels/
groupby.py`` ``seg_sum`` :166, ``seg_count_valid`` :151 and
``seg_count_star`` :159 over the contiguous groups of a sorted batch.
``segmented_extreme`` ports ``seg_min`` :228 and ``seg_max`` :256 (with
``_extreme`` :219), ``masked_extreme`` the MIN / MAX branch of
``_global_update`` (aggregate.py:292-316); ``segmented_m2`` ports
``seg_m2_update`` :179 and ``seg_m2_merge`` :200, ``masked_m2`` the M2
branch of ``_global_update`` (:286-291) and ``_global_m2_merge`` (:318).
``segmented_pick`` ports ``seg_pick`` :406 (with ``_seg_arg`` :390),
``seg_pick_by`` :419 and ``seg_extreme_string`` :341 (with
``string_order_rank`` :313), ``masked_pick`` ``global_pick`` :478,
``global_pick_by`` :496 and ``global_extreme_string`` :363: each gives
the row a segment (or the batch) picks, which the caller gathers.
``segmented_bitwise`` ports ``seg_bitwise`` :448, ``masked_bitwise``
``global_bitwise`` :528.  ``segmented_sum128`` / ``masked_sum128`` port
the Decimal128 sums (``spark_rapids_tpu/kernels/decimal.py``
``segment_sum128`` :293 and ``sum128`` :304 with ``_carry_join``, under
``plan/execs/aggregate.py`` ``_seg_sum128`` :108 and ``_global_sum128``
:160), ``segmented_extreme128`` / ``masked_extreme128`` the MIN128 /
MAX128 extremes (``segment_extreme128`` :315, ``_seg_extreme128`` :136,
``_global_extreme128`` :147).
On CUDA tensors each launches its two-pass kernel of
``csrc/reduction.cu`` and counts the launch under its own name; on CPU
tensors it runs the plain PyTorch version beside it, and on any other
device it raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels import decimal as DK
from spark_rapids_tpu_torch.kernels.sort import SortOrder, string_keys_plain

_SUM_DTYPES = (torch.float64, torch.int64)


def masked_sum_plain(data: torch.Tensor, validity: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    nvalid = validity.sum(dtype=torch.int64).reshape(1)
    total = torch.where(validity, data,
                        torch.zeros((), dtype=data.dtype,
                                    device=data.device)).sum(dtype=data.dtype)
    ok = nvalid > 0
    value = torch.where(ok, total.reshape(1),
                        torch.zeros((), dtype=data.dtype, device=data.device))
    return value, ok, nvalid


def _masked_sum_cuda(data: torch.Tensor, validity: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _lib.require_cuda("masked_sum", data, validity)
    lib = _lib.lib()
    n = data.shape[0]
    dev = data.device
    ntiles = max(-(-n // lib.srt_reduction_tile()), 1)
    scratch = torch.empty(2 * ntiles, dtype=torch.int64, device=dev)
    value = torch.empty(1, dtype=data.dtype, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    nvalid = torch.empty(1, dtype=torch.int64, device=dev)
    _lib.check(lib.srt_masked_sum(int(data.dtype == torch.float64),
                                  _lib.ptr(data), _lib.ptr(validity), n,
                                  _lib.ptr(scratch),
                                  _lib.ptr(scratch[ntiles:]),
                                  _lib.ptr(value), _lib.ptr(ok),
                                  _lib.ptr(nvalid), _lib.stream(dev)),
               "masked_sum")
    _lib.LAUNCHES["masked_sum"] += 1
    return value, ok, nvalid


def masked_sum(data: torch.Tensor, validity: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum of ``data`` over rows where ``validity`` holds.

    Returns three one-element tensors on the input's device: the sum (0
    when no row is valid), the flag ``nvalid > 0`` and ``nvalid`` (int64).
    Sums of int64 wrap on overflow, as Spark's and the reference's do."""
    if data.dtype not in _SUM_DTYPES:
        raise TypeError(f"masked_sum takes float64 or int64, got {data.dtype}")
    if validity.dtype != torch.bool or validity.shape != data.shape \
            or data.dim() != 1:
        raise ValueError("masked_sum needs 1-d data and bool validity "
                         "of the same length")
    if data.device.type == "cpu":
        return masked_sum_plain(data, validity)
    return _masked_sum_cuda(data, validity)

# ---------------------------------------------------------------------------
# segmented sum


def segment_rows(starts: torch.Tensor, n: int) -> torch.Tensor:
    """int64 row count of each segment, from the segments' first rows."""
    bounds = torch.cat([starts.to(torch.int64),
                        torch.full((1,), n, dtype=torch.int64,
                                   device=starts.device)])
    return bounds[1:] - bounds[:-1]


def segmented_sum_plain(data: torch.Tensor, validity: torch.Tensor,
                        starts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    g = starts.shape[0]
    rows = segment_rows(starts, data.shape[0])
    seg = torch.repeat_interleave(
        torch.arange(g, dtype=torch.int64, device=data.device), rows)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    total = torch.zeros(g, dtype=data.dtype, device=data.device).index_add_(
        0, seg, torch.where(validity, data, zero))
    nvalid = torch.zeros(g, dtype=torch.int64, device=data.device).index_add_(
        0, seg, validity.to(torch.int64))
    return total, nvalid > 0, nvalid, rows


def _segmented_sum_cuda(data: torch.Tensor, validity: torch.Tensor,
                        starts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    _lib.require_cuda("segmented_sum", data, validity, starts)
    lib = _lib.lib()
    n = data.shape[0]
    g = starts.shape[0]
    dev = data.device
    ntiles = max(-(-n // lib.srt_segment_tile()), 1)
    scratch = torch.empty(4 * ntiles, dtype=torch.int64, device=dev)
    total = torch.empty(g, dtype=data.dtype, device=dev)
    ok = torch.empty(g, dtype=torch.bool, device=dev)
    nvalid = torch.empty(g, dtype=torch.int64, device=dev)
    rows = torch.empty(g, dtype=torch.int64, device=dev)
    _lib.check(lib.srt_segmented_sum(
        int(data.dtype == torch.float64), _lib.ptr(data), _lib.ptr(validity),
        n, _lib.ptr(starts), g, _lib.ptr(scratch),
        _lib.ptr(scratch[2 * ntiles:]), _lib.ptr(total), _lib.ptr(ok),
        _lib.ptr(nvalid), _lib.ptr(rows), _lib.stream(dev)), "segmented_sum")
    if n and g:
        _lib.LAUNCHES["segmented_sum"] += 1
    return total, ok, nvalid, rows


def segmented_sum(data: torch.Tensor, validity: torch.Tensor,
                  starts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Per segment of contiguous rows: (sum of the valid rows, nvalid > 0,
    nvalid, row count).  ``starts`` holds each segment's first row (int32,
    increasing, ``starts[0] == 0`` when there are rows).  A segment with no
    valid row sums to 0; int64 sums wrap."""
    if data.dtype not in _SUM_DTYPES:
        raise TypeError(f"segmented_sum takes float64 or int64, got "
                        f"{data.dtype}")
    if validity.dtype != torch.bool or validity.shape != data.shape \
            or data.dim() != 1:
        raise ValueError("segmented_sum needs 1-d data and bool validity "
                         "of the same length")
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise TypeError("segment starts must be 1-d int32")
    if data.device.type == "cpu":
        return segmented_sum_plain(data, validity, starts)
    return _segmented_sum_cuda(data, validity, starts)

# ---------------------------------------------------------------------------
# MIN / MAX

#: the kernels' type codes (csrc/reduction.cu kBool ... kF64)
_DTYPE_CODE = {torch.bool: 0, torch.int32: 1, torch.int64: 2,
               torch.float32: 3, torch.float64: 4}
#: the extremes' types: BYTE and SHORT reduce at their own width
_EXTREME_CODE = {**_DTYPE_CODE, torch.int8: 5, torch.int16: 6}
_FLOAT_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF),
               torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF)}


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of non-NaN floats, -0.0 below 0.0: the
    bits, with all but the sign flipped where the sign is set."""
    itype, mask = _FLOAT_BITS[x.dtype]
    b = x.view(itype)
    return torch.where(b < 0, b ^ mask, b).to(torch.int64)


def _from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    itype, mask = _FLOAT_BITS[dtype]
    b = k.to(itype)
    return torch.where(b < 0, b ^ mask, b).view(dtype)


def _segment_ids(starts: torch.Tensor, n: int) -> torch.Tensor:
    g = starts.shape[0]
    return torch.repeat_interleave(
        torch.arange(g, dtype=torch.int64, device=starts.device),
        segment_rows(starts, n))


def _extreme_plain(data: torch.Tensor, validity: torch.Tensor,
                   seg: torch.Tensor, g: int, is_min: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = data.device
    reduce = "amin" if is_min else "amax"
    nvalid = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
        0, seg, validity.to(torch.int64))
    floating = data.is_floating_point()
    if floating:
        nan = torch.isnan(data)
        take = validity & ~nan
        keys = _order_key(data)
    else:
        take = validity
        keys = data.to(torch.int64)
    info = torch.iinfo(torch.int64)
    ident = info.max if is_min else info.min
    red = torch.full((g,), ident, dtype=torch.int64, device=dev)
    red.scatter_reduce_(0, seg, torch.where(take, keys, ident), reduce)
    if floating:
        out = _from_order_key(red, data.dtype)
        qnan = torch.full((), float("nan"), dtype=data.dtype, device=dev)
        flag = validity & (~nan if is_min else nan)
        hit = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
            0, seg, flag.to(torch.int64)) > 0
        out = torch.where(~hit if is_min else hit, qnan, out)
    else:
        out = red.to(data.dtype)
    ok = nvalid > 0
    return (torch.where(ok, out, torch.zeros((), dtype=data.dtype,
                                             device=dev)), ok, nvalid)


def segmented_extreme_plain(data: torch.Tensor, validity: torch.Tensor,
                            starts: torch.Tensor, is_min: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    g = starts.shape[0]
    out, ok, _ = _extreme_plain(data, validity,
                                _segment_ids(starts, data.shape[0]), g,
                                is_min)
    return out, ok


def masked_extreme_plain(data: torch.Tensor, validity: torch.Tensor,
                         is_min: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    seg = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    return _extreme_plain(data, validity, seg, 1, is_min)


def _check_extreme(name: str, data: torch.Tensor, validity: torch.Tensor
                   ) -> None:
    if data.dtype not in _EXTREME_CODE:
        raise TypeError(f"{name} takes bool, int8, int16, int32, int64, "
                        f"float32 or float64, got {data.dtype}")
    if validity.dtype != torch.bool or validity.shape != data.shape \
            or data.dim() != 1:
        raise ValueError(f"{name} needs 1-d data and bool validity of the "
                         "same length")


def _check_starts(starts: torch.Tensor) -> None:
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise TypeError("segment starts must be 1-d int32")


def _scratch(n: int, tile: int, slots: int, dev) -> torch.Tensor:
    """``slots`` state slots per tile of ``tile`` rows (at least one tile),
    as int64 words."""
    ntiles = max(-(-n // tile), 1)
    words = _lib.lib().srt_reduce_state_bytes() // 8
    return torch.empty(slots * ntiles * words, dtype=torch.int64, device=dev)


def _segmented_extreme_cuda(data, validity, starts, is_min):
    _lib.require_cuda("segmented_extreme", data, validity, starts)
    lib = _lib.lib()
    n, g, dev = data.shape[0], starts.shape[0], data.device
    out = torch.empty(g, dtype=data.dtype, device=dev)
    ok = torch.empty(g, dtype=torch.bool, device=dev)
    scratch = _scratch(n, lib.srt_segment_tile(), 2, dev)
    _lib.check(lib.srt_segmented_extreme(
        _EXTREME_CODE[data.dtype], int(is_min), _lib.ptr(data),
        _lib.ptr(validity), n, _lib.ptr(starts), g, _lib.ptr(scratch),
        _lib.ptr(out), _lib.ptr(ok), _lib.stream(dev)), "segmented_extreme")
    if n and g:
        _lib.LAUNCHES["segmented_extreme"] += 1
    return out, ok


def segmented_extreme(data: torch.Tensor, validity: torch.Tensor,
                      starts: torch.Tensor, is_min: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MIN (``is_min``) or MAX of the valid rows of each segment of
    contiguous rows, in Spark's order (NaN above everything: MIN skips it
    unless the segment holds nothing else, MAX is NaN with any; -0.0 below
    0.0): (values at the data's type, nvalid > 0).  A segment with no
    valid row gives 0 and False."""
    _check_extreme("segmented_extreme", data, validity)
    _check_starts(starts)
    if data.device.type == "cpu":
        return segmented_extreme_plain(data, validity, starts, is_min)
    return _segmented_extreme_cuda(data, validity, starts, is_min)


def _masked_extreme_cuda(data, validity, is_min):
    _lib.require_cuda("masked_extreme", data, validity)
    lib = _lib.lib()
    n, dev = data.shape[0], data.device
    out = torch.empty(1, dtype=data.dtype, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    nvalid = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = _scratch(n, lib.srt_reduction_tile(), 1, dev)
    _lib.check(lib.srt_masked_extreme(
        _EXTREME_CODE[data.dtype], int(is_min), _lib.ptr(data),
        _lib.ptr(validity), n, _lib.ptr(scratch), _lib.ptr(out),
        _lib.ptr(ok), _lib.ptr(nvalid), _lib.stream(dev)), "masked_extreme")
    _lib.LAUNCHES["masked_extreme"] += 1
    return out, ok, nvalid


def masked_extreme(data: torch.Tensor, validity: torch.Tensor, is_min: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``segmented_extreme`` over the whole batch as one group: three
    one-element tensors, the value, nvalid > 0 and nvalid (int64)."""
    _check_extreme("masked_extreme", data, validity)
    if data.device.type == "cpu":
        return masked_extreme_plain(data, validity, is_min)
    return _masked_extreme_cuda(data, validity, is_min)

# ---------------------------------------------------------------------------
# M2


def _m2_terms(mode: str, x: torch.Tensor, validity: torch.Tensor,
              mean: torch.Tensor, part_sum: Optional[torch.Tensor],
              part_count: Optional[torch.Tensor]) -> torch.Tensor:
    """Each row's term, 0 where it is null: (x - mean)^2 (update), or
    M2_i + n_i (s_i / max(n_i, 1) - mean)^2 (merge)."""
    one = torch.ones((), dtype=torch.float64, device=x.device)
    if mode == "update":
        d = x.to(torch.float64) - mean
        term = d * d
    else:
        ni = part_count.to(torch.float64)
        d = part_sum / torch.maximum(ni, one) - mean
        term = x + ni * d * d
    return torch.where(validity, term, torch.zeros_like(term))


def _group_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=torch.float64, device=total.device)
    return total / torch.maximum(count.to(torch.float64), one)


_RUN = 256   # the plain M2's first-level runs


def _two_level_sum(terms: torch.Tensor, seg: torch.Tensor,
                   starts: torch.Tensor, g: int) -> torch.Tensor:
    """Per segment, the sum of runs of at most _RUN rows, then of the
    runs: one index_add_ over a segment of 350,000 like terms (the
    large-mean case) adds them one by one and drifts ~4e-12 relative,
    so no sum here chains more than _RUN + rows / _RUN additions."""
    n, dev = terms.shape[0], terms.device
    head = torch.zeros(n, dtype=torch.bool, device=dev)
    head[::_RUN] = True
    head[starts.long()] = True
    run = torch.cumsum(head, 0) - 1
    nruns = int(run[-1]) + 1 if n else 0
    sums = torch.zeros(nruns, dtype=torch.float64, device=dev).index_add_(
        0, run, terms)
    return torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
        0, seg[head], sums)


def segmented_m2_plain(mode: str, x: torch.Tensor, validity: torch.Tensor,
                       starts: torch.Tensor, total: torch.Tensor,
                       count: torch.Tensor,
                       part_sum: Optional[torch.Tensor] = None,
                       part_count: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    g = starts.shape[0]
    seg = _segment_ids(starts, x.shape[0])
    mean = _group_mean(total, count)[seg]
    terms = _m2_terms(mode, x, validity, mean, part_sum, part_count)
    return _two_level_sum(terms, seg, starts, g)


def masked_m2_plain(mode: str, x: torch.Tensor, validity: torch.Tensor,
                    total: torch.Tensor, count: torch.Tensor,
                    part_sum: Optional[torch.Tensor] = None,
                    part_count: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    terms = _m2_terms(mode, x, validity, _group_mean(total, count),
                      part_sum, part_count)
    return terms.sum().reshape(1)


def _check_m2(name: str, mode: str, x, validity, total, count, part_sum,
              part_count, groups: int) -> list:
    """The M2 inputs checked; the tensors the kernel reads, in order."""
    if mode not in ("update", "merge"):
        raise ValueError(f"{name}: mode is 'update' or 'merge', not {mode!r}")
    n = x.shape[0]
    if x.dim() != 1 or validity.dtype != torch.bool or \
            validity.shape != x.shape:
        raise ValueError(f"{name} needs 1-d x and bool validity of the same "
                         "length")
    if total.dtype != torch.float64 or count.dtype != torch.int64 or \
            total.shape != (groups,) or count.shape != (groups,):
        raise TypeError(f"{name}: the groups' sums are float64 [{groups}] "
                        f"and their counts int64 [{groups}]")
    if mode == "update":
        if x.dtype not in (torch.int32, torch.int64, torch.float32,
                           torch.float64):
            raise TypeError(f"{name} updates over int32, int64, float32 or "
                            f"float64, got {x.dtype}")
        return [x, validity, total, count]
    if x.dtype != torch.float64 or part_sum is None or part_count is None \
            or part_sum.dtype != torch.float64 \
            or part_count.dtype != torch.int64 \
            or part_sum.shape != (n,) or part_count.shape != (n,):
        raise TypeError(f"{name} merges float64 M2 partials with their "
                        "float64 sums and int64 counts")
    return [x, validity, part_sum, part_count, total, count]


def _m2_pointers(mode: str, x, validity, part_sum, part_count):
    merge = mode == "merge"
    return (_DTYPE_CODE[x.dtype], int(merge), _lib.ptr(x),
            _lib.ptr(validity),
            _lib.ptr(part_sum) if merge else None,
            _lib.ptr(part_count) if merge else None)


def _widened(mode: str, x: torch.Tensor) -> torch.Tensor:
    """A BYTE or SHORT update input widened to int32 elementwise (the
    variances over them; the M2 kernel takes int32 and wider)."""
    if mode == "update" and x.dtype in (torch.int8, torch.int16):
        return x.to(torch.int32)
    return x


def segmented_m2(mode: str, x: torch.Tensor, validity: torch.Tensor,
                 starts: torch.Tensor, total: torch.Tensor,
                 count: torch.Tensor,
                 part_sum: Optional[torch.Tensor] = None,
                 part_count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float64 M2 of each segment of contiguous rows, given each segment's
    sum ``total`` and valid count ``count`` (from ``segmented_sum``).
    ``mode`` "update": sum over valid rows of (x - mean)^2, mean = total /
    max(count, 1); "merge": x holds partial M2s, ``part_sum`` and
    ``part_count`` their s_i and n_i, and the result is Chan's sum of
    M2_i + n_i (s_i / max(n_i, 1) - mean)^2 over valid rows."""
    _check_starts(starts)
    g = starts.shape[0]
    x = _widened(mode, x)
    ts = _check_m2("segmented_m2", mode, x, validity, total, count,
                   part_sum, part_count, g)
    if x.device.type == "cpu":
        return segmented_m2_plain(mode, x, validity, starts, total, count,
                                  part_sum, part_count)
    _lib.require_cuda("segmented_m2", starts, *ts)
    lib = _lib.lib()
    n, dev = x.shape[0], x.device
    out = torch.empty(g, dtype=torch.float64, device=dev)
    scratch = _scratch(n, lib.srt_segment_tile(), 2, dev)
    _lib.check(lib.srt_segmented_m2(
        *_m2_pointers(mode, x, validity, part_sum, part_count), n,
        _lib.ptr(starts), g, _lib.ptr(total), _lib.ptr(count),
        _lib.ptr(scratch), _lib.ptr(out), _lib.stream(dev)), "segmented_m2")
    if n and g:
        _lib.LAUNCHES["segmented_m2"] += 1
    return out


def masked_m2(mode: str, x: torch.Tensor, validity: torch.Tensor,
              total: torch.Tensor, count: torch.Tensor,
              part_sum: Optional[torch.Tensor] = None,
              part_count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``segmented_m2`` over the whole batch as one group: ``total`` and
    ``count`` are one-element (from ``masked_sum``); a [1] float64."""
    x = _widened(mode, x)
    ts = _check_m2("masked_m2", mode, x, validity, total, count, part_sum,
                   part_count, 1)
    if x.device.type == "cpu":
        return masked_m2_plain(mode, x, validity, total, count, part_sum,
                               part_count)
    _lib.require_cuda("masked_m2", *ts)
    lib = _lib.lib()
    n, dev = x.shape[0], x.device
    out = torch.empty(1, dtype=torch.float64, device=dev)
    scratch = _scratch(n, lib.srt_reduction_tile(), 1, dev)
    _lib.check(lib.srt_masked_m2(
        *_m2_pointers(mode, x, validity, part_sum, part_count), n,
        _lib.ptr(total), _lib.ptr(count), _lib.ptr(scratch), _lib.ptr(out),
        _lib.stream(dev)), "masked_m2")
    _lib.LAUNCHES["masked_m2"] += 1
    return out

# ---------------------------------------------------------------------------
# picks: FIRST / LAST, MAX_BY / MIN_BY, string MIN / MAX

#: the pick kinds, and the kernels' key type codes (csrc/reduction.cu
#: kPickFirst ..., kBool ... kString)
_PICK_KIND = {"first": 0, "last": 1, "min": 2, "max": 3}
_KEY_CODE = _EXTREME_CODE
_STRING_CODE = 7
_IGNORE_NULLS, _NAN_GREATEST = 1, 2
_I64 = torch.iinfo(torch.int64)


def _string_rank_plain(offsets: torch.Tensor, data: torch.Tensor,
                       validity: torch.Tensor) -> torch.Tensor:
    """int64 dense rank of each row's string in unsigned byte order (a
    prefix first; equal strings share a rank), as the reference's
    ``string_order_rank`` gives it: the ported sort keys (8-byte chunks,
    then the length), sorted stably least significant first."""
    n = validity.shape[0]
    keys = string_keys_plain(DeviceColumn(data, validity, T.STRING, offsets),
                             SortOrder(True))
    dev = validity.device
    order = torch.arange(n, dtype=torch.int64, device=dev)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    same = torch.ones(max(n - 1, 0), dtype=torch.bool, device=dev)
    for k in keys:
        sk = k[order]
        same &= sk[1:] == sk[:-1]
    boundary = torch.cat([torch.ones(min(n, 1), dtype=torch.bool,
                                     device=dev), ~same])
    rank = torch.cumsum(boundary.to(torch.int64), 0) - 1
    return torch.empty_like(rank).scatter_(0, order, rank)


def _pick_key_plain(key: torch.Tensor, key_offsets: Optional[torch.Tensor],
                    validity: torch.Tensor, nan_greatest: bool
                    ) -> torch.Tensor:
    """The int64 order word of each row's key (the kernel's
    ``order_word``, a string's rank)."""
    if key_offsets is not None:
        return _string_rank_plain(key_offsets, key, validity)
    if not key.is_floating_point():
        return key.to(torch.int64)
    zero = torch.zeros((), dtype=key.dtype, device=key.device)
    inf = torch.full((), float("inf"), dtype=key.dtype, device=key.device)
    nan = torch.isnan(key)
    x = torch.where(key == 0, zero, key)          # -0.0 is 0.0
    x = torch.where(nan, inf, x)
    k = _order_key(x)
    if nan_greatest:
        k = torch.where(nan, _I64.max, k)
    return k


def _pick_plain(pick: str, validity: torch.Tensor, seg: torch.Tensor,
                g: int, key: Optional[torch.Tensor],
                key_offsets: Optional[torch.Tensor], ignore_nulls: bool,
                nan_greatest: bool) -> torch.Tensor:
    dev = validity.device
    n = validity.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    if pick in ("first", "last"):
        eligible = validity if ignore_nulls else torch.ones_like(validity)
    else:
        k = _pick_key_plain(key, key_offsets, validity, nan_greatest)
        is_min = pick == "min"
        ident = _I64.max if is_min else _I64.min
        best = torch.full((g,), ident, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, seg, torch.where(validity, k, ident),
                             "amin" if is_min else "amax")
        eligible = validity & (k == best[seg])
    last = pick == "last"
    none = -1 if last else n
    row = torch.full((g,), none, dtype=torch.int64, device=dev)
    row.scatter_reduce_(0, seg, torch.where(eligible, pos, none),
                        "amax" if last else "amin")
    return torch.where(row == n, -1, row).to(torch.int32)


def segmented_pick_plain(pick: str, validity: torch.Tensor,
                         starts: torch.Tensor,
                         key: Optional[torch.Tensor] = None,
                         key_offsets: Optional[torch.Tensor] = None,
                         ignore_nulls: bool = False,
                         nan_greatest: bool = True) -> torch.Tensor:
    return _pick_plain(pick, validity,
                       _segment_ids(starts, validity.shape[0]),
                       starts.shape[0], key, key_offsets, ignore_nulls,
                       nan_greatest)


def masked_pick_plain(pick: str, validity: torch.Tensor,
                      key: Optional[torch.Tensor] = None,
                      key_offsets: Optional[torch.Tensor] = None,
                      ignore_nulls: bool = False,
                      nan_greatest: bool = False) -> torch.Tensor:
    seg = torch.zeros(validity.shape[0], dtype=torch.int64,
                      device=validity.device)
    return _pick_plain(pick, validity, seg, 1, key, key_offsets,
                       ignore_nulls, nan_greatest)


def _check_pick(name: str, pick: str, validity: torch.Tensor,
                key: Optional[torch.Tensor],
                key_offsets: Optional[torch.Tensor]) -> list:
    """The pick's inputs checked; the tensors the kernel reads."""
    if pick not in _PICK_KIND:
        raise ValueError(f"{name}: pick is first, last, min or max, not "
                         f"{pick!r}")
    if validity.dtype != torch.bool or validity.dim() != 1:
        raise ValueError(f"{name} needs 1-d bool validity")
    if pick in ("first", "last"):
        if key is not None or key_offsets is not None:
            raise ValueError(f"{name}: {pick} takes no key")
        return [validity]
    if key is None:
        raise ValueError(f"{name}: {pick} needs a key")
    if key_offsets is not None:
        if key.dtype != torch.uint8 or key.dim() != 1 or \
                key_offsets.dtype != torch.int32 or \
                key_offsets.shape != (validity.shape[0] + 1,):
            raise TypeError(f"{name}: a string key is uint8 bytes with int32 "
                            f"offsets [{validity.shape[0] + 1}]")
        return [validity, key, key_offsets]
    if key.dtype not in _KEY_CODE or key.shape != validity.shape:
        raise TypeError(f"{name} takes a key of bool, int8, int16, int32, "
                        f"int64, float32 or float64 of the validity's "
                        f"length, got {key.dtype} {tuple(key.shape)}")
    return [validity, key]


def _pick_args(pick: str, key, key_offsets, ignore_nulls: bool,
               nan_greatest: bool) -> tuple:
    """The entry points' kind, key type code, flags and key pointers."""
    if key is None:
        code = 0
    else:
        code = _STRING_CODE if key_offsets is not None else _KEY_CODE[
            key.dtype]
    flags = (_IGNORE_NULLS if ignore_nulls else 0) | (
        _NAN_GREATEST if nan_greatest else 0)
    return (_PICK_KIND[pick], code, flags,
            _lib.ptr(key) if key is not None else None,
            _lib.ptr(key_offsets) if key_offsets is not None else None)


def segmented_pick(pick: str, validity: torch.Tensor, starts: torch.Tensor,
                   key: Optional[torch.Tensor] = None,
                   key_offsets: Optional[torch.Tensor] = None,
                   ignore_nulls: bool = False,
                   nan_greatest: bool = True) -> torch.Tensor:
    """The row each segment of contiguous rows picks: int32 [g], -1 where
    no row qualifies.  ``pick`` "first" / "last": the segment's first /
    last row, or with ``ignore_nulls`` its first / last row where
    ``validity`` holds.  "min" / "max": the first row (lowest index)
    holding the smallest / largest valid ``key``: fixed-width (bool,
    int8 ... int64, float32, float64; -0.0 equals 0.0; NaN greatest with
    ``nan_greatest``, else equal to +inf) or a STRING's bytes with
    ``key_offsets`` (unsigned byte order, a prefix first); ``validity``
    is the key's, and a null key never wins."""
    ts = _check_pick("segmented_pick", pick, validity, key, key_offsets)
    _check_starts(starts)
    if validity.device.type == "cpu":
        return segmented_pick_plain(pick, validity, starts, key, key_offsets,
                                    ignore_nulls, nan_greatest)
    _lib.require_cuda("segmented_pick", starts, *ts)
    lib = _lib.lib()
    n, g, dev = validity.shape[0], starts.shape[0], validity.device
    out = torch.empty(g, dtype=torch.int32, device=dev)
    scratch = _scratch(n, lib.srt_segment_tile(), 2, dev)
    _lib.check(lib.srt_segmented_pick(
        *_pick_args(pick, key, key_offsets, ignore_nulls, nan_greatest),
        _lib.ptr(validity), n,
        _lib.ptr(starts), g, _lib.ptr(scratch), _lib.ptr(out),
        _lib.stream(dev)), "segmented_pick")
    if n and g:
        _lib.LAUNCHES["segmented_pick"] += 1
    return out


def masked_pick(pick: str, validity: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                key_offsets: Optional[torch.Tensor] = None,
                ignore_nulls: bool = False,
                nan_greatest: bool = False) -> torch.Tensor:
    """``segmented_pick`` over the whole batch as one segment: int32 [1]
    (NaN equal to +inf by default, as ``global_pick_by`` orders it)."""
    ts = _check_pick("masked_pick", pick, validity, key, key_offsets)
    if validity.device.type == "cpu":
        return masked_pick_plain(pick, validity, key, key_offsets,
                                 ignore_nulls, nan_greatest)
    _lib.require_cuda("masked_pick", *ts)
    lib = _lib.lib()
    n, dev = validity.shape[0], validity.device
    out = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = _scratch(n, lib.srt_reduction_tile(), 1, dev)
    _lib.check(lib.srt_masked_pick(
        *_pick_args(pick, key, key_offsets, ignore_nulls, nan_greatest),
        _lib.ptr(validity), n,
        _lib.ptr(scratch), _lib.ptr(out), _lib.stream(dev)), "masked_pick")
    _lib.LAUNCHES["masked_pick"] += 1
    return out

# ---------------------------------------------------------------------------
# BIT_AND / BIT_OR / BIT_XOR

_BIT_OP = {"bit_and": 0, "bit_or": 1, "bit_xor": 2}
_BIT_IDENT = {"bit_and": -1, "bit_or": 0, "bit_xor": 0}
_BIT_FN = {"bit_and": torch.bitwise_and, "bit_or": torch.bitwise_or,
           "bit_xor": torch.bitwise_xor}
_BIT_CODE = {torch.int8: 5, torch.int16: 6, torch.int32: 1, torch.int64: 2}


def segmented_bitwise_plain(op: str, data: torch.Tensor,
                            validity: torch.Tensor, starts: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's segmented inclusive scan with a flag-resetting
    combine (log2(n) rounds of Hillis-Steele), read at each segment's
    last row; the values sign-extended to int64 and written back at the
    data's width."""
    n, g, dev = data.shape[0], starts.shape[0], data.device
    fn = _BIT_FN[op]
    v = torch.where(validity, data.to(torch.int64),
                    torch.full((), _BIT_IDENT[op], dtype=torch.int64,
                               device=dev))
    flag = torch.zeros(n, dtype=torch.bool, device=dev)
    flag[starts.long()] = True
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(flag[d:], v[d:], fn(v[:-d], v[d:]))])
        flag = torch.cat([flag[:d], flag[d:] | flag[:-d]])
        d *= 2
    rows = segment_rows(starts, n)
    nvalid = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
        0, _segment_ids(starts, n), validity.to(torch.int64))
    ok = nvalid > 0
    out = v[(starts.to(torch.int64) + rows - 1).clamp(min=0)] if g else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    out = torch.where(ok, out, torch.zeros((), dtype=torch.int64,
                                           device=dev))
    return out.to(data.dtype), ok


def masked_bitwise_plain(op: str, data: torch.Tensor, validity: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if data.shape[0] == 0:
        return (torch.zeros(1, dtype=data.dtype, device=data.device),
                torch.zeros(1, dtype=torch.bool, device=data.device))
    return segmented_bitwise_plain(op, data, validity,
                                   torch.zeros(1, dtype=torch.int32,
                                               device=data.device))


def _check_bitwise(name: str, op: str, data: torch.Tensor,
                   validity: torch.Tensor) -> None:
    if op not in _BIT_OP:
        raise ValueError(f"{name}: op is bit_and, bit_or or bit_xor, not "
                         f"{op!r}")
    if data.dtype not in _BIT_CODE:
        raise TypeError(f"{name} takes int8, int16, int32 or int64, got "
                        f"{data.dtype}")
    if validity.dtype != torch.bool or validity.shape != data.shape \
            or data.dim() != 1:
        raise ValueError(f"{name} needs 1-d data and bool validity of the "
                         "same length")


def segmented_bitwise(op: str, data: torch.Tensor, validity: torch.Tensor,
                      starts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BIT_AND / BIT_OR / BIT_XOR (``op`` "bit_and", "bit_or", "bit_xor")
    of the valid rows of each segment of contiguous rows: (values at the
    data's type, nvalid > 0); a segment with no valid row gives 0 and
    False."""
    _check_bitwise("segmented_bitwise", op, data, validity)
    _check_starts(starts)
    if data.device.type == "cpu":
        return segmented_bitwise_plain(op, data, validity, starts)
    _lib.require_cuda("segmented_bitwise", data, validity, starts)
    lib = _lib.lib()
    n, g, dev = data.shape[0], starts.shape[0], data.device
    out = torch.empty(g, dtype=data.dtype, device=dev)
    ok = torch.empty(g, dtype=torch.bool, device=dev)
    scratch = _scratch(n, lib.srt_segment_tile(), 2, dev)
    _lib.check(lib.srt_segmented_bitwise(
        _BIT_OP[op], _BIT_CODE[data.dtype], _lib.ptr(data),
        _lib.ptr(validity), n, _lib.ptr(starts), g, _lib.ptr(scratch),
        _lib.ptr(out), _lib.ptr(ok), _lib.stream(dev)), "segmented_bitwise")
    if n and g:
        _lib.LAUNCHES["segmented_bitwise"] += 1
    return out, ok


def masked_bitwise(op: str, data: torch.Tensor, validity: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``segmented_bitwise`` over the whole batch as one segment: two
    one-element tensors, the value and nvalid > 0."""
    _check_bitwise("masked_bitwise", op, data, validity)
    if data.device.type == "cpu":
        return masked_bitwise_plain(op, data, validity)
    _lib.require_cuda("masked_bitwise", data, validity)
    lib = _lib.lib()
    n, dev = data.shape[0], data.device
    out = torch.empty(1, dtype=data.dtype, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    scratch = _scratch(n, lib.srt_reduction_tile(), 1, dev)
    _lib.check(lib.srt_masked_bitwise(
        _BIT_OP[op], _BIT_CODE[data.dtype], _lib.ptr(data),
        _lib.ptr(validity), n, _lib.ptr(scratch), _lib.ptr(out),
        _lib.ptr(ok), _lib.stream(dev)), "masked_bitwise")
    _lib.LAUNCHES["masked_bitwise"] += 1
    return out, ok

# ---------------------------------------------------------------------------
# SUM128 and MIN128 / MAX128 over Decimal128 (or widened Decimal64) rows

#: segmented_sum128's flags (csrc/reduction.cu Sum128Policy)
PAST_INT128, PAST_PRECISION, POISONED = 1, 2, 4
_M32 = 0xFFFFFFFF


def _sum128_plain(data: torch.Tensor, validity: torch.Tensor,
                  seg: torch.Tensor, g: int, precision: int,
                  count: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's exact sum: six sign-extended 32-bit limbs summed
    per segment in int64, then the carries joined (``_carry_join``)."""
    dev = validity.device
    lo, hi = DK.limbs(data)
    w = validity.to(torch.int64)
    sign = (hi >> 63) & _M32
    parts = [lo & _M32, (lo >> 32) & _M32, hi & _M32, (hi >> 32) & _M32,
             sign, sign]
    sums = [torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
        0, seg, x * w) for x in parts]
    words, carry = [], torch.zeros(g, dtype=torch.int64, device=dev)
    for x in sums:
        t = x + carry
        words.append(t & _M32)
        carry = t >> 32
    out_lo = words[0] | (words[1] << 32)
    out_hi = words[2] | (words[3] << 32)
    top = words[4] | (words[5] << 32)
    past = top != (out_hi >> 63)
    out = torch.stack([out_lo, out_hi], 1)
    digits = DK._digits(out_lo, out_hi)
    wide = DK._too_wide(digits, out_hi < 0, precision)
    nvalid = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(0, seg,
                                                                      w)
    if count is None:
        poison = torch.zeros(g, dtype=torch.bool, device=dev)
    else:
        poison = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
            0, seg, (~validity & (count > 0)).to(torch.int64)) > 0
    ok = (nvalid > 0) & ~past & ~wide & ~poison
    out = torch.where(ok[:, None], out, torch.zeros((), dtype=torch.int64,
                                                    device=dev))
    flags = (past.to(torch.uint8) * PAST_INT128
             | wide.to(torch.uint8) * PAST_PRECISION
             | poison.to(torch.uint8) * POISONED)
    return out, ok, flags


def segmented_sum128_plain(data, validity, starts, precision, count=None):
    return _sum128_plain(data, validity, _segment_ids(starts, data.shape[0]),
                         starts.shape[0], precision, count)


def masked_sum128_plain(data, validity, precision, count=None):
    seg = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    return _sum128_plain(data, validity, seg, 1, precision, count)


def _check_128(name: str, data: torch.Tensor, validity: torch.Tensor
               ) -> None:
    if data.dtype != torch.int64 or not (
            data.dim() == 1 or (data.dim() == 2 and data.shape[1] == 2)):
        raise TypeError(f"{name} takes int64 [n, 2] limbs or int64 [n], got "
                        f"{data.dtype} {tuple(data.shape)}")
    if validity.dtype != torch.bool or validity.shape != data.shape[:1]:
        raise ValueError(f"{name} needs bool validity [{data.shape[0]}]")


def _check_sum128(name, data, validity, precision, count) -> list:
    _check_128(name, data, validity)
    if not 1 <= precision <= 38:
        raise ValueError(f"{name}: the buffer's precision is 1..38, not "
                         f"{precision}")
    if count is None:
        return [data, validity]
    if count.dtype != torch.int64 or count.shape != validity.shape:
        raise TypeError(f"{name}: a merge's counts are int64 "
                        f"[{validity.shape[0]}]")
    return [data, validity, count]


def _sum128_outputs(g: int, dev):
    return (torch.empty((g, 2), dtype=torch.int64, device=dev),
            torch.empty(g, dtype=torch.bool, device=dev),
            torch.empty(g, dtype=torch.uint8, device=dev))


def segmented_sum128(data: torch.Tensor, validity: torch.Tensor,
                     starts: torch.Tensor, precision: int,
                     count: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact SUM of the valid rows of each segment of contiguous rows, of
    Decimal128 [n, 2] limbs or Decimal64 int64 [n] values: (int64 [g, 2]
    sums, validity [g], flags uint8 [g]).  Null (zero limbs) where a
    segment has no valid row, where its sum leaves int128 (flag
    PAST_INT128), reaches 10**precision (PAST_PRECISION), or, at a merge
    (``count``: each partial row's COUNT_VALID), holds a null partial of
    a count above zero (POISONED: an overflowed partial, SPARK-28067)."""
    ts = _check_sum128("segmented_sum128", data, validity, precision, count)
    _check_starts(starts)
    if data.device.type == "cpu":
        return segmented_sum128_plain(data, validity, starts, precision,
                                      count)
    _lib.require_cuda("segmented_sum128", starts, *ts)
    lib = _lib.lib()
    n, g, dev = data.shape[0], starts.shape[0], data.device
    out, ok, flags = _sum128_outputs(g, dev)
    scratch = _scratch(n, lib.srt_segment_tile(), 2, dev)
    _lib.check(lib.srt_segmented_sum128(
        _lib.ptr(data), int(data.dim() == 2), _lib.ptr(validity),
        _lib.ptr(count) if count is not None else None, n, _lib.ptr(starts),
        g, precision, _lib.ptr(scratch), _lib.ptr(out), _lib.ptr(ok),
        _lib.ptr(flags), _lib.stream(dev)), "segmented_sum128")
    if n and g:
        _lib.LAUNCHES["segmented_sum128"] += 1
    return out, ok, flags


def masked_sum128(data: torch.Tensor, validity: torch.Tensor,
                  precision: int, count: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``segmented_sum128`` over the whole batch as one segment: [1, 2],
    [1], [1]."""
    ts = _check_sum128("masked_sum128", data, validity, precision, count)
    if data.device.type == "cpu":
        return masked_sum128_plain(data, validity, precision, count)
    _lib.require_cuda("masked_sum128", *ts)
    lib = _lib.lib()
    n, dev = data.shape[0], data.device
    out, ok, flags = _sum128_outputs(1, dev)
    scratch = _scratch(n, lib.srt_reduction_tile(), 1, dev)
    _lib.check(lib.srt_masked_sum128(
        _lib.ptr(data), int(data.dim() == 2), _lib.ptr(validity),
        _lib.ptr(count) if count is not None else None, n, precision,
        _lib.ptr(scratch), _lib.ptr(out), _lib.ptr(ok), _lib.ptr(flags),
        _lib.stream(dev)), "masked_sum128")
    _lib.LAUNCHES["masked_sum128"] += 1
    return out, ok, flags


def _extreme128_plain(data: torch.Tensor, validity: torch.Tensor,
                      seg: torch.Tensor, g: int, is_min: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's two reductions: the extreme high limb, then the
    extreme low limb (unsigned) of the rows holding it."""
    dev = validity.device
    lo, hi = DK.limbs(data)
    reduce = "amin" if is_min else "amax"
    ident = _I64.max if is_min else _I64.min
    mh = torch.full((g,), ident, dtype=torch.int64, device=dev)
    mh.scatter_reduce_(0, seg, torch.where(validity, hi, ident), reduce)
    cand = validity & (hi == mh[seg])
    key = lo ^ _I64.min                    # unsigned order as signed
    ml = torch.full((g,), ident, dtype=torch.int64, device=dev)
    ml.scatter_reduce_(0, seg, torch.where(cand, key, ident), reduce)
    nvalid = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
        0, seg, validity.to(torch.int64))
    ok = nvalid > 0
    out = torch.stack([ml ^ _I64.min, mh], 1)
    return torch.where(ok[:, None], out, torch.zeros(
        (), dtype=torch.int64, device=dev)), ok


def segmented_extreme128_plain(data, validity, starts, is_min):
    return _extreme128_plain(data, validity,
                             _segment_ids(starts, data.shape[0]),
                             starts.shape[0], is_min)


def masked_extreme128_plain(data, validity, is_min):
    seg = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    return _extreme128_plain(data, validity, seg, 1, is_min)


def segmented_extreme128(data: torch.Tensor, validity: torch.Tensor,
                         starts: torch.Tensor, is_min: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MIN (``is_min``) or MAX of the valid Decimal128 rows of each
    segment of contiguous rows (signed high limb, unsigned low limb):
    (int64 [g, 2], nvalid > 0); zero limbs where no row is valid.  One
    kernel for update and merge: the min of mins is the min."""
    _check_128("segmented_extreme128", data, validity)
    _check_starts(starts)
    if data.device.type == "cpu":
        return segmented_extreme128_plain(data, validity, starts, is_min)
    _lib.require_cuda("segmented_extreme128", data, validity, starts)
    lib = _lib.lib()
    n, g, dev = data.shape[0], starts.shape[0], data.device
    out, ok, _ = _sum128_outputs(g, dev)
    scratch = _scratch(n, lib.srt_segment_tile(), 2, dev)
    _lib.check(lib.srt_segmented_extreme128(
        int(is_min), _lib.ptr(data), int(data.dim() == 2), _lib.ptr(validity),
        n, _lib.ptr(starts), g, _lib.ptr(scratch), _lib.ptr(out),
        _lib.ptr(ok), _lib.stream(dev)), "segmented_extreme128")
    if n and g:
        _lib.LAUNCHES["segmented_extreme128"] += 1
    return out, ok


def masked_extreme128(data: torch.Tensor, validity: torch.Tensor,
                      is_min: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``segmented_extreme128`` over the whole batch: [1, 2] and [1]."""
    _check_128("masked_extreme128", data, validity)
    if data.device.type == "cpu":
        return masked_extreme128_plain(data, validity, is_min)
    _lib.require_cuda("masked_extreme128", data, validity)
    lib = _lib.lib()
    n, dev = data.shape[0], data.device
    out, ok, _ = _sum128_outputs(1, dev)
    scratch = _scratch(n, lib.srt_reduction_tile(), 1, dev)
    _lib.check(lib.srt_masked_extreme128(
        int(is_min), _lib.ptr(data), int(data.dim() == 2), _lib.ptr(validity),
        n, _lib.ptr(scratch), _lib.ptr(out), _lib.ptr(ok), _lib.stream(dev)),
        "masked_extreme128")
    _lib.LAUNCHES["masked_extreme128"] += 1
    return out, ok
