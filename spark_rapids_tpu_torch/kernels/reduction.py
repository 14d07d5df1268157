"""Reductions: SUM, MIN / MAX and M2, whole-batch and segmented.

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
On CUDA tensors each launches its two-pass kernel of
``csrc/reduction.cu`` and counts the launch under its own name; on CPU
tensors it runs the plain PyTorch version beside it, and on any other
device it raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.kernels import _lib

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
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes bool, int32, int64, float32 or "
                        f"float64, got {data.dtype}")
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
        _DTYPE_CODE[data.dtype], int(is_min), _lib.ptr(data),
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
        _DTYPE_CODE[data.dtype], int(is_min), _lib.ptr(data),
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
