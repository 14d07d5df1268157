"""Reductions: the whole-batch masked SUM and the segmented SUM.

``masked_sum`` is the counterpart of the reduction inside
``spark_rapids_tpu/plan/execs/aggregate.py:274`` (``_global_update``, ops
SUM and COUNT_VALID), which the reference leaves to XLA.
``segmented_sum`` is the counterpart of ``spark_rapids_tpu/kernels/
groupby.py`` ``seg_sum`` :166, ``seg_count_valid`` :151 and
``seg_count_star`` :159 over the contiguous groups of a sorted batch.  On
CUDA tensors each launches its two-pass kernel of ``csrc/reduction.cu``
and counts the launch; on CPU tensors it runs the plain PyTorch version
beside it.
"""
from __future__ import annotations

from typing import Tuple

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
