"""Whole-batch masked reduction: SUM and count of the valid rows.

Counterpart of the reduction inside ``spark_rapids_tpu/plan/execs/
aggregate.py:274`` (``_global_update``, ops SUM and COUNT_VALID), which
the reference leaves to XLA.  On CUDA tensors ``masked_sum`` launches the
two-pass kernel of ``csrc/reduction.cu`` and counts the launch; on CPU
tensors it runs the plain PyTorch version beside it.
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
