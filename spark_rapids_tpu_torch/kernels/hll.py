"""HyperLogLog++ register kernels.

Counterpart of ``spark_rapids_tpu/kernels/hll.py`` (``p_from_rsd`` :21,
``row_idx_rho`` :28, ``_alpha`` :42, ``estimate_np`` :56, ``update_np``
:78, ``global_update`` :96, ``seg_update`` :106, ``merge_rows`` :119).  A
group's sketch is m = 2^p int8 registers; a LONG value (integral, DATE,
TIMESTAMP and BOOLEAN inputs are widened to it) hashes by Spark's
xxhash64 with seed 42, its register is ``h >> (64 - p)`` and its rho
``min(clz(h << p) + 1, 64 - p + 1)``; each register keeps its max, an
empty one 0.

``hll_update`` (L1) gives one sketch over a whole column, or one per
segment of a column sorted into groups (``starts``, kernels/groupby.py
``group_rows``): int8 ``[groups, m]``, the rows of the aggregate's
fixed-length array buffer (``T.ArrayType``).  On the card one sketch (no
``starts``, or one segment) is the global kernel, spread over the whole
grid; several segments the grouped one, a block a segment.
``hll_merge`` (L2) is the elementwise max of register rows per segment, a
null row read as 0.  On
CUDA tensors each launches its kernel of ``csrc/sketch.cu`` and counts
the launch (the card takes p <= 13: a block's registers in 48 KB of
shared memory); on CPU tensors it runs the plain version beside it.  The
plain versions work in int64 lanes holding the uint64 hash
(``kernels/hash.py`` ``_xx_long``); the leading zeros are a six-step
shift-and-mask search, because a float64 conversion rounds 2^k - 1 up and
miscounts them.

``estimate_np`` and ``update_np`` are the reference's oracle, copied; the
aggregate's estimate over a [groups, m] plane is
``expressions/aggregates.py`` ``ApproximateCountDistinct.finalize``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.hash import (XXHASH64_DEFAULT_SEED,
                                                 _i64, _lshr, _xx_long,
                                                 py_xxhash64_long)

HLL_UPDATE = "hll_update"
HLL_MERGE = "hll_merge"


def p_from_rsd(rsd: float) -> int:
    """Spark HyperLogLogPlusPlus: p = ceil(2 * log2(1.106 / rsd))."""
    p = int(math.ceil(2.0 * math.log(1.106 / rsd) / math.log(2.0)))
    return max(4, p)


def _alpha(m: int) -> float:
    """HLL++ paper (Heule et al. 2013) alpha constants, as Spark's
    HyperLogLogPlusPlusHelper uses them."""
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def estimate_np(registers: np.ndarray) -> int:
    """The reference's estimate with linear counting below 2.5 m (Spark's
    empirical bias tables are not in it; ROADMAP queue 3 pins that)."""
    m = registers.shape[0]
    inv = np.power(2.0, -registers.astype(np.float64))
    est = _alpha(m) * m * m / inv.sum()
    zeros = int((registers == 0).sum())
    if est <= 2.5 * m and zeros != 0:
        est = m * np.log(m / float(zeros))
    return int(round(est))


def update_np(values, validity, p: int, registers=None) -> np.ndarray:
    """The reference's per-row Python oracle of the register update."""
    m = 1 << p
    if registers is None:
        registers = np.zeros((m,), np.int8)
    for v, ok in zip(values, validity):
        if not ok:
            continue
        h = py_xxhash64_long(int(v), XXHASH64_DEFAULT_SEED)
        idx = h >> (64 - p)
        rest = (h << p) & ((1 << 64) - 1)
        rho = 1
        for _ in range(64 - p):
            if rest & (1 << 63):
                break
            rho += 1
            rest = (rest << 1) & ((1 << 64) - 1)
        registers[idx] = max(registers[idx], min(rho, 64 - p + 1))
    return registers

# ---------------------------------------------------------------------------
# plain versions


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 lanes read as uint64 (64 for 0)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = _lshr(x, 64 - s) == 0
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, x << s, x)
    return n + (x == 0).to(torch.int64)


def idx_rho_plain(values: torch.Tensor, validity: torch.Tensor,
                  p: int) -> tuple:
    """int64 (register index, rho) per row; 0 and 0 on a null row."""
    seed = torch.full_like(values, _i64(XXHASH64_DEFAULT_SEED))
    h = _xx_long(values, seed)
    idx = _lshr(h, 64 - p)
    rho = torch.clamp(clz64(h << p) + 1, max=64 - p + 1)
    return (torch.where(validity, idx, 0), torch.where(validity, rho, 0))


def _segment_ids(starts: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [n]: each row's segment, from the segments' first rows."""
    first = torch.zeros(n, dtype=torch.int64, device=starts.device)
    first[starts[1:].long()] = 1
    return torch.cumsum(first, 0)


def hll_update_plain(values: torch.Tensor, validity: torch.Tensor, p: int,
                     starts: Optional[torch.Tensor]) -> torch.Tensor:
    m = 1 << p
    n = values.shape[0]
    groups = 1 if starts is None else starts.shape[0]
    idx, rho = idx_rho_plain(values, validity, p)
    if starts is not None:
        idx = idx + _segment_ids(starts, n) * m
    regs = torch.zeros(groups * m, dtype=torch.int64, device=values.device)
    regs.scatter_reduce_(0, idx, rho, "amax")
    return regs.to(torch.int8).reshape(groups, m)


def hll_merge_plain(regs: torch.Tensor, validity: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
    rows, m = regs.shape
    groups = starts.shape[0]
    keep = torch.where(validity[:, None], regs, 0).to(torch.int64)
    seg = _segment_ids(starts, rows)[:, None] * m + torch.arange(
        m, device=regs.device)
    out = torch.zeros(groups * m, dtype=torch.int64, device=regs.device)
    out.scatter_reduce_(0, seg.reshape(-1), keep.reshape(-1), "amax")
    return out.to(torch.int8).reshape(groups, m)

# ---------------------------------------------------------------------------
# wrappers


def _check_p(p: int, on_card: bool) -> None:
    if not 4 <= p <= 30:
        raise ValueError(f"HyperLogLog++ precision p = {p}")
    if on_card and (1 << p) > _lib.lib().srt_hll_max_registers():
        raise ValueError(f"{HLL_UPDATE}: p = {p}; the card's kernel holds "
                         "at most 2^13 registers a group (p <= 13)")


def _hll_update_cuda(values: torch.Tensor, validity: torch.Tensor, p: int,
                     starts: Optional[torch.Tensor]) -> torch.Tensor:
    lib = _lib.lib()
    n, m, dev = values.shape[0], 1 << p, values.device
    s = _lib.stream(dev)
    if starts is None or starts.shape[0] == 1:   # one sketch of every row
        out = torch.empty((1, m), dtype=torch.int8, device=dev)
        scratch = torch.empty(m, dtype=torch.int32, device=dev)
        _lib.check(lib.srt_hll_global(_lib.ptr(values), _lib.ptr(validity), n,
                                      p, _lib.ptr(scratch), _lib.ptr(out), s),
                   HLL_UPDATE)
    else:
        groups = starts.shape[0]
        out = torch.empty((groups, m), dtype=torch.int8, device=dev)
        _lib.check(lib.srt_hll_grouped(
            _lib.ptr(values), _lib.ptr(validity), n, _lib.ptr(starts), groups,
            p, _lib.ptr(out), s), HLL_UPDATE)
    if starts is None or starts.shape[0]:
        _lib.LAUNCHES[HLL_UPDATE] += 1
    return out


def _hll_merge_cuda(regs: torch.Tensor, validity: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
    rows, m = regs.shape
    groups = starts.shape[0]
    out = torch.empty((groups, m), dtype=torch.int8, device=regs.device)
    _lib.check(_lib.lib().srt_hll_merge(
        _lib.ptr(regs), _lib.ptr(validity), rows, _lib.ptr(starts), groups, m,
        _lib.ptr(out), _lib.stream(regs.device)), HLL_MERGE)
    if groups:
        _lib.LAUNCHES[HLL_MERGE] += 1
    return out


def hll_update(col: DeviceColumn, p: int,
               starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1: int8 [groups, 2^p], the registers of the column's valid rows:
    one sketch (``starts`` None), or one per segment of a column sorted
    into groups, ``starts`` the int32 first row of each (ascending, from
    0)."""
    if col.is_string or col.is_wide or col.data.dtype.is_floating_point:
        raise TypeError(f"{HLL_UPDATE} hashes long-representable values, "
                        f"got {col.dtype!r}")
    values = col.data.to(torch.int64)
    if col.device.type == "cpu":
        _check_p(p, False)
        return hll_update_plain(values, col.validity, p, starts)
    _lib.require_cuda(HLL_UPDATE, values, col.validity,
                      *(() if starts is None else (starts,)))
    _check_p(p, True)
    return _hll_update_cuda(values, col.validity, p, starts)


def hll_merge(regs: torch.Tensor, validity: torch.Tensor,
              starts: torch.Tensor) -> torch.Tensor:
    """L2: int8 [groups, m], the elementwise max of each segment's valid
    register rows of ``regs`` (int8 [rows, m]); ``starts`` as
    ``hll_update``'s (the global merge: one segment, [0])."""
    if regs.dtype != torch.int8 or regs.dim() != 2:
        raise TypeError(f"{HLL_MERGE}: registers must be int8 [rows, m], "
                        f"got {regs.dtype} {tuple(regs.shape)}")
    if regs.device.type == "cpu":
        return hll_merge_plain(regs, validity, starts)
    _lib.require_cuda(HLL_MERGE, regs, validity, starts)
    return _hll_merge_cuda(regs, validity, starts)
