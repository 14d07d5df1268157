"""The fused segment's kernel: an interpreter of a lowered program.

Counterpart of the per-batch program of ``spark_rapids_tpu/plan/fused.py``
(``_make_program`` :943, with ``compaction_map`` / ``gather_batch`` inside
it, :1044-1049) and of ``plan/execs/aggregate.py`` ``_global_update``
(:274) for a partial aggregate with no keys.  A program comes from
``expressions/program.py``; it runs in one of two modes:

  * global (a partial aggregate with no keys): per slot the sum and the
    valid count over the kept rows, and the kept-row count, with no host
    read;
  * compact (otherwise): the computed columns of the kept rows at their
    compacted positions, and optionally the gather map (count, one read,
    allocate); with no filter, every row in place and no read.

On CUDA tensors each wrapper launches the hand-written kernel of
``csrc/fused.cu`` and counts one launch under ``fused_segment``; on CPU
tensors it runs the plain version beside it, which interprets the same
program with torch ops over whole columns.  There is no fallback from one
to the other.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions import program as P
from spark_rapids_tpu_torch.expressions.predicates import _eq, _lt
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.reduction import masked_sum_plain
from spark_rapids_tpu_torch.kernels.selection import (_ptr_array,
                                                      compaction_map_plain)

COUNTER = "fused_segment"
_SUM_DTYPE = {P.SUM_F64: torch.float64, P.SUM_I64: torch.int64,
              P.SUM_NONE: torch.int64}


class SlotSums(NamedTuple):
    """One global slot: the sum (0 where no row is valid; int64 bits of a
    double viewed as float64), ``count > 0`` and the valid count, each one
    element."""

    value: torch.Tensor
    ok: torch.Tensor
    count: torch.Tensor


class GlobalResult(NamedTuple):
    slots: List[SlotSums]
    kept: torch.Tensor   # int64 [1]: the rows the filter kept
    one: torch.Tensor    # bool [1] True: the counts' validity


# ---------------------------------------------------------------------------
# plain version


def _interpret(prog: P.Program, cols: Sequence[DeviceColumn], n: int,
               dev: torch.device):
    """Every register's last (data, validity), as tensors over n rows."""
    data: list = [None] * prog.n_regs
    valid: list = [None] * prog.n_regs
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    for op, kind, dst, a, b, c in prog.code:
        dt = P.KIND_DTYPE[kind]
        if op == P.LOAD:
            col = cols[prog.loads[a]]
            x, v = col.data, col.validity
        elif op == P.CONST:
            bits = torch.tensor([prog.literals[a]], dtype=torch.int64)
            value = (bits.view(torch.float64) if kind == P.K_F64
                     else bits.to(dt)).item()
            x, v = torch.full((n,), value, dtype=dt, device=dev), ones
        elif op == P.CAST_DEC_F64:   # a divisor tensor, as Cast.eval
            div = torch.tensor([prog.literals[b]]).view(torch.float64)
            x, v = data[a].to(torch.float64) / div.to(dev)[0], valid[a]
        elif op == P.WIDEN:
            x, v = data[a].to(torch.float64), valid[a]
        elif op == P.RESCALE:
            x, v = data[a].to(torch.int64) * prog.literals[b], valid[a]
        elif op in (P.ADD, P.SUB, P.MUL):
            lhs, rhs = data[a].to(dt), data[b].to(dt)
            x = (lhs + rhs if op == P.ADD else
                 lhs - rhs if op == P.SUB else lhs * rhs)
            v = valid[a] & valid[b]
        elif P.LT <= op <= P.EQ:
            cdt = torch.float64 if kind == P.K_F64 else torch.int64
            lhs, rhs = data[a].to(cdt), data[b].to(cdt)
            is_float = kind == P.K_F64
            x = {P.LT: lambda: _lt(lhs, rhs, is_float),
                 P.LE: lambda: _lt(lhs, rhs, is_float)
                 | _eq(lhs, rhs, is_float),
                 P.GT: lambda: _lt(rhs, lhs, is_float),
                 P.GE: lambda: _lt(rhs, lhs, is_float)
                 | _eq(lhs, rhs, is_float),
                 P.EQ: lambda: _eq(lhs, rhs, is_float)}[op]()
            v = valid[a] & valid[b]
        elif op == P.AND:
            la, lb = data[a].to(torch.bool), data[b].to(torch.bool)
            va, vb = valid[a], valid[b]
            x = (la & va) & (lb & vb)
            v = (va & vb) | (~la & va) | (~lb & vb)
        elif op == P.IS_NULL:
            x, v = ~valid[a], ones
        elif op == P.IF:
            take = data[a].to(torch.bool) & valid[a]
            x = torch.where(take, data[b].to(dt), data[c].to(dt))
            v = torch.where(take, valid[b], valid[c])
        else:
            raise ValueError(f"unknown opcode {op}")
        data[dst], valid[dst] = x, v
    return data, valid


def _keep_plain(prog, data, valid, n, dev) -> torch.Tensor:
    if prog.keep < 0:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return data[prog.keep].to(torch.bool) & valid[prog.keep]


def fused_global_plain(prog: P.Program, cols: Sequence[DeviceColumn],
                       n: int, dev: torch.device) -> GlobalResult:
    data, valid = _interpret(prog, cols, n, dev)
    keep = _keep_plain(prog, data, valid, n, dev)
    slots = []
    for r, _, sum_kind in prog.slots:
        x = data[r].to(_SUM_DTYPE[sum_kind])
        if sum_kind == P.SUM_NONE:
            x = torch.zeros_like(x)
        slots.append(SlotSums(*masked_sum_plain(x, valid[r] & keep)))
    kept = keep.sum(dtype=torch.int64).reshape(1)
    return GlobalResult(slots, kept,
                        torch.ones(1, dtype=torch.bool, device=dev))


def fused_compact_plain(prog: P.Program, cols: Sequence[DeviceColumn],
                        n: int, need_map: bool, dev: torch.device
                        ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                                   Optional[torch.Tensor], int]:
    data, valid = _interpret(prog, cols, n, dev)
    outs = []
    for r, kind in prog.outputs:
        x = data[r].to(P.KIND_DTYPE[kind])
        outs.append((torch.where(valid[r], x, torch.zeros((), dtype=x.dtype,
                                                          device=dev)),
                     valid[r]))
    if prog.keep < 0:
        return outs, None, n
    idx, count = compaction_map_plain(_keep_plain(prog, data, valid, n, dev))
    long_idx = idx.long()
    outs = [(x[long_idx], v[long_idx]) for x, v in outs]
    return outs, (idx if need_map else None), count

# ---------------------------------------------------------------------------
# CUDA


def _inputs(prog: P.Program, words: torch.Tensor,
            cols: Sequence[DeviceColumn]):
    """The loaded columns' pointer arrays (kept alive by the caller)."""
    ins = [cols[o] for o in prog.loads]
    _lib.require_cuda("fused_segment", words,
                      *(t for c in ins for t in (c.data, c.validity)))
    if words.dtype != torch.int64 or \
            words.numel() != len(prog.code) + len(prog.literals):
        raise ValueError("fused_segment: the words are not this program's")
    return (_ptr_array([c.data for c in ins]),
            _ptr_array([c.validity for c in ins]))


def _int_array(values: Sequence[int]):
    arr = (ctypes.c_int32 * max(len(values), 1))(*values)
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _fused_global_cuda(prog, words, cols, n) -> GlobalResult:
    (in_data, k1), (in_valid, k2) = _inputs(prog, words, cols)
    lib = _lib.lib()
    dev = words.device
    ns = len(prog.slots)
    ntiles = -(-n // lib.srt_fused_tile())
    scratch = torch.empty(max(ns * ntiles, 1) + max((ns + 1) * ntiles, 1),
                          dtype=torch.int64, device=dev)
    tile_cnt = scratch[max(ns * ntiles, 1):]
    res = torch.empty(2 * ns + 1, dtype=torch.int64, device=dev)
    flags = torch.empty(ns + 1, dtype=torch.bool, device=dev)
    arrays = [_int_array([s[i] for s in prog.slots]) for i in range(3)]
    _lib.check(lib.srt_fused_global(
        _lib.ptr(words), len(prog.code), prog.keep, len(prog.literals),
        prog.n_regs, len(prog.loads), in_data, in_valid, ns,
        *(a for a, _ in arrays), n, _lib.ptr(scratch), _lib.ptr(tile_cnt),
        _lib.ptr(res), _lib.ptr(flags), _lib.stream(dev)), "fused_segment")
    _lib.LAUNCHES[COUNTER] += 1
    slots = []
    for k, (_, _, sum_kind) in enumerate(prog.slots):
        value = res[k:k + 1]
        if sum_kind == P.SUM_F64:
            value = value.view(torch.float64)
        slots.append(SlotSums(value, flags[k:k + 1],
                              res[ns + k:ns + k + 1]))
    return GlobalResult(slots, res[2 * ns:], flags[ns:])


def _fused_compact_cuda(prog, words, cols, n, need_map):
    (in_data, k1), (in_valid, k2) = _inputs(prog, words, cols)
    lib = _lib.lib()
    dev = words.device
    s = _lib.stream(dev)
    offsets = None
    count = n
    if prog.keep >= 0:
        ntiles = -(-n // lib.srt_fused_tile())
        offsets = torch.empty(ntiles + 1, dtype=torch.int32, device=dev)
        scan_scratch = torch.empty(max(-(-ntiles // lib.srt_scan_tile()), 1),
                                   dtype=torch.int64, device=dev)
        total = torch.empty(1, dtype=torch.int64, device=dev)
        _lib.check(lib.srt_fused_count(
            _lib.ptr(words), len(prog.code), prog.n_pred, prog.keep,
            len(prog.literals), prog.n_regs, len(prog.loads), in_data,
            in_valid, n, _lib.ptr(offsets), _lib.ptr(scan_scratch),
            _lib.ptr(total), s), "fused_segment")
        # the one device->host read of a fused filter: the exact output size
        count = int(total.item())
    outs = [(torch.empty(count, dtype=P.KIND_DTYPE[kind], device=dev),
             torch.empty(count, dtype=torch.bool, device=dev))
            for _, kind in prog.outputs]
    idx = (torch.empty(count, dtype=torch.int32, device=dev)
           if need_map and prog.keep >= 0 else None)
    if count and (outs or idx is not None):
        planes = [_ptr_array([x for x, _ in outs]),
                  _ptr_array([v for _, v in outs])]
        meta = [_int_array([k for _, k in prog.outputs]),
                _int_array([r for r, _ in prog.outputs])]
        _lib.check(lib.srt_fused_write(
            _lib.ptr(words), len(prog.code), prog.keep, len(prog.literals),
            prog.n_regs, len(prog.loads), in_data, in_valid,
            len(prog.outputs), *(p for p, _ in planes),
            *(p for p, _ in meta),
            n, _lib.ptr(offsets) if offsets is not None else None,
            _lib.ptr(idx) if idx is not None else None, s), "fused_segment")
    if n:
        _lib.LAUNCHES[COUNTER] += 1
    return outs, idx, count

# ---------------------------------------------------------------------------
# wrappers


def _check(prog: P.Program, cols: Sequence[DeviceColumn], n: int) -> None:
    for o in prog.loads:
        c = cols[o]
        if c.num_rows != n:
            raise ValueError(f"fused_segment: a column of {c.num_rows} rows "
                             f"in a batch of {n}")
        if c.is_string or c.data.dtype != P.KIND_DTYPE[
                P.kind_of(c.dtype)]:
            raise TypeError(f"fused_segment: cannot load a {c.dtype!r} "
                            "column")
    if n >= 2**31:
        raise ValueError("fused_segment: int32 row ids need n < 2**31")


def fused_global(prog: P.Program, words: torch.Tensor,
                 cols: Sequence[DeviceColumn], n: int) -> GlobalResult:
    """Global mode over a batch of ``n`` rows whose columns are ``cols``;
    ``words`` is ``prog.words()`` on the batch's device."""
    _check(prog, cols, n)
    if words.device.type == "cpu":
        return fused_global_plain(prog, cols, n, words.device)
    return _fused_global_cuda(prog, words, cols, n)


def fused_compact(prog: P.Program, words: torch.Tensor,
                  cols: Sequence[DeviceColumn], n: int, need_map: bool
                  ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                             Optional[torch.Tensor], int]:
    """Compact mode: ((data, validity) of each output at the kept rows,
    the kept rows' int32 ids when ``need_map`` and there is a filter, the
    kept count)."""
    _check(prog, cols, n)
    if words.device.type == "cpu":
        return fused_compact_plain(prog, cols, n, need_map, words.device)
    return _fused_compact_cuda(prog, words, cols, n, need_map)
