"""Spark-exact Murmur3 row hashes and partition ids.

Counterpart of ``spark_rapids_tpu/kernels/hash.py`` (``hash_fixed_width``
:99, ``murmur3_hash`` :237, ``pmod`` :258), fixed-width columns.  Spark's
Murmur3_x86_32 with seed 42: int/date/bool hash as hashInt, long and
Decimal64 (the unscaled long) as hashLong (low word, then high word), and
doubles as hashLong of their bits after -0.0 -> 0.0 and NaN -> canonical
NaN.  Columns chain left to right; a null row passes the running hash
through.  Routing must be bit-exact: a CPU Spark stage and the card must
send a key to the same reduce partition.

On CUDA tensors ``murmur3_hash`` and ``murmur3_partition`` launch the
kernel of ``csrc/hash.cu`` (all key columns in one launch, pmod fused) and
count the launch; on CPU tensors they run the plain PyTorch version.  The
plain version computes in int64 with 32-bit masks, because PyTorch on the
CPU has no uint32 add or shift; int64 multiplies wrap, and the low 32 bits
of a wrapped product are the uint32 product.  String hashing
(``hash_string`` :187) is not ported.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib

DEFAULT_SEED = 42

_M32 = 0xFFFFFFFF
_C1, _C2, _M5 = 0xCC9E2D51, 0x1B873593, 0xE6546B64
_CANONICAL_NAN_BITS = 0x7FF8000000000000

# column kinds of csrc/hash.cu
_INT32, _INT64, _F64, _BOOL = 0, 1, 2, 3


def _kind(dtype: T.DataType) -> int:
    if isinstance(dtype, (T.IntegerType, T.DateType)):
        return _INT32
    if isinstance(dtype, (T.LongType, T.DecimalType)):
        return _INT64
    if isinstance(dtype, T.DoubleType):
        return _F64
    if isinstance(dtype, T.BooleanType):
        return _BOOL
    raise NotImplementedError(f"murmur3 of {dtype!r} is not ported")

# ---------------------------------------------------------------------------
# plain version (int64 lanes holding uint32 values)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * _C1) & _M32
    k1 = _rotl(k1, 15)
    k1 = (k1 * _C2) & _M32
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + _M5) & _M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def _hash_int(v32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return _fmix(_mix_h1(seed, v32 & _M32), 4)


def _hash_long(v64: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    h1 = _mix_h1(seed, v64 & _M32)
    h1 = _mix_h1(h1, (v64 >> 32) & _M32)   # arithmetic shift, then mask
    return _fmix(h1, 8)


def f64_hash_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 bits of doubles with -0.0 -> 0.0 and every NaN canonical."""
    x = torch.where(x == 0.0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    bits = x.view(torch.int64)
    return torch.where(torch.isnan(x),
                       torch.full((), _CANONICAL_NAN_BITS, dtype=torch.int64,
                                  device=x.device), bits)


def hash_fixed_width(col: DeviceColumn, seeds: torch.Tensor) -> torch.Tensor:
    """Chain one column into running hashes (int64 lanes, uint32 values);
    null rows keep their seed.  The plain version of one column's step."""
    kind = _kind(col.dtype)
    if kind == _INT64:
        h = _hash_long(col.data, seeds)
    elif kind == _F64:
        h = _hash_long(f64_hash_bits(col.data), seeds)
    else:   # int32 sign-extends; its low 32 bits are the value's bits
        h = _hash_int(col.data.to(torch.int64), seeds)
    return torch.where(col.validity, h, seeds)


def murmur3_hash_plain(columns: Sequence[DeviceColumn],
                       seed: int = DEFAULT_SEED) -> torch.Tensor:
    n = columns[0].num_rows
    h = torch.full((n,), seed & _M32, dtype=torch.int64,
                   device=columns[0].device)
    for c in columns:
        h = hash_fixed_width(c, h)
    # uint32 bits -> int32
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def pmod(hashes: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Spark's Pmod(hash, n): the non-negative remainder (int32)."""
    m = torch.fmod(hashes, num_partitions)
    return torch.where(m < 0, m + num_partitions, m)

# ---------------------------------------------------------------------------
# kernel


def _murmur3_cuda(columns: Sequence[DeviceColumn], seed: int,
                  num_partitions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("murmur3", *(t for c in columns
                                   for t in (c.data, c.validity)))
    lib = _lib.lib()
    if len(columns) > lib.srt_max_hash_cols():
        raise NotImplementedError(
            f"murmur3: {len(columns)} key columns, at most "
            f"{lib.srt_max_hash_cols()} in one launch")
    n = columns[0].num_rows
    dev = columns[0].device
    hashes = torch.empty(n, dtype=torch.int32, device=dev)
    part = (torch.empty(n, dtype=torch.int32, device=dev)
            if num_partitions else None)
    k = len(columns)
    data = (ctypes.c_void_p * k)(*(c.data.data_ptr() for c in columns))
    valid = (ctypes.c_void_p * k)(*(c.validity.data_ptr() for c in columns))
    kinds = (ctypes.c_int * k)(*(_kind(c.dtype) for c in columns))
    _lib.check(lib.srt_murmur3(
        k, ctypes.cast(data, ctypes.c_void_p),
        ctypes.cast(valid, ctypes.c_void_p),
        ctypes.cast(kinds, ctypes.c_void_p), n, seed & _M32,
        _lib.ptr(hashes), num_partitions,
        _lib.ptr(part) if part is not None else None, _lib.stream(dev)),
        "murmur3")
    if n:
        _lib.LAUNCHES["murmur3"] += 1
    return hashes, part


def _check_columns(columns: Sequence[DeviceColumn]) -> None:
    if not columns:
        raise ValueError("murmur3 needs at least one column")
    if len({c.num_rows for c in columns}) != 1:
        raise ValueError("murmur3: columns differ in length")
    for c in columns:
        _kind(c.dtype)


def murmur3_hash(columns: Sequence[DeviceColumn],
                 seed: int = DEFAULT_SEED) -> torch.Tensor:
    """int32 row hashes of the key columns, Spark Murmur3Hash semantics."""
    _check_columns(columns)
    if columns[0].device.type == "cpu":
        return murmur3_hash_plain(columns, seed)
    return _murmur3_cuda(columns, seed, 0)[0]


def murmur3_partition(columns: Sequence[DeviceColumn], num_partitions: int,
                      seed: int = DEFAULT_SEED
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 hashes, int32 partition ids = pmod(hash, num_partitions)),
    on the card in one launch."""
    _check_columns(columns)
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    if columns[0].device.type == "cpu":
        h = murmur3_hash_plain(columns, seed)
        return h, pmod(h, num_partitions)
    return _murmur3_cuda(columns, seed, num_partitions)
