"""Spark-exact Murmur3 row hashes and partition ids.

Counterpart of ``spark_rapids_tpu/kernels/hash.py`` (``hash_fixed_width``
:99, ``hash_string`` :187, ``murmur3_hash`` :237, ``pmod`` :258).  Spark's
Murmur3_x86_32 with seed 42: int/date/bool hash as hashInt (BYTE and
SHORT too, the value sign-extended to int, as ``hash_fixed_width`` :99
does), long and
Decimal64 (the unscaled long) as hashLong (low word, then high word),
doubles as hashLong of their bits after -0.0 -> 0.0 and NaN -> canonical
NaN, and strings as hashUnsafeBytes (4-byte little-endian words, then each
tail byte as a sign-extended int, then fmix with the byte length).
A Decimal128 (precision above 18) hashes as hashUnsafeBytes of its
minimal big-endian two's-complement bytes, Java's
``BigInteger.toByteArray`` (``_hash_decimal128_bytes`` :141; K3).
Columns chain left to right; a null row passes the running hash
through.  Routing must be bit-exact: a CPU Spark stage and the card must
send a key to the same reduce partition.

On CUDA tensors ``murmur3_hash`` and ``murmur3_partition`` launch the
kernel of ``csrc/hash.cu`` (all key columns in one launch, pmod fused) and
count the launch; on CPU tensors they run the plain PyTorch version.  The
plain version computes in int64 with 32-bit masks, because PyTorch on the
CPU has no uint32 add or shift; int64 multiplies wrap, and the low 32 bits
of a wrapped product are the uint32 product.
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
_INT32, _INT64, _F64, _BOOL, _STRING, _DEC128, _INT8, _INT16 = range(8)


def _kind(dtype: T.DataType) -> int:
    if T.two_limbs(dtype):
        return _DEC128
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
    if isinstance(dtype, T.ByteType):
        return _INT8
    if isinstance(dtype, T.ShortType):
        return _INT16
    raise T.key_type_not_ported(dtype, "murmur3")

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
    if kind == _DEC128:
        h = hash_decimal128(col, seeds)
    elif kind == _INT64:
        h = _hash_long(col.data, seeds)
    elif kind == _F64:
        h = _hash_long(f64_hash_bits(col.data), seeds)
    else:   # int8 / int16 / int32 sign-extend; the low 32 bits hash
        h = _hash_int(col.data.to(torch.int64), seeds)
    return torch.where(col.validity, h, seeds)


def hash_decimal128(col: DeviceColumn, seeds: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: each row's running hash mixed with the
    minimal big-endian bytes of its (high, low) limbs, null rows too (the
    caller keeps their seeds)."""
    lo, hi = col.data[:, 0], col.data[:, 1]
    be = torch.stack([(hi >> (8 * (7 - j))) & 0xFF for j in range(8)]
                     + [(lo >> (8 * (7 - j))) & 0xFF for j in range(8)], 1)
    neg = hi < 0
    fill = torch.where(neg, 0xFF, 0)
    top = (be & 0x80) != 0
    redundant = (be[:, :15] == fill[:, None]) & (top[:, 1:] == neg[:, None])
    strip = torch.cumprod(redundant.to(torch.int64), dim=1).sum(1)
    length = 16 - strip                                  # at least 1
    pos = torch.arange(16, device=be.device)
    src = (strip[:, None] + pos).clamp(max=15)
    tile = torch.where(pos < length[:, None], torch.gather(be, 1, src), 0)
    h = seeds
    for i in range(4):
        w = (tile[:, 4 * i] | (tile[:, 4 * i + 1] << 8)
             | (tile[:, 4 * i + 2] << 16) | (tile[:, 4 * i + 3] << 24))
        h = torch.where(i < length // 4, _mix_h1(h, w), h)
    aligned = (length // 4) * 4
    for i in range(16):
        b = tile[:, i]
        signed = torch.where(b >= 128, b - 256, b) & _M32
        h = torch.where((i >= aligned) & (i < length), _mix_h1(h, signed), h)
    return _fmix(h, length)


def hash_string(col: DeviceColumn, seeds: torch.Tensor) -> torch.Tensor:
    """Chain a string column into running hashes (int64 lanes, uint32
    values); null rows keep their seed.  The plain version of the string
    step: the rows' bytes in a [n, longest] tile, words then tail bytes,
    each applied where the row is long enough."""
    lengths = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    longest = int(lengths.max()) if col.num_rows else 0
    h = seeds
    if longest:
        tile = col.byte_tile(longest).to(torch.int64)
        words = lengths // 4
        for i in range(longest // 4):
            w = (tile[:, 4 * i] | (tile[:, 4 * i + 1] << 8)
                 | (tile[:, 4 * i + 2] << 16) | (tile[:, 4 * i + 3] << 24))
            h = torch.where(i < words, _mix_h1(h, w), h)
        for i in range(longest):
            b = tile[:, i]
            signed = torch.where(b >= 128, b - 256, b) & _M32
            h = torch.where((i >= 4 * words) & (i < lengths),
                            _mix_h1(h, signed), h)
    h = _fmix(h, lengths)
    return torch.where(col.validity, h, seeds)


def murmur3_hash_plain(columns: Sequence[DeviceColumn],
                       seed: int = DEFAULT_SEED) -> torch.Tensor:
    n = columns[0].num_rows
    h = torch.full((n,), seed & _M32, dtype=torch.int64,
                   device=columns[0].device)
    for c in columns:
        h = hash_string(c, h) if c.is_string else hash_fixed_width(c, h)
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
    _lib.require_cuda("murmur3", *(
        t for c in columns for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
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
    offsets = (ctypes.c_void_p * k)(*(c.offsets.data_ptr() if c.is_string
                                      else None for c in columns))
    kinds = (ctypes.c_int * k)(*(_kind(c.dtype) for c in columns))
    _lib.check(lib.srt_murmur3(
        k, ctypes.cast(data, ctypes.c_void_p),
        ctypes.cast(valid, ctypes.c_void_p),
        ctypes.cast(offsets, ctypes.c_void_p),
        ctypes.cast(kinds, ctypes.c_void_p), n, seed & _M32,
        _lib.ptr(hashes), num_partitions,
        _lib.ptr(part) if part is not None else None, _lib.stream(dev)),
        "murmur3")
    if n:
        _lib.LAUNCHES["murmur3"] += 1
        if any(c.is_string for c in columns):
            _lib.LAUNCHES["hash_string"] += 1
        if any(c.is_two_limb for c in columns):
            _lib.LAUNCHES["decimal128_hash"] += 1
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
