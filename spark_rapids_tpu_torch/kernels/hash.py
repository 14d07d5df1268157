"""Spark-exact row hashes (Murmur3, XxHash64, Hive) and partition ids.

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

A TIMESTAMP hashes as a LONG (:113); a FLOAT (all three hashes) as an
int of its bits with -0.0 as 0.0 and every NaN as 0x7FC00000
(``_f32_bits`` :77).

``xxhash64`` (H1; ``xxhash64_fixed_width`` :409, ``xxhash64_string``
:433, ``xxhash64`` :529) is Spark's XxHash64 with seed 42, chained the
same way: 4-byte ints for BOOL, BYTE, SHORT, INT, DATE and FLOAT, 8-byte
longs for LONG, TIMESTAMP, DOUBLE and Decimal64, strings as
hashUnsafeBytes (32-byte stripes into four accumulators, then 8-, 4- and
1-byte tails); a Decimal128 raises, as the reference's does (:429).
``hive_hash`` (H2; ``hive_hash`` :696 over ``_hive_col_hash`` :668) is
Hive's ``h = 31 * h + col_hash`` in int32, a null adding 0: LONG,
TIMESTAMP and DOUBLE fold ``v ^ (v >>> 32)``, a string is the
31-polynomial over its bytes taken as signed; a decimal raises (:692).
``py_xxhash64_row`` and ``py_hive_hash_row`` live in ``testing/hashes.py``;
the scalar ``py_hash_long`` and ``py_xxhash64_long`` they build on, which
the bloom filter's and HyperLogLog++'s host helpers also take, are at the
end of this module.

On CUDA tensors ``murmur3_hash``, ``murmur3_partition``, ``xxhash64`` and
``hive_hash`` launch a kernel of ``csrc/hash.cu`` (all columns in one
launch; pmod fused into murmur3's) and count the launch; on CPU tensors
they run the plain PyTorch version.  The plain versions compute in int64
lanes, because PyTorch on the CPU has no uint32 / uint64 add or shift:
murmur3's and Hive's hold uint32 values under 32-bit masks, xxhash64's the
uint64 bits themselves; int64 adds, multiplies and xors wrap to the same
bits as the unsigned ones, and a logical right shift is an arithmetic
shift with a mask.
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
_CANONICAL_NAN_BITS32 = 0x7FC00000

XXHASH64 = "xxhash64"
HIVE_HASH = "hive_hash"

# column kinds of csrc/hash.cu
(_INT32, _INT64, _F64, _BOOL, _STRING, _DEC128, _INT8, _INT16,
 _F32) = range(9)


def _kind(dtype: T.DataType, what: str = "murmur3") -> int:
    if T.two_limbs(dtype):
        return _DEC128
    if isinstance(dtype, (T.IntegerType, T.DateType)):
        return _INT32
    if isinstance(dtype, (T.LongType, T.DecimalType, T.TimestampType)):
        return _INT64
    if isinstance(dtype, T.FloatType):
        return _F32
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
    raise T.key_type_not_ported(dtype, what)

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


def f32_hash_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding the uint32 bits of floats with -0.0 -> 0.0 and every
    NaN 0x7FC00000."""
    x = torch.where(x == 0.0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    bits = x.view(torch.int32).to(torch.int64) & _M32
    return torch.where(torch.isnan(x),
                       torch.full((), _CANONICAL_NAN_BITS32,
                                  dtype=torch.int64, device=x.device), bits)


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
    elif kind == _F32:
        h = _hash_int(f32_hash_bits(col.data), seeds)
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


def _column_arrays(name: str, columns: Sequence[DeviceColumn]) -> tuple:
    """The launch's host arrays (data, validity and offsets pointers, kinds)
    of ``columns``, as ``void*`` arguments, after the checks."""
    _lib.require_cuda(name, *(
        t for c in columns for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
    lib = _lib.lib()
    if len(columns) > lib.srt_max_hash_cols():
        raise NotImplementedError(
            f"{name}: {len(columns)} columns, at most "
            f"{lib.srt_max_hash_cols()} in one launch")
    k = len(columns)
    data = (ctypes.c_void_p * k)(*(c.data.data_ptr() for c in columns))
    valid = (ctypes.c_void_p * k)(*(c.validity.data_ptr() for c in columns))
    offsets = (ctypes.c_void_p * k)(*(c.offsets.data_ptr() if c.is_string
                                      else None for c in columns))
    kinds = (ctypes.c_int * k)(*(_kind(c.dtype) for c in columns))
    return tuple(ctypes.cast(a, ctypes.c_void_p)
                 for a in (data, valid, offsets, kinds))


def _murmur3_cuda(columns: Sequence[DeviceColumn], seed: int,
                  num_partitions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    arrays = _column_arrays("murmur3", columns)
    lib = _lib.lib()
    n = columns[0].num_rows
    dev = columns[0].device
    hashes = torch.empty(n, dtype=torch.int32, device=dev)
    part = (torch.empty(n, dtype=torch.int32, device=dev)
            if num_partitions else None)
    _lib.check(lib.srt_murmur3(
        len(columns), *arrays, n, seed & _M32,
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


def _check_columns(columns: Sequence[DeviceColumn],
                   name: str = "murmur3") -> None:
    if not columns:
        raise ValueError(f"{name} needs at least one column")
    if len({c.num_rows for c in columns}) != 1:
        raise ValueError(f"{name}: columns differ in length")
    for c in columns:
        kind = _kind(c.dtype, name)
        if (name == XXHASH64 and kind == _DEC128) or (
                name == HIVE_HASH and isinstance(c.dtype, T.DecimalType)):
            raise NotImplementedError(f"{name} for {c.dtype!r}")


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


# ---------------------------------------------------------------------------
# H1: xxhash64.  Plain version: int64 lanes holding the uint64 bits.

XXHASH64_DEFAULT_SEED = 42
_M64 = (1 << 64) - 1


def _i64(v: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


_XP1 = _i64(0x9E3779B185EBCA87)
_XP2 = _i64(0xC2B2AE3D27D4EB4F)
_XP3 = _i64(0x165667B19E3779F9)
_XP4 = _i64(0x85EBCA77C2B2AE63)
_XP5 = _i64(0x27D4EB2F165667C5)


def _lshr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 lanes."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lshr(x, 64 - r)


def _xx_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lshr(h, 33)
    h = h * _XP2
    h = h ^ _lshr(h, 29)
    h = h * _XP3
    return h ^ _lshr(h, 32)


def _xx_round(acc, w: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc + w * _XP2, 31) * _XP1


def _xx_int(v32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashInt of uint32 values (int64 lanes)."""
    h = seed + _i64(0x27D4EB2F165667C5 + 4)
    h = h ^ (v32 * _XP1)
    return _xx_fmix(_rotl64(h, 23) * _XP2 + _XP3)


def _xx_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashLong."""
    h = seed + _i64(0x27D4EB2F165667C5 + 8)
    h = h ^ _xx_round(0, v)
    return _xx_fmix(_rotl64(h, 27) * _XP1 + _XP4)


def xxhash64_fixed_width(col: DeviceColumn,
                         seeds: torch.Tensor) -> torch.Tensor:
    """Chain one fixed-width column into the running hashes; null rows
    keep their seed."""
    kind = _kind(col.dtype, XXHASH64)
    if kind == _INT64:
        h = _xx_long(col.data, seeds)
    elif kind == _F64:
        h = _xx_long(f64_hash_bits(col.data), seeds)
    elif kind == _F32:
        h = _xx_int(f32_hash_bits(col.data), seeds)
    elif kind in (_INT32, _INT8, _INT16, _BOOL):
        h = _xx_int(col.data.to(torch.int64) & _M32, seeds)
    else:
        raise NotImplementedError(f"xxhash64 for {col.dtype!r}")
    return torch.where(col.validity, h, seeds)


def _byte_at(tile: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int64 of each row's byte at ``pos`` (clamped into the tile)."""
    pos = pos.clamp(max=tile.shape[1] - 1)[:, None]
    return torch.gather(tile, 1, pos)[:, 0].to(torch.int64)


def xxhash64_string(col: DeviceColumn, seeds: torch.Tensor) -> torch.Tensor:
    """Chain a string column (XXH64.hashUnsafeBytes) into the running
    hashes; null rows keep their seed.  The rows' bytes in a [n, width]
    tile; each step applied where the row is long enough."""
    lengths = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    longest = int(lengths.max()) if col.num_rows else 0
    tile = col.byte_tile(max(-(-longest // 8) * 8, 8))

    def word(k: int) -> torch.Tensor:   # little-endian 8 bytes at 8k
        w = tile[:, 8 * k].to(torch.int64)
        for b in range(1, 8):
            w = w | (tile[:, 8 * k + b].to(torch.int64) << (8 * b))
        return w

    words = [word(k) for k in range(longest // 8)]
    full = lengths // 32
    v = [seeds + _i64(0x9E3779B185EBCA87 + 0xC2B2AE3D27D4EB4F),
         seeds + _XP2, seeds, seeds + _i64(-0x9E3779B185EBCA87)]
    for s in range(longest // 32):
        use = s < full
        v = [torch.where(use, _xx_round(v[j], words[4 * s + j]), v[j])
             for j in range(4)]
    big = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
           + _rotl64(v[3], 18))
    for acc in v:
        big = (big ^ _xx_round(0, acc)) * _XP1 + _XP4
    h = torch.where(lengths >= 32, big, seeds + _XP5) + lengths
    done = lengths // 8
    for k in range(longest // 8):
        tail = (k >= 4 * full) & (k < done)
        h = torch.where(tail, _rotl64(h ^ _xx_round(0, words[k]), 27) * _XP1
                        + _XP4, h)
    off = 8 * done
    has4 = lengths - off >= 4
    w4 = (_byte_at(tile, off) | (_byte_at(tile, off + 1) << 8)
          | (_byte_at(tile, off + 2) << 16) | (_byte_at(tile, off + 3) << 24))
    h = torch.where(has4, _rotl64(h ^ (w4 * _XP1), 23) * _XP2 + _XP3, h)
    off = off + 4 * has4.to(torch.int64)
    for i in range(3):   # fewer than 4 bytes remain
        b = _byte_at(tile, off + i)
        h = torch.where(off + i < lengths,
                        _rotl64(h ^ (b * _XP5), 11) * _XP1, h)
    return torch.where(col.validity, _xx_fmix(h), seeds)


def xxhash64_plain(columns: Sequence[DeviceColumn],
                   seed: int = XXHASH64_DEFAULT_SEED) -> torch.Tensor:
    n = columns[0].num_rows
    h = torch.full((n,), _i64(seed), dtype=torch.int64,
                   device=columns[0].device)
    for c in columns:
        h = (xxhash64_string(c, h) if c.is_string
             else xxhash64_fixed_width(c, h))
    return h


def _xxhash64_cuda(columns: Sequence[DeviceColumn],
                   seed: int) -> torch.Tensor:
    arrays = _column_arrays(XXHASH64, columns)
    lib = _lib.lib()
    n, dev = columns[0].num_rows, columns[0].device
    hashes = torch.empty(n, dtype=torch.int64, device=dev)
    _lib.check(lib.srt_xxhash64(len(columns), *arrays, n, seed & _M64,
                                _lib.ptr(hashes), _lib.stream(dev)), XXHASH64)
    if n:
        _lib.LAUNCHES[XXHASH64] += 1
    return hashes


def xxhash64(columns: Sequence[DeviceColumn],
             seed: int = XXHASH64_DEFAULT_SEED) -> torch.Tensor:
    """int64 row hashes, Spark XxHash64 semantics (H1)."""
    _check_columns(columns, XXHASH64)
    if columns[0].device.type == "cpu":
        return xxhash64_plain(columns, seed)
    return _xxhash64_cuda(columns, seed)

# ---------------------------------------------------------------------------
# H2: Hive.  Plain version: int64 lanes holding uint32 values.


def _fold64(v: torch.Tensor) -> torch.Tensor:
    """The low word of v ^ (v >>> 32), as uint32."""
    return (v ^ (v >> 32)) & _M32


def hive_column_hash(col: DeviceColumn) -> torch.Tensor:
    """Each row's Hive hash of one column (uint32 values in int64), 0 for
    a null."""
    kind = _kind(col.dtype, HIVE_HASH)
    if kind == _STRING:
        lengths = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
        longest = int(lengths.max()) if col.num_rows else 0
        tile = col.byte_tile(longest).to(torch.int64)
        h = torch.zeros(col.num_rows, dtype=torch.int64, device=col.device)
        for i in range(longest):
            b = tile[:, i]
            signed = torch.where(b >= 128, b - 256, b)
            h = torch.where(i < lengths, (h * 31 + signed) & _M32, h)
    elif kind == _INT64:
        h = _fold64(col.data)
    elif kind == _F64:
        h = _fold64(f64_hash_bits(col.data))
    elif kind == _F32:
        h = f32_hash_bits(col.data)
    else:   # bool, int8, int16, int32: the value
        h = col.data.to(torch.int64) & _M32
    return torch.where(col.validity, h, 0)


def hive_hash_plain(columns: Sequence[DeviceColumn]) -> torch.Tensor:
    h = torch.zeros(columns[0].num_rows, dtype=torch.int64,
                    device=columns[0].device)
    for c in columns:
        h = (h * 31 + hive_column_hash(c)) & _M32
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def _hive_hash_cuda(columns: Sequence[DeviceColumn]) -> torch.Tensor:
    arrays = _column_arrays(HIVE_HASH, columns)
    lib = _lib.lib()
    n, dev = columns[0].num_rows, columns[0].device
    hashes = torch.empty(n, dtype=torch.int32, device=dev)
    _lib.check(lib.srt_hive_hash(len(columns), *arrays, n, _lib.ptr(hashes),
                                 _lib.stream(dev)), HIVE_HASH)
    if n:
        _lib.LAUNCHES[HIVE_HASH] += 1
    return hashes


def hive_hash(columns: Sequence[DeviceColumn]) -> torch.Tensor:
    """int32 row hashes, Hive's bucketing hash (H2)."""
    _check_columns(columns, HIVE_HASH)
    if columns[0].device.type == "cpu":
        return hive_hash_plain(columns)
    return _hive_hash_cuda(columns)


# ---------------------------------------------------------------------------
# host scalar hashes: one Python int at a time (the bloom filter's and
# HyperLogLog++'s host helpers; testing/hashes.py's row oracles build on
# them)


def _py_rotl(x: int, r: int) -> int:
    x &= 0xFFFFFFFF
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def _py_mix_k1(k1: int) -> int:
    k1 = (k1 * 0xCC9E2D51) & 0xFFFFFFFF
    k1 = _py_rotl(k1, 15)
    k1 = (k1 * 0x1B873593) & 0xFFFFFFFF
    return k1


def _py_mix_h1(h1: int, k1: int) -> int:
    h1 = (h1 ^ _py_mix_k1(k1)) & 0xFFFFFFFF
    h1 = _py_rotl(h1, 13)
    h1 = (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF
    return h1


def _py_fmix(h1: int, length: int) -> int:
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    return h1


def py_hash_long(value: int, seed: int) -> int:
    value &= 0xFFFFFFFFFFFFFFFF
    h1 = _py_mix_h1(seed, value & 0xFFFFFFFF)
    h1 = _py_mix_h1(h1, value >> 32)
    return _py_fmix(h1, 8)


def _py_rotl64(x, r):
    x &= _M64
    return ((x << r) | (x >> (64 - r))) & _M64


def _py_xx_fmix(h):
    h &= _M64
    h ^= h >> 33
    h = (h * 0xC2B2AE3D27D4EB4F) & _M64
    h ^= h >> 29
    h = (h * 0x165667B19E3779F9) & _M64
    h ^= h >> 32
    return h


def py_xxhash64_long(value, seed):
    h = (seed + 0x27D4EB2F165667C5 + 8) & _M64
    k1 = (_py_rotl64((value & _M64) * 0xC2B2AE3D27D4EB4F, 31)
          * 0x9E3779B185EBCA87) & _M64
    h = (_py_rotl64(h ^ k1, 27) * 0x9E3779B185EBCA87
         + 0x85EBCA77C2B2AE63) & _M64
    return _py_xx_fmix(h)
