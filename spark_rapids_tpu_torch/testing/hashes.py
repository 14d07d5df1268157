"""Python row oracles of the three hashes, for checks independent of the
port's kernels and their plain versions.

Copied from ``spark_rapids_tpu/kernels/hash.py`` (``py_murmur3_row``
:342, ``py_xxhash64_row`` :627, ``py_hive_hash_row`` :705), over the
port's types: one row's Python values (None is null) and their SQL types
give Spark's Murmur3Hash (seed 42), XxHash64 (seed 42) or Hive's hash.  A
FLOAT value is taken as a Python float and rounded to float32 here; a
TIMESTAMP is its int microseconds.
"""
from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.kernels.hash import (_M64, _py_fmix, _py_mix_h1,
                                                 _py_rotl64, _py_xx_fmix,
                                                 py_hash_long,
                                                 py_xxhash64_long)

DEFAULT_SEED = 42
XXHASH64_DEFAULT_SEED = 42


def py_hash_int(value: int, seed: int) -> int:
    return _py_fmix(_py_mix_h1(seed, value & 0xFFFFFFFF), 4)


def py_hash_bytes(data: bytes, seed: int) -> int:
    h1 = seed
    n = len(data)
    aligned = n - (n % 4)
    for i in range(0, aligned, 4):
        word = int.from_bytes(data[i : i + 4], "little")
        h1 = _py_mix_h1(h1, word)
    for i in range(aligned, n):
        b = data[i]
        if b >= 128:
            b -= 256  # sign extension
        h1 = _py_mix_h1(h1, b & 0xFFFFFFFF)
    return _py_fmix(h1, n)


def py_murmur3_row(values, dtypes, seed: int = DEFAULT_SEED) -> int:
    """Reference row hash over python values (None = null = skipped)."""
    import struct

    h = seed & 0xFFFFFFFF
    for v, dt in zip(values, dtypes):
        if v is None:
            continue
        if isinstance(dt, T.BooleanType):
            h = py_hash_int(1 if v else 0, h)
        elif isinstance(dt, (T.ByteType, T.ShortType, T.IntegerType, T.DateType)):
            h = py_hash_int(int(v), h)
        elif isinstance(dt, (T.LongType, T.TimestampType)):
            h = py_hash_long(int(v), h)
        elif isinstance(dt, T.FloatType):
            f = 0.0 if v == 0.0 else float(np.float32(v))
            bits = struct.unpack("<I", struct.pack("<f", f))[0]
            h = py_hash_int(bits, h)
        elif isinstance(dt, T.DoubleType):
            d = 0.0 if v == 0.0 else float(v)
            bits = struct.unpack("<Q", struct.pack("<d", d))[0]
            h = py_hash_long(bits, h)
        elif isinstance(dt, T.StringType):
            h = py_hash_bytes(v.encode("utf-8") if isinstance(v, str) else v, h)
        elif isinstance(dt, T.DecimalType) and not dt.uses_two_limbs:
            h = py_hash_long(int(v), h)
        elif isinstance(dt, T.DecimalType):
            # minimal big-endian two's complement (BigInteger.toByteArray)
            n = max((int(v).bit_length() // 8) + 1, 1)
            h = py_hash_bytes(int(v).to_bytes(n, "big", signed=True), h)
        else:
            raise NotImplementedError(f"py murmur3 for {dt!r}")
    res = h & 0xFFFFFFFF
    return res - (1 << 32) if res >= (1 << 31) else res


def py_xxhash64_int(value, seed):
    h = (seed + 0x27D4EB2F165667C5 + 4) & _M64
    h ^= ((value & 0xFFFFFFFF) * 0x9E3779B185EBCA87) & _M64
    h = (_py_rotl64(h, 23) * 0xC2B2AE3D27D4EB4F + 0x165667B19E3779F9) & _M64
    return _py_xx_fmix(h)


def py_xxhash64_bytes(data: bytes, seed: int) -> int:
    P1, P2, P3, P4, P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                          0x27D4EB2F165667C5)
    n = len(data)
    off = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & _M64
        v2 = (seed + P2) & _M64
        v3 = seed & _M64
        v4 = (seed - P1) & _M64
        while off + 32 <= n:
            for i, v in enumerate((v1, v2, v3, v4)):
                w = int.from_bytes(data[off + i * 8: off + i * 8 + 8],
                                   "little")
                v = (_py_rotl64((v + w * P2) & _M64, 31) * P1) & _M64
                if i == 0:
                    v1 = v
                elif i == 1:
                    v2 = v
                elif i == 2:
                    v3 = v
                else:
                    v4 = v
            off += 32
        h = (_py_rotl64(v1, 1) + _py_rotl64(v2, 7) + _py_rotl64(v3, 12)
             + _py_rotl64(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = (h ^ ((_py_rotl64((v * P2) & _M64, 31) * P1) & _M64)) & _M64
            h = (h * P1 + P4) & _M64
    else:
        h = (seed + P5) & _M64
    h = (h + n) & _M64
    while off + 8 <= n:
        w = int.from_bytes(data[off: off + 8], "little")
        k1 = (_py_rotl64((w * P2) & _M64, 31) * P1) & _M64
        h = (_py_rotl64(h ^ k1, 27) * P1 + P4) & _M64
        off += 8
    if off + 4 <= n:
        w = int.from_bytes(data[off: off + 4], "little")
        h = (_py_rotl64(h ^ ((w * P1) & _M64), 23) * P2 + P3) & _M64
        off += 4
    while off < n:
        h = (_py_rotl64(h ^ ((data[off] * P5) & _M64), 11) * P1) & _M64
        off += 1
    return _py_xx_fmix(h)


def py_xxhash64_row(values, dtypes, seed: int = XXHASH64_DEFAULT_SEED) -> int:
    import struct
    h = seed & _M64
    for v, dt in zip(values, dtypes):
        if v is None:
            continue
        if isinstance(dt, T.BooleanType):
            h = py_xxhash64_int(1 if v else 0, h)
        elif isinstance(dt, (T.ByteType, T.ShortType, T.IntegerType,
                             T.DateType)):
            h = py_xxhash64_int(int(v) & 0xFFFFFFFF, h)
        elif isinstance(dt, (T.LongType, T.TimestampType)):
            h = py_xxhash64_long(int(v), h)
        elif isinstance(dt, T.FloatType):
            f = 0.0 if v == 0.0 else float(np.float32(v))
            h = py_xxhash64_int(
                struct.unpack("<I", struct.pack("<f", f))[0], h)
        elif isinstance(dt, T.DoubleType):
            d = 0.0 if v == 0.0 else float(v)
            h = py_xxhash64_long(
                struct.unpack("<Q", struct.pack("<d", d))[0], h)
        elif isinstance(dt, T.StringType):
            h = py_xxhash64_bytes(
                v.encode("utf-8") if isinstance(v, str) else v, h)
        elif isinstance(dt, T.DecimalType) and not dt.uses_two_limbs:
            h = py_xxhash64_long(int(v), h)
        else:
            raise NotImplementedError(f"py xxhash64 for {dt!r}")
    res = h & _M64
    return res - (1 << 64) if res >= (1 << 63) else res


def py_hive_hash_row(values, dtypes) -> int:
    """Reference row hash over python values (Hive semantics)."""
    import struct as _struct

    def i32(x):
        x &= 0xFFFFFFFF
        return x - (1 << 32) if x >= (1 << 31) else x

    h = 0
    for v, dt in zip(values, dtypes):
        if v is None:
            ch = 0
        elif isinstance(dt, T.BooleanType):
            ch = 1 if v else 0
        elif isinstance(dt, (T.ByteType, T.ShortType, T.IntegerType,
                             T.DateType)):
            ch = int(v)
        elif isinstance(dt, (T.LongType, T.TimestampType)):
            u = int(v) & ((1 << 64) - 1)
            ch = i32(u ^ (u >> 32))
        elif isinstance(dt, T.FloatType):
            f = 0.0 if v == 0.0 else float(np.float32(v))
            ch = i32(_struct.unpack("<I", _struct.pack("<f", f))[0])
        elif isinstance(dt, T.DoubleType):
            d = 0.0 if v == 0.0 else float(v)
            u = _struct.unpack("<Q", _struct.pack("<d", d))[0]
            ch = i32(u ^ (u >> 32))
        elif isinstance(dt, T.StringType):
            ch = 0
            for b in (v.encode("utf-8") if isinstance(v, str) else v):
                sb = b - 256 if b >= 128 else b
                ch = i32(ch * 31 + sb)
        else:
            raise NotImplementedError(f"py hive hash for {dt!r}")
        h = i32(h * 31 + ch)
    return h
