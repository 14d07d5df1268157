"""Bloom filter build and probe with Spark's BloomFilterImpl semantics.

Counterpart of ``spark_rapids_tpu/kernels/bloom.py`` (``optimal_num_bits``
:37, ``optimal_num_hashes`` :48, ``_bit_positions`` :56, ``build_bits``
:71, ``might_contain`` :87, ``serialize`` :98, ``deserialize`` :112,
``py_bit_positions`` :126, ``PyBloomFilter`` :144).  Spark's putLong:
``h1 = murmur3(v, 0)``, ``h2 = murmur3(v, h1)``; for i in 1..k,
``combined = h1 + i * h2`` in int32, ``~combined`` if negative, bit
``combined % numBits``.

The port keeps the bits on the card as Spark's ``BitArray``: int64 words,
bit b in word b // 64 at b % 64 (the reference keeps a ``bool[numBits]``
vector and packs it only to serialize).  ``bloom_put`` (B1) ORs a LONG
column's bits into the words in place, so later batches OR into the same
words; ``bloom_probe`` (B2) reads them.  On CUDA tensors each launches its
kernel of ``csrc/sketch.cu`` and counts the launch; on CPU tensors it runs
the plain version beside it, in int64 lanes holding uint32 values
(``kernels/hash.py`` ``_hash_long``).  ``words_to_bits`` / ``bits_to_words``
convert between the words and the ``bool[numBits]`` of ``PyBloomFilter``,
the host container and oracle, which ``serialize`` writes as Spark's wire
stream (version 1, big-endian).
"""
from __future__ import annotations

import math
import struct
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.hash import _M32, _hash_long, py_hash_long

BLOOM_PUT = "bloom_put"
BLOOM_PROBE = "bloom_probe"


def optimal_num_bits(expected_items: int, fpp: float = 0.03) -> int:
    """Spark BloomFilter.optimalNumOfBits, rounded up to whole 64-bit
    words (BitArray's bitSize(), which the modulo of the walk uses)."""
    n = max(expected_items, 1)
    bits = int(-n * math.log(fpp) / (math.log(2) ** 2))
    return max(64, (bits + 63) // 64 * 64)


def optimal_num_hashes(expected_items: int, num_bits: int) -> int:
    """Spark BloomFilter.optimalNumOfHashFunctions."""
    n = max(expected_items, 1)
    return max(1, int(round(num_bits / n * math.log(2))))


# ---------------------------------------------------------------------------
# plain versions (int64 lanes)


def bit_positions_plain(values: torch.Tensor, num_bits: int,
                        k: int) -> torch.Tensor:
    """int64 [k, n]: each value's k bit indices (Spark's combined-hash
    walk); ``values`` int64."""
    h1 = _hash_long(values, torch.zeros_like(values))
    h2 = _hash_long(values, h1)
    out = []
    for i in range(1, k + 1):
        c = (h1 + i * h2) & _M32
        c = torch.where(c >= 2**31, c - 2**32, c)     # the int32 value
        c = torch.where(c < 0, ~c, c)
        out.append(c % num_bits)
    return torch.stack(out) if out else torch.zeros(
        (0, values.shape[0]), dtype=torch.int64, device=values.device)


def _bit_of(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return ((words[pos >> 6] >> (pos & 63)) & 1) != 0


def bloom_put_plain(words: torch.Tensor, col: DeviceColumn, k: int) -> None:
    num_bits = words.shape[0] * 64
    pos = bit_positions_plain(col.data, num_bits, k)[:, col.validity]
    bits = torch.zeros(num_bits, dtype=torch.bool, device=words.device)
    bits[pos.reshape(-1)] = True
    words |= bits_to_words(bits)


def bloom_probe_plain(words: torch.Tensor, col: DeviceColumn,
                      k: int) -> torch.Tensor:
    hit = col.validity.clone()
    for pos in bit_positions_plain(col.data, words.shape[0] * 64, k):
        hit &= _bit_of(words, pos)
    return hit

# ---------------------------------------------------------------------------
# wrappers


def _check(words: torch.Tensor, col: DeviceColumn, k: int, what: str):
    if words.dtype != torch.int64 or words.dim() != 1 or words.shape[0] < 1:
        raise TypeError(f"{what}: the filter is int64 words [numBits / 64], "
                        f"got {words.dtype} {tuple(words.shape)}")
    if col.data.dtype != torch.int64 or col.data.dim() != 1:
        raise TypeError(f"{what} takes a LONG column, got {col.dtype!r}")
    if k < 1:
        raise ValueError(f"{what}: k = {k} hash functions")


def _bloom_put_cuda(words: torch.Tensor, col: DeviceColumn, k: int) -> None:
    n = col.num_rows
    _lib.check(_lib.lib().srt_bloom_put(
        _lib.ptr(col.data), _lib.ptr(col.validity), n, words.shape[0] * 64,
        k, _lib.ptr(words), _lib.stream(words.device)), BLOOM_PUT)
    if n:
        _lib.LAUNCHES[BLOOM_PUT] += 1


def _bloom_probe_cuda(words: torch.Tensor, col: DeviceColumn,
                      k: int) -> torch.Tensor:
    n = col.num_rows
    out = torch.empty(n, dtype=torch.bool, device=col.device)
    _lib.check(_lib.lib().srt_bloom_probe(
        _lib.ptr(col.data), _lib.ptr(col.validity), n, words.shape[0] * 64,
        k, _lib.ptr(words), _lib.ptr(out), _lib.stream(col.device)),
        BLOOM_PROBE)
    if n:
        _lib.LAUNCHES[BLOOM_PROBE] += 1
    return out


def bloom_put(words: torch.Tensor, col: DeviceColumn, k: int) -> None:
    """B1: OR the k bits of each valid row of a LONG column into
    ``words`` (int64 [numBits / 64]), in place."""
    _check(words, col, k, BLOOM_PUT)
    if words.device.type == "cpu" and col.device.type == "cpu":
        bloom_put_plain(words, col, k)
        return
    _lib.require_cuda(BLOOM_PUT, words, col.data, col.validity)
    _bloom_put_cuda(words, col, k)


def bloom_probe(words: torch.Tensor, col: DeviceColumn,
                k: int) -> torch.Tensor:
    """B2: bool [n], the row is valid and all its k bits are set."""
    _check(words, col, k, BLOOM_PROBE)
    if words.device.type == "cpu" and col.device.type == "cpu":
        return bloom_probe_plain(words, col, k)
    _lib.require_cuda(BLOOM_PROBE, words, col.data, col.validity)
    return _bloom_probe_cuda(words, col, k)

# ---------------------------------------------------------------------------
# host glue: words <-> bits, the wire stream, the oracle


def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """bool [numBits] (a multiple of 64) -> int64 words, bit b in word
    b // 64 at b % 64."""
    lanes = bits.reshape(-1, 64).to(torch.int64)
    words = torch.zeros(lanes.shape[0], dtype=torch.int64, device=bits.device)
    for j in range(64):
        words |= lanes[:, j] << j
    return words


def words_to_bits(words: np.ndarray) -> np.ndarray:
    """int64 / uint64 words -> bool [64 * words] (host)."""
    u = np.asarray(words).astype(np.uint64)
    idx = np.arange(u.shape[0] * 64, dtype=np.uint64)
    return ((u[idx // np.uint64(64)] >> (idx % np.uint64(64)))
            & np.uint64(1)).astype(np.bool_)


def serialize(bits_np: np.ndarray, k: int) -> bytes:
    """Spark BloomFilterImpl.writeTo stream (version 1, big-endian)."""
    num_words = (bits_np.shape[0] + 63) // 64
    words = np.zeros((num_words,), dtype=np.uint64)
    set_idx = np.nonzero(bits_np)[0]
    np.bitwise_or.at(words, set_idx // 64,
                     (np.uint64(1) << (set_idx % 64).astype(np.uint64)))
    return b"".join([struct.pack(">iii", 1, k, num_words),
                     words.astype(">u8").tobytes()])


def deserialize(buf: bytes):
    """-> (bits bool ndarray, k)."""
    version, k, num_words = struct.unpack(">iii", buf[:12])
    if version != 1:
        raise ValueError(f"unsupported bloom version {version}")
    words = np.frombuffer(buf[12:12 + num_words * 8], dtype=">u8")
    return words_to_bits(words.astype(np.uint64)), k


def py_bit_positions(value: int, num_bits: int, k: int):
    h1 = py_hash_long(value, 0)
    h2 = py_hash_long(value, h1)
    h1 = h1 - (1 << 32) if h1 >= (1 << 31) else h1
    h2 = h2 - (1 << 32) if h2 >= (1 << 31) else h2
    out = []
    for i in range(1, k + 1):
        combined = (h1 + i * h2) & 0xFFFFFFFF
        if combined >= (1 << 31):
            combined -= (1 << 32)
        if combined < 0:
            combined = ~combined
        out.append(combined % num_bits)
    return out


class PyBloomFilter:
    """Host container and oracle (what ``DataFrame.build_bloom`` returns)."""

    def __init__(self, num_bits: int, k: int,
                 bits: Optional[np.ndarray] = None):
        self.num_bits = num_bits
        self.k = k
        self.bits = bits if bits is not None \
            else np.zeros((num_bits,), np.bool_)

    def put(self, value: int) -> None:
        for b in py_bit_positions(int(value), self.num_bits, self.k):
            self.bits[b] = True

    def might_contain(self, value: int) -> bool:
        return all(self.bits[b]
                   for b in py_bit_positions(int(value), self.num_bits,
                                             self.k))

    def words(self) -> np.ndarray:
        """The bits as int64 words (the card's layout)."""
        return bits_to_words(torch.from_numpy(
            np.ascontiguousarray(self.bits))).numpy()

    def serialize(self) -> bytes:
        return serialize(self.bits, self.k)

    @staticmethod
    def from_bytes(buf: bytes) -> "PyBloomFilter":
        bits, k = deserialize(buf)
        return PyBloomFilter(bits.shape[0], k, bits)
