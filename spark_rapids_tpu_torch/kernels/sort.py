"""Sort kernels: stable multi-key lexicographic argsort, Spark ordering.

Counterpart of ``spark_rapids_tpu/kernels/sort.py`` (``SortOrder`` :32,
``sort_indices`` :200, ``sort_batch`` :241) for fixed-width and string
keys, with the key builders ``_data_key_fixed`` :101, ``_null_key`` :117,
``f64_total_order_u64`` :52 (its non-TPU branch) and, in place of
``_string_data_keys`` :160, big-endian 8-byte chunks plus the length.
``f64_injective_u64`` :74 is one bitcast off the TPU (:84-85): the F64
kind's key already is the double's bits in Java's total order.  Ordering follows Spark's
SortExec: ASC NULLS FIRST by default (DESC NULLS LAST), NULLS FIRST/LAST
absolute, doubles in Java's total order (-0.0 < 0.0, NaN above +Inf), and
the sort is stable.  Strings sort in Spark's ``UTF8String.binaryCompare``
order: unsigned bytes, a proper prefix first ("ab" before "ab\0").
Columns hold exactly ``num_rows`` rows, so the reference's liveness key for
padding rows has no counterpart.

A string key is ceil(longest live length / 8) big-endian 8-byte chunks,
zero past the end, and the length as the least significant key: equal
chunks leave only "one string is the other plus zero bytes", which the
length orders.  The longest length is read back once per sort, with the
null counts.

On CUDA tensors ``sort_indices`` runs the LSD radix passes of
``csrc/sort.cu`` (a string column's keys written by ``csrc/strings.cu``)
and counts one launch per call; on CPU tensors it runs the plain version:
the same keys, as order-preserving signed int64 (the CPU has no uint64
compare), each applied with a stable ``torch.sort`` from the least
significant key up.  A Decimal128 key sorts as two words
(``_decimal128_data_keys`` :123): the signed high limb, then the unsigned
low limb (K2: two key kinds of ``csrc/sort.cu``; every launch over one of
them also counts as ``decimal128_sort_key``).  ``order_words`` writes the
range sort's per-row key words (the null word, then each key's data words;
``range_sort.py`` ``_encode_fn`` :43).  BYTE and SHORT keys sort as
sign-flipped 1- and 2-byte keys (``_data_key_fixed`` :101 over int8 and
int16): one or two digit passes, not four.

The split-tolerant grouping key (``_string_hash_key`` :183, behind
``sort_indices(..., hash_string_keys=True)`` :200): one uint64 per string
row, the FNV-1a fold (offset basis 14695981039346656037, prime
1099511628211) of the reference's ``_string_data_keys`` chunks (7 bytes a
chunk in 9-bit lanes, byte + 1, 0 past the end) over ceil(longest / 7)
chunks, the longest live key of the column (so equal strings of a batch
always hash equal); 0 on a null row.  A string key then sorts as (its null
key, that word), one pass of 8 digits instead of ceil(longest / 8) chunk
passes and a length pass: equal keys contiguous, up to a collision that
interleaves two keys, which a caller that compares the bytes at its
boundaries (``group_rows(..., allow_split_groups=True)``) turns into a
split group, never a merged one.  K3, ``string_hash_key``, computes it
on the card (``csrc/sort.cu``).  Struct keys are not ported.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.selection import gather_batch

# key kinds of csrc/sort.cu, and their key widths in bytes (a string column
# is -1 here: its keys are _RAW_U32 lengths and _RAW_U64 chunks)
_INT32, _INT64, _F64, _BOOL, _RAW_U32, _RAW_U64 = 0, 1, 2, 3, 4, 5
_DEC128_HI, _DEC128_LO, _INT8, _INT16 = 6, 7, 8, 9
_STRING = -1
_KEY_BYTES = {_INT32: 4, _INT64: 8, _F64: 8, _BOOL: 1, _STRING: 8,
              _DEC128_HI: 8, _INT8: 1, _INT16: 2}
_F64_MAGNITUDE = 0x7FFFFFFFFFFFFFFF
_SIGN64 = -2**63
CHUNK_BYTES = 8
#: the hash key's chunks: 7 bytes in 9-bit lanes (the reference's
#: BYTES_PER_CHUNK), folded by FNV-1a
HASH_CHUNK_BYTES = 7
FNV_OFFSET = 14695981039346656037
FNV_PRIME = 1099511628211


class SortOrder:
    """Direction + null placement of one sort key."""

    def __init__(self, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.ascending = ascending
        # Spark default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = nulls_first if nulls_first is not None else ascending

    def __repr__(self):
        return (f"{'ASC' if self.ascending else 'DESC'} "
                f"NULLS {'FIRST' if self.nulls_first else 'LAST'}")


def _kind(dtype: T.DataType) -> int:
    if T.two_limbs(dtype):
        return _DEC128_HI
    if isinstance(dtype, (T.IntegerType, T.DateType)):
        return _INT32
    if isinstance(dtype, (T.LongType, T.DecimalType, T.TimestampType)):
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
    raise T.key_type_not_ported(dtype, "sort key")


def string_chunks(longest: int) -> int:
    """Chunks of a string key whose longest live string has this length."""
    return -(-longest // CHUNK_BYTES)


def hash_chunks(longest: int) -> int:
    """The hash key's chunks for a longest live string of this length (at
    least one: the reference's ``max(1, ceil(max_bytes / 7))``)."""
    return max(1, -(-longest // HASH_CHUNK_BYTES))

# ---------------------------------------------------------------------------
# plain version


def data_key_plain(col: DeviceColumn, order: SortOrder) -> torch.Tensor:
    """int64 key whose signed order is the reference's uint64 key order
    (the uint64 key is this key with its sign bit flipped)."""
    kind = _kind(col.dtype)
    if kind == _F64:
        bits = col.data.view(torch.int64)
        k = torch.where(bits < 0, bits ^ _F64_MAGNITUDE, bits)
    else:
        k = col.data.to(torch.int64)
    if not order.ascending:
        k = ~k
    # null rows get a constant so they never perturb less-significant keys
    return torch.where(col.validity, k, torch.zeros((), dtype=torch.int64,
                                                    device=k.device))


def decimal128_sort_keys_plain(col: DeviceColumn, order: SortOrder
                               ) -> torch.Tensor:
    """K2's plain version, int64 [2, n]: the uint64 bits of a Decimal128
    column's order words, the high limb with its sign bit flipped, then the
    low limb; complemented for DESC, 0 on a null row.  On the card the
    words are key kinds of the radix sort's, the order words' and the
    join's key kernels (``_DEC128_HI``, ``_DEC128_LO``)."""
    words = torch.stack([col.data[:, 1] ^ _SIGN64, col.data[:, 0]])
    if not order.ascending:
        words = ~words
    return torch.where(col.validity, words, 0)


def string_sort_keys_plain(col: DeviceColumn, longest: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``string_sort_keys``: int64 tensors holding the
    chunks' uint64 bits (int64 shifts wrap as uint64 ones do)."""
    nchunks = string_chunks(longest)
    tile = col.byte_tile(CHUNK_BYTES * nchunks).to(torch.int64)
    chunks = torch.zeros((nchunks, col.num_rows), dtype=torch.int64,
                         device=tile.device)
    for c in range(nchunks):
        for j in range(CHUNK_BYTES):
            chunks[c] = (chunks[c] << 8) | tile[:, CHUNK_BYTES * c + j]
    return chunks, (col.offsets[1:] - col.offsets[:-1]).to(torch.int32)


def _string_sort_keys_cuda(col: DeviceColumn, longest: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("string_sort_keys", col.offsets, col.data,
                      col.validity)
    n = col.num_rows
    nchunks = string_chunks(longest)
    chunks = torch.empty((nchunks, n), dtype=torch.int64, device=col.device)
    lengths = torch.empty(n, dtype=torch.int32, device=col.device)
    _lib.check(_lib.lib().srt_string_sort_keys(
        _lib.ptr(col.offsets), _lib.ptr(col.data), _lib.ptr(col.validity), n,
        nchunks, _lib.ptr(chunks), _lib.ptr(lengths),
        _lib.stream(col.device)), "string_sort_keys")
    if n:
        _lib.LAUNCHES["string_sort_keys"] += 1
    return chunks, lengths


def string_sort_keys(col: DeviceColumn, longest: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A string column's sort keys: ([ceil(longest / 8), n] big-endian
    8-byte chunks, zero past the end, as uint64 bits in int64; int32
    lengths); a null row's are 0.  ``longest`` covers the longest valid
    row."""
    if col.device.type == "cpu":
        return string_sort_keys_plain(col, longest)
    return _string_sort_keys_cuda(col, longest)


def _longest_plain(col: DeviceColumn) -> int:
    lengths = torch.where(col.validity, col.offsets[1:] - col.offsets[:-1], 0)
    return int(lengths.max()) if col.num_rows else 0


def _string_longest_cuda(cols: Sequence[DeviceColumn]) -> List[int]:
    dev = cols[0].device
    out = torch.empty(len(cols), dtype=torch.int64, device=dev)
    for j, c in enumerate(cols):
        _lib.require_cuda("string_longest", c.offsets, c.validity)
        _lib.check(_lib.lib().srt_string_max_length(
            _lib.ptr(c.offsets), _lib.ptr(c.validity), c.num_rows,
            _lib.ptr(out[j:]), _lib.stream(dev)), "string_longest")
    return out.tolist()


def string_longest(cols: Sequence[DeviceColumn]) -> List[int]:
    """The longest valid length of each string column (0 where none is
    valid): on the card one blocking read for all of them."""
    if not cols:
        return []
    if cols[0].device.type == "cpu":
        return [_longest_plain(c) for c in cols]
    return _string_longest_cuda(cols)


def _signed(u: int) -> int:
    return u - 2**64 if u >= 2**63 else u


def string_hash_key_plain(col: DeviceColumn, nchunks: int) -> torch.Tensor:
    """K3's plain version: int64 [n] holding the uint64 bits of each row's
    FNV-1a fold of ``nchunks`` 9-bit-lane chunks (int64 products wrap as
    uint64 ones do), 0 on a null row."""
    n = col.num_rows
    lengths = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    width = HASH_CHUNK_BYTES * nchunks
    # a column of empty strings has no bytes to index
    tile = (col.byte_tile(width).to(torch.int64) if col.data.numel()
            else torch.zeros((n, width), dtype=torch.int64,
                             device=col.data.device))
    pos = torch.arange(width, device=tile.device)
    lanes = torch.where(pos < lengths[:, None], tile + 1, 0)
    h = torch.full((n,), _signed(FNV_OFFSET), dtype=torch.int64,
                   device=tile.device)
    prime = _signed(FNV_PRIME)
    for c in range(nchunks):
        chunk = torch.zeros(n, dtype=torch.int64, device=tile.device)
        for j in range(HASH_CHUNK_BYTES):
            chunk = (chunk << 9) | lanes[:, HASH_CHUNK_BYTES * c + j]
        h = (h ^ chunk) * prime
    return torch.where(col.validity, h, 0)


def _string_hash_key_cuda(col: DeviceColumn, nchunks: int) -> torch.Tensor:
    _lib.require_cuda("string_hash_key", col.offsets, col.data, col.validity)
    n = col.num_rows
    out = torch.empty(n, dtype=torch.int64, device=col.device)
    _lib.check(_lib.lib().srt_string_hash_key(
        _lib.ptr(col.offsets), _lib.ptr(col.data), _lib.ptr(col.validity), n,
        nchunks, _lib.ptr(out), _lib.stream(col.device)), "string_hash_key")
    if n:
        _lib.LAUNCHES["string_hash_key"] += 1
    return out


def string_hash_key(col: DeviceColumn, nchunks: int) -> torch.Tensor:
    """K3: one split-tolerant grouping word per string row (uint64 bits in
    int64; see the module's docstring), over ``nchunks`` 7-byte chunks,
    which must be the same for every row of the batch."""
    if nchunks < 1:
        raise ValueError(f"string_hash_key: nchunks must be >= 1, got "
                         f"{nchunks}")
    if col.device.type == "cpu":
        return string_hash_key_plain(col, nchunks)
    return _string_hash_key_cuda(col, nchunks)


def string_keys_plain(col: DeviceColumn, order: SortOrder
                      ) -> List[torch.Tensor]:
    """int64 keys of a string column, most significant first: the chunks,
    then the length (signed order = the kernel's unsigned order)."""
    off = col.offsets.to(torch.int64)
    lengths = torch.where(col.validity, off[1:] - off[:-1], 0)
    longest = int(lengths.max()) if col.num_rows else 0
    chunks, lengths = string_sort_keys_plain(col, longest)
    keys = [k ^ _SIGN64 for k in chunks] + [lengths.to(torch.int64)]
    if not order.ascending:
        keys = [~k for k in keys]
    return [torch.where(col.validity, k, 0) for k in keys]


def null_key_plain(col: DeviceColumn, order: SortOrder) -> torch.Tensor:
    return col.validity if order.nulls_first else ~col.validity


def sort_indices_plain(columns: Sequence[DeviceColumn],
                       orders: Sequence[SortOrder],
                       hash_string_keys: bool = False) -> torch.Tensor:
    n = columns[0].num_rows
    perm = torch.arange(n, dtype=torch.int64, device=columns[0].device)
    keys: List[torch.Tensor] = []   # least significant first
    for c, o in zip(reversed(list(columns)), reversed(list(orders))):
        if c.is_string and hash_string_keys:
            data = [string_hash_key_plain(c, hash_chunks(_longest_plain(c)))
                    ^ _SIGN64]
        elif c.is_string:
            data = string_keys_plain(c, o)[::-1]
        elif c.is_two_limb:   # signed order of word ^ sign = its uint64 order
            data = list(decimal128_sort_keys_plain(c, o) ^ _SIGN64)[::-1]
        else:
            data = [data_key_plain(c, o)]
        keys += data + [null_key_plain(c, o).to(torch.int8)]
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm.to(torch.int32)

# ---------------------------------------------------------------------------
# kernel


def _string_key_planes(c: DeviceColumn, longest: int) -> List[tuple]:
    """A string column's passes as (kind, plane, key bytes), least
    significant first: the length on as many bytes as the longest needs,
    then the chunks from last to first."""
    chunks, lengths = string_sort_keys(c, longest)
    passes = [(_RAW_U32, lengths, max(-(-longest.bit_length() // 8), 1))]
    return passes + [(_RAW_U64, chunks[j], 0)
                     for j in reversed(range(chunks.shape[0]))]


def _sort_indices_cuda(columns: Sequence[DeviceColumn],
                       orders: Sequence[SortOrder],
                       hash_string_keys: bool = False) -> torch.Tensor:
    _lib.require_cuda("sort", *(
        t for c in columns for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
    lib = _lib.lib()
    n = columns[0].num_rows
    dev = columns[0].device
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    s = _lib.stream(dev)
    k = len(columns)
    strings = [i for i, c in enumerate(columns) if c.is_string]
    stats = torch.empty(k + len(strings), dtype=torch.int64, device=dev)
    valid = (ctypes.c_void_p * k)(*(c.validity.data_ptr() for c in columns))
    _lib.check(lib.srt_null_counts(k, ctypes.cast(valid, ctypes.c_void_p), n,
                                   _lib.ptr(stats), s), "sort")
    for j, i in enumerate(strings):
        _lib.check(lib.srt_string_max_length(
            _lib.ptr(columns[i].offsets), _lib.ptr(columns[i].validity), n,
            _lib.ptr(stats[k + j:]), s), "sort")
    # the one device->host read of a sort: which columns take a null pass,
    # and how many chunks each string key needs
    host = stats.tolist()
    has_nulls, longest = host[:k], dict(zip(strings, host[k:]))
    ntiles = -(-n // lib.srt_sort_tile())
    nb = 1 << lib.srt_max_radix_bits()
    width = max(_KEY_BYTES[_kind(c.dtype)] for c in columns)
    key_a = torch.empty(n * width, dtype=torch.uint8, device=dev)
    key_b = torch.empty(n * width, dtype=torch.uint8, device=dev)
    hist = torch.empty(nb * ntiles, dtype=torch.int32, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    ids = None
    for i in reversed(range(k)):
        c, o = columns[i], orders[i]
        if c.is_string and hash_string_keys:    # K3: one word, 8 passes
            passes = [(_RAW_U64, string_hash_key(
                c, hash_chunks(longest[i])), 0)]
        elif c.is_string:
            passes = _string_key_planes(c, longest[i])
        elif c.is_two_limb:     # K2: the low word, then the high word
            passes = [(_DEC128_LO, c.data, 0), (_DEC128_HI, c.data, 0)]
        else:
            passes = [(_kind(c.dtype), c.data, 0)]
        for p, (kind, plane, key_bytes) in enumerate(passes):
            # the column's null pass follows its most significant key
            null_pass = p == len(passes) - 1 and has_nulls[i] > 0
            out = torch.empty(n, dtype=torch.int32, device=dev)
            tmp = torch.empty(n, dtype=torch.int32, device=dev)
            _lib.check(lib.srt_sort_column(
                kind, _lib.ptr(plane), _lib.ptr(c.validity),
                int(not o.ascending), int(o.nulls_first), int(null_pass),
                key_bytes, _lib.ptr(ids) if ids is not None else None, n,
                _lib.ptr(key_a), _lib.ptr(key_b), _lib.ptr(out),
                _lib.ptr(tmp), _lib.ptr(hist), _lib.ptr(totals), s), "sort")
            if kind in (_DEC128_HI, _DEC128_LO):
                _lib.LAUNCHES["decimal128_sort_key"] += 1
            ids = out
    _lib.LAUNCHES["sort"] += 1
    return ids


def sort_indices(batch: ColumnarBatch, key_cols: Sequence[int],
                 orders: Sequence[SortOrder],
                 hash_string_keys: bool = False) -> torch.Tensor:
    """Stable argsort of the batch's rows by the given key columns (most
    significant first): int32 row ids in sorted order.
    ``hash_string_keys``: a string key sorts by its null key and its K3
    word (``string_hash_key``), which keeps equal strings contiguous up to
    a collision and does not give byte order (the reference's option)."""
    if not key_cols or len(key_cols) != len(orders):
        raise ValueError("sort_indices needs one SortOrder per key column, "
                         "and at least one key")
    columns = [batch.columns[c] for c in key_cols]
    for c in columns:
        _kind(c.dtype)
    if batch.num_rows >= 2**31:
        raise ValueError("sort_indices: int32 row ids need n < 2**31")
    if columns[0].device.type == "cpu":
        return sort_indices_plain(columns, orders, hash_string_keys)
    return _sort_indices_cuda(columns, orders, hash_string_keys)


def sort_batch(batch: ColumnarBatch, key_cols: Sequence[int],
               orders: Sequence[SortOrder]) -> ColumnarBatch:
    return gather_batch(batch, sort_indices(batch, key_cols, orders))

# ---------------------------------------------------------------------------
# order words of the range sort


def _data_word_plain(col: DeviceColumn) -> torch.Tensor:
    """The key kernel's ascending uint64 word of a fixed-width key, as
    int64 bits."""
    kind = _kind(col.dtype)
    if kind == _INT32:
        return (col.data.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    if kind == _INT8:
        return (col.data.to(torch.int64) & 0xFF) ^ 0x80
    if kind == _INT16:
        return (col.data.to(torch.int64) & 0xFFFF) ^ 0x8000
    if kind == _INT64:
        return col.data ^ _SIGN64
    if kind == _F64:
        bits = col.data.view(torch.int64)
        return torch.where(bits < 0, ~bits, bits | _SIGN64)
    return (col.data != 0).to(torch.int64)


def order_words_plain(col: DeviceColumn, order: SortOrder,
                      nchunks: int = 0) -> torch.Tensor:
    """int64 [1 + w, n]: uint64 bits of the null word (1 sorts after 0),
    then the key's w data words: 1 for a fixed-width key, 2 for a
    Decimal128, ``nchunks`` chunks and the length for a string; DESC
    complements the data words, and a null row's are 0."""
    null = (col.validity if order.nulls_first else ~col.validity).to(
        torch.int64)
    if col.is_two_limb:
        return torch.cat([null[None], decimal128_sort_keys_plain(col, order)])
    if col.is_string:
        chunks, lengths = string_sort_keys_plain(col, CHUNK_BYTES * nchunks)
        data = torch.cat([chunks, lengths.to(torch.int64)[None]])
    else:
        data = _data_word_plain(col)[None]
    if not order.ascending:
        data = ~data
    return torch.cat([null[None], torch.where(col.validity, data, 0)])


def _order_words_cuda(col: DeviceColumn, order: SortOrder,
                      nchunks: int) -> torch.Tensor:
    _lib.require_cuda("order_words", col.data, col.validity)
    lib = _lib.lib()
    n, dev = col.num_rows, col.device
    if col.is_string:
        chunks, lengths = string_sort_keys(col, CHUNK_BYTES * nchunks)
        planes = [(_RAW_U64, chunks[j]) for j in range(nchunks)] + \
            [(_RAW_U32, lengths)]
    elif col.is_two_limb:
        planes = [(_DEC128_HI, col.data), (_DEC128_LO, col.data)]
    else:
        planes = [(_kind(col.dtype), col.data)]
    out = torch.empty((1 + len(planes), n), dtype=torch.int64, device=dev)
    for j, (kind, plane) in enumerate(planes):
        _lib.check(lib.srt_order_words(
            kind, _lib.ptr(plane), _lib.ptr(col.validity),
            int(not order.ascending), int(order.nulls_first), n,
            _lib.ptr(out[0]) if j == 0 else None, _lib.ptr(out[1 + j]),
            _lib.stream(dev)), "order_words")
        if n and kind in (_DEC128_HI, _DEC128_LO):
            _lib.LAUNCHES["decimal128_sort_key"] += 1
    if n:
        _lib.LAUNCHES["order_words"] += 1
    return out


def order_words(col: DeviceColumn, order: SortOrder,
                nchunks: int = 0) -> torch.Tensor:
    """The range sort's words of one key column (see
    ``order_words_plain``); a string key takes ``nchunks`` chunks, which
    must cover its longest valid row."""
    _kind(col.dtype)
    if col.device.type == "cpu":
        return order_words_plain(col, order, nchunks)
    return _order_words_cuda(col, order, nchunks)
