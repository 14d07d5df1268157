"""Join kernels: the inner, left, right, full, left semi and left anti
joins on one fixed-width key or on several keys, strings among them, the
cross join, and the final maps of a join with a residual condition.

Counterpart of ``spark_rapids_tpu/kernels/join.py``
(``conditional_join_maps`` :44, ``join_path`` :134, ``_probe_single``
:154, ``_expand_single`` :226, ``_probe_cross`` :250, ``_expand_cross``
:260, ``_probe_multi`` :275 with its right and full branches :393-416,
``_expand_multi`` :420 with :445-452, ``join_probe`` :457,
``join_expand`` :484, ``join_gather_maps`` :496, ``apply_gather_maps``
:521) for every join type but the existence join.
Spark's semantics hold: a null in any key never matches, NaN
matches NaN and -0.0 matches 0.0 (keys are normalized), an int key matches
a long key by value, strings match byte for byte, and the pairs come out
in stream-row order, each row's matches in build-row order, as the
reference's do.

The build side is sorted once per join (``build_side``).  On one
fixed-width key (the reference's 'single' path) it is the normalized key
ordered by the ported radix ``sort_indices``, nulls last, written as
uint64 order keys.  On several keys or a string key ('multi') it is
ordered by (any key null, the keys) and each sorted row's key tuple
becomes a row of uint64 order words (a string key: its big-endian 8-byte
chunks, then its length; a Decimal128 key: the two words of
``kernels/sort.py`` ``decimal128_sort_keys_plain``, the high limb with its
sign bit flipped, then the low limb; each key-word launch over one counts
as ``decimal128_sort_key`` too), where the reference sorts both sides
together.  A Decimal128 key always takes the 'multi' path.
Each stream batch is then probed (``join_probe``: a lower and an upper
bound per row, the exclusive scan of the match counts, one blocking read
of the number of pairs) and expanded (``join_expand``: each row writes its
``(li, ri = perm[lo + j])`` pairs; both paths share it).  The maps have
exactly as many pairs as the join outputs, so there is no capacity retry;
``apply_gather_maps`` is the ported gather on each side.

The left join (the reference's left branches, :203-206 and :237-246 of
the single-key path, :395 of the several-key one) probes with a left flag:
a stream row with no match, a null key included, gets one output row whose
right index is -1, and the gather makes that row's right columns null.

The right and full joins (K1; the reference's right and full branches of
``_probe_multi`` :393-416 and ``_expand_multi`` :445-452) probe as the
inner and the left join do, and the expand also sets a byte flag for each
build row it writes a pair for (``matched``, bool [build rows], zeroed once
per build and set by every stream group; many pairs may store the same 1,
which needs no atomics).  After the last stream group the unmatched build
rows, compacted in build-row order by the ported ``compaction_map``
(``unmatched_build_rows``), are appended with right index their row and
left index -1.  So the maps are the reference's: the left-driven pairs in
stream-row order, each row's matches in build-row order, then the
unmatched right rows in right-row order.  The reference sends right and
full joins down its several-key path on any key; the port keeps its
sorted build, which gives the same maps.

The cross join (K2, ``cross_join_maps``; the reference's ``_probe_cross``
:250 and ``_expand_cross`` :260) writes ``li = k / nr, ri = k % nr`` for
``k < nl * nr``; the same pairs are the candidates of a keyless join with
a condition.

The semi and anti joins (the reference's :197-201, :212 and :231-233 of
the single-key path, :397-400 and :440-441 of the several-key one) probe
in a mode of their own: a stream row needs only the lower bound and one
comparison, and its count is 1 where it is kept (semi: it has a match;
anti: it has none, a null key included) and 0 elsewhere.  The scan makes
the offsets, and the left-only expand (``join_expand`` of a semi or anti
join) writes each kept row's index at its offset: the rows in stream
order, each once, and no right map (an empty ``ri``); the gather takes
the left columns alone.

A join with a residual condition takes its candidates from the inner
probe and expand, evaluates the condition over them (in the exec), and
``conditional_join_maps`` turns the candidates and their pass mask into
the final maps of any join type: the passing pairs in candidate order,
then the unmatched live left rows (left, full), then the unmatched live
right rows (right, full); semi, anti and existence keep left rows only.
A right or full join whose stream comes in several groups passes its
build's ``matched`` flags as ``rmatched``: each call then ORs its passing
pairs' right rows into them and leaves the right rows out, and the caller
appends the unmatched ones once, after the last group (a build row that
passes only in a later group must not be null-extended in an earlier
one).

BYTE and SHORT keys are sign-extended order keys like INT's.

On CUDA tensors each step launches its kernel of ``csrc/join.cu`` and
counts the launch; on CPU tensors it runs the plain PyTorch version
beside it.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.groupby import normalize_key_column
from spark_rapids_tpu_torch.kernels.selection import (compaction_map,
                                                      gather_columns)
from spark_rapids_tpu_torch.kernels.sort import (SortOrder, sort_indices,
                                                 string_chunks,
                                                 string_longest,
                                                 string_sort_keys_plain)

JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "cross", "existence")

# key kinds of csrc/join.cu
_INT32, _INT64, _F64, _BOOL, _STRING, _DEC128, _INT8, _INT16 = range(8)
_SIGN64 = -2**63
_NULLS_LAST = SortOrder(True, False)


def _kind(dtype: T.DataType) -> int:
    if T.two_limbs(dtype):
        return _DEC128
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
    raise T.key_type_not_ported(dtype, "a join key")


def _check_key_types(lt: T.DataType, rt: T.DataType) -> None:
    """Both keys compare as one type: equal types, or int with long."""
    ints = (T.INT, T.LONG)
    if lt != rt and not (lt in ints and rt in ints):
        raise NotImplementedError(
            f"a join of a {lt!r} key with a {rt!r} key is not ported")
    _kind(lt)


#: the join types whose probe and expand are ported, and the probe's mode
#: for each (csrc/join.cu): a right join probes as the inner join, a full
#: join as the left join
PROBE_TYPES = ("inner", "left", "left_semi", "left_anti", "right", "full")
_MODES = {"inner": 0, "left": 1, "left_semi": 2, "left_anti": 3,
          "right": 0, "full": 1}
#: the join types whose output is the stream rows alone
LEFT_ONLY = ("left_semi", "left_anti")
#: the join types that append the build rows no stream row matched
OUTER = ("right", "full")
# the launch counter of each probe mode, after the kernel's name
_MODE_SUFFIX = {"inner": "", "left": "_left", "left_semi": "_semi",
                "left_anti": "_anti", "right": "", "full": "_left"}


def join_path(left: ColumnarBatch, left_keys: Sequence[int],
              right: ColumnarBatch, right_keys: Sequence[int],
              join_type: str) -> str:
    """The reference's kernel-path dispatch ('cross' | 'single' |
    'multi'; right and full joins take 'multi').  Every path is ported;
    the port's build picks its own layout from the keys (``build_side``),
    so only 'cross' changes what runs."""
    if join_type == "cross":
        return "cross"
    if (join_type in ("inner", "left", "left_semi", "left_anti")
            and len(left_keys) == 1
            and _single(left, left_keys) and _single(right, right_keys)):
        return "single"
    return "multi"


def require_probe_type(join_type: str) -> None:
    if join_type not in PROBE_TYPES:
        raise NotImplementedError(f"the {join_type} join is not ported; "
                                  f"only {', '.join(PROBE_TYPES)}")

# ---------------------------------------------------------------------------
# conditional join maps

# per join type: (segments: 1 pairs, 2 left rows, 4 right rows; which left
# rows: 0 unmatched, 1 matched, -1 every live one)
_COND_SEGMENTS = {"inner": (1, 0), "left": (3, 0), "right": (5, 0),
                  "full": (7, 0), "left_semi": (2, 1), "left_anti": (2, 0),
                  "existence": (2, -1)}


def _check_cond_inputs(li, ri, pass_mask, left_live, right_live,
                       join_type) -> None:
    if join_type not in _COND_SEGMENTS:
        raise ValueError(f"conditional_join_maps: join type {join_type!r} "
                         f"is none of {sorted(_COND_SEGMENTS)}")
    for name, t, dt in (("li", li, torch.int32), ("ri", ri, torch.int32),
                        ("pass_mask", pass_mask, torch.bool),
                        ("left_live", left_live, torch.bool),
                        ("right_live", right_live, torch.bool)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"conditional_join_maps: {name} must be 1-d "
                            f"{dt}, got {t.dtype} {tuple(t.shape)}")
    if not li.shape == ri.shape == pass_mask.shape:
        raise ValueError("conditional_join_maps: li, ri and pass_mask "
                         "differ in length")


def _cond_segments(join_type: str, rmatched: Optional[torch.Tensor]
                   ) -> Tuple[int, int]:
    """The join type's segments, without the right rows where the caller
    accumulates the right flags across calls."""
    segments, want = _COND_SEGMENTS[join_type]
    return (segments & ~4 if rmatched is not None else segments), want


def conditional_join_maps_plain(li: torch.Tensor, ri: torch.Tensor,
                                pass_mask: torch.Tensor,
                                left_live: torch.Tensor,
                                right_live: torch.Tensor, join_type: str,
                                rmatched: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Flags set through the passing pairs, then the segments selected by
    boolean-mask indexing and concatenated."""
    segments, want = _cond_segments(join_type, rmatched)
    dev = li.device
    lmatched = torch.zeros_like(left_live)
    if rmatched is None:
        rmatched = torch.zeros_like(right_live)
    lmatched[li[pass_mask].long()] = True
    rmatched[ri[pass_mask].long()] = True
    lis: List[torch.Tensor] = []
    ris: List[torch.Tensor] = []
    if segments & 1:
        lis.append(li[pass_mask])
        ris.append(ri[pass_mask])
    if segments & 2:
        mask = left_live if want < 0 else left_live & (lmatched == bool(want))
        rows = torch.arange(left_live.shape[0], dtype=torch.int32,
                            device=dev)[mask]
        lis.append(rows)
        ris.append(torch.full_like(rows, -1))
    if segments & 4:
        rows = torch.arange(right_live.shape[0], dtype=torch.int32,
                            device=dev)[right_live & ~rmatched]
        lis.append(torch.full_like(rows, -1))
        ris.append(rows)
    return torch.cat(lis), torch.cat(ris), lmatched


def _conditional_join_maps_cuda(li, ri, pass_mask, left_live, right_live,
                                join_type, rmatched=None):
    _lib.require_cuda("conditional_join_maps", li, ri, pass_mask, left_live,
                      right_live)
    lib = _lib.lib()
    accumulate = rmatched is not None
    segments, want = _cond_segments(join_type, rmatched)
    dev = li.device
    npairs, nl, nr = li.shape[0], left_live.shape[0], right_live.shape[0]
    tile = lib.srt_cond_join_tile()
    tiles = sum(-(-n // tile) for bit, n in ((1, npairs), (2, nl), (4, nr))
                if segments & bit)
    lmatched = torch.empty(nl, dtype=torch.bool, device=dev)
    if accumulate:
        _lib.require_cuda("conditional_join_maps", rmatched)
    else:
        rmatched = torch.empty(nr, dtype=torch.bool, device=dev)
    tile_counts = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(max(-(-tiles // lib.srt_join_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    s = _lib.stream(dev)
    args = (segments, want, _lib.ptr(pass_mask), _lib.ptr(li), _lib.ptr(ri),
            npairs, _lib.ptr(left_live), nl, _lib.ptr(right_live), nr,
            _lib.ptr(lmatched), _lib.ptr(rmatched), _lib.ptr(tile_counts))
    _lib.check(lib.srt_cond_join_count(*args, _lib.ptr(tile_sums),
                                       _lib.ptr(total), int(accumulate), s),
               "conditional_join_maps")
    _lib.LAUNCHES["conditional_join_maps"] += 1
    # the one device->host read: the number of output rows
    count = int(total.item())
    if count >= 2**31:
        raise ValueError(f"a join batch of {count} rows: int32 row ids need "
                         "fewer than 2**31")
    li2 = torch.empty(count, dtype=torch.int32, device=dev)
    ri2 = torch.empty(count, dtype=torch.int32, device=dev)
    if count:
        _lib.check(lib.srt_cond_join_scatter(*args, _lib.ptr(li2),
                                             _lib.ptr(ri2), s),
                   "conditional_join_maps")
    return li2, ri2, lmatched


def conditional_join_maps(li: torch.Tensor, ri: torch.Tensor,
                          pass_mask: torch.Tensor, left_live: torch.Tensor,
                          right_live: torch.Tensor, join_type: str,
                          rmatched: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The final maps of a join with a residual condition: from candidate
    pairs ``(li, ri)`` (int32) and ``pass_mask`` (the pair is live and its
    condition is true), over ``left_live`` [nl] and ``right_live`` [nr]
    rows, the int32 ``(li2, ri2)`` of the join's rows (-1: null-extend that
    side) and the bool ``lmatched`` [nl], whether a left row has a passing
    pair (the existence join's flag).  ``rmatched`` (bool [nr], right and
    full joins streamed in groups): the passing pairs' right rows are ORed
    into it and the unmatched right rows are left out of the maps, for the
    caller to append after its last group (``unmatched_build_rows``)."""
    _check_cond_inputs(li, ri, pass_mask, left_live, right_live, join_type)
    if rmatched is not None and (rmatched.dtype != torch.bool
                                 or rmatched.shape != right_live.shape):
        raise TypeError("conditional_join_maps: rmatched must be bool "
                        f"[{right_live.shape[0]}]")
    if li.device.type == "cpu":
        return conditional_join_maps_plain(li, ri, pass_mask, left_live,
                                           right_live, join_type, rmatched)
    return _conditional_join_maps_cuda(li, ri, pass_mask, left_live,
                                       right_live, join_type, rmatched)


@dataclasses.dataclass
class JoinBuild:
    """The build side of a join, sorted once: ``perm`` orders its rows by
    key (rows with a null key last); ``keys[i]`` and ``key_valid[i]`` are
    the order key and validity of row ``perm[i]``.  On one fixed-width key
    ``key`` is its ordinal and ``keys`` int64 [nb]; on several keys (the
    'multi' path) ``key`` is a tuple of ordinals, ``keys`` the int64 [nb,
    words] order words, and ``chunks`` holds each key's chunk count (None
    for a fixed-width key)."""

    batch: ColumnarBatch
    key: Union[int, Tuple[int, ...]]
    perm: torch.Tensor         # int32 [nb]
    keys: torch.Tensor         # int64: the kernel's uint64 order keys
    key_valid: torch.Tensor    # bool [nb]
    chunks: Tuple[Optional[int], ...] = ()

    @property
    def num_rows(self) -> int:
        return self.batch.num_rows

    @property
    def multi(self) -> bool:
        return isinstance(self.key, tuple)

# ---------------------------------------------------------------------------
# plain versions


def order_keys_plain(col: DeviceColumn) -> torch.Tensor:
    """The kernel's uint64 order keys, as their bits in int64: integers
    with the sign bit flipped, doubles in Java's total order after -0.0 ->
    0.0 and NaN -> the canonical NaN; 0 on a null row."""
    if col.data.dtype == torch.float64:
        bits = normalize_key_column(col).data.view(torch.int64)
        k = torch.where(bits < 0, ~bits, bits | _SIGN64)
    elif col.data.dtype == torch.bool:
        k = col.data.to(torch.int64)
    else:
        k = col.data.to(torch.int64) ^ _SIGN64
    return torch.where(col.validity, k, 0)


def build_keys_plain(col: DeviceColumn, perm: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    p = perm.long()
    return order_keys_plain(col)[p], col.validity[p]


def _counts_plain(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor,
                  join_type: str) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(int32 first match, int32 offsets, pairs) from the bounds: a null
    row matches nothing; in a left or full join a row with no match gets one pair
    and first match -1; in a semi or anti join a row counts 1 where it is
    kept and there is no first match (an empty tensor)."""
    counts = torch.where(valid, hi - lo, 0)
    lo = torch.where(valid, lo, 0)
    if join_type in LEFT_ONLY:
        counts = ((counts > 0) == (join_type == "left_semi")).to(counts.dtype)
        lo = lo[:0]
    elif _MODES[join_type] == _MODES["left"]:     # left and full
        lo = torch.where(counts > 0, lo, -1)
        counts = counts.clamp(min=1)
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                          device=lo.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return lo.to(torch.int32), offsets.to(torch.int32), int(offsets[-1])


def probe_plain(col: DeviceColumn, build: JoinBuild,
                join_type: str = "inner"
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(int32 first match, int32 offsets [n + 1], pairs): a search of the
    valid prefix of the sorted build keys (signed order of key ^ sign bit
    = unsigned order of the key)."""
    valid_keys = build.keys[:int(build.key_valid.sum())] ^ _SIGN64
    k = order_keys_plain(col) ^ _SIGN64
    lo = torch.searchsorted(valid_keys, k, side="left")
    hi = torch.searchsorted(valid_keys, k, side="right")
    return _counts_plain(lo, hi, col.validity, join_type)


def expand_plain(lo: torch.Tensor, offsets: torch.Tensor, total: int,
                 perm: torch.Tensor,
                 matched: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row's pairs; a row whose first match is -1 (a left join's row
    with no match) gets right index -1; ``matched``: K1's plain version,
    each written pair's build row flagged."""
    counts = (offsets[1:] - offsets[:-1]).long()
    row = torch.repeat_interleave(
        torch.arange(lo.shape[0], device=lo.device), counts)
    within = torch.arange(total, device=lo.device) - offsets[row].long()
    first = lo.long()[row]
    pos = (first + within).clamp(0, max(perm.shape[0] - 1, 0))
    ri = (perm.long()[pos] if perm.shape[0]
          else torch.zeros_like(pos))
    ri = torch.where(first < 0, -1, ri)
    if matched is not None:
        matched[ri[ri >= 0]] = True
    return row.to(torch.int32), ri.to(torch.int32)


def cross_join_maps_plain(nl: int, nr: int, device
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: every (left row, right row) pair, left-major."""
    k = torch.arange(nl * nr, dtype=torch.int64, device=device)
    return (k // max(nr, 1)).to(torch.int32), (k % max(nr, 1)).to(torch.int32)


def expand_left_only_plain(offsets: torch.Tensor, total: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A semi or anti join's map: the rows whose count is 1, in order; no
    right map."""
    kept = offsets[1:] != offsets[:-1]
    li = torch.arange(kept.shape[0], dtype=torch.int32,
                      device=offsets.device)[kept]
    return li, li[:0]


def _all_valid(cols: Sequence[DeviceColumn]) -> torch.Tensor:
    valid = cols[0].validity
    for c in cols[1:]:
        valid = valid & c.validity
    return valid


def key_words_plain(cols: Sequence[DeviceColumn],
                    chunks: Sequence[Optional[int]],
                    perm: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 [n, words] order words as uint64 bits, bool [n] all keys
    valid) of rows ``perm`` (None: every row in order): per key its order
    key, or a string key's ``chunks`` big-endian 8-byte chunks and its
    full length; a row with a null key is all zero."""
    words: List[torch.Tensor] = []
    for c, nch in zip(cols, chunks):
        if c.is_string:
            ch, lengths = string_sort_keys_plain(c, 8 * nch)
            words += list(ch) + [lengths.to(torch.int64)]
        elif c.is_two_limb:
            words += [c.data[:, 1] ^ _SIGN64, c.data[:, 0]]
        else:
            words.append(order_keys_plain(c))
    valid = _all_valid(cols)
    w = torch.stack(words, dim=1)
    if perm is not None:
        p = perm.long()
        w, valid = w[p], valid[p]
    return torch.where(valid[:, None], w, 0), valid


def probe_multi_plain(swords: torch.Tensor, svalid: torch.Tensor,
                      build: JoinBuild, join_type: str = "inner"
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``probe_plain`` over word rows: every row, build and stream, gets
    its rank in the lexicographic order of the word rows (signed order of
    word ^ sign bit = unsigned order of the word), then the stream ranks
    are searched in the build's valid prefix."""
    nvalid = int(build.key_valid.sum())
    rows = torch.cat([build.keys[:nvalid], swords]) ^ _SIGN64
    _, rank = torch.unique(rows, dim=0, return_inverse=True)
    brank, srank = rank[:nvalid].contiguous(), rank[nvalid:].contiguous()
    lo = torch.searchsorted(brank, srank, side="left")
    hi = torch.searchsorted(brank, srank, side="right")
    return _counts_plain(lo, hi, svalid, join_type)

# ---------------------------------------------------------------------------
# kernels


def _build_keys_cuda(col: DeviceColumn, perm: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("join_build", col.data, col.validity, perm)
    n = perm.shape[0]
    keys = torch.empty(n, dtype=torch.int64, device=perm.device)
    key_valid = torch.empty(n, dtype=torch.bool, device=perm.device)
    _lib.check(_lib.lib().srt_join_build_keys(
        _kind(col.dtype), _lib.ptr(col.data), _lib.ptr(col.validity),
        _lib.ptr(perm), n, _lib.ptr(keys), _lib.ptr(key_valid),
        _lib.stream(perm.device)), "join_build")
    if n:
        _lib.LAUNCHES["join_build"] += 1
    return keys, key_valid


def _probe_cuda(col: DeviceColumn, build: JoinBuild,
                join_type: str = "inner"
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    _lib.require_cuda("join_probe", col.data, col.validity, build.keys,
                      build.key_valid)
    lib = _lib.lib()
    n = col.num_rows
    dev = col.device
    # a semi or anti probe writes no first match
    lo = torch.empty(0 if join_type in LEFT_ONLY else n, dtype=torch.int32,
                     device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_join_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    _lib.check(lib.srt_join_probe(
        _kind(col.dtype), _lib.ptr(col.data), _lib.ptr(col.validity), n,
        _lib.ptr(build.keys), _lib.ptr(build.key_valid), build.num_rows,
        _MODES[join_type], _lib.ptr(lo), _lib.ptr(offsets),
        _lib.ptr(tile_sums), _lib.ptr(total), _lib.stream(dev)), "join_probe")
    if n:
        _lib.LAUNCHES["join_probe" + _MODE_SUFFIX[join_type]] += 1
    # the one device->host read of a probe: the number of pairs
    return lo, offsets, int(total.item())


def _key_col_arrays(cols: Sequence[DeviceColumn],
                    chunks: Sequence[Optional[int]]) -> tuple:
    """The ctypes arrays of csrc/join.cu's key columns: kinds, chunk
    counts, data, validity and offsets pointers (the arrays are kept alive
    by the returned tuple)."""
    k = len(cols)
    if k > _lib.lib().srt_join_max_keys():
        raise NotImplementedError(f"a join on {k} keys: at most "
                                  f"{_lib.lib().srt_join_max_keys()}")
    kinds = (ctypes.c_int * k)(*(_kind(c.dtype) for c in cols))
    nch = (ctypes.c_int * k)(*(n or 0 for n in chunks))
    data = (ctypes.c_void_p * k)(*(c.data.data_ptr() for c in cols))
    valid = (ctypes.c_void_p * k)(*(c.validity.data_ptr() for c in cols))
    offs = (ctypes.c_void_p * k)(*(c.offsets.data_ptr() if c.is_string
                                   else None for c in cols))
    arrays = (kinds, nch, data, valid, offs)
    return arrays, [ctypes.cast(a, ctypes.c_void_p) for a in arrays]


def _words(cols: Sequence[DeviceColumn],
           chunks: Sequence[Optional[int]]) -> int:
    return sum(2 if c.is_two_limb else 1 if n is None else n + 1
               for c, n in zip(cols, chunks))


def _count_dec128_words(cols: Sequence[DeviceColumn]) -> None:
    """A key-word launch over a Decimal128 key ran K2's kind as well."""
    if any(c.is_two_limb for c in cols):
        _lib.LAUNCHES["decimal128_sort_key"] += 1


def _multi_build_cuda(cols: Sequence[DeviceColumn], perm: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Tuple[Optional[int], ...]]:
    _lib.require_cuda("join_multi_build", perm, *(
        t for c in cols for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
    strings = [c for c in cols if c.is_string]
    longest = iter(string_longest(strings))
    chunks = tuple(string_chunks(next(longest)) if c.is_string else None
                   for c in cols)
    n, nw = perm.shape[0], _words(cols, chunks)
    words = torch.empty((n, nw), dtype=torch.int64, device=perm.device)
    valid = torch.empty(n, dtype=torch.bool, device=perm.device)
    _keep, arrays = _key_col_arrays(cols, chunks)
    _lib.check(_lib.lib().srt_join_key_words(
        len(cols), *arrays, _lib.ptr(perm), n, nw, _lib.ptr(words),
        _lib.ptr(valid), _lib.stream(perm.device)), "join_multi_build")
    if n:
        _lib.LAUNCHES["join_multi_build"] += 1
        _count_dec128_words(cols)
    return words, valid, chunks


def _multi_probe_cuda(cols: Sequence[DeviceColumn], build: JoinBuild,
                      join_type: str = "inner"
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    _lib.require_cuda("join_multi_probe", build.keys, build.key_valid, *(
        t for c in cols for t in (c.data, c.validity)
        + ((c.offsets,) if c.is_string else ())))
    lib = _lib.lib()
    n, dev = cols[0].num_rows, cols[0].device
    nw = build.keys.shape[1]
    swords = torch.empty((n, nw), dtype=torch.int64, device=dev)
    svalid = torch.empty(n, dtype=torch.bool, device=dev)
    lo = torch.empty(0 if join_type in LEFT_ONLY else n, dtype=torch.int32,
                     device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(max(-(-n // lib.srt_join_scan_tile()), 1),
                            dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    _keep, arrays = _key_col_arrays(cols, build.chunks)
    _lib.check(lib.srt_join_multi_probe(
        len(cols), *arrays, n, nw, _lib.ptr(swords), _lib.ptr(svalid),
        _lib.ptr(build.keys), _lib.ptr(build.key_valid), build.num_rows,
        _MODES[join_type], _lib.ptr(lo), _lib.ptr(offsets),
        _lib.ptr(tile_sums), _lib.ptr(total), _lib.stream(dev)),
        "join_multi_probe")
    if n:
        _lib.LAUNCHES["join_multi_probe" + _MODE_SUFFIX[join_type]] += 1
        _count_dec128_words(cols)
    # the one device->host read of a probe: the number of pairs
    return lo, offsets, int(total.item())


def _expand_cuda(lo: torch.Tensor, offsets: torch.Tensor, total: int,
                 perm: torch.Tensor, matched: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("join_expand", lo, offsets, perm,
                      *(() if matched is None else (matched,)))
    dev = lo.device
    li = torch.empty(total, dtype=torch.int32, device=dev)
    ri = torch.empty(total, dtype=torch.int32, device=dev)
    if total:
        _lib.check(_lib.lib().srt_join_expand(
            _lib.ptr(lo), _lib.ptr(offsets), _lib.ptr(perm), lo.shape[0],
            _lib.ptr(li), _lib.ptr(ri),
            _lib.ptr(matched) if matched is not None else None,
            _lib.stream(dev)), "join_expand")
        _lib.LAUNCHES["join_expand" if matched is None
                      else "join_expand_outer"] += 1
    return li, ri


def _cross_join_maps_cuda(nl: int, nr: int, device
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    total = nl * nr
    li = torch.empty(total, dtype=torch.int32, device=device)
    ri = torch.empty(total, dtype=torch.int32, device=device)
    _lib.require_cuda("join_expand_cross", li, ri)
    if total:
        _lib.check(_lib.lib().srt_join_expand_cross(
            nl, nr, _lib.ptr(li), _lib.ptr(ri), _lib.stream(device)),
            "join_expand_cross")
        _lib.LAUNCHES["join_expand_cross"] += 1
    return li, ri


def _expand_left_only_cuda(offsets: torch.Tensor, total: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("join_expand_left_only", offsets)
    dev = offsets.device
    li = torch.empty(total, dtype=torch.int32, device=dev)
    if total:
        _lib.check(_lib.lib().srt_join_expand_left_only(
            _lib.ptr(offsets), offsets.shape[0] - 1, _lib.ptr(li),
            _lib.stream(dev)), "join_expand_left_only")
        _lib.LAUNCHES["join_expand_left_only"] += 1
    return li, li[:0]

# ---------------------------------------------------------------------------
# the join


def _ordinals(keys: Union[int, Sequence[int]]) -> List[int]:
    return [keys] if isinstance(keys, int) else list(keys)


def _single(batch: ColumnarBatch, keys: Sequence[int]) -> bool:
    """The reference's 'single' path: one key, not a string (nor, in the
    port, a Decimal128: its two words take the 'multi' path)."""
    return len(keys) == 1 and not batch.columns[keys[0]].is_string \
        and not batch.columns[keys[0]].is_two_limb


def build_side(right: ColumnarBatch,
               right_keys: Union[int, Sequence[int]]) -> JoinBuild:
    """Sort the build rows by their normalized keys, rows with a null key
    last, and write the sorted order keys (one key) or order words
    (several keys, or a string key)."""
    keys = _ordinals(right_keys)
    if not keys:
        raise ValueError("a build side needs at least one key")
    cols = [normalize_key_column(right.columns[k]) for k in keys]
    for c in cols:
        _kind(c.dtype)
    n, dev = right.num_rows, cols[0].device
    if _single(right, keys):
        perm = (sort_indices(ColumnarBatch((cols[0],), n, Schema(
            ("k",), (cols[0].dtype,))), [0], [_NULLS_LAST]) if n
            else torch.empty(0, dtype=torch.int32, device=dev))
        return JoinBuild(right, keys[0], perm, *build_keys(cols[0], perm))
    perm = _multi_build_perm(cols)
    words, valid, chunks = build_words(cols, perm)
    return JoinBuild(right, tuple(keys), perm, words, valid, chunks)


def keyless_build(right: ColumnarBatch) -> JoinBuild:
    """The build of a keyless join: its rows as they are, no key."""
    none = torch.empty(0, dtype=torch.int32, device=right.device)
    return JoinBuild(right, (), none, none.to(torch.int64),
                     none.to(torch.bool))


def _multi_build_perm(cols: Sequence[DeviceColumn]) -> torch.Tensor:
    """The build's order: (any key null, the keys), the ported radix sort;
    equal tuples keep their row order."""
    n, dev = cols[0].num_rows, cols[0].device
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    valid = _all_valid(cols)
    null_key = DeviceColumn(~valid, torch.ones_like(valid), T.BOOLEAN)
    work = ColumnarBatch((null_key, *cols), n, Schema(
        tuple(f"k{i}" for i in range(len(cols) + 1)),
        (T.BOOLEAN,) + tuple(c.dtype for c in cols)))
    return sort_indices(work, list(range(len(cols) + 1)),
                        [_NULLS_LAST] * (len(cols) + 1))


def build_words(cols: Sequence[DeviceColumn], perm: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Tuple[Optional[int], ...]]:
    """(int64 [nb, words] order words, bool [nb] all keys valid, chunk
    counts) of the build rows in the order ``perm``; a string key takes as
    many chunks as its longest valid row needs."""
    if cols[0].device.type == "cpu":
        longest = iter(string_longest([c for c in cols if c.is_string]))
        chunks = tuple(string_chunks(next(longest)) if c.is_string
                       else None for c in cols)
        return (*key_words_plain(cols, chunks, perm), chunks)
    return _multi_build_cuda(cols, perm)


def build_keys(col: DeviceColumn, perm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint64 order keys as int64 bits, validity) of the key column's rows
    in the order ``perm``."""
    if col.device.type == "cpu":
        return build_keys_plain(col, perm)
    return _build_keys_cuda(col, perm)


def join_probe(left: ColumnarBatch, left_keys: Union[int, Sequence[int]],
               build: JoinBuild, join_type: str = "inner"
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(int32 first match per stream row, int32 offsets [n + 1] of its
    pairs, the number of pairs); a left join gives a row with no match one
    pair and first match -1; a semi or anti join gives a kept row one
    pair and no first match (an empty tensor)."""
    require_probe_type(join_type)
    keys = _ordinals(left_keys)
    bkeys = _ordinals(build.key)
    if len(keys) != len(bkeys):
        raise ValueError(f"{len(keys)} stream keys against {len(bkeys)} "
                         "build keys")
    for k, bk in zip(keys, bkeys):
        _check_key_types(left.columns[k].dtype,
                         build.batch.columns[bk].dtype)
    cols = [left.columns[k] for k in keys]
    if not build.multi:
        probe = probe_plain if cols[0].device.type == "cpu" else _probe_cuda
        lo, offsets, total = probe(cols[0], build, join_type)
    elif cols[0].device.type == "cpu":
        lo, offsets, total = probe_multi_plain(
            *key_words_plain(cols, build.chunks), build, join_type)
    else:
        lo, offsets, total = _multi_probe_cuda(cols, build, join_type)
    if total >= 2**31:
        raise ValueError(f"a join batch of {total} pairs: int32 row ids "
                         "need fewer than 2**31")
    return lo, offsets, total


def join_expand(lo: torch.Tensor, offsets: torch.Tensor, total: int,
                build: JoinBuild, join_type: str = "inner",
                matched: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (left, right) int32 row-id maps of the pairs (right -1 for a
    left or full join's row with no match); a semi or anti join's kept rows
    and an empty right map.  ``matched`` (bool [build rows], a right or
    full join; K1): each pair's build row is flagged in it, for
    ``unmatched_build_rows`` after the last stream group."""
    if join_type in LEFT_ONLY:
        if offsets.device.type == "cpu":
            return expand_left_only_plain(offsets, total)
        return _expand_left_only_cuda(offsets, total)
    if matched is not None and (matched.dtype != torch.bool
                                or matched.shape != (build.num_rows,)):
        raise TypeError(f"join_expand: matched must be bool "
                        f"[{build.num_rows}]")
    if lo.device.type == "cpu":
        return expand_plain(lo, offsets, total, build.perm, matched)
    return _expand_cuda(lo, offsets, total, build.perm, matched)


def new_matched(build_rows: int, device) -> torch.Tensor:
    """The zeroed per-build-row flags of a right or full join."""
    return torch.zeros(build_rows, dtype=torch.bool, device=device)


def unmatched_build_rows(matched: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The appended maps of a right or full join: (-1, each build row no
    pair flagged), in build-row order (the ported ``compaction_map``)."""
    rows, _ = compaction_map(~matched)
    return torch.full_like(rows, -1), rows


def cross_join_maps(nl: int, nr: int, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: the int32 maps of every (left row, right row) pair, ``li = k /
    nr, ri = k % nr`` for ``k < nl * nr``: a cross join's pairs, and the
    candidates of a keyless join with a condition."""
    if nl * nr >= 2**31:
        raise ValueError(f"a cross join batch of {nl} x {nr} pairs: int32 "
                         "row ids need fewer than 2**31")
    if torch.device(device).type == "cpu":
        return cross_join_maps_plain(nl, nr, device)
    return _cross_join_maps_cuda(nl, nr, device)


def join_gather_maps(left: ColumnarBatch, left_keys: Sequence[int],
                     right: ColumnarBatch, right_keys: Sequence[int],
                     join_type: str) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One-shot (li, ri, rows) of a join: build, probe and expand (a right
    or full join then appends its unmatched build rows); the cross join's
    every pair."""
    if join_type not in JOIN_TYPES:
        raise ValueError(f"unknown join type {join_type!r}")
    if len(left_keys) != len(right_keys):
        raise ValueError("a join needs as many left keys as right keys")
    if join_path(left, left_keys, right, right_keys, join_type) == "cross":
        li, ri = cross_join_maps(left.num_rows, right.num_rows, left.device)
        return li, ri, li.shape[0]
    require_probe_type(join_type)
    build = build_side(right, right_keys)
    lo, offsets, total = join_probe(left, left_keys, build, join_type)
    matched = (new_matched(build.num_rows, left.device)
               if join_type in OUTER else None)
    li, ri = join_expand(lo, offsets, total, build, join_type, matched)
    if matched is not None:
        ali, ari = unmatched_build_rows(matched)
        li, ri = torch.cat([li, ali]), torch.cat([ri, ari])
    return li, ri, li.shape[0]


def apply_gather_maps(left: ColumnarBatch, right: ColumnarBatch,
                      li: torch.Tensor, ri: torch.Tensor, schema: Schema,
                      join_type: str = "inner") -> ColumnarBatch:
    """The joined batch: the left columns gathered by ``li``, then (but for
    the semi, anti and existence joins) the right columns by ``ri`` (the
    ported gather, strings included).  An index of -1 gives a null row:
    the gather of a side that a join type null-extends counts as the
    null-extending gather."""
    if join_type not in JOIN_TYPES:
        raise ValueError(f"apply_gather_maps: join type {join_type!r}")
    cols = gather_columns(left.columns, li,
                          null_extend=join_type in ("right", "full"))
    if join_type not in ("left_semi", "left_anti", "existence"):
        cols += gather_columns(right.columns, ri,
                               null_extend=join_type in ("left", "full"))
    return ColumnarBatch(tuple(cols), li.shape[0], schema)
