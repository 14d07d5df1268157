"""Window kernels over a partition-sorted batch: the layout, frame sums and
counts, RANGE frame bounds and frame extremes.

Counterpart of ``spark_rapids_tpu/kernels/window.py``: ``window_layout``
:45 (``WindowLayout`` :31), ``row_number`` :75, ``rank`` :79,
``dense_rank`` :83, ``_prefix_sum`` :88 and ``_at_or_zero`` :94,
``running_sum_range`` :100, ``rows_frame_sum`` :113, ``_segmented_scan``
:133, ``running_min_range`` :144, ``running_max_range`` :151,
``whole_partition_agg`` :158, ``shift`` :189, ``frame_bounds_rows`` :202,
``frame_bounds_range`` :216, ``bounded_sum_count`` :255 and
``bounded_min_max`` :268.  Every function takes arrays indexed by sorted
position; a batch holds exactly its rows, so the reference's ``live``
mask and its padding have no counterpart.

Four functions are kernels of ``csrc/window.cu``, each a wrapper: on CUDA
tensors it launches the kernel and counts the launch under its name; on
CPU tensors it runs the plain PyTorch version beside it; on any other
device it raises.

  * ``window_layout`` (K1): the layout.  The ranks (``row_number``,
    ``rank``, ``dense_rank``, ``percent_rank``, ``cume_dist``, ``ntile``)
    are elementwise torch over it.
  * ``frame_sum_count`` (K2): sum and valid count over any inclusive
    position frame, the one path of ``rows_frame_sum``,
    ``running_sum_range`` (the frame [seg_start, run_last]),
    ``bounded_sum_count`` and the sums of ``whole_partition_agg`` (the
    frame [seg_start, seg_end - 1]).  The whole-partition frame goes
    through K2 and K4 rather than the ported segmented reductions, which
    would need the partitions' starts compacted (one device->host read)
    and their results gathered back to the rows: a frame is one launch
    and no read.
  * ``range_frame_bounds`` (K3): ``frame_bounds_range``.
  * ``frame_extreme`` (K4): MIN / MAX over any frame, the one path of
    ``bounded_min_max``, ``running_min_range`` / ``running_max_range``
    (the frame [seg_start, run_last]) and the extremes of
    ``whole_partition_agg``.

``frame_bounds_rows`` is an elementwise clamp; LEAD / LAG (``shift``) and
FIRST / LAST / NTH_VALUE are a row index per row (``shift_index``, the
frame's bounds) that the ported null-extending gather moves.

Where the reference's paths differ, the port takes one rule (ROADMAP
queue 3 pins each against the reference):

  * MIN / MAX follow Spark's order on every path: NaN above +inf (MIN
    skips NaN unless the frame holds nothing else, MAX is NaN with any),
    -0.0 below 0.0.  The reference's bounded frames give the same (its
    exec maps NaN to +inf for MIN); its running frames scan with
    ``jnp.minimum``, which carries a NaN to every later row, and its whole
    partition takes ``segment_min`` / ``segment_max``.
  * A float frame sum is the finite values' sum, NaN with a NaN or both
    infinities, else +-inf with one: the reference's difference of one
    cumsum gives NaN in every frame after an infinity (in any partition).
  * The RANGE bounds are the reference's binary search, wrap and all.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.kernels import _lib

_SUM_DTYPES = (torch.float64, torch.int64)
#: frame_extreme's type codes (csrc/window.cu ExtremeType)
_EXTREME_CODE = {torch.bool: 0, torch.int32: 1, torch.int64: 2,
                 torch.float32: 3, torch.float64: 4}
_I64_MAX = 2**63 - 1
_I64_MIN = -2**63


@dataclasses.dataclass
class WindowLayout:
    """Segmentation of a partition-sorted batch (int32 [n] each)."""

    seg_start: torch.Tensor   # first position of the row's partition
    seg_end: torch.Tensor     # one past its last position
    run_id: torch.Tensor      # peer runs at or before the row, less one
    run_first: torch.Tensor   # first position of the row's peer run
    run_last: torch.Tensor    # last position of the row's peer run

    @property
    def n(self) -> int:
        return self.seg_start.shape[0]

    @property
    def pos(self) -> torch.Tensor:
        return torch.arange(self.n, dtype=torch.int32,
                            device=self.seg_start.device)

# ---------------------------------------------------------------------------
# K1: window_layout


def window_layout_plain(part_boundary: torch.Tensor,
                        peer_boundary: torch.Tensor) -> WindowLayout:
    n = part_boundary.shape[0]
    dev = part_boundary.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    peer = peer_boundary | part_boundary
    if n == 0:
        e = torch.empty(0, dtype=torch.int32, device=dev)
        return WindowLayout(e, e, e, e, e)

    def last_at_or_before(flags):
        return torch.cummax(torch.where(flags, pos, -1), 0).values

    def next_after(flags):
        at_or_after = torch.cummin(
            torch.where(flags, pos, n).flip(0), 0).values.flip(0)
        return torch.cat([at_or_after[1:],
                          torch.full((1,), n, dtype=torch.int64,
                                     device=dev)])
    i32 = torch.int32
    return WindowLayout(
        seg_start=last_at_or_before(part_boundary).to(i32),
        seg_end=next_after(part_boundary).to(i32),
        run_id=(torch.cumsum(peer.to(torch.int64), 0) - 1).to(i32),
        run_first=last_at_or_before(peer).to(i32),
        run_last=(next_after(peer) - 1).to(i32))


def _window_layout_cuda(part_boundary, peer_boundary) -> WindowLayout:
    _lib.require_cuda("window_layout", part_boundary, peer_boundary)
    lib = _lib.lib()
    n = part_boundary.shape[0]
    dev = part_boundary.device
    ntiles = max(-(-n // lib.srt_window_tile()), 1)
    scratch = torch.empty(-(-2 * ntiles * lib.srt_window_state_bytes(0)
                            // 8), dtype=torch.int64, device=dev)
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(5)]
    _lib.check(lib.srt_window_layout(
        _lib.ptr(part_boundary), _lib.ptr(peer_boundary), n,
        _lib.ptr(scratch), *(_lib.ptr(t) for t in out), _lib.stream(dev)),
        "window_layout")
    if n:
        _lib.LAUNCHES["window_layout"] += 1
    return WindowLayout(*out)


def window_layout(part_boundary: torch.Tensor,
                  peer_boundary: torch.Tensor) -> WindowLayout:
    """The layout of a partition-sorted batch from its bool boundary flags
    (true at the first row of each partition / peer run; row 0 starts a
    partition; a partition boundary is a peer boundary too):
    ``seg_start`` the last partition boundary at or before each row,
    ``seg_end`` the next one after it (n past the last), ``run_id`` the
    peer boundaries at or before it less one, ``run_first`` the last peer
    boundary at or before it, ``run_last`` the next one after it less
    one."""
    for t in (part_boundary, peer_boundary):
        if t.dtype != torch.bool or t.dim() != 1:
            raise TypeError("window_layout takes 1-d bool boundary flags")
    if part_boundary.shape != peer_boundary.shape:
        raise ValueError("window_layout: flags of different lengths")
    if part_boundary.shape[0] >= 2**31:
        raise ValueError("window_layout: int32 positions need n < 2**31")
    if part_boundary.device.type == "cpu":
        return window_layout_plain(part_boundary, peer_boundary)
    return _window_layout_cuda(part_boundary, peer_boundary)


def row_number(layout: WindowLayout) -> torch.Tensor:
    return layout.pos - layout.seg_start + 1


def rank(layout: WindowLayout) -> torch.Tensor:
    return layout.run_first - layout.seg_start + 1


def dense_rank(layout: WindowLayout) -> torch.Tensor:
    return layout.run_id - layout.run_id[layout.seg_start.long()] + 1


def percent_rank(layout: WindowLayout) -> torch.Tensor:
    """(rank - 1) / (partition rows - 1); 0.0 in a partition of one row
    (``plan/execs/window.py:146`` of the reference)."""
    cnt = (layout.seg_end - layout.seg_start).to(torch.float64)
    rk = (layout.run_first - layout.seg_start).to(torch.float64)
    return torch.where(cnt > 1, rk / torch.clamp(cnt - 1.0, min=1.0), 0.0)


def cume_dist(layout: WindowLayout) -> torch.Tensor:
    """Rows up to the row's last peer over the partition's rows."""
    cnt = (layout.seg_end - layout.seg_start).to(torch.float64)
    le = (layout.run_last + 1 - layout.seg_start).to(torch.float64)
    return le / torch.clamp(cnt, min=1.0)


def ntile(layout: WindowLayout, buckets: int) -> torch.Tensor:
    """Spark's NTILE: near-equal buckets, the remainder to the first
    ones (``plan/execs/window.py:158`` of the reference)."""
    cnt = layout.seg_end - layout.seg_start
    r = layout.pos - layout.seg_start
    bs = cnt // buckets
    rem = cnt % buckets
    thr = rem * (bs + 1)
    big = r // torch.clamp(bs + 1, min=1) + 1
    small = rem + (r - thr) // torch.clamp(bs, min=1) + 1
    return torch.where(bs == 0, r + 1,
                       torch.where(r < thr, big, small)).to(torch.int32)


def frame_bounds_rows(layout: WindowLayout, preceding: Optional[int],
                      following: Optional[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) inclusive position bounds of ROWS BETWEEN preceding
    PRECEDING AND following FOLLOWING (None: unbounded), clamped to the
    partition."""
    pos = layout.pos
    upper = (layout.seg_end - 1 if following is None
             else torch.minimum(pos + following, layout.seg_end - 1))
    lower = (layout.seg_start if preceding is None
             else torch.maximum(pos - preceding, layout.seg_start))
    return lower, upper


def shift_index(layout: WindowLayout, offset: int) -> torch.Tensor:
    """LEAD (offset > 0) / LAG (offset < 0): the position offset rows away
    when it is in the row's partition, else -1 (a null row for the
    null-extending gather)."""
    idx = layout.pos + offset
    inside = (idx >= layout.seg_start) & (idx < layout.seg_end)
    return torch.where(inside, idx, -1)

# ---------------------------------------------------------------------------
# K2: frame_sum_count


def _two_sum(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _at(prefix: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """prefix[idx], 0 where idx < 0 (the reference's ``_at_or_zero``)."""
    got = prefix[idx.clamp(min=0).long()]
    return torch.where(idx >= 0, got, torch.zeros((), dtype=prefix.dtype,
                                                  device=prefix.device))


def frame_sum_count_plain(values: torch.Tensor, validity: torch.Tensor,
                          seg_start: torch.Tensor, lower: torch.Tensor,
                          upper: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix differences over the whole batch (the frames lie in their
    partitions, so no restart is needed); an f64 prefix carries the
    rounding errors of its cumsum in a second cumsum, and the NaN, +inf
    and -inf are counted apart, as the kernel does."""
    del seg_start   # the kernel's restart; the plain prefix spans all rows
    dev = values.device
    count = torch.cumsum(validity.to(torch.int64), 0)
    before = lower - 1
    n = _at(count, upper) - _at(count, before)
    empty = upper < lower
    zero_n = torch.zeros((), dtype=torch.int64, device=dev)
    if values.dtype == torch.int64:
        p = torch.cumsum(torch.where(validity, values,
                                     torch.zeros((), dtype=torch.int64,
                                                 device=dev)), 0)
        s = _at(p, upper) - _at(p, before)
        return (torch.where(empty, torch.zeros((), dtype=torch.int64,
                                               device=dev), s),
                torch.where(empty, zero_n, n))
    finite = validity & torch.isfinite(values)
    v = torch.where(finite, values, torch.zeros((), dtype=values.dtype,
                                                device=dev))
    hi = torch.cumsum(v, 0)
    prev = torch.cat([torch.zeros(1, dtype=hi.dtype, device=dev), hi[:-1]])
    s0, e0 = _two_sum(prev, v)
    lo = torch.cumsum((s0 - hi) + e0, 0)
    s, e = _two_sum(_at(hi, upper), -_at(hi, before))
    total = s + (e + (_at(lo, upper) - _at(lo, before)))

    def counted(flags):
        c = torch.cumsum(flags.to(torch.int64), 0)
        return _at(c, upper) - _at(c, before)
    nan = counted(validity & torch.isnan(values))
    pinf = counted(validity & (values == float("inf")))
    ninf = counted(validity & (values == float("-inf")))
    total = torch.where(ninf > 0, float("-inf"), total)
    total = torch.where(pinf > 0, float("inf"), total)
    total = torch.where((nan > 0) | ((pinf > 0) & (ninf > 0)),
                        float("nan"), total)
    return (torch.where(empty, torch.zeros((), dtype=total.dtype,
                                           device=dev), total),
            torch.where(empty, zero_n, n))


def _frame_sum_count_cuda(values, validity, seg_start, lower, upper):
    _lib.require_cuda("frame_sum_count", values, validity, seg_start, lower,
                      upper)
    lib = _lib.lib()
    n = values.shape[0]
    dev = values.device
    f64 = values.dtype == torch.float64
    ntiles = max(-(-n // lib.srt_window_tile()), 1)
    scratch = torch.empty(-(-2 * ntiles * lib.srt_window_state_bytes(
        1 if f64 else 2) // 8), dtype=torch.int64, device=dev)
    psum = torch.empty(n, dtype=values.dtype, device=dev)
    pcount = torch.empty(n, dtype=torch.int64, device=dev)
    plo = torch.empty(n if f64 else 0, dtype=torch.float64, device=dev)
    flags = torch.empty((3, n) if f64 else (3, 0), dtype=torch.int32,
                        device=dev)
    out = torch.empty(n, dtype=values.dtype, device=dev)
    out_count = torch.empty(n, dtype=torch.int64, device=dev)
    _lib.check(lib.srt_frame_sum(
        int(f64), _lib.ptr(values), _lib.ptr(validity), _lib.ptr(seg_start),
        _lib.ptr(lower), _lib.ptr(upper), n, _lib.ptr(scratch),
        _lib.ptr(psum), _lib.ptr(plo) if f64 else None, _lib.ptr(pcount),
        *((_lib.ptr(flags[i]) for i in range(3)) if f64
          else (None, None, None)),
        _lib.ptr(out), _lib.ptr(out_count), _lib.stream(dev)),
        "frame_sum_count")
    if n:
        _lib.LAUNCHES["frame_sum_count"] += 1
    return out, out_count


def _check_frames(name: str, n: int, *bounds: torch.Tensor) -> None:
    for t in bounds:
        if t.dtype != torch.int32 or t.shape != (n,):
            raise TypeError(f"{name}: positions must be int32 [{n}], got "
                            f"{t.dtype} {tuple(t.shape)}")


def frame_sum_count(values: torch.Tensor, validity: torch.Tensor,
                    seg_start: torch.Tensor, lower: torch.Tensor,
                    upper: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) of the valid values over each row's inclusive frame
    [lower, upper], which must lie in the row's partition (``seg_start``
    from ``window_layout``); an empty frame (upper < lower) gives 0 and 0.
    int64 sums wrap; f64 sums are accurate to about one rounding of the
    frame's own sum (see ``csrc/window.cu``), NaN with a NaN or both
    infinities in the frame, +-inf with one."""
    if values.dtype not in _SUM_DTYPES:
        raise TypeError(f"frame_sum_count takes float64 or int64, got "
                        f"{values.dtype}")
    n = values.shape[0]
    if values.dim() != 1 or validity.dtype != torch.bool or \
            validity.shape != (n,):
        raise ValueError("frame_sum_count needs 1-d values and bool "
                         "validity of the same length")
    _check_frames("frame_sum_count", n, seg_start, lower, upper)
    if values.device.type == "cpu":
        return frame_sum_count_plain(values, validity, seg_start, lower,
                                     upper)
    return _frame_sum_count_cuda(values, validity, seg_start, lower, upper)

# ---------------------------------------------------------------------------
# K3: range_frame_bounds


def _search(key: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            target: torch.Tensor, strict: bool) -> torch.Tensor:
    """The reference's vectorised binary search (``frame_bounds_range``
    :231-243): the same steps row by row."""
    n = key.shape[0]
    for _ in range(max(n.bit_length(), 1)):
        open_ = lo < hi
        if not bool(open_.any()):
            break
        mid = (lo + hi) // 2
        v = key[mid.clamp(0, max(n - 1, 0))]
        right = v < target if strict else v <= target
        lo = torch.where(open_ & right, mid + 1, lo)
        hi = torch.where(open_ & ~right, mid, hi)
    return lo


def range_frame_bounds_plain(key: torch.Tensor, seg_start: torch.Tensor,
                             seg_end: torch.Tensor,
                             preceding: Optional[int],
                             following: Optional[int]
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo0, hi0 = seg_start.to(torch.int64), seg_end.to(torch.int64)
    if key.shape[0] == 0:
        return seg_start, seg_end - 1
    # key - preceding and key + following in the key's type: they wrap
    lower = (seg_start if preceding is None else
             _search(key, lo0, hi0, key - preceding, True).to(torch.int32))
    upper = (seg_end - 1 if following is None else
             (_search(key, lo0, hi0, key + following, False) - 1
              ).to(torch.int32))
    return lower, upper


def _range_frame_bounds_cuda(key, seg_start, seg_end, preceding, following):
    _lib.require_cuda("range_frame_bounds", key, seg_start, seg_end)
    lib = _lib.lib()
    n = key.shape[0]
    dev = key.device
    lower = torch.empty(n, dtype=torch.int32, device=dev)
    upper = torch.empty(n, dtype=torch.int32, device=dev)
    _lib.check(lib.srt_range_frame_bounds(
        int(key.dtype == torch.int64), _lib.ptr(key), _lib.ptr(seg_start),
        _lib.ptr(seg_end), n, int(preceding is not None), preceding or 0,
        int(following is not None), following or 0, _lib.ptr(lower),
        _lib.ptr(upper), _lib.stream(dev)), "range_frame_bounds")
    if n:
        _lib.LAUNCHES["range_frame_bounds"] += 1
    return lower, upper


def range_frame_bounds(key: torch.Tensor, seg_start: torch.Tensor,
                       seg_end: torch.Tensor, preceding: Optional[int],
                       following: Optional[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) inclusive bounds of RANGE BETWEEN preceding
    PRECEDING AND following FOLLOWING (None: unbounded) over an int32 or
    int64 order key, ascending within each partition: the first position
    of the partition whose key is at least key - preceding, and the last
    whose key is at most key + following.  Both targets are computed in
    the key's type and wrap, as the reference's are."""
    if key.dtype not in (torch.int32, torch.int64) or key.dim() != 1:
        raise TypeError(f"range_frame_bounds takes a 1-d int32 or int64 "
                        f"key, got {key.dtype}")
    _check_frames("range_frame_bounds", key.shape[0], seg_start, seg_end)
    info = torch.iinfo(key.dtype)
    for off in (preceding, following):
        if off is not None and not info.min <= off <= info.max:
            raise OverflowError(f"range_frame_bounds: offset {off} out of "
                                f"the key's {key.dtype} range")
    if key.device.type == "cpu":
        return range_frame_bounds_plain(key, seg_start, seg_end, preceding,
                                        following)
    return _range_frame_bounds_cuda(key, seg_start, seg_end, preceding,
                                    following)

# ---------------------------------------------------------------------------
# K4: frame_extreme

_FLOAT_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF, 0x7FC00000),
               torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF,
                               0x7FF8000000000000)}


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """int64 keys in Spark's order: floats by their bits, all but the
    sign flipped where it is set, after every NaN is made the canonical
    one (NaN above +inf, -0.0 below 0.0)."""
    if values.dtype not in _FLOAT_BITS:
        return values.to(torch.int64)
    itype, mask, qnan = _FLOAT_BITS[values.dtype]
    b = values.view(itype)
    b = torch.where(torch.isnan(values), torch.tensor(qnan, dtype=itype,
                                                      device=b.device), b)
    return torch.where(b < 0, b ^ mask, b).to(torch.int64)


def _from_order_keys(k: torch.Tensor, dtype: torch.dtype, is_min: bool
                     ) -> torch.Tensor:
    none = k == (_I64_MAX if is_min else _I64_MIN)
    if dtype in _FLOAT_BITS:
        itype, mask, _ = _FLOAT_BITS[dtype]
        b = k.to(itype)
        out = torch.where(b < 0, b ^ mask, b).view(dtype)
        ident = float("inf") if is_min else float("-inf")
    elif dtype == torch.bool:
        out, ident = k != 0, is_min
    else:
        info = torch.iinfo(dtype)
        out, ident = k.to(dtype), info.max if is_min else info.min
    return torch.where(none, torch.tensor(ident, dtype=dtype,
                                          device=k.device), out)


def extreme_levels(max_len: int) -> int:
    """Sparse-table levels that cover frames of at most ``max_len`` rows."""
    return max(int(max_len), 1).bit_length()


def frame_extreme_plain(values: torch.Tensor, validity: torch.Tensor,
                        lower: torch.Tensor, upper: torch.Tensor,
                        is_min: bool, max_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = values.shape[0]
    dev = values.device
    ident = _I64_MAX if is_min else _I64_MIN
    pick = torch.minimum if is_min else torch.maximum
    level = torch.where(validity, _order_keys(values),
                        torch.tensor(ident, dtype=torch.int64, device=dev))
    table = [level]
    half = 1
    for _ in range(1, extreme_levels(n if max_len is None else max_len)):
        prev = table[-1]
        shifted = torch.cat([prev[half:], torch.full(
            (min(half, n),), ident, dtype=torch.int64, device=dev)])
        table.append(pick(prev, shifted))
        half <<= 1
    length = (upper - lower + 1).to(torch.int64)
    nonempty = length > 0
    lvl = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(1, len(table)):
        lvl = torch.where(length >= (1 << j), j, lvl)
    stack = torch.stack(table) if n else level.reshape(1, 0)
    cap = max(n - 1, 0)
    a = stack[lvl, lower.to(torch.int64).clamp(0, cap)]
    b = stack[lvl, (upper.to(torch.int64) - (1 << lvl) + 1).clamp(0, cap)]
    key = torch.where(nonempty, pick(a, b),
                      torch.tensor(ident, dtype=torch.int64, device=dev))
    return _from_order_keys(key, values.dtype, is_min), nonempty


def _frame_extreme_cuda(values, validity, lower, upper, is_min, max_len):
    _lib.require_cuda("frame_extreme", values, validity, lower, upper)
    lib = _lib.lib()
    n = values.shape[0]
    dev = values.device
    levels = extreme_levels(n if max_len is None else max_len)
    table = torch.empty(levels * n, dtype=torch.int64, device=dev)
    out = torch.empty(n, dtype=values.dtype, device=dev)
    nonempty = torch.empty(n, dtype=torch.bool, device=dev)
    _lib.check(lib.srt_frame_extreme(
        _EXTREME_CODE[values.dtype], int(is_min), _lib.ptr(values),
        _lib.ptr(validity), n, _lib.ptr(lower), _lib.ptr(upper), levels,
        _lib.ptr(table), _lib.ptr(out), _lib.ptr(nonempty),
        _lib.stream(dev)), "frame_extreme")
    if n:
        _lib.LAUNCHES["frame_extreme"] += 1
    return out, nonempty


def frame_extreme(values: torch.Tensor, validity: torch.Tensor,
                  lower: torch.Tensor, upper: torch.Tensor, is_min: bool,
                  max_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(MIN or MAX of the valid values over each row's inclusive frame
    [lower, upper], nonempty = upper >= lower) in Spark's order (NaN above
    +inf: MIN skips it unless nothing else is valid, MAX is NaN with any;
    -0.0 below 0.0).  A frame with no valid value gives the type's
    identity (MIN: its largest value or +inf; MAX: its smallest or -inf;
    a bool's True / False).  ``max_len`` bounds every frame's length (the
    sparse table's depth); None: the row count."""
    if values.dtype not in _EXTREME_CODE or values.dim() != 1:
        raise TypeError(f"frame_extreme takes 1-d bool, int32, int64, "
                        f"float32 or float64, got {values.dtype}")
    n = values.shape[0]
    if validity.dtype != torch.bool or validity.shape != (n,):
        raise ValueError("frame_extreme needs bool validity of the values' "
                         "length")
    _check_frames("frame_extreme", n, lower, upper)
    if values.device.type == "cpu":
        return frame_extreme_plain(values, validity, lower, upper, is_min,
                                   max_len)
    return _frame_extreme_cuda(values, validity, lower, upper, is_min,
                               max_len)
