"""Time-zone shifts of TIMESTAMP microseconds: the zone table on the host,
the shift on the device.

Counterpart of ``spark_rapids_tpu/kernels/timezone.py`` (``zone_table``
:30, ``utc_to_local_micros`` :74, ``local_to_utc_micros`` :84).  Python's
``zoneinfo`` gives the IANA rules on the host; each zone becomes one
table, sampled over 1900-2100 as the reference samples it (Spark's rebase
horizon): the UTC instants (seconds) at which its offset changes, the first
the sentinel ``INT64_MIN // 2`` so that the search never underflows, and
the offset (seconds) from each one on.  Rows past 2100 take the last
offset and rows before 1900 the first, as the reference's device path
does; its per-row zoneinfo oracle and Spark extend the rules instead
(ROADMAP queue 3 pins the difference).

Semantics are java.time's, as Spark's:

- UTC -> local (T1 ``utc_to_local``): the offset of the interval holding
  the instant's floor second;
- local -> UTC (T2 ``local_to_utc``): a wall time that two offsets reach
  (the fall-back overlap) takes the earlier offset; a wall time skipped by
  a gap (spring forward) takes the offset before it, so it moves forward
  by the gap.

Each shift is a wrapper: on CUDA tensors it launches the kernel of
``csrc/timezone.cu`` (the table in shared memory, a thread a row) and
counts the launch; on CPU tensors it runs the plain PyTorch version beside
it (``torch.searchsorted`` with the reference's arithmetic).  There is no
fallback from one to the other.  A zone's table goes to a device once
(``device_table``, cached by zone and device), so a batch does not upload
it again.  UTC and its aliases (``UTC_ALIASES``) skip the shift, as the
reference's callers do (``expressions/datetime.py:75-76``).
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import functools
from typing import Dict, Tuple
from zoneinfo import ZoneInfo

import numpy as np
import torch

from spark_rapids_tpu_torch.kernels import _lib

MICROS_PER_SECOND = 1_000_000
UTC_TO_LOCAL = "utc_to_local"
LOCAL_TO_UTC = "local_to_utc"
#: zone names that need no shift
UTC_ALIASES = ("UTC", "Etc/UTC", "GMT", "Z", "+00:00")
_MIN_YEAR, _MAX_YEAR = 1900, 2100
# the kernel's modes (csrc/timezone.cu)
_MODES = {UTC_TO_LOCAL: 0, LOCAL_TO_UTC: 1}


def is_utc(tz_name: str) -> bool:
    return tz_name in UTC_ALIASES


@functools.lru_cache(maxsize=None)
def zone_table(tz_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions, int64 UTC seconds [n]; offsets, int32 seconds [n]):
    offsets[i] applies to instants in [transitions[i], transitions[i+1]).
    The reference's walk: UTC time in steps of 14 days, each change of
    offset bisected to the exact second."""
    tz = ZoneInfo(tz_name)
    utc = _dt.timezone.utc
    transitions = [np.iinfo(np.int64).min // 2]
    probe = _dt.datetime(_MIN_YEAR, 1, 1, tzinfo=utc)
    offsets = [int(probe.astimezone(tz).utcoffset().total_seconds())]
    step = _dt.timedelta(days=14)
    end = _dt.datetime(_MAX_YEAR, 1, 1, tzinfo=utc)
    t, cur = probe, offsets[0]
    while t < end:
        nxt = min(t + step, end)
        off = int(nxt.astimezone(tz).utcoffset().total_seconds())
        if off != cur:
            lo, hi = t, nxt
            while hi - lo > _dt.timedelta(seconds=1):
                mid = (lo + (hi - lo) / 2).replace(microsecond=0)
                if mid <= lo:
                    break
                if int(mid.astimezone(tz).utcoffset()
                       .total_seconds()) == cur:
                    lo = mid
                else:
                    hi = mid
            transitions.append(int(hi.timestamp()))
            offsets.append(off)
            cur = off
        t = nxt
    return (np.asarray(transitions, np.int64),
            np.asarray(offsets, np.int32))


@dataclasses.dataclass(frozen=True)
class ZoneTable:
    """A zone's table on one device, with T2's derived arrays: prev_off[i]
    is the offset before transition i (offsets[0] for the first) and
    wall_old_end[i] = transitions[i] + prev_off[i], the wall clock at
    which that offset stops."""

    transitions: torch.Tensor    # int64 [n]
    offsets: torch.Tensor        # int32 [n]
    prev_off: torch.Tensor       # int32 [n]
    wall_old_end: torch.Tensor   # int64 [n]

    @property
    def entries(self) -> int:
        return self.transitions.shape[0]


_DEVICE_TABLES: Dict[Tuple[str, str], ZoneTable] = {}


def device_table(tz_name: str, device) -> ZoneTable:
    """The zone's table on ``device``, uploaded once per (zone, device)."""
    device = torch.device(device)
    key = (tz_name, str(device))
    table = _DEVICE_TABLES.get(key)
    if table is None:
        trans, offs = zone_table(tz_name)
        prev = np.concatenate([offs[:1], offs[:-1]])
        table = ZoneTable(
            torch.from_numpy(trans).to(device),
            torch.from_numpy(offs).to(device),
            torch.from_numpy(prev).to(device),
            torch.from_numpy(trans + prev.astype(np.int64)).to(device))
        _DEVICE_TABLES[key] = table
    return table

# ---------------------------------------------------------------------------
# plain versions


def _floor_seconds(micros: torch.Tensor) -> torch.Tensor:
    return torch.div(micros, MICROS_PER_SECOND, rounding_mode="floor")


def _interval(keys: torch.Tensor, secs: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(keys, secs, right=True) - 1
    return idx.clamp(0, keys.shape[0] - 1)


def utc_to_local_plain(micros: torch.Tensor,
                       table: ZoneTable) -> torch.Tensor:
    idx = _interval(table.transitions, _floor_seconds(micros))
    return micros + table.offsets[idx].to(torch.int64) * MICROS_PER_SECOND


def local_to_utc_plain(micros: torch.Tensor,
                       table: ZoneTable) -> torch.Tensor:
    idx = _interval(table.wall_old_end, _floor_seconds(micros))
    utc = micros - table.offsets[idx].to(torch.int64) * MICROS_PER_SECOND
    in_gap = _floor_seconds(utc) < table.transitions[idx]
    gap = micros - table.prev_off[idx].to(torch.int64) * MICROS_PER_SECOND
    return torch.where(in_gap, gap, utc)


_PLAIN = {UTC_TO_LOCAL: utc_to_local_plain, LOCAL_TO_UTC: local_to_utc_plain}

# ---------------------------------------------------------------------------
# kernel


def _shift_cuda(name: str, micros: torch.Tensor,
                table: ZoneTable) -> torch.Tensor:
    _lib.require_cuda(name, micros, table.transitions)
    lib = _lib.lib()
    if table.entries > lib.srt_tz_max_entries():
        raise NotImplementedError(
            f"{name}: a zone table of {table.entries} entries, at most "
            f"{lib.srt_tz_max_entries()} in shared memory")
    n, dev = micros.shape[0], micros.device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    keys = table.transitions if name == UTC_TO_LOCAL else table.wall_old_end
    _lib.check(lib.srt_tz_shift(
        _MODES[name], _lib.ptr(micros), n, _lib.ptr(keys),
        _lib.ptr(table.transitions), _lib.ptr(table.offsets),
        _lib.ptr(table.prev_off), table.entries, _lib.ptr(out),
        _lib.stream(dev)), name)
    if n:
        _lib.LAUNCHES[name] += 1
    return out


def _shift(name: str, micros: torch.Tensor, tz_name: str) -> torch.Tensor:
    if micros.dtype != torch.int64 or micros.dim() != 1:
        raise TypeError(f"{name}: int64 microseconds [n], got {micros.dtype} "
                        f"{tuple(micros.shape)}")
    table = device_table(tz_name, micros.device)
    if micros.device.type == "cpu":
        return _PLAIN[name](micros, table)
    return _shift_cuda(name, micros.contiguous(), table)


def utc_to_local_micros(micros: torch.Tensor, tz_name: str) -> torch.Tensor:
    """T1: UTC microseconds -> the zone's wall clock, so that the civil
    fields read local time."""
    return _shift(UTC_TO_LOCAL, micros, tz_name)


def local_to_utc_micros(micros: torch.Tensor, tz_name: str) -> torch.Tensor:
    """T2: the zone's wall-clock microseconds -> UTC (the gap and overlap
    rules above)."""
    return _shift(LOCAL_TO_UTC, micros, tz_name)
