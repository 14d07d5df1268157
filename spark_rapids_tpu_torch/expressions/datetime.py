"""Date and time expressions, and the civil-date arithmetic under them.

Counterpart of ``spark_rapids_tpu/expressions/datetime.py``: the
conversions ``_civil_from_days`` (:36) and ``_days_from_civil`` (:58),
Howard Hinnant's public-domain construction in integer arithmetic over
the proleptic Gregorian calendar; the DATE and TIMESTAMP fields ``Year``
to ``Quarter`` (:118-148) and ``Hour`` / ``Minute`` / ``Second``
(:173-186); ``DateAdd``, ``DateSub``, ``DateDiff``, ``AddMonths``,
``LastDay``, ``WeekOfYear``, ``MakeDate``, ``TruncDate``, ``NextDay`` and
``MonthsBetween`` (:188-525); the ``_TsScalar`` family (:527-602); and
``FromUtcTimestamp`` / ``ToUtcTimestamp`` (:604-669).

A DATE is int32 days since 1970-01-01, a TIMESTAMP int64 microseconds
since the epoch, UTC.  A TIMESTAMP's fields, and its cast to a DATE
(``casts.py``), read the wall clock of the session zone
(``spark.sql.session.timeZone``, the ambient the engine sets around a
plan's run): outside UTC and its aliases each row is shifted by T1
(``kernels/timezone.py`` ``utc_to_local_micros``, a kernel on the card).
``from_utc_timestamp`` runs T1 and ``to_utc_timestamp`` T2 in the zone
they name.  Every division of a value that may be negative floors, as the
reference's ``floor_divide`` does: -1 us is 1969-12-31 23:59:59.999999.
All but the two shifts is plain PyTorch elementwise code; none of it has
a fused-program form, so a chain that holds one runs op by op.
"""
from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import current_session_timezone
from spark_rapids_tpu_torch.expressions.core import (
    BinaryExpression, EvalContext, Expression, UnaryExpression, col,
    make_column, null_propagating)
from spark_rapids_tpu_torch.kernels import timezone as TZ

MICROS_PER_SECOND = 1_000_000
MICROS_PER_DAY = 86400 * MICROS_PER_SECOND


def _floor(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Days since 1970-01-01 -> (year, month in [1, 12], day in [1, 31]),
    int64."""
    z = z.to(torch.int64) + 719468
    era = _floor(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                                 # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)        # [0, 365]
    mp = (5 * doy + 2) // 153                              # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                      # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)               # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor,
                     d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> int64 days since 1970-01-01."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _floor(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d.to(torch.int64) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _first_of(y: torch.Tensor, m) -> torch.Tensor:
    """Days of the first of month m (int64 or tensor) of year y."""
    m = torch.as_tensor(m, dtype=torch.int64, device=y.device).expand_as(y)
    return _days_from_civil(y, m, torch.ones_like(y))


def _month_length(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    nxt = _first_of(torch.where(m == 12, y + 1, y),
                    torch.where(m == 12, 1, m + 1))
    return nxt - _first_of(y, m)


def session_local(micros: torch.Tensor) -> torch.Tensor:
    """UTC microseconds as the session zone's wall clock (T1; no shift in
    UTC)."""
    tz = current_session_timezone()
    if TZ.is_utc(tz):
        return micros
    return TZ.utc_to_local_micros(micros.to(torch.int64), tz)


def timestamp_days(micros: torch.Tensor) -> torch.Tensor:
    """The session zone's civil day of each instant (int64 epoch days)."""
    return _floor(session_local(micros.to(torch.int64)), MICROS_PER_DAY)


class _DateField(UnaryExpression):
    """A field of a DATE, or of a TIMESTAMP's day in the session zone."""

    @property
    def dtype(self):
        return T.INT

    def _field(self, days: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        days = (timestamp_days(c.data)
                if isinstance(c.dtype, T.TimestampType)
                else c.data.to(torch.int64))
        return make_column(self._field(days).to(torch.int32), c.validity,
                           T.INT)


class Year(_DateField):
    def _field(self, days):
        return _civil_from_days(days)[0]


class Month(_DateField):
    def _field(self, days):
        return _civil_from_days(days)[1]


class DayOfMonth(_DateField):
    def _field(self, days):
        return _civil_from_days(days)[2]


class DayOfWeek(_DateField):
    """Spark dayofweek: 1 = Sunday ... 7 = Saturday."""

    def _field(self, days):
        return (days + 4) % 7 + 1


class DayOfYear(_DateField):
    def _field(self, days):
        return days - _first_of(_civil_from_days(days)[0], 1) + 1


class Quarter(_DateField):
    def _field(self, days):
        return (_civil_from_days(days)[1] + 2) // 3


class _TimestampField(UnaryExpression):
    """A field of a TIMESTAMP's time of day in the session zone."""

    @property
    def dtype(self):
        return T.INT

    def _field(self, micros_of_day: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        x = session_local(c.data.to(torch.int64))
        mod = x - _floor(x, MICROS_PER_DAY) * MICROS_PER_DAY
        return make_column(self._field(mod).to(torch.int32), c.validity,
                           T.INT)


class Hour(_TimestampField):
    def _field(self, mod):
        return mod // (3600 * MICROS_PER_SECOND)


class Minute(_TimestampField):
    def _field(self, mod):
        return (mod // (60 * MICROS_PER_SECOND)) % 60


class Second(_TimestampField):
    def _field(self, mod):
        return (mod // MICROS_PER_SECOND) % 60


class DateAdd(BinaryExpression):
    """date_add(date, days) -> DATE (int32, wrapping); DateSub negates."""

    symbol = "date_add"
    _sign = 1

    @property
    def dtype(self):
        return T.DATE

    def eval(self, ctx: EvalContext):
        lc, rc = self.left.eval(ctx), self.right.eval(ctx)
        out = lc.data.to(torch.int32) + self._sign * rc.data.to(torch.int32)
        return make_column(out.to(torch.int32),
                           null_propagating([lc.validity, rc.validity]),
                           T.DATE)


class DateSub(DateAdd):
    symbol = "date_sub"
    _sign = -1


class DateDiff(BinaryExpression):
    """datediff(end, start) -> INT days."""

    symbol = "datediff"

    @property
    def dtype(self):
        return T.INT

    def eval(self, ctx: EvalContext):
        lc, rc = self.left.eval(ctx), self.right.eval(ctx)
        out = lc.data.to(torch.int64) - rc.data.to(torch.int64)
        return make_column(out.to(torch.int32),
                           null_propagating([lc.validity, rc.validity]),
                           T.INT)


class AddMonths(BinaryExpression):
    """add_months(date, n): civil month arithmetic, the day clamped to the
    target month's last day."""

    symbol = "add_months"

    @property
    def dtype(self):
        return T.DATE

    def eval(self, ctx: EvalContext):
        lc, rc = self.left.eval(ctx), self.right.eval(ctx)
        y, m, d = _civil_from_days(lc.data)
        total = y * 12 + (m - 1) + rc.data.to(torch.int64)
        ny = _floor(total, 12)
        nm = total - ny * 12 + 1
        nd = torch.minimum(d, _month_length(ny, nm))
        out = _days_from_civil(ny, nm, nd).to(torch.int32)
        return make_column(out, null_propagating([lc.validity, rc.validity]),
                           T.DATE)


class LastDay(UnaryExpression):
    @property
    def dtype(self):
        return T.DATE

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        y, m, _ = _civil_from_days(c.data)
        out = _first_of(torch.where(m == 12, y + 1, y),
                        torch.where(m == 12, 1, m + 1)) - 1
        return make_column(out.to(torch.int32), c.validity, T.DATE)


class WeekOfYear(UnaryExpression):
    """ISO-8601 week number (Spark weekofyear): the Thursday of a row's
    week names its ISO year; 1970-01-01 was a Thursday."""

    @property
    def dtype(self):
        return T.INT

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        days = c.data.to(torch.int64)
        thursday = days - (days + 3) % 7 + 3
        jan1 = _first_of(_civil_from_days(thursday)[0], 1)
        out = (thursday - jan1) // 7 + 1
        return make_column(out.to(torch.int32), c.validity, T.INT)


_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


class MakeDate(Expression):
    """make_date(y, m, d) -> DATE; NULL where the date does not exist or
    its year is outside [1, 9999] (non-ANSI)."""

    def __init__(self, year: Expression, month: Expression, day: Expression):
        self.children = (year, month, day)

    def with_children(self, children):
        return MakeDate(*children)

    @property
    def dtype(self):
        return T.DATE

    def eval(self, ctx: EvalContext):
        y, m, d = (c.eval(ctx) for c in self.children)
        yy, mm, dd = (c.data.to(torch.int64) for c in (y, m, d))
        leap = ((yy % 4 == 0) & (yy % 100 != 0)) | (yy % 400 == 0)
        dim = torch.tensor(_MONTH_DAYS, dtype=torch.int64,
                           device=yy.device)[(mm - 1).clamp(0, 11)]
        dim = torch.where((mm == 2) & leap, 29, dim)
        ok = ((yy >= 1) & (yy <= 9999) & (mm >= 1) & (mm <= 12)
              & (dd >= 1) & (dd <= dim))
        days = _days_from_civil(yy, mm.clamp(1, 12), dd.clamp(1, 31))
        return make_column(days.to(torch.int32),
                           y.validity & m.validity & d.validity & ok, T.DATE)

    def __repr__(self):
        y, m, d = self.children
        return f"make_date({y!r}, {m!r}, {d!r})"


class TruncDate(UnaryExpression):
    """trunc(date, fmt), fmt a literal: YEAR / YYYY / YY, QUARTER, MONTH /
    MM / MON, WEEK (its Monday)."""

    def __init__(self, child: Expression, fmt: str):
        super().__init__(child)
        self.fmt = fmt.upper()

    def with_children(self, children):
        return TruncDate(children[0], self.fmt)

    @property
    def dtype(self):
        return T.DATE

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        days = c.data.to(torch.int64)
        y, m, _ = _civil_from_days(days)
        if self.fmt in ("YEAR", "YYYY", "YY"):
            out = _first_of(y, 1)
        elif self.fmt == "QUARTER":
            out = _first_of(y, ((m - 1) // 3) * 3 + 1)
        elif self.fmt in ("MONTH", "MM", "MON"):
            out = _first_of(y, m)
        elif self.fmt == "WEEK":
            out = days - (days + 3) % 7   # Monday = 0
        else:
            raise ValueError(self.fmt)
        return make_column(out.to(torch.int32), c.validity, T.DATE)

    def __repr__(self):
        return f"trunc({self.child!r}, {self.fmt!r})"


_DAY_NAMES = ["MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN"]


class NextDay(UnaryExpression):
    """next_day(date, day-of-week literal): the first date strictly after
    ``date`` on that weekday."""

    def __init__(self, child: Expression, day_name: str):
        super().__init__(child)
        self.day_name = day_name
        key = day_name.strip().upper()[:3]
        if key not in _DAY_NAMES:
            raise ValueError(f"bad day name {day_name!r}")
        self.target = _DAY_NAMES.index(key)   # Monday = 0

    def with_children(self, children):
        return NextDay(children[0], self.day_name)

    @property
    def dtype(self):
        return T.DATE

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        days = c.data.to(torch.int64)
        delta = (self.target - (days + 3) % 7) % 7
        out = days + torch.where(delta == 0, 7, delta)
        return make_column(out.to(torch.int32), c.validity, T.DATE)

    def __repr__(self):
        return f"next_day({self.child!r}, {self.day_name!r})"


class MonthsBetween(BinaryExpression):
    """months_between(end, start) over DATEs: the whole months plus the day
    difference / 31, whole where both days are their months' last or the
    days of month agree (Spark, roundOff=false)."""

    symbol = "months_between"

    @property
    def dtype(self):
        return T.DOUBLE

    def eval(self, ctx: EvalContext):
        lc, rc = self.left.eval(ctx), self.right.eval(ctx)
        y1, m1, d1 = _civil_from_days(lc.data)
        y2, m2, d2 = _civil_from_days(rc.data)
        months = (y1 - y2) * 12 + (m1 - m2)
        whole = ((d1 == _month_length(y1, m1)) & (d2 == _month_length(y2, m2))
                 ) | (d1 == d2)
        # a 0-d divisor on the device: CUDA's division by a host number
        # multiplies by its reciprocal
        frac = (d1 - d2).to(torch.float64) / torch.full(
            (), 31.0, dtype=torch.float64, device=d1.device)
        out = months.to(torch.float64) + torch.where(
            whole, torch.zeros((), dtype=torch.float64, device=d1.device),
            frac)
        return make_column(out, null_propagating([lc.validity, rc.validity]),
                           T.DOUBLE)


class _TsScalar(UnaryExpression):
    """An elementwise transform between TIMESTAMP, DATE and integers, over
    the child's value as int64."""

    out_dtype = T.LONG

    @property
    def dtype(self):
        return self.out_dtype

    def _op(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        out = self._op(c.data.to(torch.int64))
        return make_column(out.to(self.out_dtype.torch_dtype), c.validity,
                           self.out_dtype)


class UnixSeconds(_TsScalar):
    """unix_seconds(ts): the floor second."""

    def _op(self, x):
        return _floor(x, MICROS_PER_SECOND)


class UnixMillis(_TsScalar):
    def _op(self, x):
        return _floor(x, 1000)


class UnixMicros(_TsScalar):
    def _op(self, x):
        return x


class SecondsToTimestamp(_TsScalar):
    out_dtype = T.TIMESTAMP

    def _op(self, x):
        return x * MICROS_PER_SECOND


class MillisToTimestamp(_TsScalar):
    out_dtype = T.TIMESTAMP

    def _op(self, x):
        return x * 1000


class MicrosToTimestamp(_TsScalar):
    out_dtype = T.TIMESTAMP

    def _op(self, x):
        return x


class UnixDate(_TsScalar):
    """unix_date(date): its epoch days as INT."""

    out_dtype = T.INT

    def _op(self, x):
        return x


class DateFromUnixDate(_TsScalar):
    out_dtype = T.DATE

    def _op(self, x):
        return x


class _TzShift(UnaryExpression):
    """from_utc_timestamp / to_utc_timestamp: shift the microseconds by the
    named zone's offset at each instant (T1 / T2)."""

    TO_LOCAL = True

    def __init__(self, child: Expression, tz_name: str):
        super().__init__(child)
        self.tz_name = tz_name

    def with_children(self, children):
        return type(self)(children[0], self.tz_name)

    @property
    def dtype(self):
        return T.TIMESTAMP

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        shift = (TZ.utc_to_local_micros if self.TO_LOCAL
                 else TZ.local_to_utc_micros)
        return make_column(shift(c.data.to(torch.int64), self.tz_name),
                           c.validity, T.TIMESTAMP)

    def __repr__(self):
        name = ("from_utc_timestamp" if self.TO_LOCAL
                else "to_utc_timestamp")
        return f"{name}({self.child!r}, {self.tz_name!r})"


class FromUtcTimestamp(_TzShift):
    """from_utc_timestamp(ts, tz): a UTC instant as the zone's wall clock
    (Spark GpuFromUTCTimestamp)."""

    TO_LOCAL = True


class ToUtcTimestamp(_TzShift):
    """to_utc_timestamp(ts, tz): ts read as the zone's wall clock (Spark
    GpuToUTCTimestamp; the gap and overlap rules of java.time)."""

    TO_LOCAL = False


def from_utc_timestamp(e, tz: str) -> FromUtcTimestamp:
    return FromUtcTimestamp(col(e) if isinstance(e, str) else e, tz)


def to_utc_timestamp(e, tz: str) -> ToUtcTimestamp:
    return ToUtcTimestamp(col(e) if isinstance(e, str) else e, tz)
