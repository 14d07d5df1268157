"""Declarative aggregate functions: SUM, COUNT, AVG, MIN, MAX, the
variances and standard deviations, BOOL_AND and BOOL_OR, FIRST and LAST,
MAX_BY and MIN_BY, BIT_AND, BIT_OR and BIT_XOR, and
APPROX_COUNT_DISTINCT.

Counterpart of ``spark_rapids_tpu/expressions/aggregates.py`` (``Sum`` :91,
``Count`` :134, ``Min`` :172, ``Max`` :204, ``Average`` :236,
``VarianceBase`` :382 with ``_finish`` :413, ``VarianceSamp``,
``VariancePop``, ``StddevSamp``, ``StddevPop`` :434-454, ``BoolAnd`` /
``BoolOr`` :476-490, ``First`` :1069, ``Last`` :1113, ``_ExtremeBy`` /
``MaxBy`` / ``MinBy`` :1118-1171, ``_BitAggBase`` and the bit aggregates
:1176-1216, ``ApproximateCountDistinct`` :492 with ``HLL_UPDATE`` /
``HLL_MERGE`` :488-489), decimals included: SUM and AVG over any decimal use
the two-limb SUM128 buffer, MIN / MAX over a Decimal128 the MIN128 /
MAX128 buffers (:91-130, :172-235, :290-345).
Each function declares its buffer slots: the slot's type, how raw rows
fold into it (``update_op``) and how partial buffers fold together
(``merge_op``; counts update by counting and merge by summing), plus a
finalize step over the merged buffers.  The exec layer
(plan/execs/aggregate.py) lowers the ops onto the masked kernels (no
keys) or the segmented kernels (grouped) of ``kernels/reduction.py``.

Type rules follow Spark: sum(integral) -> LONG, sum(floating) -> DOUBLE,
sum(decimal(p, s)) -> decimal(p + 10, s) (a Decimal64 below precision 19,
else a SUM128 buffer: exact, null past its precision), count -> LONG
(never null), avg(numeric) -> DOUBLE and avg(decimal(p, s)) ->
decimal(p + 4, s + 4) (HALF_UP over the exact sum; null over no valid
row), min / max keep the input type (null over no valid row), the
variances and standard deviations are DOUBLE over the buffers (SUM
DOUBLE, M2 merged by Chan's formula, COUNT_VALID), null where the
divisor would be 0.  MIN / MAX over STRING keep the first row holding
the extreme (unsigned byte order).  FIRST / LAST keep their input's type
(any, strings too), MAX_BY / MIN_BY their value's, the bit aggregates
their integral input's; each is null where no row qualifies.  A
multi-input aggregate (MAX_BY, MIN_BY) lists its ``inputs``, and each
buffer slot names the input it folds (``input_index``).  MIN / MAX over
BYTE and SHORT reduce at their own width (BYTE and SHORT results); their
variances update from the values widened to int32 (DOUBLE results).
APPROX_COUNT_DISTINCT is HyperLogLog++ over m = 2^p registers (p from
the relative standard deviation, 9 at the default 0.05): its one buffer
is the fixed-length array<tinyint> of a group's registers, updated by L1
and merged by L2 (``kernels/hll.py``), its LONG result never null.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.core import Expression, col

SUM = "sum"
M2 = "m2"                    # sum of squared deviations from the group mean
M2_MERGE = "m2_merge"        # Chan's parallel merge of partial M2 buffers
COUNT_VALID = "count_valid"  # counts non-null inputs
COUNT_STAR = "count_star"    # counts rows
MIN = "min"
MAX = "max"
FIRST = "first"
FIRST_VALID = "first_valid"  # ignoreNulls=true
LAST = "last"
LAST_VALID = "last_valid"
PICK_OPS = (FIRST, FIRST_VALID, LAST, LAST_VALID)
MAXBY_VAL = "maxby_val"      # x at the extreme of y
MINBY_VAL = "minby_val"
BY_OPS = (MAXBY_VAL, MINBY_VAL)
BIT_AND = "bit_and"
BIT_OR = "bit_or"
BIT_XOR = "bit_xor"
BIT_OPS = (BIT_AND, BIT_OR, BIT_XOR)
SUM128 = "sum128"            # exact two-limb decimal sum (merge: poisoned
                             # by a null partial of a nonzero count)
MIN128 = "min128"
MAX128 = "max128"
HLL_UPDATE = "hll_update"    # HyperLogLog++ registers of the raw rows
HLL_MERGE = "hll_merge"      # their elementwise max across partials


@dataclasses.dataclass(frozen=True)
class BufferSlot:
    """One aggregation buffer column."""

    dtype: T.DataType
    update_op: str
    merge_op: str
    input_index: int = 0   # which of the aggregate's ``inputs`` it folds


class AggregateFunction(Expression):
    """Base: children[0] (if any) is the input value expression; an
    aggregate of several inputs (MAX_BY) overrides ``inputs``."""

    name = "agg"

    @property
    def input(self) -> Optional[Expression]:
        return self.children[0] if self.children else None

    @property
    def inputs(self) -> Tuple[Expression, ...]:
        return (self.children[0],) if self.children else ()

    def with_children(self, children):
        return type(self)(children[0]) if children else type(self)()

    @property
    def buffers(self) -> Tuple[BufferSlot, ...]:
        raise NotImplementedError

    def finalize(self, bufs: List[Tuple[torch.Tensor, torch.Tensor]]):
        """(values, validity) per merged buffer -> (values, validity).  A
        STRING buffer comes as its column in place of its values; a STRING
        result is such a column, whose own validity is the result's."""
        raise NotImplementedError

    def __repr__(self):
        inner = repr(self.input) if self.input is not None else "*"
        return f"{self.name}({inner})"


class Sum(AggregateFunction):
    name = "sum"

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        cdt = self.input.dtype
        if isinstance(cdt, T.DecimalType):
            return T.DecimalType(min(cdt.precision + 10,
                                     T.DecimalType.MAX_PRECISION), cdt.scale)
        if cdt.is_integral or isinstance(cdt, T.BooleanType):
            return T.LONG
        if cdt.is_floating:
            return T.DOUBLE
        raise NotImplementedError(f"sum({cdt!r}) is not ported")

    @property
    def buffers(self):
        dt = self.dtype
        if T.two_limbs(dt):
            # int128 accumulation; an overflow is a null sum buffer beside
            # a nonzero count (Spark's contract since SPARK-28067)
            return (BufferSlot(dt, SUM128, SUM128),
                    BufferSlot(T.LONG, COUNT_VALID, SUM))
        return (BufferSlot(dt, SUM, SUM),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        (s, s_valid), (n, _) = bufs
        return s, (n > 0) & s_valid


class Count(AggregateFunction):
    """count(expr) counts non-null rows; Count(None) counts rows."""

    name = "count"

    def __init__(self, child: Optional[Expression] = None):
        self.children = (child,) if child is not None else ()

    @property
    def dtype(self):
        return T.LONG

    @property
    def buffers(self):
        op = COUNT_STAR if self.input is None else COUNT_VALID
        return (BufferSlot(T.LONG, op, SUM),)

    def finalize(self, bufs):
        (n, _), = bufs
        return n, torch.ones(n.shape, dtype=torch.bool, device=n.device)


class Average(AggregateFunction):
    """avg over a non-decimal numeric input: buffers (DOUBLE SUM, LONG
    COUNT_VALID merged by SUM), result sum / count, null when the count is
    0.  Over decimal(p, s): decimal(p + 4, s + 4), from a two-limb SUM128
    buffer of decimal(max(p + 10, 19), s): the sum rescaled by 10**4, then
    divided by the count with HALF_UP (``decimal128_binary`` and
    ``decimal128_divide``); null where the sum reaches 10**34 (the
    reference's headroom cap, :315-322) or the result its precision."""

    name = "avg"

    def __init__(self, child: Expression):
        self.children = (child,)

    def _decimal_in(self) -> Optional[T.DecimalType]:
        dt = self.input.dtype
        return dt if isinstance(dt, T.DecimalType) else None

    @property
    def dtype(self):
        d = self._decimal_in()
        if d is not None:
            return T.DecimalType(
                min(d.precision + 4, T.DecimalType.MAX_PRECISION),
                min(d.scale + 4, T.DecimalType.MAX_PRECISION))
        cdt = self.input.dtype
        if cdt.is_integral or cdt.is_floating:
            return T.DOUBLE
        raise NotImplementedError(f"avg({cdt!r}) is not ported")

    @property
    def buffers(self):
        d = self._decimal_in()
        if d is not None:
            buf = T.DecimalType(
                min(max(d.precision + 10, T.DecimalType.MAX_LONG_DIGITS + 1),
                    T.DecimalType.MAX_PRECISION), d.scale)
            return (BufferSlot(buf, SUM128, SUM128),
                    BufferSlot(T.LONG, COUNT_VALID, SUM))
        return (BufferSlot(self.dtype, SUM, SUM),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        (s, s_valid), (n, _) = bufs
        d = self._decimal_in()
        if d is None:
            valid = n > 0
            return s / torch.where(valid, n, 1).to(s.dtype), valid
        from spark_rapids_tpu_torch.kernels import decimal as DK
        out = self.dtype
        k = out.scale - d.scale
        valid = s_valid & (n > 0)
        if k != _AVG_HEADROOM:
            # the reference's cap is |sum| < 10**34 whatever the rescale
            valid = DK.decimal128_binary(DK.RESCALE, s, valid,
                                         precision=_AVG_CAP)[1]
        s, valid = DK.decimal128_binary(DK.RESCALE, s, valid, ka=k,
                                        precision=DK.MAX_PRECISION)
        return DK.decimal128_divide(s, valid, n, torch.ones_like(valid),
                                    precision=out.precision,
                                    out_two=out.uses_two_limbs)


#: avg(decimal)'s rescale and its cap on the sum's digits
_AVG_HEADROOM = 4
_AVG_CAP = T.DecimalType.MAX_PRECISION - _AVG_HEADROOM


class _Extreme(AggregateFunction):
    """MIN / MAX: buffers (the extreme at the input's type, LONG
    COUNT_VALID merged by SUM), valid where the count is > 0.  Floats
    follow Spark's order: NaN above everything (MIN skips NaN unless the
    group holds nothing else, any NaN makes MAX NaN), and -0.0 below 0.0,
    as the reference's extremes give it on the CPU.  A STRING's extreme is
    its first row holding the smallest / largest bytes (a pick); a
    Decimal128's is a MIN128 / MAX128 buffer over its two limbs."""

    op = MIN
    op128 = MIN128

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return self.input.dtype

    @property
    def buffers(self):
        dt = self.dtype
        op = self.op128 if T.two_limbs(dt) else self.op
        return (BufferSlot(dt, op, op),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        (v, _), (n, _) = bufs
        return v, n > 0


class Min(_Extreme):
    name = "min"
    op = MIN
    op128 = MIN128


class Max(_Extreme):
    name = "max"
    op = MAX
    op128 = MAX128


class BoolAnd(Min):
    """bool_and / every: true iff every non-null value is true, which is
    MIN over BOOLEAN."""

    name = "bool_and"


class BoolOr(Max):
    """bool_or / any / some: MAX over BOOLEAN."""

    name = "bool_or"


class VarianceBase(AggregateFunction):
    """The shared (SUM DOUBLE, M2, COUNT_VALID) buffer plan.  M2 is the
    sum of squared deviations from the group mean, taken in two passes
    over a batch and merged with Chan's formula (M2 = sum_i M2_i +
    n_i (mean_i - mean)^2), which does not cancel when mean >> stddev as
    the sum-of-squares identity does."""

    name = "var"
    _sample = True    # divide by n - 1 (sample) or n (population)
    _sqrt = False     # a standard deviation

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        cdt = self.input.dtype
        if not (cdt.is_integral or cdt.is_floating):
            raise NotImplementedError(f"{self.name}({cdt!r}) is not ported")
        return T.DOUBLE

    @property
    def buffers(self):
        return (BufferSlot(T.DOUBLE, SUM, SUM),
                BufferSlot(T.DOUBLE, M2, M2_MERGE),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        """The reference's ``_finish``: max(M2, 0) over n - 1 or n, null
        where that divisor is not positive; NaN stays NaN."""
        _, (m2, _), (n, _) = bufs
        ok = n > (1 if self._sample else 0)
        nf = torch.where(n > 0, n, 1).to(m2.dtype)
        div = nf - 1 if self._sample else nf
        var = torch.maximum(m2, torch.zeros((), dtype=m2.dtype,
                                            device=m2.device))
        var = var / torch.where(ok, div, torch.ones((), dtype=div.dtype,
                                                    device=div.device))
        if self._sqrt:
            var = torch.sqrt(var)
        return var, ok


class VarianceSamp(VarianceBase):
    name = "var_samp"
    _sample = True


class VariancePop(VarianceBase):
    name = "var_pop"
    _sample = False


class StddevSamp(VarianceBase):
    name = "stddev_samp"
    _sample = True
    _sqrt = True


class StddevPop(VarianceBase):
    name = "stddev_pop"
    _sample = False
    _sqrt = True


class First(AggregateFunction):
    """first(expr[, ignoreNulls]): the value of the first row in input
    order, or of the first valid row with ``ignore_nulls``; one buffer of
    the input's type, picked again at the merge (the partials arrive in
    input order).  Spark calls it non-deterministic without an ordering:
    the tests pin the partitioning."""

    name = "first"
    _pick_last = False

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        self.children = (child,)
        self.ignore_nulls = bool(ignore_nulls)

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    @property
    def dtype(self):
        return self.input.dtype

    @property
    def buffers(self):
        if self._pick_last:
            op = LAST_VALID if self.ignore_nulls else LAST
        else:
            op = FIRST_VALID if self.ignore_nulls else FIRST
        return (BufferSlot(self.dtype, op, op),)

    def finalize(self, bufs):
        return bufs[0]

    def __repr__(self):
        ign = ", ignoreNulls" if self.ignore_nulls else ""
        return f"{self.name}({self.input!r}{ign})"


class Last(First):
    name = "last"
    _pick_last = True


class _ExtremeBy(AggregateFunction):
    """max_by / min_by(x, y): x at the extreme of y; of equal y the first
    row wins (Spark's update keeps the incumbent).  Buffers: x at the
    pick, y's extreme (MAX / MIN over y, the key the merge picks by) and
    y's valid count; null where y has no valid row."""

    name = "max_by"
    _is_min = False

    def __init__(self, value: Expression, ordering: Expression):
        self.children = (value, ordering)

    @property
    def inputs(self):
        return self.children

    def with_children(self, children):
        return type(self)(children[0], children[1])

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def buffers(self):
        vop = MINBY_VAL if self._is_min else MAXBY_VAL
        kop = MIN if self._is_min else MAX
        return (BufferSlot(self.children[0].dtype, vop, vop, input_index=0),
                BufferSlot(self.children[1].dtype, kop, kop, input_index=1),
                BufferSlot(T.LONG, COUNT_VALID, SUM, input_index=1))

    def finalize(self, bufs):
        (v, v_valid), _key, (n, _) = bufs
        if isinstance(v, DeviceColumn):   # a STRING x: a valid pick has n > 0
            return v, v.validity
        return v, v_valid & (n > 0)

    def __repr__(self):
        return f"{self.name}({self.children[0]!r}, {self.children[1]!r})"


class MaxBy(_ExtremeBy):
    name = "max_by"
    _is_min = False


class MinBy(_ExtremeBy):
    name = "min_by"
    _is_min = True


class _BitAggBase(AggregateFunction):
    """bit_and / bit_or / bit_xor over an integral input: its type kept,
    nulls ignored, null over no valid row.  Buffers: the reduction and
    the valid count."""

    name = "bit_and"
    _op = BIT_AND

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        dt = self.input.dtype
        if not dt.is_integral:
            raise TypeError(f"{self.name} takes an integral input, got "
                            f"{dt!r}")
        return dt

    @property
    def buffers(self):
        return (BufferSlot(self.dtype, self._op, self._op),
                BufferSlot(T.LONG, COUNT_VALID, SUM))

    def finalize(self, bufs):
        (v, v_valid), (n, _) = bufs
        return v, v_valid & (n > 0)


class BitAndAgg(_BitAggBase):
    name = "bit_and"
    _op = BIT_AND


class BitOrAgg(_BitAggBase):
    name = "bit_or"
    _op = BIT_OR


class BitXorAgg(_BitAggBase):
    name = "bit_xor"
    _op = BIT_XOR


class ApproximateCountDistinct(AggregateFunction):
    """approx_count_distinct through HyperLogLog++'s dense registers
    (aggregate/GpuHyperLogLogPlusPlus.scala).  ``finalize`` is the
    reference's ``finalize_jnp`` (:543-556) in torch: the raw estimate
    alpha m^2 / sum(2^-r), linear counting m log(m / zeros) where it is at
    most 2.5 m and a register is empty, rounded half to even.  Each 2^-r
    is exact in float64, and so is their sum over 512 registers in any
    order while every r <= 43 (exponents -43..0 and a total below 2^10
    take at most 53 bits), so the card's sum equals the reference's
    numpy sum; Spark's empirical bias tables are not applied (the
    reference omits them too)."""

    name = "approx_count_distinct"

    def __init__(self, child: Expression, rsd: float = 0.05):
        from spark_rapids_tpu_torch.kernels.hll import p_from_rsd
        self.children = (child,)
        self.rsd = float(rsd)
        self.p = p_from_rsd(self.rsd)

    def with_children(self, children):
        return ApproximateCountDistinct(children[0], self.rsd)

    @property
    def dtype(self):
        return T.LONG

    @property
    def m(self) -> int:
        return 1 << self.p

    @property
    def buffers(self):
        return (BufferSlot(T.ArrayType(T.ByteType(), contains_null=False,
                                       length=self.m),
                           HLL_UPDATE, HLL_MERGE),)

    def finalize(self, bufs):
        from spark_rapids_tpu_torch.kernels.hll import _alpha
        regs = bufs[0][0]    # int8 [groups, m]
        m = self.m
        inv = torch.pow(2.0, -regs.to(torch.float64))
        est = _alpha(m) * m * m / inv.sum(1)
        zeros = (regs == 0).sum(1)
        lc = m * torch.log(m / zeros.clamp(min=1).to(torch.float64))
        est = torch.where((est <= 2.5 * m) & (zeros != 0), lc, est)
        out = torch.round(est).to(torch.int64)
        return out, torch.ones(out.shape, dtype=torch.bool,
                               device=out.device)


def find_aggregates(e: Expression) -> List[AggregateFunction]:
    """All aggregate calls inside an output expression tree."""
    if isinstance(e, AggregateFunction):
        return [e]
    out: List[AggregateFunction] = []
    for c in e.children:
        out += find_aggregates(c)
    return out


def sum_(e) -> Sum:
    return Sum(col(e) if isinstance(e, str) else e)


def count(e=None) -> Count:
    if e is None:
        return Count()
    return Count(col(e) if isinstance(e, str) else e)


def avg(e) -> Average:
    return Average(col(e) if isinstance(e, str) else e)


def _arg(e) -> Expression:
    return col(e) if isinstance(e, str) else e


def min_(e) -> Min:
    return Min(_arg(e))


def max_(e) -> Max:
    return Max(_arg(e))


def var_samp(e) -> VarianceSamp:
    return VarianceSamp(_arg(e))


def var_pop(e) -> VariancePop:
    return VariancePop(_arg(e))


def stddev(e) -> StddevSamp:
    return StddevSamp(_arg(e))


def stddev_pop(e) -> StddevPop:
    return StddevPop(_arg(e))


def first(e, ignore_nulls: bool = False) -> First:
    return First(_arg(e), ignore_nulls)


def last(e, ignore_nulls: bool = False) -> Last:
    return Last(_arg(e), ignore_nulls)


def max_by(value, ordering) -> MaxBy:
    return MaxBy(_arg(value), _arg(ordering))


def min_by(value, ordering) -> MinBy:
    return MinBy(_arg(value), _arg(ordering))


def bit_and(e) -> BitAndAgg:
    return BitAndAgg(_arg(e))


def bit_or(e) -> BitOrAgg:
    return BitOrAgg(_arg(e))


def bit_xor(e) -> BitXorAgg:
    return BitXorAgg(_arg(e))


def approx_count_distinct(e, rsd: float = 0.05) -> ApproximateCountDistinct:
    return ApproximateCountDistinct(_arg(e), rsd)
