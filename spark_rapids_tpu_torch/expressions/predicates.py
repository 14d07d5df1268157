"""Comparison and boolean predicates, and the null test.

Counterpart of ``spark_rapids_tpu/expressions/predicates.py``
(``EqualTo`` :160, ``LessThan`` :174, ``GreaterThan`` :190,
``LessThanOrEqual`` :201, ``GreaterThanOrEqual`` :213, ``And`` :262,
``Or`` :290, ``Not`` :314, ``IsNull`` :328), numeric, date, decimal and
string operands.  Spark semantics: NaN equals NaN and is larger than
every other double; strings compare by their UTF-8 bytes
(``UTF8String.binaryCompare``, a proper prefix first); a comparison with a
null operand is null; AND and OR are three-valued (FALSE AND null = FALSE,
TRUE OR null = TRUE); NOT null is null; IS NULL is never null.

Two decimals compare at their common scale: int64 values where that
scale's precision is at most 18, else two-limb values (:122-135): each
side rescaled by ``decimal128_binary`` (wrapping, as the reference's
``rescale`` wraps), then ``lt128`` / ``eq128``.

Two strings compare as the reference's ``_string_cmp_rank`` (:423) does:
through the sort's string keys (``kernels/sort.py`` ``string_sort_keys``,
a kernel on the card) at the chunk count of the longer column, most
significant chunk first, then the lengths.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    BinaryExpression, EvalContext, Expression, make_column, null_propagating)

_SIGN64 = -2**63


def _cmp_dtype(l: T.DataType, r: T.DataType) -> T.DataType:
    """Common comparison type: the wider decimal, or numeric promotion."""
    if l == r:
        return l
    if isinstance(l, T.DecimalType) and isinstance(r, T.DecimalType):
        scale = max(l.scale, r.scale)
        intd = max(l.precision - l.scale, r.precision - r.scale)
        return T.DecimalType(min(intd + scale, T.DecimalType.MAX_PRECISION),
                             scale)
    return T.numeric_promote(l, r)


def _rescale(unscaled, from_scale: int, to_scale: int):
    """arithmetic.py:68 _rescale_unscaled: no work when the scales agree."""
    if to_scale == from_scale:
        return unscaled
    return unscaled * (10 ** (to_scale - from_scale))


def decimal128_rank(lc, rc, scale: int) -> torch.Tensor:
    """Per row, int8 0, 1 or 2 as decimal ``lc`` is below, equal to or
    above ``rc``, both taken as two limbs at ``scale``."""
    from spark_rapids_tpu_torch.kernels import decimal as DK

    def at_scale(c):
        k = scale - c.dtype.scale
        if k == 0:
            return c.data if c.is_two_limb else DK.widen64(c.data)
        return DK.decimal128_binary(DK.RESCALE, c.data, c.validity, ka=k,
                                    precision=DK.WRAP)[0]
    lhs, rhs = at_scale(lc), at_scale(rc)
    lt, eq = DK.lt128(lhs, rhs), DK.eq128(lhs, rhs)
    one = torch.ones((), dtype=torch.int8, device=lhs.device)
    return torch.where(lt, 0 * one, torch.where(eq, one, 2 * one))


def string_rank(lc, rc) -> torch.Tensor:
    """Per row, int8 0, 1 or 2 as string ``lc`` orders before, equal to or
    after ``rc`` (a null row's rank is meaningless)."""
    from spark_rapids_tpu_torch.kernels.sort import (string_longest,
                                                     string_sort_keys)
    longest = max(string_longest([lc, rc]))
    lch, llen = string_sort_keys(lc, longest)
    rch, rlen = string_sort_keys(rc, longest)
    # the chunks are uint64 bits: flipping the sign bit makes the signed
    # order the unsigned one
    keys = [(a ^ _SIGN64, b ^ _SIGN64) for a, b in zip(lch, rch)]
    keys.append((llen, rlen))
    rank = torch.ones(lc.num_rows, dtype=torch.int8, device=lc.device)
    decided = torch.zeros(lc.num_rows, dtype=torch.bool, device=lc.device)
    for a, b in keys:
        ne = (a != b) & ~decided
        rank = torch.where(ne & (a < b), 0, rank)
        rank = torch.where(ne & (a > b), 2, rank)
        decided = decided | ne
    return rank.to(torch.int8)


class BinaryComparison(BinaryExpression):
    #: the ranks (0 less, 1 equal, 2 greater) that make it true, for
    #: strings and two-limb decimals
    string_ranks: tuple = ()

    @property
    def dtype(self):
        return T.BOOLEAN

    def _compare(self, lhs, rhs, is_float):
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        if lc.is_string or rc.is_string:
            if not (lc.is_string and rc.is_string):
                raise TypeError(f"{self.symbol} compares a string with a "
                                "string only")
            return self._from_rank(string_rank(lc, rc), lc, rc)
        cdt = _cmp_dtype(lc.dtype, rc.dtype)
        if T.two_limbs(cdt) or lc.is_two_limb or rc.is_two_limb:
            return self._from_rank(decimal128_rank(lc, rc, cdt.scale), lc, rc)
        validity = null_propagating([lc.validity, rc.validity])
        if isinstance(cdt, T.DecimalType):
            # compare unscaled int64 values at the common scale
            lhs = _rescale(lc.data, lc.dtype.scale, cdt.scale)
            rhs = _rescale(rc.data, rc.dtype.scale, cdt.scale)
            is_float = False
        else:
            lhs = lc.data.to(cdt.torch_dtype)
            rhs = rc.data.to(cdt.torch_dtype)
            is_float = cdt.is_floating
        return make_column(self._compare(lhs, rhs, is_float), validity,
                           T.BOOLEAN)


    def _from_rank(self, rank, lc, rc):
        vals = torch.zeros(lc.num_rows, dtype=torch.bool, device=lc.device)
        for r in self.string_ranks:
            vals = vals | (rank == r)
        return make_column(vals, null_propagating(
            [lc.validity, rc.validity]), T.BOOLEAN)


def _lt(lhs, rhs, is_float):
    lt = lhs < rhs
    if is_float:
        # NaN is greater than everything: l < NaN iff l is not NaN
        lt = torch.where(torch.isnan(rhs), ~torch.isnan(lhs), lt)
    return lt


def _eq(lhs, rhs, is_float):
    eq = lhs == rhs
    if is_float:
        eq = eq | (torch.isnan(lhs) & torch.isnan(rhs))
    return eq


class EqualTo(BinaryComparison):
    symbol = "="
    string_ranks = (1,)

    def _compare(self, lhs, rhs, is_float):
        return _eq(lhs, rhs, is_float)


class LessThan(BinaryComparison):
    symbol = "<"
    string_ranks = (0,)

    def _compare(self, lhs, rhs, is_float):
        return _lt(lhs, rhs, is_float)


class LessThanOrEqual(BinaryComparison):
    symbol = "<="
    string_ranks = (0, 1)

    def _compare(self, lhs, rhs, is_float):
        return _lt(lhs, rhs, is_float) | _eq(lhs, rhs, is_float)


class GreaterThan(BinaryComparison):
    symbol = ">"
    string_ranks = (2,)

    def _compare(self, lhs, rhs, is_float):
        return _lt(rhs, lhs, is_float)


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="
    string_ranks = (1, 2)

    def _compare(self, lhs, rhs, is_float):
        return _lt(rhs, lhs, is_float) | _eq(lhs, rhs, is_float)


class And(BinaryExpression):
    symbol = "AND"

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        lt = lc.data & lc.validity    # true-and-valid
        rt = rc.data & rc.validity
        lf = ~lc.data & lc.validity   # false-and-valid
        rf = ~rc.data & rc.validity
        validity = (lc.validity & rc.validity) | lf | rf
        return make_column(lt & rt, validity, T.BOOLEAN)


class Or(BinaryExpression):
    symbol = "OR"

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        lt = lc.data & lc.validity    # true-and-valid
        rt = rc.data & rc.validity
        validity = (lc.validity & rc.validity) | lt | rt
        return make_column(lt | rt, validity, T.BOOLEAN)


class Not(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    def with_children(self, children):
        return Not(children[0])

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return make_column(~c.data & c.validity, c.validity, T.BOOLEAN)

    def __repr__(self):
        return f"NOT {self.child!r}"


class IsNull(Expression):
    """True where the child is null; never null itself."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    def with_children(self, children):
        return IsNull(children[0])

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return make_column(~c.validity, torch.ones_like(c.validity),
                           T.BOOLEAN)

    def __repr__(self):
        return f"isnull({self.child!r})"
