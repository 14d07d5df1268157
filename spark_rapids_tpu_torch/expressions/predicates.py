"""Comparison and boolean predicates, and the null test.

Counterpart of ``spark_rapids_tpu/expressions/predicates.py``
(``EqualTo`` :160, ``LessThan`` :174, ``GreaterThan`` :190,
``LessThanOrEqual`` :201, ``GreaterThanOrEqual`` :213, ``And`` :262,
``Or`` :290, ``Not`` :314, ``IsNull`` :328, ``EqualNullSafe`` :225,
``IsNotNull`` :347, ``In`` :366, ``Coalesce`` :473), numeric, date,
decimal and string operands.  Spark semantics: NaN equals NaN and is
larger than every other double; strings compare by their UTF-8 bytes
(``UTF8String.binaryCompare``, a proper prefix first); a comparison with a
null operand is null; AND and OR are three-valued (FALSE AND null = FALSE,
TRUE OR null = TRUE); NOT null is null; IS NULL, IS NOT NULL and ``<=>``
are never null.  Numeric operands of two types compare at their
promotion (BYTE < SHORT < INT < LONG < FLOAT < DOUBLE).

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
    BinaryExpression, EvalContext, Expression, lit, make_column,
    null_propagating)

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
        return self.compare(self.left.eval(ctx), self.right.eval(ctx))

    def compare(self, lc, rc):
        """The comparison of two evaluated columns, null where either is
        (a null slot false)."""
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


class EqualNullSafe(BinaryComparison):
    """``<=>`` (:225): equality where both sides are valid, TRUE where both
    are null, FALSE where one is; never null."""

    symbol = "<=>"
    string_ranks = (1,)

    def _compare(self, lhs, rhs, is_float):
        return _eq(lhs, rhs, is_float)

    def compare(self, lc, rc):
        eq = super().compare(lc, rc)
        both_null = ~lc.validity & ~rc.validity
        return make_column(eq.data | both_null, torch.ones_like(eq.validity),
                           T.BOOLEAN)


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


class IsNotNull(Expression):
    """True where the child is valid (:347); never null itself."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    def with_children(self, children):
        return IsNotNull(children[0])

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return make_column(c.validity, torch.ones_like(c.validity),
                           T.BOOLEAN)

    def __repr__(self):
        return f"isnotnull({self.child!r})"


class In(Expression):
    """``value IN (items...)`` (:366), three-valued: TRUE where an item
    equals the value (as ``=`` compares them), null where the value is
    null or where none does and an item is null, else FALSE.  An item that
    is null in some rows counts as null in those rows only; the reference
    takes every column item as null in every row (its ``nullable``), the
    same where the items are literals, as they are here."""

    def __init__(self, value: Expression, items, null_item: bool = False):
        self.value = value
        #: a Python None among the items: a null of the value's type
        self.null_item = null_item or any(i is None for i in items)
        self.items = tuple(i if isinstance(i, Expression) else lit(i)
                           for i in items if i is not None)
        self.children = (value,) + self.items

    def with_children(self, children):
        return In(children[0], children[1:], self.null_item)

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        vc = self.value.eval(ctx)
        hit = torch.zeros_like(vc.validity)
        null_item = torch.full_like(vc.validity, self.null_item)
        eq = EqualTo(self.value, self.value)   # its compare of two columns
        for item in self.items:
            ic = item.eval(ctx)
            hit = hit | eq.compare(vc, ic).data
            null_item = null_item | ~ic.validity
        return make_column(hit, vc.validity & (hit | ~null_item), T.BOOLEAN)

    def __repr__(self):
        items = [repr(i) for i in self.items] + ["NULL"] * self.null_item
        return f"{self.value!r} IN ({', '.join(items)})"


class Coalesce(Expression):
    """The first valid argument (``nullExpressions.scala`` GpuCoalesce,
    :473), of the first argument's type; null where every one is null.
    Strings go through the string assembly kernel's select (one launch),
    as a string IF does."""

    def __init__(self, *exprs: Expression):
        self.children = tuple(exprs)

    def with_children(self, children):
        return Coalesce(*children)

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype
        cols = [c.eval(ctx) for c in self.children]
        if out_dt.variable_width:
            from spark_rapids_tpu_torch.kernels.strings import select_strings
            choice = torch.full((ctx.num_rows,), len(cols), dtype=torch.int32,
                                device=ctx.device)
            for i in reversed(range(len(cols))):
                choice = torch.where(cols[i].validity, i, choice).to(
                    torch.int32)
            return select_strings(choice, cols)
        vals = cols[-1].data.to(out_dt.torch_dtype)
        validity = cols[-1].validity
        for c in reversed(cols[:-1]):
            take = c.validity[:, None] if T.two_limbs(out_dt) else c.validity
            vals = torch.where(take, c.data.to(out_dt.torch_dtype), vals)
            validity = validity | c.validity
        return make_column(vals, validity, out_dt)

    def __repr__(self):
        return f"coalesce({', '.join(map(repr, self.children))})"
