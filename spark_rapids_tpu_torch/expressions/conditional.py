"""The conditional expressions If and CaseWhen.

Counterpart of ``spark_rapids_tpu/expressions/conditional.py`` (``If``
:26, ``CaseWhen`` :74): every branch is evaluated over the whole batch and
selected row by row.  The result takes the type of the (first) value
branch, the others cast to it as the reference does; a null predicate or
condition does not take its branch, and the result is null where the
selected value is (a CASE WHEN without ELSE: where no condition holds).
Fixed-width values select with ``torch.where``; string values with the
string assembly kernel (``kernels/strings.py`` ``select_strings``), which
takes a whole CASE WHEN in one launch where the reference folds its
branches from the right through ``select_strings`` (:49-50, :125-143),
with the same rows.

``NullIf`` (:175), ``Nvl2`` (:201) and ``Greatest`` / ``Least``
(``_Extremum`` :232, :298, :302) follow the reference's device path:
nullif(a, b) is null where both are valid and equal (NaN is not equal to
NaN there, -0.0 equals 0.0), else a; nvl2(c, a, b) is IF(c IS NOT NULL,
a, b); greatest / least skip nulls, are null only where every input is,
take each input at the first child's type, order NaN above every number
and keep the earlier input on a tie.  Over strings the three raise at
planning, as the reference's tag sends them to its CPU.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)
from spark_rapids_tpu_torch.kernels.strings import select_strings


def _taken(c) -> torch.Tensor:
    """Rows whose predicate is true (a null one is not)."""
    return c.data & c.validity


def _pick(take: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          dt: T.DataType) -> torch.Tensor:
    return torch.where(take[:, None] if T.two_limbs(dt) else take,
                       a.to(dt.torch_dtype), b.to(dt.torch_dtype))


class If(Expression):
    def __init__(self, predicate: Expression, if_true: Expression,
                 if_false: Expression):
        self.predicate = predicate
        self.if_true = if_true
        self.if_false = if_false
        self.children = (predicate, if_true, if_false)

    def with_children(self, children):
        return If(*children)

    @property
    def dtype(self):
        return self.if_true.dtype

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype
        take_true = _taken(self.predicate.eval(ctx))
        t = self.if_true.eval(ctx)
        f = self.if_false.eval(ctx)
        if out_dt.variable_width:
            choice = torch.where(take_true, 0, 1).to(torch.int32)
            return select_strings(choice, [t, f])
        validity = torch.where(take_true, t.validity, f.validity)
        return make_column(_pick(take_true, t.data, f.data, out_dt),
                           validity, out_dt)

    def __repr__(self):
        return f"if({self.predicate!r}, {self.if_true!r}, {self.if_false!r})"


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2]... [ELSE e] END: the first
    branch whose condition is true wins."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        self.branches = tuple((c, v) for c, v in branches)
        self.else_value = else_value
        kids: List[Expression] = []
        for c, v in self.branches:
            kids += [c, v]
        if else_value is not None:
            kids.append(else_value)
        self.children = tuple(kids)

    def with_children(self, children):
        n = len(self.branches)
        branches = [(children[2 * i], children[2 * i + 1]) for i in range(n)]
        else_v = children[2 * n] if len(children) > 2 * n else None
        return CaseWhen(branches, else_v)

    @property
    def dtype(self):
        return self.branches[0][1].dtype

    def eval(self, ctx: EvalContext):
        out_dt = self.dtype
        if out_dt.variable_width:
            return self._eval_strings(ctx)
        n, dev = ctx.num_rows, ctx.device
        shape = (n, 2) if T.two_limbs(out_dt) else (n,)
        vals = torch.zeros(shape, dtype=out_dt.torch_dtype, device=dev)
        validity = torch.zeros(n, dtype=torch.bool, device=dev)
        if self.else_value is not None:
            e = self.else_value.eval(ctx)
            vals = e.data.to(out_dt.torch_dtype)
            validity = e.validity
        decided = torch.zeros(n, dtype=torch.bool, device=dev)
        for cond, value in self.branches:
            c = _taken(cond.eval(ctx))
            v = value.eval(ctx)
            take = c & ~decided
            vals = _pick(take, v.data, vals, out_dt)
            validity = torch.where(take, v.validity, validity)
            decided = decided | c
        return make_column(vals, validity, out_dt)

    def _eval_strings(self, ctx: EvalContext):
        """One select over every value: each row's branch is its first
        true condition's, else ELSE's (or none: null)."""
        values = [v.eval(ctx) for _, v in self.branches]
        if self.else_value is not None:
            values.append(self.else_value.eval(ctx))
        choice = torch.full((ctx.num_rows,), len(values)
                            if self.else_value is None else len(values) - 1,
                            dtype=torch.int32, device=ctx.device)
        for i in reversed(range(len(self.branches))):
            take = _taken(self.branches[i][0].eval(ctx))
            choice = torch.where(take, i, choice).to(torch.int32)
        return select_strings(choice, values)

    def __repr__(self):
        parts = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.branches)
        tail = f" ELSE {self.else_value!r}" if self.else_value is not None \
            else ""
        return f"CASE {parts}{tail} END"


class NullIf(Expression):
    """nullif(a, b): NULL where a == b, else a."""

    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = (left, right)

    def with_children(self, children):
        return NullIf(*children)

    @property
    def dtype(self):
        return self.left.dtype

    def eval(self, ctx: EvalContext):
        l, r = self.left.eval(ctx), self.right.eval(ctx)
        if l.is_string or l.is_two_limb or r.is_string or r.is_two_limb:
            raise NotImplementedError(f"nullif over {l.dtype!r}")
        eq = (l.data == r.data) & l.validity & r.validity
        return make_column(l.data, l.validity & ~eq, self.dtype)

    def __repr__(self):
        return f"nullif({self.left!r}, {self.right!r})"


class Nvl2(Expression):
    """nvl2(c, a, b): a where c is not null, else b."""

    def __init__(self, cond: Expression, if_notnull: Expression,
                 if_null: Expression):
        self.cond, self.if_notnull, self.if_null = cond, if_notnull, if_null
        self.children = (cond, if_notnull, if_null)

    def with_children(self, children):
        return Nvl2(*children)

    @property
    def dtype(self):
        return self.if_notnull.dtype

    def eval(self, ctx: EvalContext):
        from spark_rapids_tpu_torch.expressions.predicates import IsNotNull
        return If(IsNotNull(self.cond), self.if_notnull,
                  self.if_null).eval(ctx)

    def __repr__(self):
        return (f"nvl2({self.cond!r}, {self.if_notnull!r}, "
                f"{self.if_null!r})")


class _Extremum(Expression):
    prefer_greater = True

    def __init__(self, *children: Expression):
        if len(children) < 2:
            raise ValueError(f"{type(self).__name__.lower()} needs at least "
                             "two inputs")
        self.children = tuple(children)

    def with_children(self, children):
        return type(self)(*children)

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval(self, ctx: EvalContext):
        dt = self.dtype
        cols = [c.eval(ctx) for c in self.children]
        if dt.variable_width or T.two_limbs(dt):
            raise NotImplementedError(
                f"{type(self).__name__.lower()} over {dt!r}")
        acc, acc_valid = cols[0].data.to(dt.torch_dtype), cols[0].validity
        for c in cols[1:]:
            v = c.data.to(dt.torch_dtype)
            if dt.is_floating:
                v_nan, a_nan = torch.isnan(v), torch.isnan(acc)
                wins = (v_nan | (~a_nan & (v > acc)) if self.prefer_greater
                        else ~v_nan & (a_nan | (v < acc)))
            else:
                wins = v > acc if self.prefer_greater else v < acc
            take = c.validity & (~acc_valid | wins)
            acc = torch.where(take, v, acc)
            acc_valid = acc_valid | c.validity
        return make_column(acc, acc_valid, dt)

    def __repr__(self):
        name = "greatest" if self.prefer_greater else "least"
        return f"{name}({', '.join(map(repr, self.children))})"


class Greatest(_Extremum):
    prefer_greater = True


class Least(_Extremum):
    prefer_greater = False
