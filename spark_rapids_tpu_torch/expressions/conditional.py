"""The conditional expression If.

Counterpart of ``spark_rapids_tpu/expressions/conditional.py`` (``If``
:26) for fixed-width branches: both branches are evaluated over the whole
batch and selected elementwise.  The result takes the type of the true
branch (the false branch is cast to it, as the reference does); a null
predicate selects the false branch, and the result is null where the
selected branch is.  A string If (the reference's ``select_strings``) is
not ported.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)


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
        if out_dt.variable_width:
            raise NotImplementedError("a string If is not ported")
        p = self.predicate.eval(ctx)
        t = self.if_true.eval(ctx)
        f = self.if_false.eval(ctx)
        take_true = p.data & p.validity
        pick = take_true[:, None] if T.two_limbs(out_dt) else take_true
        vals = torch.where(pick, t.data.to(out_dt.torch_dtype),
                           f.data.to(out_dt.torch_dtype))
        validity = torch.where(take_true, t.validity, f.validity)
        return make_column(vals, validity, out_dt)

    def __repr__(self):
        return f"if({self.predicate!r}, {self.if_true!r}, {self.if_false!r})"
