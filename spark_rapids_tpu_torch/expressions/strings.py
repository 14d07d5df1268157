"""String expressions: SUBSTRING.

Counterpart of ``spark_rapids_tpu/expressions/strings.py`` ``Substring``
(:87): SUBSTRING(str, pos[, len]) over UTF-8 characters, 1-based.  ``pos``
and ``len`` are expressions evaluated per row and cast to int32 (a long
wraps, as the reference's ``astype(jnp.int32)`` does); a missing ``len``
is ``2**30``, as in the reference.  A literal ``pos`` or ``len`` reaches
the kernel as one value for every row.  As in the reference, the result's
validity is the string's alone: a null ``pos`` or ``len`` reads its zero
slot.  The work is ``kernels/strings.py`` ``substring`` (a kernel on the
card).
"""
from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (EvalContext, Expression,
                                                     Literal, lit)
from spark_rapids_tpu_torch.kernels.strings import NO_LENGTH, substring


def _int32_arg(e: Optional[Expression], ctx: EvalContext,
               default: int) -> torch.Tensor:
    """int32 [n] values of an argument, or [1] for a literal or none."""
    if e is None or (isinstance(e, Literal) and e.value is not None):
        v = default if e is None else int(e.value)
        return torch.tensor([v], dtype=torch.int64,
                            device=ctx.device).to(torch.int32)
    return e.eval(ctx).data.to(torch.int32)


class Substring(Expression):
    """SUBSTRING(str, pos[, len]), 1-based, over characters."""

    def __init__(self, child: Expression, pos,
                 length: Optional[Expression] = None):
        self.child = child
        self.pos = pos if isinstance(pos, Expression) else lit(pos)
        self.length = (length if isinstance(length, Expression)
                       or length is None else lit(length))
        self.children = ((child, self.pos, self.length)
                         if self.length is not None else (child, self.pos))

    def with_children(self, children):
        return Substring(children[0], children[1],
                         children[2] if len(children) > 2 else None)

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return substring(c, _int32_arg(self.pos, ctx, 0),
                         _int32_arg(self.length, ctx, NO_LENGTH))

    def __repr__(self):
        return f"substring({self.child!r}, {self.pos!r}, {self.length!r})"
