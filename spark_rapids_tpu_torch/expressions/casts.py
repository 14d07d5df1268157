"""Cast expression.

Counterpart of ``spark_rapids_tpu/expressions/casts.py`` (``Cast`` :41),
cut to the identity cast and Decimal64 -> DOUBLE.  The latter divides the
unscaled value by 10**scale, exactly as the reference does at
``casts.py:467-469``: a multiply by 0.01 would round differently.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)


def decimal_divisor(scale: int, device) -> torch.Tensor:
    """10**scale as a 0-d double tensor on the device.  Dividing by it is an
    IEEE division on the CPU and the card alike; a Python number would not
    do: PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal (7 * 0.01 is not 7 / 100.0)."""
    return torch.full((), 10.0 ** scale, dtype=torch.float64, device=device)


class Cast(Expression):
    def __init__(self, child: Expression, dtype: T.DataType):
        self.child = child
        self.children = (child,)
        self._dtype = dtype

    def with_children(self, children):
        return Cast(children[0], self._dtype)

    @property
    def dtype(self):
        return self._dtype

    def __repr__(self):
        return f"cast({self.child!r} AS {self._dtype!r})"

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        src, dst = c.dtype, self._dtype
        if src == dst:
            return c
        if isinstance(src, T.DecimalType) and isinstance(dst, T.DoubleType):
            return make_column(
                c.data.to(torch.float64) / decimal_divisor(src.scale,
                                                           c.device),
                c.validity, dst)
        raise NotImplementedError(f"cast {src!r} -> {dst!r} is not ported")
