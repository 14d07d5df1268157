"""Cast expression.

Counterpart of ``spark_rapids_tpu/expressions/casts.py`` (``Cast`` :41),
cut to the identity cast and the decimal casts: decimal -> decimal,
INT / LONG -> decimal, decimal -> INT / LONG and decimal -> DOUBLE.
Spark's non-ANSI rules: a rescale up is exact, a rescale down rounds
HALF_UP once, a value past the target precision is NULL, a decimal ->
integral cast truncates toward zero and is NULL outside the type's range
where the source is two limbs (``_decimal128_cast_eval`` :404; a Decimal64
source truncates and wraps, as ``_decimal_cast`` :447 does).  Where both
sides are Decimal64 the casts are int64 PyTorch; where either is two
limbs, ``kernels/decimal.py``'s ``decimal128_binary`` rescales up and
converts to double and ``decimal128_divide`` rescales down.  Decimal ->
DOUBLE divides the unscaled value by 10**scale, exactly as the reference
does at ``casts.py:467-469``: a multiply by 0.01 would round differently.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, make_column)

_INT_RANGE = {torch.int32: (-2**31, 2**31 - 1),
              torch.int64: (-2**63, 2**63 - 1)}


def decimal_divisor(scale: int, device) -> torch.Tensor:
    """10**scale as a 0-d double tensor on the device.  Dividing by it is an
    IEEE division on the CPU and the card alike; a Python number would not
    do: PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal (7 * 0.01 is not 7 / 100.0)."""
    return torch.full((), 10.0 ** scale, dtype=torch.float64, device=device)


def _integral(dt: T.DataType) -> bool:
    return isinstance(dt, (T.IntegerType, T.LongType))


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
        src_dec = isinstance(src, T.DecimalType)
        dst_dec = isinstance(dst, T.DecimalType)
        if src_dec and isinstance(dst, T.DoubleType):
            if c.is_two_limb:
                from spark_rapids_tpu_torch.kernels import decimal as DK
                return make_column(*DK.decimal128_binary(
                    DK.TO_DOUBLE, c.data, c.validity, ka=src.scale), dst)
            return make_column(
                c.data.to(torch.float64) / decimal_divisor(src.scale,
                                                           c.device),
                c.validity, dst)
        if src_dec and dst_dec:
            return _rescale(c, src.scale, dst)
        if src_dec and _integral(dst):
            return _to_integral(c, dst)
        if dst_dec and _integral(src):
            return _rescale(c, 0, dst)
        raise NotImplementedError(f"cast {src!r} -> {dst!r} is not ported")


def _rescale(c, from_scale: int, dst: T.DecimalType):
    """A decimal (or an integral value at scale 0) to decimal ``dst``."""
    k = dst.scale - from_scale
    if not (T.two_limbs(dst) or c.is_two_limb):
        return _rescale64(c.data.to(torch.int64), c.validity, k, dst)
    from spark_rapids_tpu_torch.kernels import decimal as DK
    data = c.data.to(torch.int64) if c.data.dim() == 1 else c.data
    if k >= 0:
        vals, valid = DK.decimal128_binary(
            DK.RESCALE, data, c.validity, ka=k, precision=dst.precision,
            out_two=dst.uses_two_limbs)
    else:
        vals, valid = DK.decimal128_divide(
            data, c.validity, DK.POW10[-k], precision=dst.precision,
            out_two=dst.uses_two_limbs)
    return make_column(vals, valid, dst)


def _rescale64(data: torch.Tensor, validity: torch.Tensor, k: int,
               dst: T.DecimalType):
    """Decimal64 -> Decimal64 (``_decimal_cast`` :447): scale up checked
    before the multiply (a wrapped product could land back in range),
    scale down HALF_UP away from zero; null past the precision."""
    bound = 10 ** dst.precision
    if k >= 0:
        pre = (bound - 1) // 10 ** k
        validity = validity & (data <= pre) & (data >= -pre)
        out = data * 10 ** k
    else:
        f = 10 ** -k
        out = torch.sign(data) * ((data.abs() + f // 2) // f)
    validity = validity & (out < bound) & (out > -bound)
    return make_column(out, validity, dst)


def _to_integral(c, dst: T.DataType):
    """Decimal -> INT / LONG, truncating toward zero."""
    src = c.dtype
    f = 10 ** src.scale
    if not c.is_two_limb:
        d = c.data
        q = torch.where(d >= 0, d // f, -((-d) // f))
        return make_column(q.to(dst.torch_dtype), c.validity, dst)
    from spark_rapids_tpu_torch.kernels import decimal as DK
    vals, valid = c.data, c.validity
    if src.scale:
        vals, valid = DK.decimal128_divide(vals, valid, f, half_up=False,
                                           precision=DK.INT128)
    v64, fits = DK.narrow64(vals)
    lo, hi = _INT_RANGE[dst.torch_dtype]
    ok = valid & fits & (v64 >= lo) & (v64 <= hi)
    return make_column(v64.to(dst.torch_dtype), ok, dst)
