"""Expression tree of the port: Catalyst-style nodes evaluated on tensors.

Counterpart of ``spark_rapids_tpu/expressions/core.py`` (``Expression``
:107, ``BoundReference`` :292, ``Literal`` :346, ``Alias`` :415).  ``eval``
maps an ``EvalContext`` to a ``DeviceColumn`` of the batch's exact row
count, on the batch's device.  Elementwise evaluation stays plain PyTorch:
the row-moving and reducing work goes to the kernels in ``kernels/``.

Null semantics follow Spark: nulls propagate through elementwise ops unless
a node says otherwise (three-valued AND).  Null slots hold zero.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


class EvalContext:
    """The input batch of an expression evaluation."""

    def __init__(self, batch: ColumnarBatch):
        self.batch = batch
        self.num_rows = batch.num_rows
        self.device = batch.device


def _not_ported(op: str):
    def raise_(self, *args):
        raise NotImplementedError(f"operator {op} is not ported")
    return raise_


class Expression:
    """Base class.  Subclasses are immutable."""

    children: Tuple["Expression", ...] = ()

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> DeviceColumn:
        raise NotImplementedError(type(self).__name__)

    def bind(self, schema: Schema) -> "Expression":
        """Resolve Col() name references to ordinals against schema."""
        new_children = tuple(c.bind(schema) for c in self.children)
        if all(n is o for n, o in zip(new_children, self.children)):
            return self
        return self.with_children(new_children)

    def with_children(self, children: Tuple["Expression", ...]) -> "Expression":
        raise NotImplementedError(
            f"{type(self).__name__} must override with_children")

    def references(self) -> set:
        out = set()
        for c in self.children:
            out |= c.references()
        return out

    def __bool__(self):
        raise TypeError("Expression has no truth value")

    __hash__ = object.__hash__

    # -- DSL ----------------------------------------------------------------

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def _bin(self, other, cls):
        return cls(self, other if isinstance(other, Expression) else lit(other))

    def __add__(self, other):
        from spark_rapids_tpu_torch.expressions.arithmetic import Add
        return self._bin(other, Add)

    def __sub__(self, other):
        from spark_rapids_tpu_torch.expressions.arithmetic import Subtract
        return self._bin(other, Subtract)

    def __mul__(self, other):
        from spark_rapids_tpu_torch.expressions.arithmetic import Multiply
        return self._bin(other, Multiply)

    def __lt__(self, other):
        from spark_rapids_tpu_torch.expressions.predicates import LessThan
        return self._bin(other, LessThan)

    def __le__(self, other):
        from spark_rapids_tpu_torch.expressions.predicates import (
            LessThanOrEqual)
        return self._bin(other, LessThanOrEqual)

    def __gt__(self, other):
        from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
        return self._bin(other, GreaterThan)

    def __ge__(self, other):
        from spark_rapids_tpu_torch.expressions.predicates import (
            GreaterThanOrEqual)
        return self._bin(other, GreaterThanOrEqual)

    def __and__(self, other):
        from spark_rapids_tpu_torch.expressions.predicates import And
        return self._bin(other, And)

    def __eq__(self, other):
        # a DSL operator, as in the reference: builds EqualTo (hash stays
        # the identity's, above)
        from spark_rapids_tpu_torch.expressions.predicates import EqualTo
        return self._bin(other, EqualTo)

    def __ne__(self, other):
        from spark_rapids_tpu_torch.expressions.predicates import EqualTo, Not
        return Not(self._bin(other, EqualTo))

    def __or__(self, other):
        from spark_rapids_tpu_torch.expressions.predicates import Or
        return self._bin(other, Or)

    def __invert__(self):
        from spark_rapids_tpu_torch.expressions.predicates import Not
        return Not(self)

    def __truediv__(self, other):
        from spark_rapids_tpu_torch.expressions.arithmetic import Divide
        return self._bin(other, Divide)

    __mod__ = _not_ported("%")
    __neg__ = _not_ported("unary -")


class BinaryExpression(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right
        self.children = (left, right)

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class Col(Expression):
    """Unresolved column reference by name (resolved by bind())."""

    def __init__(self, name: str):
        self.name = name

    @property
    def dtype(self):
        raise TypeError(f"unresolved column {self.name!r} has no dtype; "
                        "bind() first")

    def bind(self, schema: Schema) -> Expression:
        idx = schema.index_of(self.name)
        return BoundReference(idx, schema.dtypes[idx], self.name)

    def references(self):
        return {self.name}

    def __repr__(self):
        return f"'{self.name}"


class BoundReference(Expression):
    """Column reference resolved to an ordinal (Catalyst BoundReference)."""

    def __init__(self, ordinal: int, dtype: T.DataType, name: str = "?"):
        self.ordinal = ordinal
        self._dtype = dtype
        self.name = name

    @property
    def dtype(self):
        return self._dtype

    def eval(self, ctx: EvalContext) -> DeviceColumn:
        return ctx.batch.columns[self.ordinal]

    def references(self):
        return {self.name}

    def __repr__(self):
        return f"{self.name}#{self.ordinal}"


def _infer_literal_type(value) -> T.DataType:
    if isinstance(value, bool):
        return T.BOOLEAN
    if isinstance(value, int):
        return T.INT if -(2**31) <= value < 2**31 else T.LONG
    if isinstance(value, float):
        return T.DOUBLE
    if isinstance(value, str):
        return T.STRING
    raise NotImplementedError(f"literal {value!r} of type "
                              f"{type(value).__name__} is not ported")


class Literal(Expression):
    """A constant; a decimal literal is its unscaled int, a string literal
    its UTF-8 bytes in every row.  ``Literal(None, dtype)`` is a typed null:
    an all-invalid column of that type (null slots zero; a string's offsets
    all zero and no bytes), as the reference's ``Literal`` (:346) with its
    expand's ``_coerce`` (``plan/execs/misc.py:72-82``) gives it.  A null
    needs its type: the null type is not ported."""

    def __init__(self, value, dtype: Optional[T.DataType] = None):
        if value is None and dtype is None:
            raise NotImplementedError("a null literal needs its type: the "
                                      "null type is not ported")
        self._dtype = dtype if dtype is not None else _infer_literal_type(value)
        self.value = value

    @property
    def dtype(self):
        return self._dtype

    def eval(self, ctx: EvalContext) -> DeviceColumn:
        n, dev = ctx.num_rows, ctx.device
        if self.value is None:
            invalid = torch.zeros(n, dtype=torch.bool, device=dev)
            if self._dtype.variable_width:
                return DeviceColumn(
                    torch.empty(0, dtype=torch.uint8, device=dev), invalid,
                    self._dtype, torch.zeros(n + 1, dtype=torch.int32,
                                             device=dev))
            return DeviceColumn(
                torch.zeros(n, dtype=self._dtype.torch_dtype, device=dev),
                invalid, self._dtype)
        if self._dtype.variable_width:
            raw = self.value.encode("utf-8")
            if n * len(raw) >= 2**31:
                raise ValueError("a string column holds < 2**31 bytes")
            one = torch.tensor(list(raw), dtype=torch.uint8, device=dev)
            return DeviceColumn(
                one.repeat(n), torch.ones(n, dtype=torch.bool, device=dev),
                self._dtype, torch.arange(n + 1, dtype=torch.int32,
                                          device=dev) * len(raw))
        return DeviceColumn(
            torch.full((n,), self.value, dtype=self._dtype.torch_dtype,
                       device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), self._dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


def lit(value, dtype: Optional[T.DataType] = None) -> Literal:
    if isinstance(value, Literal):
        return value
    return Literal(value, dtype)


def col(name: str) -> Col:
    return Col(name)


class Alias(Expression):
    """Name a subexpression (projection output naming)."""

    def __init__(self, child: Expression, name: str):
        self.child = child
        self.name = name
        self.children = (child,)

    @property
    def dtype(self):
        return self.child.dtype

    def with_children(self, children):
        return Alias(children[0], self.name)

    def eval(self, ctx):
        return self.child.eval(ctx)

    def __repr__(self):
        return f"{self.child!r} AS {self.name}"


def output_name(e: Expression, i: int) -> str:
    """Projection output column name, Spark-style."""
    if isinstance(e, (Alias, Col, BoundReference)):
        return e.name
    return f"col{i}"


def null_propagating(validities: Sequence[torch.Tensor]) -> torch.Tensor:
    out = validities[0]
    for v in validities[1:]:
        out = out & v
    return out


def make_column(values: torch.Tensor, validity: torch.Tensor,
                dtype: T.DataType) -> DeviceColumn:
    """Null slots hold zero."""
    values = torch.where(validity, values,
                         torch.zeros((), dtype=values.dtype,
                                     device=values.device))
    return DeviceColumn(values, validity, dtype)
