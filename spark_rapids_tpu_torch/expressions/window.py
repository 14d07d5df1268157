"""Window expressions: frames, specs, the ranking, offset and positional
functions, and ``over``.

Counterpart of ``spark_rapids_tpu/expressions/window.py`` (``WindowFrame``
:26, ``WindowSpec`` :41, ``RowNumber`` :81, ``Rank`` :97, ``DenseRank``
:113, ``Lead`` / ``Lag`` :129-148, ``WindowExpression`` :151, ``over``
:184, ``PercentRank`` :199, ``CumeDist`` :217, ``Ntile`` :234,
``FirstValue`` / ``LastValue`` / ``NthValue`` :259-297), with the same
result types and nullability.  A WindowExpression pairs a function (a
ranking, offset or positional function, or an aggregate) with a
WindowSpec; the window exec (``plan/execs/window.py``) evaluates it over
a partition-sorted layout.  These classes carry structure only: their
``eval`` is the exec's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expressions.core import Expression, col
from spark_rapids_tpu_torch.kernels.sort import SortOrder

UNBOUNDED = None
CURRENT = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """kind: 'rows' or 'range'.  start / end: None is unbounded, 0 the
    current row, -n / +n offsets (rows before / after, or order-key
    distance for a range frame)."""

    kind: str = "range"
    start: Optional[int] = UNBOUNDED
    end: Optional[int] = CURRENT

    def is_unbounded_to_current(self) -> bool:
        return self.start is None and self.end == 0

    def is_unbounded_both(self) -> bool:
        return self.start is None and self.end is None


class WindowSpec:
    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_by: Sequence[Tuple[Expression, SortOrder]] = (),
                 frame: Optional[WindowFrame] = None):
        self.partition_by = tuple(partition_by)
        self.order_by = tuple(o if isinstance(o, tuple) else
                              (o, SortOrder(True)) for o in order_by)
        if frame is None:
            # Spark's defaults: RANGE UNBOUNDED PRECEDING..CURRENT ROW with
            # an ORDER BY, the whole partition without
            frame = (WindowFrame("range", UNBOUNDED, CURRENT)
                     if self.order_by else WindowFrame("range", None, None))
        self.frame = frame

    def __repr__(self):
        parts = []
        if self.partition_by:
            parts.append("partition by " + ", ".join(
                map(repr, self.partition_by)))
        if self.order_by:
            parts.append("order by " + ", ".join(
                f"{e!r} {o!r}" for e, o in self.order_by))
        parts.append(f"{self.frame.kind} [{self.frame.start},"
                     f"{self.frame.end}]")
        return "(" + " ".join(parts) + ")"


class WindowFunction(Expression):
    """A ranking, offset or positional function: it exists only inside a
    window."""

    name = "winfn"
    children = ()

    def with_children(self, children):
        return self

    def __repr__(self):
        return f"{self.name}()"


class _Ranking(WindowFunction):
    """A function of the row's position alone: never null."""

    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return False


class RowNumber(_Ranking):
    name = "row_number"


class Rank(_Ranking):
    name = "rank"


class DenseRank(_Ranking):
    name = "dense_rank"


class PercentRank(_Ranking):
    """(rank - 1) / (partition rows - 1); 0.0 for a single-row
    partition."""

    name = "percent_rank"

    @property
    def dtype(self):
        return T.DOUBLE


class CumeDist(_Ranking):
    """Rows up to and with the row's peers over the partition's rows."""

    name = "cume_dist"

    @property
    def dtype(self):
        return T.DOUBLE


class Ntile(_Ranking):
    """ntile(n): n near-equal buckets, the remainder spread over the first
    ones (Spark's NTile)."""

    name = "ntile"

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"ntile needs n >= 1, got {n}")
        self.n = int(n)

    def __repr__(self):
        return f"ntile({self.n})"


class Lead(WindowFunction):
    """The value ``offset`` rows after the row in its partition, else
    null; ``Lag`` the value before."""

    name = "lead"

    def __init__(self, child: Expression, offset: int = 1):
        self.child = child
        self.offset = offset
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0], self.offset)

    @property
    def dtype(self):
        return self.child.dtype

    def __repr__(self):
        return f"{self.name}({self.child!r}, {self.offset})"


class Lag(Lead):
    name = "lag"


class FirstValue(WindowFunction):
    """The frame's first row's value, nulls respected (Spark's default);
    ``LastValue`` its last row's."""

    name = "first_value"

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0])

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True

    def __repr__(self):
        return f"{self.name}({self.child!r})"


class LastValue(FirstValue):
    name = "last_value"


class NthValue(FirstValue):
    """nth_value(col, k): the frame's k-th row's value (1-based), null
    when the frame holds fewer than k rows."""

    name = "nth_value"

    def __init__(self, child: Expression, k: int):
        if k < 1:
            raise ValueError(f"nth_value needs k >= 1, got {k}")
        super().__init__(child)
        self.k = int(k)

    def with_children(self, children):
        return NthValue(children[0], self.k)

    def __repr__(self):
        return f"nth_value({self.child!r}, {self.k})"


class WindowExpression(Expression):
    def __init__(self, function: Expression, spec: WindowSpec):
        if not isinstance(function, (WindowFunction, AggregateFunction)):
            raise TypeError(f"not a window-capable function: {function!r}")
        self.function = function
        self.spec = spec
        self.children = ((function,) + tuple(spec.partition_by)
                         + tuple(e for e, _ in spec.order_by))

    def with_children(self, children):
        n_part = len(self.spec.partition_by)
        part = children[1:1 + n_part]
        orders = tuple((e, o) for e, (_, o) in zip(children[1 + n_part:],
                                                   self.spec.order_by))
        return WindowExpression(children[0],
                                WindowSpec(part, orders, self.spec.frame))

    @property
    def dtype(self):
        return self.function.dtype

    @property
    def nullable(self):
        return True

    def __repr__(self):
        return f"{self.function!r} OVER {self.spec!r}"


def over(function: Expression, partition_by=(), order_by=(),
         frame: Optional[WindowFrame] = None) -> WindowExpression:
    """DSL: over(sum_('x'), partition_by=['k'], order_by=['t']); an order
    is a name, an expression or an (expression or name, SortOrder)
    pair."""
    pb = [col(p) if isinstance(p, str) else p for p in partition_by]
    ob = []
    for o in order_by:
        if isinstance(o, str):
            ob.append((col(o), SortOrder(True)))
        elif isinstance(o, tuple) and isinstance(o[0], str):
            ob.append((col(o[0]), o[1]))
        else:
            ob.append(o)
    return WindowExpression(function, WindowSpec(pb, ob, frame))
