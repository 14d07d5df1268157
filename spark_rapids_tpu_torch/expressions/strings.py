"""String expressions.

Counterpart of ``spark_rapids_tpu/expressions/strings.py``: ``Length``
:42, ``Upper`` :61, ``Lower`` :74, ``Substring`` :87, ``ConcatStrings``
:144, ``StartsWith`` / ``EndsWith`` / ``Contains`` :166-231, ``Like``
:234, ``RLike`` :372, ``Trim`` / ``LTrim`` / ``RTrim`` :443-491,
``Reverse`` :494, ``InitCap`` :513, ``StringReplace`` :544,
``StringLocate`` / ``StringInstr`` :588-641, ``Ascii`` :644,
``StringRepeat`` :679, ``Lpad`` / ``Rpad`` :711-761, ``ConcatWs`` :763,
``Left`` / ``Right`` :796-850, ``OctetLength`` / ``BitLength`` :852-886,
``Translate`` :888, ``Empty2Null`` :947 and ``Concat`` :967, with the
reference's constructors.  Each result has the device path's rows (the
reference's ``eval``); the work is ``kernels/strings.py`` (kernels on the
card), and the elementwise work over offsets (``OctetLength``,
``BitLength``, ``Ascii``, ``Empty2Null``) is plain torch.

SUBSTRING(str, pos[, len]) counts UTF-8 characters, 1-based.  ``pos``
and ``len`` are expressions evaluated per row and cast to int32 (a long
wraps, as the reference's ``astype(jnp.int32)`` does); a missing ``len``
is ``2**30``, as in the reference.  A literal ``pos`` or ``len`` reaches
the kernel as one value for every row.  As in the reference, the result's
validity is the string's alone: a null ``pos`` or ``len`` reads its zero
slot.

UPPER and LOWER map ASCII and Latin-1 (the reference's device coverage;
its CPU oracle maps all of Unicode), INITCAP ASCII letters after 0x20 or
at a row's start, TRIM strips 0x20 only.  LIKE's shapes ``'lit'``,
``'lit%'``, ``'%lit'`` and ``'%lit%'`` run the literal tests (the exact
shape as a prefix test and a byte length); every other pattern, and
RLIKE, compiles to a DFA on the host (``regex/``) that the DFA kernel
runs.  STARTSWITH / ENDSWITH / CONTAINS take a literal pattern (a null
one gives null rows); the planner raises for any other.
"""
from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.core import (BinaryExpression,
                                                     EvalContext, Expression,
                                                     Literal, UnaryExpression,
                                                     lit, make_column)
from spark_rapids_tpu_torch.kernels import strings as SK
from spark_rapids_tpu_torch.kernels.strings import NO_LENGTH, substring


def _int32_arg(e: Optional[Expression], ctx: EvalContext,
               default: int) -> torch.Tensor:
    """int32 [n] values of an argument, or [1] for a literal or none."""
    if e is None or (isinstance(e, Literal) and e.value is not None):
        v = default if e is None else int(e.value)
        return torch.tensor([v], dtype=torch.int64,
                            device=ctx.device).to(torch.int32)
    return e.eval(ctx).data.to(torch.int32)


def _with_validity(out: DeviceColumn, validity: torch.Tensor) -> DeviceColumn:
    return DeviceColumn(out.data, validity, T.STRING, out.offsets)


class _StringToString(UnaryExpression):
    """A string function of one string: the kernel wrapper ``fn``."""

    fn = None

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return _with_validity(type(self).fn(c), c.validity)


class _StringToInt(UnaryExpression):
    @property
    def dtype(self):
        return T.INT

    def _values(self, c: DeviceColumn) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return make_column(self._values(c).to(torch.int32), c.validity, T.INT)


class Length(_StringToInt):
    """Character count (Spark length)."""

    def _values(self, c):
        return SK.char_length(c)


class Upper(_StringToString):
    fn = staticmethod(SK.upper_ascii)


class Lower(_StringToString):
    fn = staticmethod(SK.lower_ascii)


class Trim(_StringToString):
    fn = staticmethod(SK.trim_ws)


class LTrim(_StringToString):
    fn = staticmethod(SK.ltrim_ws)


class RTrim(_StringToString):
    fn = staticmethod(SK.rtrim_ws)


class Reverse(_StringToString):
    """Character-level reverse (stringFunctions.scala GpuStringReverse)."""

    fn = staticmethod(SK.reverse_chars)


class InitCap(_StringToString):
    """ASCII initcap (like Upper / Lower on the device)."""

    fn = staticmethod(SK.initcap_ascii)


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


class ConcatStrings(BinaryExpression):
    """Two-way string concat, null if either side is."""

    symbol = "||"

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        return SK.concat_strings([self.left.eval(ctx), self.right.eval(ctx)])


class _LiteralPatternPredicate(BinaryExpression):
    """STARTSWITH / ENDSWITH / CONTAINS with a literal pattern."""

    fn = None

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, ctx: EvalContext):
        if not isinstance(self.right, Literal):
            raise NotImplementedError(
                "non-literal match patterns are not supported yet")
        c = self.left.eval(ctx)
        v = self.right.value
        if v is None:   # a null pattern: every row null
            return make_column(torch.zeros_like(c.validity),
                               torch.zeros_like(c.validity), T.BOOLEAN)
        return make_column(type(self).fn(c, v.encode("utf-8")), c.validity,
                           T.BOOLEAN)


class StartsWith(_LiteralPatternPredicate):
    symbol = "STARTSWITH"
    fn = staticmethod(SK.startswith_literal)


class EndsWith(_LiteralPatternPredicate):
    symbol = "ENDSWITH"
    fn = staticmethod(SK.endswith_literal)


class Contains(_LiteralPatternPredicate):
    symbol = "CONTAINS"
    fn = staticmethod(SK.contains_literal)


class _DfaPredicate(Expression):
    """A boolean over one string column by a host-compiled DFA; the
    tables are built once and kept on each device they were asked for."""

    def __init__(self, child: Expression, pattern: str):
        self.child = child
        self.pattern = pattern
        self.children = (child,)
        self._dfa = None
        self._tables = {}

    def with_children(self, children):
        return type(self)(children[0], self.pattern)

    @property
    def dtype(self):
        return T.BOOLEAN

    def _compiled(self):
        raise NotImplementedError

    def _match(self, c: DeviceColumn) -> torch.Tensor:
        dfa = self._compiled()
        key = str(c.device)
        if key not in self._tables:
            self._tables[key] = SK.dfa_tables(dfa.table, dfa.accept,
                                              c.device)
        return SK.dfa_match(c, *self._tables[key], dfa.start)


class Like(_DfaPredicate):
    """SQL LIKE.  The shapes the reference's regex rewrite fast-paths
    (RegexRewriteUtils: 'lit', 'lit%', '%lit', '%lit%') run the literal
    tests; every other pattern compiles to a full-match byte DFA
    (regex/automata.py compile_like, escape '\\') for the DFA kernel."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__(child, pattern)
        self._fast = Like.supported_pattern(pattern)

    @staticmethod
    def supported_pattern(pattern: str) -> bool:
        """Shapes with dedicated kernels (no DFA needed)."""
        inner = pattern
        if inner.startswith("%"):
            inner = inner[1:]
        if inner.endswith("%") and not inner.endswith(r"\%"):
            inner = inner[:-1]
        return ("%" not in inner and "_" not in inner
                and "\\" not in inner)

    def _compiled(self):
        if self._dfa is None:
            from spark_rapids_tpu_torch.regex import compile_like
            self._dfa = compile_like(self.pattern)
        return self._dfa

    def _shape(self):
        p = self.pattern
        starts_pct = p.startswith("%")
        ends_pct = p.endswith("%")
        inner = p[1 if starts_pct else 0: len(p) - 1 if ends_pct else len(p)]
        return starts_pct, ends_pct, inner

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        if not self._fast:
            return make_column(self._match(c), c.validity, T.BOOLEAN)
        sp, ep, inner = self._shape()
        pat = inner.encode("utf-8")
        if sp and ep:
            hits = SK.contains_literal(c, pat)
        elif ep:
            hits = SK.startswith_literal(c, pat)
        elif sp:
            hits = SK.endswith_literal(c, pat)
        else:
            hits = SK.startswith_literal(c, pat) & \
                (SK.byte_length(c) == len(pat))
        return make_column(hits, c.validity, T.BOOLEAN)

    def __repr__(self):
        return f"({self.child!r} LIKE {self.pattern!r})"


class RLike(_DfaPredicate):
    """Spark RLIKE: java.util.regex find() over a literal pattern, through
    a host-compiled DFA (the reference's cuDF regex via its transpiler;
    a pattern outside the dialect makes the planner raise)."""

    def _compiled(self):
        if self._dfa is None:
            from spark_rapids_tpu_torch.regex import compile_regex
            self._dfa = compile_regex(self.pattern, mode="search")
        return self._dfa

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return make_column(self._match(c), c.validity, T.BOOLEAN)

    def __repr__(self):
        return f"({self.child!r} RLIKE {self.pattern!r})"


class StringReplace(Expression):
    """replace(str, search, replace) with literal search / replace: the
    non-overlapping hits from the left (an empty search is the input)."""

    def __init__(self, child: Expression, search: str, replacement: str = ""):
        self.child = child
        self.search = search
        self.replacement = replacement
        self.children = (child,)

    def with_children(self, children):
        return StringReplace(children[0], self.search, self.replacement)

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        if not self.search:
            return c
        return _with_validity(SK.replace_literal(
            c, self.search.encode("utf-8"),
            self.replacement.encode("utf-8")), c.validity)

    def __repr__(self):
        return (f"replace({self.child!r}, {self.search!r}, "
                f"{self.replacement!r})")


class StringLocate(Expression):
    """locate(substr, str[, pos]): the 1-based character index, 0 when
    absent or when pos < 1.  substr and pos are literals."""

    def __init__(self, substr: str, child: Expression, pos: int = 1):
        self.child = child
        self.substr = substr
        self.pos = pos
        self.children = (child,)

    def with_children(self, children):
        return StringLocate(self.substr, children[0], self.pos)

    @property
    def dtype(self):
        return T.INT

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        if self.pos < 1:
            hits = torch.zeros(c.num_rows, dtype=torch.int32,
                               device=c.device)
        else:
            hits = SK.first_occurrence_char(c, self.substr.encode("utf-8"),
                                            self.pos)
        return make_column(hits, c.validity, T.INT)

    def __repr__(self):
        return f"locate({self.substr!r}, {self.child!r}, {self.pos})"


class StringInstr(StringLocate):
    """instr(str, substr) == locate(substr, str, 1)."""

    def __init__(self, child: Expression, substr: str):
        super().__init__(substr, child, 1)

    def with_children(self, children):
        return StringInstr(children[0], self.substr)

    def __repr__(self):
        return f"instr({self.child!r}, {self.substr!r})"


class Ascii(_StringToInt):
    """The first character's code point (0 for the empty string), decoded
    from its lead byte as the reference does."""

    def _values(self, c):
        starts = c.offsets[:-1].to(torch.int64)
        lens = c.offsets[1:] - c.offsets[:-1]
        top = max(c.data.shape[0] - 1, 0)
        if c.data.shape[0] == 0:
            return torch.zeros(c.num_rows, dtype=torch.int32, device=c.device)
        b0, b1, b2, b3 = (c.data[(starts + i).clamp(0, top)].to(torch.int32)
                          for i in range(4))
        cp = torch.where(
            b0 < 0x80, b0,
            torch.where(b0 < 0xE0, ((b0 & 0x1F) << 6) | (b1 & 0x3F),
                        torch.where(b0 < 0xF0,
                                    ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6)
                                    | (b2 & 0x3F),
                                    ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12)
                                    | ((b2 & 0x3F) << 6) | (b3 & 0x3F))))
        return torch.where(lens > 0, cp, 0)


class StringRepeat(Expression):
    """repeat(str, n) with a literal n (n <= 0: empty)."""

    def __init__(self, child: Expression, n: int):
        self.child = child
        self.n = int(n)
        self.children = (child,)

    def with_children(self, children):
        return StringRepeat(children[0], self.n)

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return _with_validity(SK.repeat_string(c, self.n), c.validity)

    def __repr__(self):
        return f"repeat({self.child!r}, {self.n})"


class _Pad(Expression):
    left_pad = True

    def __init__(self, child: Expression, length: int, pad: str = " "):
        self.child = child
        self.length = int(length)
        self.pad = pad
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0], self.length, self.pad)

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return _with_validity(SK.pad_chars(c, self.length,
                                           self.pad.encode("utf-8"),
                                           self.left_pad), c.validity)

    def __repr__(self):
        name = "lpad" if self.left_pad else "rpad"
        return f"{name}({self.child!r}, {self.length}, {self.pad!r})"


class Lpad(_Pad):
    left_pad = True


class Rpad(_Pad):
    left_pad = False


class ConcatWs(Expression):
    """concat_ws(sep, cols...): the non-null values joined; never null."""

    def __init__(self, sep: str, *children: Expression):
        self.sep = sep
        self.children = tuple(children)

    def with_children(self, children):
        return ConcatWs(self.sep, *children)

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        return SK.concat_ws([c.eval(ctx) for c in self.children],
                            self.sep.encode("utf-8"))

    def __repr__(self):
        inner = ", ".join(map(repr, self.children))
        return f"concat_ws({self.sep!r}, {inner})"


class Left(UnaryExpression):
    """left(str, n-literal): the first n characters (n <= 0: empty), as
    SUBSTRING(str, 1, max(n, 0))."""

    def __init__(self, child: Expression, n: int):
        super().__init__(child)
        self.n = int(n)

    def with_children(self, children):
        return Left(children[0], self.n)

    @property
    def dtype(self):
        return T.STRING

    def as_substring(self) -> Substring:
        return Substring(self.child, 1, max(self.n, 0))

    def eval(self, ctx: EvalContext):
        return self.as_substring().eval(ctx)

    def __repr__(self):
        return f"left({self.child!r}, {self.n})"


class Right(UnaryExpression):
    """right(str, n-literal): the last n characters, as SUBSTRING(str, -n,
    n) (n <= 0: SUBSTRING(str, 1, 0))."""

    def __init__(self, child: Expression, n: int):
        super().__init__(child)
        self.n = int(n)

    def with_children(self, children):
        return Right(children[0], self.n)

    @property
    def dtype(self):
        return T.STRING

    def as_substring(self) -> Substring:
        if self.n <= 0:
            return Substring(self.child, 1, 0)
        return Substring(self.child, -self.n, self.n)

    def eval(self, ctx: EvalContext):
        return self.as_substring().eval(ctx)

    def __repr__(self):
        return f"right({self.child!r}, {self.n})"


class OctetLength(_StringToInt):
    """Byte length (Length counts characters)."""

    def _values(self, c):
        return SK.byte_length(c)


class BitLength(_StringToInt):
    def _values(self, c):
        return SK.byte_length(c) * 8


class Translate(UnaryExpression):
    """translate(str, from, to) with ASCII literals: a character of
    ``from`` maps to ``to``'s at its place (its first occurrence wins),
    one beyond ``to``'s length is deleted."""

    def __init__(self, child: Expression, src: str, dst: str):
        super().__init__(child)
        if not all(ord(ch) < 128 for ch in src + dst):
            # the reference asserts this and its planner falls back to its
            # CPU; the port has no CPU fallback
            raise NotImplementedError(
                f"translate({src!r}, {dst!r}): non-ASCII translate "
                "arguments are not supported on the device")
        self.src = src
        self.dst = dst

    def with_children(self, children):
        return Translate(children[0], self.src, self.dst)

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        table, drop = SK._byte_tables(self.src, self.dst)
        return _with_validity(SK.translate_bytes(c, table, drop), c.validity)

    def __repr__(self):
        return f"translate({self.child!r}, {self.src!r}, {self.dst!r})"


class Empty2Null(UnaryExpression):
    """'' -> NULL (Spark's writer-side Empty2Null)."""

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        return _with_validity(c, c.validity & (SK.byte_length(c) > 0))


class Concat(Expression):
    """Variadic string concat, null if any input is: one launch of the
    assembly kernel (the reference folds it pairwise, with the same
    rows)."""

    def __init__(self, *children: Expression):
        if not children:
            raise ValueError("concat takes at least one input")
        self.children = tuple(children)

    def with_children(self, children):
        return Concat(*children)

    @property
    def dtype(self):
        return T.STRING

    def eval(self, ctx: EvalContext):
        return SK.concat_strings([c.eval(ctx) for c in self.children])

    def __repr__(self):
        return f"concat({', '.join(map(repr, self.children))})"
