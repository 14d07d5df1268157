"""Lowering of bound expression trees to a flat program.

Counterpart of the in-trace evaluation inside ``spark_rapids_tpu/plan/
fused.py`` ``_emit_one`` (:1032), where XLA traces ``Expression.eval`` over
``EvalContext`` / ``bind_trace_consts`` into one program.  PyTorch has no
tracer, so a fused segment's expressions become a short list of
instructions over typed registers, with a table of 8-byte literals, that
``kernels/fused.py`` interprets: by hand on the card (``csrc/fused.cu``,
one thread per row) and with torch ops over whole columns on the CPU.

Every instruction has the exact semantics of the per-op expression it
comes from, so a lowered expression equals its ``eval`` bit for bit:

  LOAD         a stream column's value and validity byte (bool, int32,
               DATE, int64, Decimal64 unscaled, double);
  CONST        a literal, as ``Literal.eval`` fills it;
  CAST_DEC_F64 ``(double) unscaled / 10**scale``, a division
               (``casts.py``), not a multiply by 0.01;
  WIDEN        ``.to()``'s int / long -> double (a register holds an
               integer sign-extended to 64 bits, so int -> long and
               bool -> int need no instruction);
  RESCALE      the decimal compare's ``_rescale`` (an int64 multiply that
               wraps);
  ADD SUB MUL  wrapping at the result's own width, doubles in IEEE-754
               round-to-nearest;
  LT LE GT GE EQ  with Spark's double rules (``predicates.py`` ``_lt``,
               ``_eq``: NaN equals NaN and is above everything, -0.0
               equals 0.0);
  AND          three-valued; IS_NULL; IF (fixed-width, a null predicate
               takes the false branch).

Validity propagates as ``null_propagating`` does; a register's data under
a null is never read by a valid result, so only outputs zero their null
slots (``make_column``).  An expression that does not lower raises
``NotLowerable``: its chain breaks there and runs op by op, as the
reference's ``_fusable`` (:114) breaks a chain at what its program cannot
hold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.arithmetic import (
    Add, BinaryArithmetic, Multiply, Subtract)
from spark_rapids_tpu_torch.expressions.casts import Cast
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.core import (
    Alias, BoundReference, Expression, Literal)
from spark_rapids_tpu_torch.expressions.predicates import (
    And, BinaryComparison, EqualTo, GreaterThan, GreaterThanOrEqual, IsNull,
    LessThan, LessThanOrEqual, _cmp_dtype)

# opcodes and register kinds; csrc/fused.cu has the same numbers
(LOAD, CONST, CAST_DEC_F64, WIDEN, RESCALE, ADD, SUB, MUL, LT, LE, GT, GE,
 EQ, AND, IS_NULL, IF) = range(16)
K_BOOL, K_I32, K_I64, K_F64 = range(4)
# a global aggregate's sum kinds
SUM_F64, SUM_I64, SUM_NONE = range(3)

# the kernel's limits (csrc/fused.cu kMax*): a chain whose program is
# larger breaks, and its lower ops run op by op
MAX_INSTRS = 128
MAX_LITERALS = 64
MAX_REGS = 48
MAX_INPUTS = 32
MAX_OUTPUTS = 32
MAX_SLOTS = 16

KIND_DTYPE = {K_BOOL: torch.bool, K_I32: torch.int32, K_I64: torch.int64,
              K_F64: torch.float64}
_BINARY_OPS = {Add: ADD, Subtract: SUB, Multiply: MUL}
_COMPARE_OPS = {LessThan: LT, LessThanOrEqual: LE, GreaterThan: GT,
                GreaterThanOrEqual: GE, EqualTo: EQ}


class NotLowerable(Exception):
    """The expression or chain has no program form."""


def kind_of(dt: T.DataType) -> int:
    """The register kind of a fixed-width type (by its torch dtype)."""
    for k, td in KIND_DTYPE.items():
        if dt.torch_dtype == td and not dt.variable_width:
            return k
    raise NotLowerable(f"no register kind for {dt!r}")


def _literal_bits(value, dt: T.DataType) -> int:
    """The literal's value as ``Literal.eval`` fills it, as int64 bits."""
    one = torch.full((1,), value, dtype=dt.torch_dtype)
    if one.dtype == torch.float64:
        return int(one.view(torch.int64)[0])
    return int(one.to(torch.int64)[0])


@dataclasses.dataclass(frozen=True)
class Column:
    """A column of a segment's batch while it is lowered: a stream column
    passed through (``ordinal``) or a value the program computes."""

    dtype: T.DataType
    ordinal: Optional[int] = None
    value: Optional[int] = None


@dataclasses.dataclass
class Program:
    """A lowered segment.  ``code`` holds (op, kind, dst, a, b, c) with
    register operands; instructions [0, n_pred) compute ``keep``, the
    filter's register (-1: no filter)."""

    code: List[Tuple[int, int, int, int, int, int]]
    literals: List[int]
    loads: List[int]                  # stream ordinal of each load slot
    n_regs: int
    n_pred: int
    keep: int
    outputs: List[Tuple[int, int]]    # (register, kind), compact mode
    slots: List[Tuple[int, int, int]]  # (register, kind, sum kind), global

    def words(self) -> torch.Tensor:
        """The code (one int64 a instruction, a byte a field) followed by
        the literals: what the kernel reads."""
        w = [op | kind << 8 | dst << 16 | a << 24 | b << 32 | c << 40
             for op, kind, dst, a, b, c in self.code]
        return torch.tensor(w + self.literals, dtype=torch.int64)


class ProgramBuilder:
    """Builds one program in SSA form (equal instructions are shared), then
    orders the filter's instructions first and allocates registers."""

    def __init__(self, stream_dtypes: Sequence[T.DataType]):
        self.stream_dtypes = tuple(stream_dtypes)
        self._ins: List[Tuple[int, int, int, int, int]] = []
        self._kind: List[int] = []
        self._memo: Dict[tuple, int] = {}
        self._lits: Dict[int, int] = {}
        self._loads: Dict[int, int] = {}

    # -- SSA emission ---------------------------------------------------------

    def _emit(self, op: int, kind: int, a: int = 0, b: int = 0,
              c: int = 0) -> int:
        key = (op, kind, a, b, c)
        if key not in self._memo:
            self._memo[key] = len(self._ins)
            self._ins.append(key)
            self._kind.append(K_BOOL if LT <= op <= IS_NULL else kind)
        return self._memo[key]

    def _literal(self, bits: int) -> int:
        return self._lits.setdefault(bits, len(self._lits))

    def _load(self, ordinal: int) -> int:
        kind = kind_of(self.stream_dtypes[ordinal])
        slot = self._loads.setdefault(ordinal, len(self._loads))
        return self._emit(LOAD, kind, slot)

    def column(self, e: Expression, cols: Sequence[Column]) -> Column:
        """Lower one projection output: a plain reference passes through."""
        while isinstance(e, Alias):
            e = e.child
        if isinstance(e, BoundReference):
            return cols[e.ordinal]
        v = self.value(e, cols)
        return Column(e.dtype, value=v)

    def _materialize(self, c: Column) -> int:
        return c.value if c.value is not None else self._load(c.ordinal)

    def value(self, e: Expression, cols: Sequence[Column]) -> int:
        """The SSA value of a fixed-width expression."""
        try:
            return self._value(e, cols)
        except (NotImplementedError, TypeError, RuntimeError) as err:
            # a dtype the per-op path rejects: it raises there, at run time
            raise NotLowerable(str(err)) from err

    def _value(self, e: Expression, cols: Sequence[Column]) -> int:
        if isinstance(e, Alias):
            return self._value(e.child, cols)
        if isinstance(e, BoundReference):
            return self._materialize(cols[e.ordinal])
        if isinstance(e, Literal):
            kind = kind_of(e.dtype)
            return self._emit(CONST, kind,
                              self._literal(_literal_bits(e.value, e.dtype)))
        if isinstance(e, Cast):
            src = self._dtype(e.child, cols)
            if src == e.dtype:
                return self._value(e.child, cols)
            if isinstance(src, T.DecimalType) and e.dtype == T.DOUBLE:
                div = self._literal(_literal_bits(float(10 ** src.scale),
                                                  T.DOUBLE))
                return self._emit(CAST_DEC_F64, K_F64,
                                  self._value(e.child, cols), div)
            raise NotLowerable(f"cast {src!r} -> {e.dtype!r}")
        if isinstance(e, BinaryArithmetic) and type(e) in _BINARY_OPS:
            out = e.dtype
            kind = kind_of(out)
            if kind == K_BOOL or isinstance(out, T.DecimalType):
                raise NotLowerable(f"arithmetic on {out!r}")
            return self._emit(_BINARY_OPS[type(e)], kind,
                              self._to(e.left, out, cols),
                              self._to(e.right, out, cols))
        if isinstance(e, BinaryComparison) and type(e) in _COMPARE_OPS:
            ldt = self._dtype(e.left, cols)
            rdt = self._dtype(e.right, cols)
            cdt = _cmp_dtype(ldt, rdt)
            if isinstance(cdt, T.DecimalType):
                lhs = self._rescale(self._value(e.left, cols), ldt.scale,
                                    cdt.scale)
                rhs = self._rescale(self._value(e.right, cols), rdt.scale,
                                    cdt.scale)
                kind = K_I64
            else:
                lhs = self._to(e.left, cdt, cols)
                rhs = self._to(e.right, cdt, cols)
                kind = kind_of(cdt)
            return self._emit(_COMPARE_OPS[type(e)], kind, lhs, rhs)
        if isinstance(e, And):
            for c in e.children:
                if self._dtype(c, cols) != T.BOOLEAN:
                    raise NotLowerable("AND of a non-boolean")
            return self._emit(AND, K_BOOL, self._value(e.left, cols),
                              self._value(e.right, cols))
        if isinstance(e, IsNull):
            kind_of(self._dtype(e.child, cols))
            return self._emit(IS_NULL, K_BOOL, self._value(e.child, cols))
        if isinstance(e, If):
            out = e.dtype
            kind = kind_of(out)
            if self._dtype(e.predicate, cols) != T.BOOLEAN:
                raise NotLowerable("IF on a non-boolean predicate")
            return self._emit(IF, kind, self._value(e.predicate, cols),
                              self._to(e.if_true, out, cols),
                              self._to(e.if_false, out, cols))
        raise NotLowerable(f"{type(e).__name__} has no instruction")

    def _dtype(self, e: Expression, cols: Sequence[Column]) -> T.DataType:
        """The type of what ``e.eval`` returns (a reference's column's)."""
        while isinstance(e, Alias):
            e = e.child
        if isinstance(e, BoundReference):
            return cols[e.ordinal].dtype
        return e.dtype

    def _to(self, e: Expression, dst: T.DataType,
            cols: Sequence[Column]) -> int:
        """``.to(dst.torch_dtype)`` of e's value."""
        src = self._dtype(e, cols)
        v = self._value(e, cols)
        sk, dk = kind_of(src), kind_of(dst)
        if sk == dk or (sk in (K_BOOL, K_I32) and dk in (K_I32, K_I64)
                        and sk < dk):
            return v
        if dk == K_F64:
            return self._emit(WIDEN, K_F64, v)
        raise NotLowerable(f".to() from {src!r} to {dst!r}")

    def _rescale(self, v: int, from_scale: int, to_scale: int) -> int:
        if to_scale == from_scale:
            return v
        mul = self._literal(10 ** (to_scale - from_scale))
        return self._emit(RESCALE, K_I64, v, mul)

    def and_keep(self, keep: Optional[int], pred: int) -> int:
        """Two filters in one chain: a row stays where both are true.  The
        three-valued AND is exact here, because a row is kept only where
        the result is true and valid."""
        return pred if keep is None else self._emit(AND, K_BOOL, keep, pred)

    # -- finishing ------------------------------------------------------------

    def finish(self, keep: Optional[int], outputs: Sequence[int],
               slots: Sequence[Tuple[int, int]]) -> Program:
        """Drop what no result reads, order the filter's instructions
        first, then give each SSA value a register, reused after the
        value's last read.  ``outputs``: values written in compact mode;
        ``slots``: (value, sum kind) reduced in global mode."""
        live_out = list(outputs) + [v for v, _ in slots]
        pred = self._reachable([] if keep is None else [keep])
        used = self._reachable(live_out) | pred
        order = sorted(pred) + sorted(used - pred)
        end = len(order)
        last = {}
        for pos, i in enumerate(order):
            for a in self._operands(i):
                last[a] = pos
        for v in live_out + ([] if keep is None else [keep]):
            last[v] = end
        reg_of: Dict[int, int] = {}
        free: List[int] = []
        n_regs = 0
        code = []
        # the kept loads and literals, renumbered in order of first use
        load_of: Dict[int, int] = {}
        lit_of: Dict[int, int] = {}
        for pos, i in enumerate(order):
            op, kind, a, b, c = self._ins[i]
            for v in set(self._operands(i)):
                if last[v] == pos:      # read here for the last time
                    free.append(reg_of[v])
            if free:
                free.sort()
                dst = free.pop(0)
            else:
                dst = n_regs
                n_regs += 1
            if op == LOAD:
                fields = (load_of.setdefault(a, len(load_of)), 0, 0)
            elif op == CONST:
                fields = (lit_of.setdefault(a, len(lit_of)), 0, 0)
            elif op in (CAST_DEC_F64, RESCALE):   # b: a literal's index
                fields = (reg_of[a], lit_of.setdefault(b, len(lit_of)), 0)
            else:
                regs = [reg_of[x] for x in self._operands(i)]
                fields = tuple(regs + [0] * (3 - len(regs)))
            reg_of[i] = dst
            code.append((op, kind, dst) + fields)
        ordinals = sorted(self._loads, key=self._loads.get)
        bits = sorted(self._lits, key=self._lits.get)
        lits = [bits[k] for k in sorted(lit_of, key=lit_of.get)]
        prog = Program(
            code=code, literals=lits,
            loads=[ordinals[k] for k in sorted(load_of, key=load_of.get)],
            n_regs=n_regs,
            n_pred=len(pred), keep=reg_of[keep] if keep is not None else -1,
            outputs=[(reg_of[v], self._kind[v]) for v in outputs],
            slots=[(reg_of[v], self._kind[v], s) for v, s in slots])
        for what, got, cap in (("instructions", len(code), MAX_INSTRS),
                               ("literals", len(lits), MAX_LITERALS),
                               ("registers", n_regs, MAX_REGS),
                               ("inputs", len(prog.loads), MAX_INPUTS),
                               ("outputs", len(outputs), MAX_OUTPUTS),
                               ("slots", len(slots), MAX_SLOTS)):
            if got > cap:
                raise NotLowerable(f"{got} {what}, the kernel takes {cap}")
        return prog

    def _reachable(self, roots: Sequence[int]) -> set:
        seen = set()
        stack = list(roots)
        while stack:
            i = stack.pop()
            if i not in seen:
                seen.add(i)
                stack.extend(self._operands(i))
        return seen

    def _operands(self, i: int) -> Tuple[int, ...]:
        op, _, a, b, c = self._ins[i]
        if op in (LOAD, CONST):
            return ()
        if op in (CAST_DEC_F64, RESCALE, WIDEN, IS_NULL):
            return (a,)
        if op == IF:
            return (a, b, c)
        return (a, b)


def lowerable(e: Expression, stream_dtypes: Sequence[T.DataType],
              value: bool = False) -> bool:
    """True when ``e``, bound to a batch of ``stream_dtypes``, has a
    program form: a fixed-width value, or (unless ``value``) a plain
    column reference of any type, which passes through."""
    cols = [Column(dt, ordinal=i) for i, dt in enumerate(stream_dtypes)]
    b = ProgramBuilder(stream_dtypes)
    try:
        if value:
            b.value(e, cols)
        else:
            b.column(e, cols)
    except NotLowerable:
        return False
    return True
