"""NFA/DFA lowering: regex AST -> dense byte-transition table.

Thompson construction over UTF-8 **bytes** (multi-byte characters become
byte-sequence fragments; `.` and negated classes include the well-formed
multi-byte sequences minus Java's line terminators), then subset
construction to a DFA with a state budget; over-budget patterns raise
RegexUnsupported and the planner raises (the reference's transpiler
discipline, RegexParser.scala:696, falls back to its CPU).

The DFA executes on the card in ``string_dfa_match`` (kernels/strings.py
`dfa_match`): the table narrowed to uint8 in shared memory, one thread a
row stepping through the row's bytes.

Search ("contains", RLIKE) mode adds an any-byte self-loop on the start
state unless the pattern is ^-anchored, and makes accepting states
absorbing unless it is $-anchored; full mode (LIKE lowering) requires the
entire string to match.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.regex.parser import (
    Alt,
    Char,
    CharClass,
    Concat,
    Dot,
    Empty,
    Grouped,
    Node,
    Pattern,
    RegexUnsupported,
    Repeat,
    parse,
)

MAX_DFA_STATES = 192

# byte-range sequences for "any well-formed multi-byte UTF-8 character"
_MB_ANY = [
    [(0xC2, 0xDF), (0x80, 0xBF)],
    [(0xE0, 0xEF), (0x80, 0xBF), (0x80, 0xBF)],
    [(0xF0, 0xF4), (0x80, 0xBF), (0x80, 0xBF), (0x80, 0xBF)],
]

# Java '.' excludes \n \r     ; the latter three are the
# multi-byte sequences C2.85, E2.80.A8, E2.80.A9
_MB_DOT = [
    [(0xC2, 0xC2), (0x80, 0x84)],
    [(0xC2, 0xC2), (0x86, 0xBF)],
    [(0xC3, 0xDF), (0x80, 0xBF)],
    [(0xE2, 0xE2), (0x80, 0x80), (0x80, 0xA7)],
    [(0xE2, 0xE2), (0x80, 0x80), (0xAA, 0xBF)],
    [(0xE2, 0xE2), (0x81, 0xBF), (0x80, 0xBF)],
    [(0xE0, 0xE1), (0x80, 0xBF), (0x80, 0xBF)],
    [(0xE3, 0xEF), (0x80, 0xBF), (0x80, 0xBF)],
    [(0xF0, 0xF4), (0x80, 0xBF), (0x80, 0xBF), (0x80, 0xBF)],
]


class _Nfa:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[int, int, int]]] = []  # (lo, hi, dst)

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def add_range(self, a: int, lo: int, hi: int, b: int) -> None:
        self.edges[a].append((lo, hi, b))


def _emit(nfa: _Nfa, node: Node) -> Tuple[int, int]:
    """Thompson fragment; returns (start, accept)."""
    if isinstance(node, Empty):
        s = nfa.state()
        return s, s
    if isinstance(node, Char):
        bs = chr(node.cp).encode("utf-8")
        start = nfa.state()
        cur = start
        for b in bs:
            nxt = nfa.state()
            nfa.add_range(cur, b, b, nxt)
            cur = nxt
        return start, cur
    if isinstance(node, CharClass):
        start, end = nfa.state(), nfa.state()
        for lo, hi in node.ranges:
            nfa.add_range(start, lo, hi, end)
        if node.include_non_ascii:
            for seq in _MB_ANY:
                cur = start
                for i, (lo, hi) in enumerate(seq):
                    nxt = end if i == len(seq) - 1 else nfa.state()
                    nfa.add_range(cur, lo, hi, nxt)
                    cur = nxt
        return start, end
    if isinstance(node, Dot):
        start, end = nfa.state(), nfa.state()
        # ASCII minus \n \r
        nfa.add_range(start, 0x00, 0x09, end)
        nfa.add_range(start, 0x0B, 0x0C, end)
        nfa.add_range(start, 0x0E, 0x7F, end)
        for seq in _MB_DOT:
            cur = start
            for i, (lo, hi) in enumerate(seq):
                nxt = end if i == len(seq) - 1 else nfa.state()
                nfa.add_range(cur, lo, hi, nxt)
                cur = nxt
        return start, end
    if isinstance(node, Grouped):
        return _emit(nfa, node.child)
    if isinstance(node, Concat):
        start, end = None, None
        for part in node.parts:
            s, e = _emit(nfa, part)
            if start is None:
                start, end = s, e
            else:
                nfa.add_eps(end, s)
                end = e
        assert start is not None
        return start, end
    if isinstance(node, Alt):
        start, end = nfa.state(), nfa.state()
        for opt in node.options:
            s, e = _emit(nfa, opt)
            nfa.add_eps(start, s)
            nfa.add_eps(e, end)
        return start, end
    if isinstance(node, Repeat):
        start = nfa.state()
        cur = start
        for _ in range(node.lo):
            s, e = _emit(nfa, node.child)
            nfa.add_eps(cur, s)
            cur = e
        if node.hi is None:
            # star: loop fragment
            s, e = _emit(nfa, node.child)
            loop_in = nfa.state()
            nfa.add_eps(cur, loop_in)
            nfa.add_eps(loop_in, s)
            nfa.add_eps(e, loop_in)
            return start, loop_in
        end = nfa.state()
        nfa.add_eps(cur, end)
        for _ in range(node.hi - node.lo):
            s, e = _emit(nfa, node.child)
            nfa.add_eps(cur, s)
            cur = e
            nfa.add_eps(cur, end)
        return start, end
    raise RegexUnsupported(f"unhandled AST node {type(node).__name__}")


def _closure(nfa: _Nfa, states: FrozenSet[int]) -> FrozenSet[int]:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


@dataclass
class CompiledRegex:
    """Dense DFA: table[state, byte] -> state; accept[state] -> bool."""
    table: np.ndarray        # [S, 256] int32
    accept: np.ndarray       # [S] bool
    start: int
    pattern: str
    mode: str

    @property
    def num_states(self) -> int:
        return self.table.shape[0]

    def match_host(self, data: bytes) -> bool:
        """Host-side reference run (oracle for unit tests and the CPU
        engine's differential twin)."""
        s = self.start
        for b in data:
            if self.accept[s] and self.mode_absorbing:
                return True
            s = int(self.table[s, b])
        return bool(self.accept[s])

    @property
    def mode_absorbing(self) -> bool:
        return self.mode == "search_absorbing"


def compile_regex(pattern: str, mode: str = "search",
                  max_states: int = MAX_DFA_STATES) -> CompiledRegex:
    """mode: 'search' (RLIKE find()) or 'full' (entire string)."""
    return _lower(parse(pattern), mode, max_states, pattern)


_ANY_CHAR = CharClass([(0x00, 0x7F)], include_non_ascii=True)


def compile_like(pattern: str, escape: str = "\\",
                 max_states: int = MAX_DFA_STATES) -> CompiledRegex:
    """SQL LIKE pattern -> full-match DFA (% = any sequence, _ = any char,
    escape char quotes the next char).  Built directly as AST — no regex
    source round-trip, no metachar escaping hazards."""
    parts: List[object] = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            parts.append(Char(ord(pattern[i + 1])))
            i += 2
            continue
        if c == "%":
            parts.append(Repeat(_ANY_CHAR, 0, None))
        elif c == "_":
            parts.append(_ANY_CHAR)
        else:
            parts.append(Char(ord(c)))
        i += 1
    body = Concat(parts) if len(parts) != 1 else parts[0]
    if not parts:
        body = Empty()
    return _lower(Pattern(body, True, True), "full", max_states,
                  f"LIKE:{pattern}")


def _lower(pat: Pattern, mode: str, max_states: int,
           pattern: str) -> CompiledRegex:
    body = pat.body
    if mode == "search" and pat.anchored_end:
        # '$' in find() matches at end of input OR before one final '\n'
        # (the Python-re rule; Java additionally allows CR and the unicode
        # terminators - documented divergence; the CPU oracle is Python re)
        body = Concat([body, Repeat(Char(0x0A), 0, 1)])
    nfa = _Nfa()
    start, end = _emit(nfa, body)

    unanchored_start = mode == "search" and not pat.anchored_start
    absorbing = mode == "search" and not pat.anchored_end
    if unanchored_start:
        s0 = nfa.state()
        nfa.add_range(s0, 0x00, 0xFF, s0)   # .*? prefix (any byte)
        nfa.add_eps(s0, start)
        start = s0

    start_set = _closure(nfa, frozenset([start]))
    dfa_index: Dict[FrozenSet[int], int] = {start_set: 0}
    rows: List[np.ndarray] = []
    accepts: List[bool] = []
    worklist = [start_set]
    ordered: List[FrozenSet[int]] = [start_set]
    while worklist:
        cur = worklist.pop(0)
        is_accept = end in cur
        accepts.append(is_accept)
        row = np.zeros((256,), np.int32)
        if is_accept and absorbing:
            row[:] = dfa_index[cur]      # absorbing accept: stay matched
            rows.append(row)
            continue
        # successor sets per byte (range edges -> per-byte targets)
        targets: List[set] = [set() for _ in range(256)]
        for s in cur:
            for lo, hi, dst in nfa.edges[s]:
                for b in range(lo, hi + 1):
                    targets[b].add(dst)
        cache: Dict[FrozenSet[int], int] = {}
        for b in range(256):
            tset = frozenset(targets[b])
            tclo_id = cache.get(tset)
            if tclo_id is None:
                tclo = _closure(nfa, tset) if tset else frozenset()
                if tclo not in dfa_index:
                    dfa_index[tclo] = len(dfa_index)
                    worklist.append(tclo)
                    ordered.append(tclo)
                    if len(dfa_index) > max_states:
                        raise RegexUnsupported(
                            f"DFA exceeds {max_states} states for "
                            f"{pattern!r}")
                tclo_id = dfa_index[tclo]
                cache[tset] = tclo_id
            row[b] = tclo_id
        rows.append(row)

    table = np.stack(rows)
    accept = np.array(accepts, np.bool_)
    return CompiledRegex(table=table, accept=accept, start=0,
                        pattern=pattern,
                        mode="search_absorbing" if absorbing else mode)
