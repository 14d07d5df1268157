"""Java-regex subset parser.

Produces a small AST consumed by automata.py.  The supported dialect is the
subset whose *matching* semantics we can reproduce exactly with a DFA over
UTF-8 bytes (capture-free):

  literals (incl. escapes), ``.``, character classes ``[a-z0-9_]`` /
  negated ``[^...]``, predefined classes ``\\d \\D \\w \\W \\s \\S``
  (Java default = ASCII-only, unlike Python's unicode-aware versions),
  alternation ``|``, groups ``(...)`` and non-capturing ``(?:...)``
  (transparent — no captures), greedy quantifiers ``* + ? {m} {m,} {m,n}``,
  and ``^``/``$`` at the pattern boundaries only.

Rejected with RegexUnsupported (→ the planner raises; the reference's
planner falls back to its CPU, mirroring the
reference's transpiler tagging, RegexParser.scala:696): backreferences,
lookaround, lazy/possessive quantifiers, inline flags, named groups,
``\\b``/``\\B``/``\\A``/``\\z`` word/input anchors, interior ``^``/``$``,
octal/\\p{...} classes, and explicit non-ASCII ranges in classes (non-ASCII
*literals* are fine — they compile to their UTF-8 byte sequence).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class RegexUnsupported(Exception):
    """Pattern outside the supported dialect (or over the DFA budget)."""


# -- AST ---------------------------------------------------------------------

@dataclass
class Node:
    pass


@dataclass
class Empty(Node):
    pass


@dataclass
class Char(Node):
    """One literal character (codepoint; lowered to UTF-8 bytes later)."""
    cp: int


@dataclass
class CharClass(Node):
    """Set of ASCII codepoints + optionally 'all non-ASCII characters'.

    ranges: sorted list of inclusive (lo, hi) ASCII pairs.
    include_non_ascii: a negated class like [^a-z] matches every non-ASCII
    character too; we track that as a flag rather than enumerating them.
    """
    ranges: List[Tuple[int, int]]
    include_non_ascii: bool = False


@dataclass
class Dot(Node):
    """Java '.': any char except line terminators \\n \\r \\u0085 \\u2028
    \\u2029."""


@dataclass
class Grouped(Node):
    """(...) / (?:...): transparent for matching, but marks that an inner
    alternation is NOT top-level (anchor binding)."""
    child: Node = None


@dataclass
class Concat(Node):
    parts: List[Node] = field(default_factory=list)


@dataclass
class Alt(Node):
    options: List[Node] = field(default_factory=list)


@dataclass
class Repeat(Node):
    child: Node
    lo: int
    hi: Optional[int]   # None = unbounded


@dataclass
class Pattern:
    body: Node
    anchored_start: bool
    anchored_end: bool


_PREDEF = {
    "d": [(0x30, 0x39)],
    "w": [(0x30, 0x39), (0x41, 0x5A), (0x5F, 0x5F), (0x61, 0x7A)],
    "s": [(0x09, 0x0D), (0x20, 0x20)],
}

# NOTE: no "0" entry — Java treats \0n as an OCTAL escape, which the
# dialect rejects (the alphanumeric-escape check catches it)
_ESCAPE_LITERALS = {
    "n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "a": 0x07, "e": 0x1B,
}

_MAX_REPEAT = 64   # {m,n} expansion budget (DFA size guard)


def _negate(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    prev = 0
    for lo, hi in sorted(ranges):
        if lo > prev:
            out.append((prev, lo - 1))
        prev = max(prev, hi + 1)
    if prev <= 0x7F:
        out.append((prev, 0x7F))
    return out


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str):
        raise RegexUnsupported(f"{msg} at {self.i} in {self.p!r}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def eat(self, c: str) -> bool:
        if self.peek() == c:
            self.i += 1
            return True
        return False

    # pattern := alt, with boundary-only anchors
    def parse(self) -> Pattern:
        anchored_start = self.eat("^")
        body = self.alt()
        anchored_end = False
        # the alt() parser stops at a trailing unescaped '$' only if it is
        # the final char; interior '$' raises inside atom()
        if self.p.endswith("$") and not self.p.endswith("\\$") \
                and self.i == len(self.p) - 1:
            anchored_end = True
            self.i += 1
        if self.i != len(self.p):
            self.error(f"unparsed tail {self.p[self.i:]!r}")
        if (anchored_start or anchored_end) and isinstance(body, Alt):
            # Java binds ^/$ to only the first/last ALTERNATIVE of a bare
            # top-level alternation; anchoring the whole Alt would be a
            # wrong answer, so reject (grouped "(a|b)$" parses as Grouped
            # and stays supported)
            raise RegexUnsupported(
                f"anchor with top-level alternation in {self.p!r}")
        return Pattern(body, anchored_start, anchored_end)

    def alt(self) -> Node:
        options = [self.concat()]
        while self.eat("|"):
            options.append(self.concat())
        return options[0] if len(options) == 1 else Alt(options)

    def concat(self) -> Node:
        parts: List[Node] = []
        while True:
            c = self.peek()
            if c is None or c in ")|":
                break
            if c == "$" and self.i == len(self.p) - 1:
                break   # boundary anchor, handled by parse()
            parts.append(self.quantified())
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Concat(parts)

    def quantified(self) -> Node:
        atom = self.atom()
        c = self.peek()
        if c == "*":
            self.next()
            atom = Repeat(atom, 0, None)
        elif c == "+":
            self.next()
            atom = Repeat(atom, 1, None)
        elif c == "?":
            self.next()
            atom = Repeat(atom, 0, 1)
        elif c == "{":
            atom = Repeat(atom, *self.braces())
        else:
            return atom
        nxt = self.peek()
        if nxt in ("?", "+"):
            self.error("lazy/possessive quantifiers unsupported")
        if nxt in ("*", "{"):
            # Java rejects stacked quantifiers (a**, a{2}{3})
            self.error("stacked quantifiers")
        return atom

    def braces(self) -> Tuple[int, Optional[int]]:
        assert self.next() == "{"
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.next()
        if not digits:
            self.error("bad {m,n}")
        lo = int(digits)
        hi: Optional[int] = lo
        if self.eat(","):
            digits = ""
            while self.peek() is not None and self.peek().isdigit():
                digits += self.next()
            hi = int(digits) if digits else None
        if not self.eat("}"):
            self.error("bad {m,n}")
        if hi is not None and hi < lo:
            self.error("bad {m,n}: max < min")
        if (hi or lo) > _MAX_REPEAT:
            raise RegexUnsupported(f"repeat bound > {_MAX_REPEAT}")
        return lo, hi

    def atom(self) -> Node:
        c = self.next()
        if c == "(":
            if self.eat("?"):
                if not self.eat(":"):
                    self.error("only (?:...) groups supported "
                               "(no lookaround/flags/named groups)")
            inner = self.alt()
            if not self.eat(")"):
                self.error("unclosed group")
            return Grouped(inner)
        if c == "[":
            return self.char_class()
        if c == ".":
            return Dot()
        if c == "\\":
            return self.escape(in_class=False)
        if c in "^$":
            self.error(f"interior anchor {c!r} unsupported")
        if c in "*+?{":
            self.error(f"dangling quantifier {c!r}")
        return Char(ord(c))

    def escape(self, in_class: bool) -> Node:
        if self.peek() is None:
            self.error("trailing backslash")
        c = self.next()
        if c in _PREDEF:
            return CharClass(list(_PREDEF[c]))
        if c.lower() in _PREDEF and c.isupper():
            base = _PREDEF[c.lower()]
            return CharClass(_negate(list(base)), include_non_ascii=True)
        if c in _ESCAPE_LITERALS:
            return Char(_ESCAPE_LITERALS[c])
        if c == "x":
            h = self.p[self.i:self.i + 2]
            if len(h) == 2:
                try:
                    self.i += 2
                    return Char(int(h, 16))
                except ValueError:
                    pass
            self.error("bad \\x escape")
        if c == "u":
            h = self.p[self.i:self.i + 4]
            if len(h) == 4:
                try:
                    self.i += 4
                    return Char(int(h, 16))
                except ValueError:
                    pass
            self.error("bad \\u escape")
        if c.isalnum():
            # every unhandled alphanumeric escape is a Java metacharacter
            # (\Q \E \R \h \v \H \V \c \k \N \G \X, word anchors, backrefs,
            # unicode classes) — wrong answers if literalized, so reject
            # (the transpiler's "fallback, never wrong answers" contract)
            self.error(f"\\{c} unsupported")
        # any other escaped punctuation is a literal (\. \[ \\ \| \$ ...)
        return Char(ord(c))

    def char_class(self) -> Node:
        negated = self.eat("^")
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unclosed character class")
            if c == "]":
                if first:
                    # Java rejects []...] (']' is NOT a literal first
                    # member, unlike POSIX)
                    self.error("empty character class")
                self.next()
                break
            first = False
            atom = self._class_atom()
            if isinstance(atom, list):     # predefined class: merge ranges
                ranges.extend(atom)
                continue
            lo = atom
            if self.peek() == "-" and self.p[self.i + 1: self.i + 2] not in ("]", ""):
                self.next()
                hi = self._class_atom()
                if isinstance(hi, list):
                    self.error("bad range endpoint")
                if hi < lo:
                    self.error("reversed class range")
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        for lo, hi in ranges:
            if hi > 0x7F:
                raise RegexUnsupported(
                    "non-ASCII in character class (transpiler limit; "
                    "non-ASCII literals outside classes are fine)")
        if negated:
            return CharClass(_negate(ranges), include_non_ascii=True)
        return CharClass(sorted(ranges))

    def _class_atom(self):
        """One class member: a codepoint, or the range list of a predefined
        class used inside [...] (e.g. [\\d.])."""
        c = self.next()
        if c == "\\":
            node = self.escape(in_class=True)
            if isinstance(node, Char):
                return node.cp
            assert isinstance(node, CharClass)
            if node.include_non_ascii:
                raise RegexUnsupported(
                    "negated predefined class inside [...] unsupported")
            return list(node.ranges)
        return ord(c)


def parse(pattern: str) -> Pattern:
    return _Parser(pattern).parse()
