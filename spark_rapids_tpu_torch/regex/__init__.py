"""Regex engine: Java-regex subset -> byte-level DFA for device matching.

Copied from ``spark_rapids_tpu/regex/`` (``__init__.py``, ``parser.py``,
``automata.py``), which imports no JAX; the port keeps its own copy so
that it imports nothing of the JAX package.  The tables it compiles equal
the reference's bit for bit (``tests/test_torch_regex.py``).

The reference ships a full Java-regex parser + transpiler into cuDF's regex
dialect with per-pattern supportability tagging (RegexParser.scala:696,
CudfRegexTranspiler).  Here patterns are parsed and lowered on the host to
a dense byte-transition table, and the device match is the hand-written
kernel ``string_dfa_match`` (``kernels/strings.py`` ``dfa_match``,
``csrc/string_functions.cu``): one thread a row walks the row's bytes
through the table, held in shared memory.  Patterns the parser or the DFA
budget cannot handle raise RegexUnsupported, which the port's planner
turns into NotImplementedError with the reference's reason (the port has
no CPU fallback).

Match modes (what RLIKE/LIKE/regexp_like need):
  * search ("contains"): Spark RLIKE — unanchored java.util.regex find()
  * full: entire string must match (LIKE lowering, regexp full-match)
Anchors ^/$ are honored at pattern boundaries and rewrite the mode.
"""
from spark_rapids_tpu_torch.regex.parser import RegexUnsupported, parse
from spark_rapids_tpu_torch.regex.automata import (
    CompiledRegex,
    compile_like,
    compile_regex,
)


def is_supported(pattern: str) -> bool:
    try:
        compile_regex(pattern)
        return True
    except RegexUnsupported:
        return False


def to_python_pattern(pattern: str) -> str:
    """Translate the supported Java-regex dialect to Python `re` source for
    the CPU oracle (use with re.ASCII so \\d/\\w/\\s match Java's defaults).
    The one source-level difference is '.': Java excludes all five line
    terminators, Python only \\n."""
    out = []
    i = 0
    in_class = False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        elif c == "." and not in_class:
            out.append("[^\\n\\r\\u0085\\u2028\\u2029]")
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


__all__ = ["CompiledRegex", "RegexUnsupported", "compile_like",
           "compile_regex", "is_supported", "parse", "to_python_pattern"]
