"""Regex -> byte-level DFA compiler.

The generate stage tests every corpus substring (<= max_token_length
chars) for a FULL match against the allow-regex — in the reference this
is a Rust `regex` is_match per candidate (reference:
src/generate.rs:80-111), millions of calls. Here the allow-regex is
compiled once into a dense byte-DFA table `next[state, byte]` +
`accept[state]`; all (position, length) candidates of a sample are then
evaluated with L vectorized table-gather steps (numpy on host, and the
same table powers the TPU DFA kernel).

Supported syntax (the subset used by the reference pattern library,
reference: src/regex.rs:3-48): literals, escapes, `.`, char classes
with ranges and negation (full Unicode, lowered to UTF-8 byte
automata), `(?:...)`, `|`, `?`, `+`, `*`, `{m}`, `{m,}`, `{m,n}`,
`[[:punct:]]`, and anchors `^`/`$` (no-ops: matching is whole-string).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

MAX_CP = 0x10FFFF


# ---------------------------------------------------------------------------
# Parsing to an AST over codepoint ranges
# ---------------------------------------------------------------------------

class _Node:
    pass


class _Empty(_Node):
    pass


class _CharClass(_Node):
    def __init__(self, ranges: List[Tuple[int, int]]):
        self.ranges = ranges  # inclusive codepoint ranges, sorted, disjoint


class _Concat(_Node):
    def __init__(self, parts: List[_Node]):
        self.parts = parts


class _Alt(_Node):
    def __init__(self, options: List[_Node]):
        self.options = options


class _Repeat(_Node):
    def __init__(self, node: _Node, lo: int, hi: Optional[int]):
        self.node = node
        self.lo = lo
        self.hi = hi  # None = unbounded


_PUNCT_RANGES = [(0x21, 0x2F), (0x3A, 0x40), (0x5B, 0x60), (0x7B, 0x7E)]
_WHITESPACE_CPS = [0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680,
                   0x2000, 0x2001, 0x2002, 0x2003, 0x2004, 0x2005, 0x2006,
                   0x2007, 0x2008, 0x2009, 0x200A, 0x2028, 0x2029, 0x202F,
                   0x205F, 0x3000]
_ESCAPES = {
    "n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B, "0": 0x00,
    "a": 0x07,
}

# \d / \w are Unicode-aware in the Rust regex crate (\d = \p{Nd},
# \w = [\p{Alphabetic}\p{M}\p{Nd}\p{Pc}\p{Join_Control}]). Derived
# lazily from unicodedata categories (L* + M* + Nd + Nl + Pc + ZWJ/ZWNJ)
# plus the static Other_Alphabetic table below — Alphabetic codepoints
# Python's category data cannot identify. One full-codepoint scan,
# cached.
_CLASS_RANGE_CACHE: Dict[str, List[Tuple[int, int]]] = {}

# Other_Alphabetic \ (L* ∪ M* ∪ Nl) as of Unicode 15.0 (the vintage of
# both CPython 3.12's unicodedata and the reference's bundled regex
# tables): symbol-category letters that ARE \p{Alphabetic}. Derived by
# diffing the PyPI regex module's \p{Alphabetic} against the category
# union, restricted to Unicode-15-assigned codepoints (closes the
# round-3 PARITY.md "circled letters" deviation).
_OTHER_ALPHABETIC = [
    (0x24B6, 0x24E9),    # CIRCLED LATIN LETTER A..Z, a..z
    (0x1F130, 0x1F149),  # SQUARED LATIN CAPITAL LETTER A..Z
    (0x1F150, 0x1F169),  # NEGATIVE CIRCLED LATIN CAPITAL LETTER A..Z
    (0x1F170, 0x1F189),  # NEGATIVE SQUARED LATIN CAPITAL LETTER A..Z
]


def _unicode_class_ranges(kind: str) -> List[Tuple[int, int]]:
    cached = _CLASS_RANGE_CACHE.get(kind)
    if cached is not None:
        return cached
    import unicodedata

    if kind == "d":
        cats = {"Nd"}
        extra: Set[int] = set()
    else:  # "w"
        cats = {"Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd",
                "Nl", "Pc"}
        extra = {0x200C, 0x200D}  # Join_Control
        for lo, hi in _OTHER_ALPHABETIC:
            extra.update(range(lo, hi + 1))
    ranges: List[Tuple[int, int]] = []
    start = None
    for cp in range(MAX_CP + 1):
        hit = unicodedata.category(chr(cp)) in cats or cp in extra
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            ranges.append((start, cp - 1))
            start = None
    if start is not None:
        ranges.append((start, MAX_CP))
    _CLASS_RANGE_CACHE[kind] = ranges
    return ranges


def _normalize(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    rs = sorted(r for r in ranges if r[0] <= r[1])
    out: List[Tuple[int, int]] = []
    for lo, hi in rs:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _negate(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    prev = 0
    for lo, hi in _normalize(ranges):
        if lo > prev:
            out.append((prev, lo - 1))
        prev = hi + 1
    if prev <= MAX_CP:
        out.append((prev, MAX_CP))
    return out


class RegexSyntaxError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str):
        self.s = pattern.replace("[[:punct:]]", "\x00PUNCT\x00")
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.s[self.i] if self.i < len(self.s) else None

    def next(self) -> str:
        ch = self.s[self.i]
        self.i += 1
        return ch

    def parse(self) -> _Node:
        node = self.parse_alt()
        if self.i != len(self.s):
            raise RegexSyntaxError(f"unexpected {self.s[self.i]!r} at {self.i}")
        return node

    def parse_alt(self) -> _Node:
        options = [self.parse_concat()]
        while self.peek() == "|":
            self.next()
            options.append(self.parse_concat())
        return options[0] if len(options) == 1 else _Alt(options)

    def parse_concat(self) -> _Node:
        parts: List[_Node] = []
        while True:
            ch = self.peek()
            if ch is None or ch in "|)":
                break
            parts.append(self.parse_repeat())
        if not parts:
            return _Empty()
        return parts[0] if len(parts) == 1 else _Concat(parts)

    def parse_repeat(self) -> _Node:
        atom = self.parse_atom()
        while True:
            ch = self.peek()
            if ch == "?":
                self.next()
                atom = _Repeat(atom, 0, 1)
            elif ch == "*":
                self.next()
                atom = _Repeat(atom, 0, None)
            elif ch == "+":
                self.next()
                atom = _Repeat(atom, 1, None)
            elif ch == "{":
                j = self.s.find("}", self.i)
                if j < 0:
                    raise RegexSyntaxError("unterminated {")
                body = self.s[self.i + 1 : j]
                self.i = j + 1
                if "," in body:
                    lo_s, hi_s = body.split(",", 1)
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(body)
                atom = _Repeat(atom, lo, hi)
            else:
                return atom

    def parse_atom(self) -> _Node:
        ch = self.next()
        if ch == "(":
            if self.peek() == "?":
                self.next()
                nxt = self.next()
                if nxt != ":":
                    raise RegexSyntaxError(f"unsupported group (?{nxt}")
            node = self.parse_alt()
            if self.peek() != ")":
                raise RegexSyntaxError("unterminated group")
            self.next()
            return node
        if ch == "[":
            return self.parse_class()
        if ch == ".":
            # Rust regex `.`: any char except \n.
            return _CharClass(_normalize([(0, 0x09), (0x0B, MAX_CP)]))
        if ch == "\\":
            return _CharClass(self.parse_escape())
        if ch in "^$":
            return _Empty()  # anchors are no-ops for whole-string DFA match
        if ch == "\x00":
            # PUNCT marker
            j = self.s.find("\x00", self.i)
            assert self.s[self.i : j] == "PUNCT"
            self.i = j + 1
            return _CharClass(list(_PUNCT_RANGES))
        return _CharClass([(ord(ch), ord(ch))])

    def parse_escape(self) -> List[Tuple[int, int]]:
        ch = self.next()
        if ch == "s":
            return _normalize([(c, c) for c in _WHITESPACE_CPS])
        if ch == "S":
            return _negate([(c, c) for c in _WHITESPACE_CPS])
        if ch == "d":
            return list(_unicode_class_ranges("d"))
        if ch == "D":
            return _negate(list(_unicode_class_ranges("d")))
        if ch == "w":
            return list(_unicode_class_ranges("w"))
        if ch == "W":
            return _negate(list(_unicode_class_ranges("w")))
        if ch in ("u", "x"):
            if self.peek() == "{":
                j = self.s.find("}", self.i)
                cp = int(self.s[self.i + 1 : j], 16)
                self.i = j + 1
            else:
                n = 4 if ch == "u" else 2
                cp = int(self.s[self.i : self.i + n], 16)
                self.i += n
            return [(cp, cp)]
        if ch in _ESCAPES:
            cp = _ESCAPES[ch]
            return [(cp, cp)]
        return [(ord(ch), ord(ch))]

    def parse_class(self) -> _Node:
        negated = False
        if self.peek() == "^":
            self.next()
            negated = True
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise RegexSyntaxError("unterminated class")
            if ch == "]" and not first:
                self.next()
                break
            first = False
            if ch == "\x00":
                self.next()
                j = self.s.find("\x00", self.i)
                self.i = j + 1
                ranges.extend(_PUNCT_RANGES)
                continue
            if ch == "\\":
                self.next()
                sub = self.parse_escape()
                if len(sub) == 1 and sub[0][0] == sub[0][1]:
                    lo_cp = sub[0][0]
                else:
                    ranges.extend(sub)
                    continue
            else:
                self.next()
                lo_cp = ord(ch)
            if self.peek() == "-" and self.i + 1 < len(self.s) and \
                    self.s[self.i + 1] != "]":
                self.next()  # consume '-'
                hi_ch = self.next()
                if hi_ch == "\\":
                    sub = self.parse_escape()
                    hi_cp = sub[0][0]
                else:
                    hi_cp = ord(hi_ch)
                ranges.append((lo_cp, hi_cp))
            else:
                ranges.append((lo_cp, lo_cp))
        ranges = _normalize(ranges)
        if negated:
            ranges = _negate(ranges)
        return _CharClass(ranges)


# ---------------------------------------------------------------------------
# UTF-8 lowering: codepoint ranges -> byte-sequence NFA fragments
# ---------------------------------------------------------------------------


def _between(blo: bytes, bhi: bytes) -> List[List[Tuple[int, int]]]:
    """Byte-range sequences covering all UTF-8 encodings lexicographically
    between blo and bhi (same length). Valid because UTF-8 is
    order-preserving within an encoded length, and any byte string
    between two valid same-length encodings with continuation bytes in
    [0x80, 0xBF] is itself a valid in-range encoding."""
    n = len(blo)
    if n == 1:
        return [[(blo[0], bhi[0])]]
    if blo[0] == bhi[0]:
        return [[(blo[0], blo[0])] + s for s in _between(blo[1:], bhi[1:])]
    res: List[List[Tuple[int, int]]] = []
    cont_min = b"\x80" * (n - 1)
    cont_max = b"\xbf" * (n - 1)
    if blo[1:] == cont_min:
        lo_first = blo[0]
    else:
        res += [[(blo[0], blo[0])] + s for s in _between(blo[1:], cont_max)]
        lo_first = blo[0] + 1
    if bhi[1:] == cont_max:
        hi_first = bhi[0]
    else:
        hi_first = bhi[0] - 1
        res += [[(bhi[0], bhi[0])] + s for s in _between(cont_min, bhi[1:])]
    if lo_first <= hi_first:
        res.append([(lo_first, hi_first)] + [(0x80, 0xBF)] * (n - 1))
    return res


def _utf8_ranges(lo: int, hi: int) -> List[List[Tuple[int, int]]]:
    """Split a codepoint range into byte-wise range sequences, each a
    list of per-byte inclusive (lo, hi) byte ranges."""
    out: List[List[Tuple[int, int]]] = []

    def split(lo: int, hi: int) -> None:
        if lo > hi:
            return
        for bound in (0x80, 0x800, 0x10000):
            if lo < bound <= hi:
                split(lo, bound - 1)
                split(bound, hi)
                return
        if lo <= 0xDFFF and hi >= 0xD800:  # exclude surrogates
            if lo <= 0xD7FF:
                split(lo, 0xD7FF)
            if hi >= 0xE000:
                split(0xE000, hi)
            return
        out.extend(_between(chr(lo).encode("utf-8"), chr(hi).encode("utf-8")))

    split(lo, hi)
    return out


# ---------------------------------------------------------------------------
# Thompson NFA over bytes + subset construction
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[int, int, int]]] = []  # (lo, hi, target)

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def add_range(self, a: int, lo: int, hi: int, b: int) -> None:
        self.trans[a].append((lo, hi, b))


def _build(nfa: _NFA, node: _Node, start: int, end: int) -> None:
    if isinstance(node, _Empty):
        nfa.add_eps(start, end)
    elif isinstance(node, _CharClass):
        for lo, hi in node.ranges:
            for seq in _utf8_ranges(lo, hi):
                cur = start
                for k, (blo, bhi) in enumerate(seq):
                    nxt = end if k == len(seq) - 1 else nfa.new_state()
                    nfa.add_range(cur, blo, bhi, nxt)
                    cur = nxt
    elif isinstance(node, _Concat):
        cur = start
        for k, part in enumerate(node.parts):
            nxt = end if k == len(node.parts) - 1 else nfa.new_state()
            _build(nfa, part, cur, nxt)
            cur = nxt
    elif isinstance(node, _Alt):
        for opt in node.options:
            s = nfa.new_state()
            e = nfa.new_state()
            nfa.add_eps(start, s)
            _build(nfa, opt, s, e)
            nfa.add_eps(e, end)
    elif isinstance(node, _Repeat):
        lo, hi = node.lo, node.hi
        cur = start
        for _ in range(lo):
            nxt = nfa.new_state()
            _build(nfa, node.node, cur, nxt)
            cur = nxt
        if hi is None:
            # loop state
            loop = nfa.new_state()
            nfa.add_eps(cur, loop)
            s = nfa.new_state()
            e = nfa.new_state()
            nfa.add_eps(loop, s)
            _build(nfa, node.node, s, e)
            nfa.add_eps(e, loop)
            nfa.add_eps(loop, end)
        else:
            for _ in range(hi - lo):
                nfa.add_eps(cur, end)
                nxt = nfa.new_state()
                _build(nfa, node.node, cur, nxt)
                cur = nxt
            nfa.add_eps(cur, end)
    else:
        raise AssertionError(type(node))


class ByteDFA:
    """Dense byte DFA: next[state, byte] int32 (-1 = dead encoded as
    state 0, the absorbing dead state), accept[state] bool."""

    def __init__(self, next_table: np.ndarray, accept: np.ndarray, start: int):
        self.next = next_table
        self.accept = accept
        self.start = start

    @property
    def num_states(self) -> int:
        return self.next.shape[0]

    def fullmatch_bytes(self, data: bytes) -> bool:
        s = self.start
        for b in data:
            s = int(self.next[s, b])
        return bool(self.accept[s])

    def match_lengths(self, data: np.ndarray, max_len: int) -> np.ndarray:
        """allowed[p, l-1]: whether data[p:p+l] full-matches, for every
        start position p and l in 1..max_len. data: (W,) uint8."""
        W = data.shape[0]
        states = np.full(W, self.start, dtype=np.int32)
        allowed = np.zeros((W, max_len), dtype=bool)
        for l in range(1, max_len + 1):
            if l > W:
                break
            w = W - l + 1
            states = states[:w]
            states = self.next[states, data[l - 1 : l - 1 + w]]
            allowed[:w, l - 1] = self.accept[states]
        return allowed


def compile_dfa(pattern: str) -> ByteDFA:
    """Compile a (reference-syntax) regex into a whole-string byte DFA."""
    return _compile_ast(_Parser(pattern).parse())


def compile_search_dfa(pattern: str) -> ByteDFA:
    """Whole-string DFA with SEARCH semantics — fullmatch_bytes(s) is
    True iff the pattern matches anywhere in s (the Rust Regex::is_match
    used by merge, reference: src/merge.rs:105-106). Wraps the pattern
    in any-char closures (including newlines, unlike `.`)."""
    ast = _Parser(pattern).parse()
    wrapped = _Concat([
        _Repeat(_CharClass([(0, MAX_CP)]), 0, None),
        ast,
        _Repeat(_CharClass([(0, MAX_CP)]), 0, None),
    ])
    return _compile_ast(wrapped)


def compile_is_match_dfa(pattern: str) -> ByteDFA:
    """DFA whose fullmatch_bytes reproduces Rust Regex::is_match for the
    two anchor shapes that occur in practice:

      - no anchors at all -> unanchored search (closure-wrapped);
      - every top-level alternative fully ^...$-anchored (what
        build_allow_regex emits) -> plain whole-string match.

    Mixed/internal anchors raise RegexSyntaxError; callers fall back to
    a host regex engine."""
    depth = 0
    cls = False
    esc = False
    tops: List[str] = []
    cur: List[str] = []
    for ch in pattern:
        if esc:
            esc = False
            cur.append(ch)
            continue
        if ch == "\\":
            esc = True
            cur.append(ch)
            continue
        if cls:
            if ch == "]":
                cls = False
            cur.append(ch)
            continue
        if ch == "[":
            cls = True
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "|" and depth == 0:
            tops.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    tops.append("".join(cur))

    def anchors(a: str):
        body = a
        lead = body.startswith("^")
        if lead:
            body = body[1:]
        trail = body.endswith("$") and not body.endswith("\\$")
        if trail:
            body = body[:-1]
        # any remaining bare anchors are "internal"
        inner = False
        e = False
        inc = False
        for ch in body:
            if e:
                e = False
                continue
            if ch == "\\":
                e = True
                continue
            if inc:
                if ch == "]":
                    inc = False
                continue
            if ch == "[":
                inc = True
                continue
            if ch in "^$":
                inner = True
        return lead, trail, inner

    infos = [anchors(a) for a in tops]
    if all(le and tr and not inn for le, tr, inn in infos):
        return compile_dfa(pattern)
    if all(not le and not tr and not inn for le, tr, inn in infos):
        return compile_search_dfa(pattern)
    raise RegexSyntaxError(
        "partially anchored pattern needs a host regex engine")


def _compile_ast(ast: _Node) -> ByteDFA:
    nfa = _NFA()
    start = nfa.new_state()
    end = nfa.new_state()
    assert start == 0 and end == 1
    _build(nfa, ast, start, end)

    # Epsilon closures.
    n = len(nfa.eps)

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    # Subset construction. State 0 of the DFA = dead state.
    dfa_states: Dict[FrozenSet[int], int] = {frozenset(): 0}
    next_rows: List[np.ndarray] = [np.zeros(256, dtype=np.int32)]
    accept: List[bool] = [False]

    def intern(s: FrozenSet[int]) -> int:
        if s in dfa_states:
            return dfa_states[s]
        idx = len(next_rows)
        dfa_states[s] = idx
        next_rows.append(np.zeros(256, dtype=np.int32))
        accept.append(end in s)
        worklist.append(s)
        return idx

    worklist: List[FrozenSet[int]] = []
    start_idx = intern(start_set)

    while worklist:
        cur = worklist.pop()
        idx = dfa_states[cur]
        # Gather transitions per byte.
        targets: List[Set[int]] = [set() for _ in range(256)]
        for s in cur:
            for lo, hi, t in nfa.trans[s]:
                for b in range(lo, hi + 1):
                    targets[b].add(t)
        cache: Dict[FrozenSet[int], int] = {}
        out_row = next_rows[idx]
        for b in range(256):
            if not targets[b]:
                out_row[b] = 0
                continue
            key = frozenset(targets[b])
            if key in cache:
                out_row[b] = cache[key]
            else:
                tgt = intern(closure(key))
                cache[key] = tgt
                out_row[b] = tgt

    return ByteDFA(np.stack(next_rows), np.asarray(accept, dtype=bool),
                   start_idx)
