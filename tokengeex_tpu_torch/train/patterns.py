"""Named regex pattern library for token-shape engineering.

Reference: src/regex.rs. Pattern strings are kept in the reference's
Rust-regex syntax (including `[[:punct:]]` POSIX classes) so that
written .regex files are byte-compatible with the reference CLI; the
compile helpers translate to Python `re` semantics:

  - `[[:punct:]]` -> explicit ASCII punctuation class,
  - unescaped `$` -> `\\Z` (Rust `$` is absolute end-of-string; Python
    `$` also matches before a trailing newline, which would wrongly
    accept e.g. ";\\n\\n" for `^(?:[[:punct:]]+\\n)$`).
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Tuple

ANY_CHAR = r"."

# Word (reference: src/regex.rs:6-17).
LOWERCASE_WORD = r"[a-z]+"
UPPERCASE_WORD = r"[A-Z]+"
CAPITALIZED_WORD = r"[A-Z][a-z]+"
WORD = r"[A-Za-z]+"
CHINESE_WORD = r"[\u3400-\u4DBF\u4E00-\u9FFF]+"
SPACE_LOWERCASE_WORD = r" ?[a-z]+"
SPACE_UPPERCASE_WORD = r" ?[A-Z]+"
SPACE_CAPITALIZED_WORD = r" ?[A-Z][a-z]+"
SPACE_WORD = r" ?[A-Za-z]+"
SPACE_ENGLISH_WORD = r" ?[A-Za-z]+'[a-zA-Z]{1,2}"
SPACE_FRENCH_WORD = " ?[A-Za-zÀ-ÿ]+"
# Grammar (reference: src/regex.rs:19).
ENGLISH_CONTRACTION = r"'(?:re|ve|s|d|ll|t|m)"
# Numbers (reference: src/regex.rs:21-25).
SPACE_DIGIT = r" [0-9]"
SHORT_NUMBER = r"[0-9]{1,3}"
SPACE_SHORT_NUMBER = r" [0-9]{1,3}"
SHORT_DECIMAL_NUMBER = r"[0-9]{1,3}\.[0-9]"
SPACE_SHORT_DECIMAL_NUMBER = r" [0-9]{1,3}\.[0-9]"
# Wrapped (reference: src/regex.rs:27-30).
WORD_WRAPPED_IN_BRACKETS = r"\[[A-Za-z]+\]"
SHORT_NUMBER_WRAPPED_IN_BRACKETS = r"\[[0-9]{1,3}\]"
WORD_WRAPPED_IN_QUOTES = r"['\"][A-Za-z]+['\"]"
WORD_WRAPPED_IN_ANGLE_BRACKETS = r"<[A-Za-z]+>"
# Word punctuation (reference: src/regex.rs:32-34).
PUNCT_WORD = r"[[:punct:]][A-Za-z]+"
SPACE_PUNCT_WORD = r" [[:punct:]][A-Za-z]+"
WORD_PUNCT = r"[A-Za-z][[:punct:]]"
# Number punctuation (reference: src/regex.rs:36).
DOT_SHORT_NUMBER = r"\.[0-9]{1,3}"
# Whitespace (reference: src/regex.rs:38-40).
INDENT = r"(?:[ ]+)|[\t]+"
NEWLINE_INDENT = r"(?:\n[ ]+)|(?:\n[\t]+)"
WHITESPACE = r"\s+"
# Punctuation (reference: src/regex.rs:42-48).
SPACE_PUNCT_SPACE = r" ?[[:punct:]] ?"
REPEATED_PUNCT = r"[[:punct:]]+"
FEW_REPEATED_PUNCT = r"[[:punct:]]{1,4}"
REPEATED_PUNCT_SPACE = r"(?: |[[:punct:]])+"
FEW_REPEATED_PUNCT_SPACE = r"(?: |[[:punct:]]){1,4}"
PUNCT_NEWLINE = r"[[:punct:]]+\n"
REPEATED_PUNCT_NEWLINE_INDENT = r"[[:punct:]]+\n[ \t]+"

# reference: src/regex.rs:84-88
OPERATORS = [
    "+", "-", "*", "/", "%", "&", "|", "^", "!", "~", "&&", "||", "==", "!=",
    "!==", "<", ">", "<=", ">=", "<<", ">>", ">>>", "++", "--", "+=", "-=",
    "*=", "/=", "%=", "&=", "|=", "^=", "=>", "->", ".", "...", "?", "=",
    ":=", "[]", "()",
]


def _rust_escape(s: str) -> str:
    """regex::escape equivalent (escape all regex metacharacters)."""
    return re.sub(r"([\\.+*?()|\[\]{}^$#&\-~])", r"\\\1", s)


def _space_anyof_space(items: List[str]) -> str:
    """reference: src/regex.rs:59-80."""
    inner = "|".join(f"(?:{_rust_escape(el)})" for el in items)
    return f" ?(?:{inner}) ?"


SPACE_OPERATOR_SPACE = _space_anyof_space(OPERATORS)

# ASCII punctuation, the expansion of POSIX [:punct:]: !-/ :-@ [-` {-~
_PUNCT_CLASS = r"[!-/:-@\[-`{-~]"


def rust_to_python(pattern: str) -> str:
    """Translate a reference-syntax regex into Python `re` syntax."""
    out = pattern.replace("[[:punct:]]", _PUNCT_CLASS)
    # Replace unescaped `$` outside character classes with \Z.
    res = []
    in_class = False
    escaped = False
    for ch in out:
        if escaped:
            res.append(ch)
            escaped = False
            continue
        if ch == "\\":
            res.append(ch)
            escaped = True
            continue
        if in_class:
            res.append(ch)
            if ch == "]":
                in_class = False
            continue
        if ch == "[":
            res.append(ch)
            in_class = True
            continue
        if ch == "$":
            res.append(r"\Z")
            continue
        res.append(ch)
    return "".join(res)


def compile_rust(pattern: str) -> "re.Pattern[str]":
    return re.compile(rust_to_python(pattern))


# (name, pattern, examples, counter_examples) — reference: src/regex.rs:178-411
PATTERNS: List[Tuple[str, str, List[str], List[str]]] = [
    ("any-char", ANY_CHAR, ["好", "A"], ["123"]),
    ("lowercase-word", LOWERCASE_WORD, ["hello"], ["Hello", "HELLO"]),
    ("space-lowercase-word", SPACE_LOWERCASE_WORD, [" hello", " world"],
     ["Hello", " WORLD"]),
    ("uppercase-word", UPPERCASE_WORD, ["HELLO"], ["Hello", " WORLD"]),
    ("space-uppercase-word", SPACE_UPPERCASE_WORD, [" HELLO", "WORLD"],
     ["Hello", " world"]),
    ("capitalized-word", CAPITALIZED_WORD, ["Hello"], ["HeLlO"]),
    ("space-capitalized-word", SPACE_CAPITALIZED_WORD, [" Hello", "Hello"],
     ["HeLlO"]),
    ("word", WORD, ["hello", "Hello", "HELLO"], ["123"]),
    ("space-word", SPACE_WORD, [" hello", " Hello", " HeLlO"], ["123"]),
    ("space-english-word", SPACE_ENGLISH_WORD, ["don't", " You'll", " He's"],
     ["ABC'DEF"]),
    ("space-french-word", SPACE_FRENCH_WORD, ["Été", " compliqué"], ["مرحبا"]),
    ("chinese-word", CHINESE_WORD, ["你好", "大家好"], ["مرحبا"]),
    ("english-contraction", ENGLISH_CONTRACTION,
     ["'re", "'ve", "'s", "'d", "'ll", "'t", "'m"], []),
    ("space-digit", SPACE_DIGIT, [" 1", " 2", " 3"], [" 10"]),
    ("short-number", SHORT_NUMBER, ["1", "123", "789"], ["1000"]),
    ("space-short-number", SPACE_SHORT_NUMBER, [" 1", " 123", " 789"], []),
    ("short-decimal-number", SHORT_DECIMAL_NUMBER, ["1.1", "123.4", "789.9"],
     ["123.456", "1000.0"]),
    ("space-short-decimal-number", SPACE_SHORT_DECIMAL_NUMBER,
     [" 1.1", " 123.4", " 789.9"], [" 123.456", " 1000.0"]),
    ("word-wrapped-in-brackets", WORD_WRAPPED_IN_BRACKETS,
     ["[abc]", "[VALUE]"], []),
    ("short-number-wrapped-in-brackets", SHORT_NUMBER_WRAPPED_IN_BRACKETS,
     ["[1]", "[123]", "[789]"], []),
    ("word-wrapped-in-quotes", WORD_WRAPPED_IN_QUOTES,
     ["'abc'", '"VALUE"'], []),
    ("word-wrapped-in-angle-brackets", WORD_WRAPPED_IN_ANGLE_BRACKETS,
     ["<abc>", "<VALUE>"], []),
    ("punct-word", PUNCT_WORD, ["&abc", ":Abc", "+ABC"], []),
    ("space-punct-word", SPACE_PUNCT_WORD, [" &abc", " :Abc", " +ABC"], []),
    ("word-punct", WORD_PUNCT, ["a&", "B:", "C+"], []),
    ("dot-short-number", DOT_SHORT_NUMBER, [".1", ".123", ".789"], [".1000"]),
    ("indent", INDENT, [" ", "  ", "    ", "\t", "\t\t", "\t\t\t"], ["\t "]),
    ("newline-indent", NEWLINE_INDENT,
     ["\n ", "\n  ", "\n    ", "\n\t\t", "\n\t\t", "\n\t\t\t"], ["\n\t "]),
    ("whitespace", WHITESPACE, [" ", "  ", "    ", "\n", "\n\n", "\t\t", " \n\t"],
     []),
    # NB: the reference's fixture also lists " != " as an example for
    # space-punct-space (src/regex.rs:365), but ` ?[[:punct:]] ?` cannot
    # full-match a 4-char string — the reference has no test CI, so its
    # inline table was never executed. Dropped here.
    ("space-punct-space", SPACE_PUNCT_SPACE,
     [" # ", " ( ", " ) ", " { ", " } ", ", "], []),
    ("repeated-punct", REPEATED_PUNCT, ["####", "()[]{}"], ["\n#\n#\n#"]),
    ("few-repeated-punct", FEW_REPEATED_PUNCT,
     ["#", "##", "###", "()", "[]", "{}"], ["#####", "()[]{}"]),
    ("repeated-punct-space", REPEATED_PUNCT_SPACE,
     [" # ", " ( ", " ) ", " { ", " } ", " != ", ", "], []),
    ("few-repeated-punct-space", FEW_REPEATED_PUNCT_SPACE,
     [" # ", " ( ", " ) ", " { ", " } ", " != ", ", "], []),
    ("punct-newline", PUNCT_NEWLINE, [";\n", "]\n", "}\n"],
     [";\n\n", "]\n\n", "}\n\n"]),
    ("repeated-punct-newline-indent", REPEATED_PUNCT_NEWLINE_INDENT,
     [");\n\t\t", "]\n    "], []),
    ("space-operator-space", SPACE_OPERATOR_SPACE, [" + ", " !=="], []),
]

_BY_NAME = {name: pattern for name, pattern, _, _ in PATTERNS}


def get_pattern(name: str) -> Optional[str]:
    return _BY_NAME.get(name)


def load_patterns(names: Iterable[str]) -> List[str]:
    """Named-or-inline pattern resolution (reference: src/cli.rs:336-351)."""
    out = []
    for name in names:
        pattern = _BY_NAME.get(name)
        if pattern is None:
            re.compile(rust_to_python(name))  # validate
            pattern = name
        out.append(pattern)
    return out


def build_allow_regex(patterns: Iterable[str]) -> str:
    """Anchored full-match alternation (reference: src/regex.rs:413-425)."""
    return "|".join(f"^(?:{p})$" for p in patterns)


def build_mine_regex(patterns: Iterable[str]) -> str:
    """Unanchored alternation (reference: src/regex.rs:427-439)."""
    return "|".join(f"(?:{p})" for p in patterns)
