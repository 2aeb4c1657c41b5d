"""Special-token splitter.

Reference: src/tokenizer.rs:299-347 (SpecialTokenSplitter). The
reference scans character by character; at each position the FIRST
special token (in registration order) that matches wins. Specials match
anywhere in the string — no word-boundary requirement (see reference
tests src/tokenizer.rs:441-487, e.g. "randomstring" ->
[("random", True), ("string", False)]).

A Python `re` alternation has exactly those semantics — leftmost match
position first, and among tokens matching at the same position the
first alternative in pattern order — so the scan compiles once per
special-token list and runs in C instead of a per-character Python
loop (which dominated encode_batch wall-clock before).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Iterator, List, Optional, Tuple


@lru_cache(maxsize=256)
def _compile(special_tokens: Tuple[str, ...]) -> Optional["re.Pattern"]:
    toks = [t for t in special_tokens if t]
    if not toks:
        return None
    return re.compile("|".join(re.escape(t) for t in toks))


def split_special_tokens(
    text: str, special_tokens: List[str]
) -> Iterator[Tuple[str, bool]]:
    """Yield (span, is_special) pairs covering `text` in order."""
    pat = _compile(tuple(special_tokens))
    if pat is None:
        if text:
            yield text, False
        return
    cursor = 0
    for m in pat.finditer(text):
        if m.start() > cursor:
            yield text[cursor : m.start()], False
        yield m.group(0), True
        cursor = m.end()
    if cursor < len(text):
        yield text[cursor:], False
