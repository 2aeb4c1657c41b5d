"""Seeded code-like corpus: the benchmark's inputs, made from `--seed`.

The text rule is chip_smoke.py's `build_corpus` (itself from bench.py):
Zipf-weighted identifiers, the language's keywords first and then
random-letter names, joined by code punctuation into lines of 3-11 words.
It is drawn here in bulk with numpy. Files are cut from the text at
lengths drawn from a lognormal distribution (median and sigma from the
traffic file) clipped to the size filter of scripts/datagen.py (16 B to
256 KiB), so a few files pass the port's 32 KiB pack cap and take its
chained encode.
"""

from __future__ import annotations

from typing import List

import numpy as np

KEYWORDS = [
    "def", "return", "value", "data", "self", "import", "print",
    "class", "for", "in", "range", "len", "if", "else", "while",
    "try", "except", "yield", "lambda", "none", "true", "false",
    "result", "index", "count", "total", "items", "key", "object",
]
SEPS = [" ", "(", ") ", ", ", "._", " = ", ": ", "[0]", "();\n    ",
        " == 1", "...", "{}", " += 2", "'%s'"]
# Text is drawn in blocks of about this many bytes, to bound the index
# arrays' memory.
BLOCK_BYTES = 1 << 23


def word_pool(rng: np.random.Generator, size: int) -> List[bytes]:
    pool = list(KEYWORDS)
    seen = set(pool)
    while len(pool) < size:
        w = "".join(chr(97 + int(c))
                    for c in rng.integers(0, 26, rng.integers(3, 11)))
        if w not in seen:
            seen.add(w)
            pool.append(w)
    return [w.encode() for w in pool]


def _pieces(pool: List[bytes]):
    """(bytes buffer, offsets, lengths) of every piece: the pool's words,
    then the separators, then the newline."""
    pieces = pool + [s.encode() for s in SEPS] + [b"\n"]
    lens = np.array([len(p) for p in pieces], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.frombuffer(b"".join(pieces), np.uint8), offs, lens


def _text_block(rng, nbytes: int, weights, buf, offs, lens, n_words: int,
                n_seps: int, lead_newline: bool) -> np.ndarray:
    """At least `nbytes` of text: lines of 3-11 words, the words joined by
    separators and the lines by newlines (one before the first line too
    with `lead_newline`)."""
    n_lines = nbytes // 40 + 1
    per_line = rng.integers(3, 12, n_lines)
    T = int(per_line.sum())
    picks = rng.choice(n_words, size=T, p=weights)
    joins = rng.integers(0, n_seps, T)
    first = np.zeros(T, bool)
    first[np.concatenate([[0], np.cumsum(per_line)[:-1]])] = True
    seq = np.empty(2 * T, np.int64)
    seq[0::2] = np.where(first, n_words + n_seps, n_words + joins)
    seq[1::2] = picks
    if not lead_newline:
        seq = seq[1:]
    plen = lens[seq]
    ends = np.cumsum(plen)
    idx = (np.arange(int(ends[-1]), dtype=np.int64)
           - np.repeat(ends - plen, plen) + np.repeat(offs[seq], plen))
    return buf[idx]


def file_lengths(rng: np.random.Generator, nbytes: int, median: float,
                 sigma: float, lo: int, hi: int) -> np.ndarray:
    """File sizes drawn until they add up to `nbytes` or more."""
    out, total = [], 0
    while total < nbytes:
        n = max(64, int((nbytes - total) / median) + 64)
        sizes = np.clip(rng.lognormal(np.log(median), sigma, n), lo, hi)
        sizes = sizes.astype(np.int64)
        cum = total + np.cumsum(sizes)
        stop = int(np.searchsorted(cum, nbytes)) + 1
        out.append(sizes[:stop])
        total = int(cum[min(stop, n) - 1])
    return np.concatenate(out)


def build_corpus(nbytes: int, seed: int, corpus: dict) -> List[bytes]:
    """The files of a corpus of at least `nbytes`, from `seed` and the
    traffic file's corpus parameters (pool_size, zipf, file_median_bytes,
    file_sigma, file_min_bytes, file_max_bytes, sizes_seed). The file
    sizes come from `sizes_seed`, the same for every run, in an order and
    with a text drawn from `seed`: every seed gives the same work."""
    rng = np.random.default_rng(seed)
    pool = word_pool(rng, int(corpus["pool_size"]))
    weights = 1.0 / (1.0 + np.arange(len(pool))) ** float(corpus["zipf"])
    weights /= weights.sum()
    sizes = rng.permutation(file_lengths(
        np.random.default_rng(int(corpus["sizes_seed"])), nbytes,
        float(corpus["file_median_bytes"]), float(corpus["file_sigma"]),
        int(corpus["file_min_bytes"]), int(corpus["file_max_bytes"])))
    total = int(sizes.sum())
    buf, offs, lens = _pieces(pool)
    blocks, have = [], 0
    while have < total:
        block = _text_block(rng, min(BLOCK_BYTES, total - have), weights,
                            buf, offs, lens, len(pool), len(SEPS),
                            lead_newline=bool(blocks))
        blocks.append(block)
        have += block.size
    text = np.concatenate(blocks)[:total].tobytes()
    cuts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return [text[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
