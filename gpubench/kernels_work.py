"""The least time each measured kernel could take on the chip: the larger
of its bytes over the memory bandwidth and its operations over the f32
rate, counted from what the window handed the entry, never from padded
launch shapes or from what an implementation re-reads.

The per-position rules are chip_smoke.py's byte and operation counts,
applied to the real corpus positions of each call: `positions` is the
bytes of the texts (or snippets) the call was given and L the maximum
token length. Published peaks of one H100 SXM (NVIDIA's data sheet).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SCORE_BYTES = 4  # f32 scores, forward values and backpointer words


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def match_probe(positions: int, L: int, vocab_size: int, calls: int) -> float:
    """The probe: per position and length one score written; per
    position the two prefix-hash streams, the sample ids and the two
    inverse powers read (20 bytes); the vocabulary's table read once a
    call (a 16-byte key and a score a token); ~14 integer operations a
    (position, length) point."""
    nbytes = positions * (L * SCORE_BYTES + 20) + calls * vocab_size * 20
    return bound_s(nbytes, 14 * L * positions)


def viterbi_scan(positions: int, L: int) -> float:
    """The Viterbi scan: per position the L scores, the start flag, the
    history and the dp and backpointer written (4 (L + 3) bytes); an add,
    a max and a compare a (position, length)."""
    return bound_s(positions * SCORE_BYTES * (L + 3), 3 * L * positions)


def forward_scan(positions: int, L: int, dropout: bool) -> float:
    """The E-step's forward scan: per position the L scores, the reset
    flag and the value written (4 (L + 2) bytes), a dropout word with
    dropout; five operations a (position, length) and four a
    position."""
    nbytes = positions * SCORE_BYTES * (L + 2 + (1 if dropout else 0))
    return bound_s(nbytes, (5 * L + 4) * positions)


def seg_weights_gather(positions: int, hits: int, vocab_size: int,
                       dropout: bool) -> float:
    """The segsum's gather kernel: per lattice entry (a token's match at
    a position) its position read and its weight written (8 bytes, and
    12 a 128-entry block); per position the forward value, beta and
    start flag (9 bytes), the sample end (4) and a dropout word with
    dropout; the score column and the count bins (8 bytes a token) once;
    ~23 operations an entry and 6 a position."""
    nbytes = (8 * hits + 12 * (hits // 128)
              + positions * (13 + (4 if dropout else 0)) + 8 * vocab_size)
    return bound_s(nbytes, 23 * hits + 6 * positions)
