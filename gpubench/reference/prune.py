"""Plain reference of a prune stage's passes: the E-step, the frequency
pass and the alternatives on the reference's lattice passes (lattice.py),
in float64 or, for the control, in a lower dtype; and its host
arithmetic, `m_step` and `select`, frozen copies of upstream's rules
(src/prune.rs:124-170, 173-319; the digamma of src/prune.rs:322-334),
written here apart from the program.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from . import lattice as rl

EXPECTED_FREQUENCY_THRESHOLD = 0.5
E_STEP_SNIPPET = 1024  # the port's f32 E-step snippet (see PERF.md)


def digamma(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64).copy()
    out = np.zeros_like(x)
    for _ in range(8):
        m = x < 7.0
        if not m.any():
            break
        out[m] -= 1.0 / x[m]
        x[m] += 1.0
    x -= 0.5
    xx = 1.0 / x
    xx2 = xx * xx
    xx4 = xx2 * xx2
    return out + (np.log(x) + (1.0 / 24.0) * xx2 - (7.0 / 960.0) * xx4
                  + (31.0 / 8064.0) * xx4 * xx2
                  - (127.0 / 30720.0) * xx4 * xx4)


def m_step(vocab: List[tuple], expected: np.ndarray) -> List[tuple]:
    """Tokens (bytes, score, keep) rescored from expected counts; tokens
    under the threshold and not kept drop out."""
    keep = np.array([t[2] for t in vocab], bool)
    alive = (expected >= EXPECTED_FREQUENCY_THRESHOLD) | keep
    freqs = np.maximum(expected[alive], EXPECTED_FREQUENCY_THRESHOLD)
    scores = digamma(freqs) - digamma(np.array([freqs.sum()]))[0]
    idx = np.flatnonzero(alive)
    return [(vocab[i][0], float(s), vocab[i][2])
            for i, s in zip(idx.tolist(), scores.tolist())]


def select(vocab: List[tuple], freqs: np.ndarray, always_keep: np.ndarray,
           alternatives: List[List[int]], n_samples: int, target: int,
           shrink: float) -> List[tuple]:
    """The round's loss-ranked removal (upstream's alternatives.len() - 1
    normaliser, V - 1)."""
    V = len(vocab)
    size = max(int(V * shrink), target)
    sum_freq = float(freqs.sum())
    logsum = math.log(sum_freq)
    kept, cands = [], []
    for tid in range(V):
        tok = vocab[tid]
        f = int(freqs[tid])
        if tok[2]:
            kept.append(tok)
            continue
        if f == 0 and not always_keep[tid]:
            continue
        if not alternatives[tid]:
            kept.append(tok)
        elif f != 0:
            freq = float(f)
            alt_logsum = math.log(sum_freq + freq * (V - 1))
            # Summed left to right, as upstream's f64 sum: Python's sum()
            # compensates and can land an ulp away, which reorders tied
            # candidates.
            alt = 0.0
            for a in alternatives[tid]:
                alt += math.log(float(freqs[a]) + freq) - alt_logsum
            cands.append((tid, freq / n_samples
                          * (math.log(freq) - logsum - alt)))
    cands.sort(key=lambda c: -c[1])
    for tid, _ in cands:
        if len(kept) == size:
            break
        kept.append(vocab[tid])
    kept.sort(key=lambda t: -t[1])
    return kept


def e_step(vocab: List[tuple], samples: Sequence[bytes], dropout: float,
           gen: torch.Generator, device, dtype=torch.float64):
    """(expected counts (V,), matches (V,): each token's (position,
    length) entries in the snippets' lattices)."""
    rows, room, lens = rl.snippet_rows(samples, E_STEP_SNIPPET)
    lookup = rl.Lookup([t[0] for t in vocab], device)
    scores = torch.tensor([t[1] for t in vocab], dtype=torch.float64,
                          device=device)
    ids = lookup.match(torch.as_tensor(rows, device=device),
                       torch.as_tensor(room, device=device))
    counts, z = rl.e_step(ids, scores, torch.as_tensor(lens, device=device),
                          dropout, gen, len(vocab), dtype)
    if not bool(torch.isfinite(z).all()):
        raise ValueError("a snippet has no segmentation")
    hits = torch.bincount(ids[ids >= 0], minlength=len(vocab))
    return counts.cpu().numpy(), hits.cpu().numpy()


def frequencies(vocab: List[tuple], samples: Sequence[bytes], device,
                dtype=torch.float64) -> np.ndarray:
    """Token counts of every sample's best segmentation."""
    rows, room, start, where = rl.pack_rows(samples)
    lookup = rl.Lookup([t[0] for t in vocab], device)
    scores = torch.tensor([t[1] for t in vocab], dtype=torch.float64,
                          device=device)
    ids = lookup.match(torch.as_tensor(rows, device=device),
                       torch.as_tensor(room, device=device))
    _, bp = rl.viterbi(ids, scores, torch.as_tensor(start, device=device),
                       dtype)
    del scores
    rr, ss, nn = rl.row_paths(bp, where)
    tok = ids.cpu().numpy()[rr, ss, nn - 1]
    return np.bincount(tok, minlength=len(vocab)).astype(np.int64)


def alternatives(vocab: List[tuple], device, dtype=torch.float64):
    """(always_keep, alternatives) as the program's `_alternatives`
    returns them, and the reference's scores (s_w, s_m) for the check."""
    tokens = [t[0] for t in vocab]
    scores = torch.tensor([t[1] for t in vocab], dtype=torch.float64,
                          device=device)
    s_w, s_m, keep, paths = rl.alternatives(tokens, scores,
                                            rl.Lookup(tokens, device), dtype)
    alts = [p if (k and np.isfinite(m)) else []
            for p, k, m in zip(paths, keep.tolist(), s_m.tolist())]
    return keep, alts, s_w, s_m

