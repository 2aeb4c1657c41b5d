"""Vocabularies the benchmark builds from its corpus, counted with numpy.

Two rules, each named by a configuration file's `vocab` entries:

- `words`: chip_smoke.py's `build_vocab`: the most frequent word-shaped
  substrings (`[^a-z]?[a-z]+|[^a-z]+` per file, cut to max_len bytes),
  with `prefixes` also their prefixes of 2 or more bytes counted over the
  first quarter of the files, plus up to 32 whole-line prefixes of max_len
  bytes; log relative frequencies as scores.
- `sampled`: the generate stage's rule (train/generate.py, upstream
  src/generate.rs:148-243) without the allow regex: each substring of 2 to
  max_len bytes of every file is taken with probability p and counted
  once a file (document frequency); the most frequent by (-frequency,
  bytes) are kept, scored frequency x length, then as log probabilities.

Both start with the bytes 0-254 marked keep, as generate seeds them.
A token is (bytes, score, keep).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

Token = Tuple[bytes, float, bool]
N_BYTES = 255  # generate's byte seed: 0..254 (upstream src/generate.rs:164)


def _flat(samples: Sequence[bytes]):
    """(text as uint8, file start offsets, bytes to the end of each byte's
    file)."""
    lens = np.array([len(s) for s in samples], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    a = np.frombuffer(b"".join(samples), np.uint8)
    ends = np.repeat(starts + lens, lens)
    room = ends - np.arange(a.size, dtype=np.int64)
    return a, starts, room


def pack_keys(a: np.ndarray, starts: np.ndarray, lengths) -> tuple:
    """(lo, hi) uint64 words of the substrings a[s : s + n] (n <= 16),
    little-endian, zero past the end: with the length, an exact key."""
    lengths = np.broadcast_to(np.asarray(lengths, np.int64), starts.shape)
    win = np.minimum(starts[:, None] + np.arange(16), max(a.size - 1, 0))
    w = a[win] if a.size else np.zeros(win.shape, np.uint8)
    w[np.arange(16) >= lengths[:, None]] = 0
    w = np.ascontiguousarray(w).view("<u8")
    return w[:, 0].astype(np.uint64), w[:, 1].astype(np.uint64)


def _unpack(lo: int, hi: int, n: int) -> bytes:
    return (int(lo).to_bytes(8, "little") + int(hi).to_bytes(8, "little"))[:n]


def _hash(lo, hi, n) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (lo * np.uint64(0x9E3779B97F4A7C15)
             ^ (hi + np.uint64(0x632BE59BD9B4E019)) * np.uint64(0xC2B2AE3D27D4EB4F)
             ^ np.asarray(n, np.uint64) * np.uint64(0x165667B19E3779F9))
        h ^= h >> np.uint64(31)
    return h


def _distinct(lo, hi, n):
    """Distinct keys: (index of each one's first occurrence, counts,
    inverse), checked free of hash collisions."""
    h = _hash(lo, hi, n)
    _, first, inv, counts = np.unique(h, return_index=True,
                                      return_inverse=True,
                                      return_counts=True)
    rep = first[inv]
    if not ((lo[rep] == lo).all() and (hi[rep] == hi).all()
            and (n[rep] == n).all()):
        raise RuntimeError("key hash collision")
    return first, counts, inv


def words_vocab(samples: Sequence[bytes], size: int, max_len: int,
                prefixes: bool) -> List[Token]:
    a, starts, _ = _flat(samples)
    n_all = a.size
    if prefixes:  # counted over the first quarter of the files
        q = max(1, len(samples) // 4)
        n_all = int(sum(len(s) for s in samples[:q]))
    lower = (a[:n_all] >= 97) & (a[:n_all] <= 122)
    file_start = np.zeros(n_all + 1, bool)
    file_start[starts[starts < n_all]] = True
    brk = file_start[:n_all].copy()
    brk[0] = True
    brk[1:] |= lower[1:] != lower[:-1]
    rs = np.flatnonzero(brk)
    re_ = np.append(rs[1:], n_all)
    rlow = lower[rs]
    # A one-byte run of other bytes joins the lowercase run after it in
    # its file: the regex's first alternative.
    nxt_low = np.append(rlow[1:], False) & ~file_start[re_]
    merge = ~rlow & (re_ - rs == 1) & nxt_low
    joined = np.append(False, merge[:-1])
    ws = np.where(joined, rs - 1, rs)[~merge]
    wn = np.minimum(re_ - np.where(joined, rs - 1, rs), max_len)[~merge]
    key_s, key_n = [ws], [wn]
    if prefixes:
        for k in range(2, max_len):
            m = wn > k
            key_s.append(ws[m])
            key_n.append(np.full(int(m.sum()), k, np.int64))
    # Whole-line prefixes of max_len bytes, so the longest token is L.
    long = list(dict.fromkeys(s[:max_len] for s in samples[:64]
                              if len(s) >= max_len))[:32]
    a_long = np.frombuffer(b"".join(long), np.uint8)
    s_all = np.concatenate(key_s)
    n_all_k = np.concatenate(key_n)
    lo, hi = pack_keys(a[: max(n_all, 1)], s_all, n_all_k)
    llo, lhi = pack_keys(a_long, np.arange(len(long)) * max_len, max_len)
    lo = np.concatenate([lo, llo])
    hi = np.concatenate([hi, lhi])
    nn = np.concatenate([n_all_k, np.full(len(long), max_len, np.int64)])
    pos = np.concatenate([s_all, np.full(len(long), -1, np.int64)])
    first, counts, _ = _distinct(lo, hi, nn)
    keys = [_unpack(lo[i], hi[i], int(nn[i])) for i in first]
    count = dict(zip(keys, counts.tolist()))
    long_set = set(long)
    order = np.lexsort((pos[first], -counts))
    common = [keys[i] for i in order.tolist()
              if len(keys[i]) > 1 and keys[i] not in long_set]
    chosen = long + common[: size - N_BYTES - len(long)]
    if len(chosen) != size - N_BYTES:
        raise ValueError(f"the corpus has {len(common)} candidate tokens "
                         f"for a vocabulary of {size}")
    total = sum(count[w] for w in chosen) + N_BYTES
    vocab = [(bytes([b]), math.log(1.0 / total) - 4.0, True)
             for b in range(N_BYTES)]
    vocab += [(w, math.log(count[w] / total), False) for w in chosen]
    return vocab


def sampled_vocab(samples: Sequence[bytes], size: int, max_len: int,
                  p: float, seed: int) -> List[Token]:
    a, starts, room = _flat(samples)
    rng = np.random.default_rng(seed)
    char_start = (a & 0xC0) != 0x80
    fid = np.repeat(np.arange(len(samples), dtype=np.uint64),
                    [len(s) for s in samples])
    s_parts, n_parts = [], []
    for n in range(2, max_len + 1):
        # Each position with n bytes left in its file is taken with
        # probability p: geometric gaps over all positions, the others
        # dropped after.
        gaps = rng.geometric(p, int(a.size * p * 1.2) + 64)
        idx = np.cumsum(gaps) - 1
        while idx[-1] < a.size:
            more = np.cumsum(rng.geometric(p, int(a.size * p * 0.2) + 64))
            idx = np.concatenate([idx, more + idx[-1]])
        pos = idx[idx < a.size]
        pos = pos[room[pos] >= n]
        end = np.minimum(pos + n, a.size - 1)
        ok = char_start[pos] & ((room[pos] == n) | char_start[end])
        s_parts.append(pos[ok])
        n_parts.append(np.full(int(ok.sum()), n, np.int64))
    s_all = np.concatenate(s_parts)
    n_all = np.concatenate(n_parts)
    lo, hi = pack_keys(a, s_all, n_all)
    # Document frequency: a substring counts once a file.
    h = _hash(lo, hi, n_all)
    f = fid[s_all]
    pair = _distinct(h, f, np.zeros_like(n_all))[0]
    lo, hi, n_all = lo[pair], hi[pair], n_all[pair]
    first, freq, _ = _distinct(lo, hi, n_all)
    lo, hi, n_all = lo[first], hi[first], n_all[first]
    need = size - N_BYTES
    if first.size < need:
        raise ValueError(f"{first.size} distinct substrings at p = {p} "
                         f"for {need} tokens")
    # Ties ordered by the bytes: big-endian words, zero-padded.
    order = np.lexsort((hi.byteswap(), lo.byteswap(), -freq))[:need]
    highest = int(freq.max())
    raw = [(bytes([b]), float(highest), True) for b in range(N_BYTES)]
    raw += [(_unpack(lo[i], hi[i], int(n_all[i])),
             float(freq[i] * n_all[i]), False) for i in order.tolist()]
    raw.sort(key=lambda t: -t[1])
    logsum = math.log(sum(t[1] for t in raw))
    return [(v, math.log(s) - logsum, k) for v, s, k in raw]
