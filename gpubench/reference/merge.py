"""Plain reference of merge's pass (upstream TokenGeeX src/merge.rs,
src/model.rs), in torch ops and numpy.

It shares no code with the program under test:

  - `Lookup`: an exact byte lookup of tokens of up to 24 bytes (three
    little-endian words and the length a key, hashed, sorted and
    searched; the last of equal tokens wins, as upstream's
    HashMap::insert), so merged tokens past the 16 bytes of
    `reference/lattice.py`'s lookup are found;
  - `pair_counts`: every sample's best segmentation by the Viterbi of
    `reference/lattice.py` (position by position, in the dtype asked
    for: float64 for the reference, bfloat16 for the control), and the
    counts of adjacent id pairs within a sample (src/merge.rs:53-84),
    for several vocabularies at once: their rows share each block's
    position loop;
  - `select`: upstream's choice of new tokens from ordered pairs
    (src/merge.rs:84-125): by count descending, equal counts in
    ascending key (a << 32) | b, a pair refused by length or by the
    allow patterns memoised, score (a + b) x scale_factor, keep false;
  - `FINE`: the fine pattern set (`any-char`, `space-lowercase-word`,
    `space-uppercase-word`, `space-capitalized-word`,
    `english-contraction`, `chinese-word`, `indent`,
    `space-operator-space`, `space-punct-space`) written anew in Python
    `re` syntax from upstream's definitions (src/regex.rs), each matched
    whole against the token's bytes decoded with replacement, as
    upstream's anchored alternation does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import lattice as rl

L_MAX = 24
_M1 = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
_M2 = -4417276706812531889  # 0xC2B2AE3D27D4EB4F as int64
_M3 = 1609587929392839161   # 0x165667B19E3779F9
_M4 = -7723592293110705685  # 0x94D049BB133111EB as int64
# Samples up to this many bytes are packed into rows of this width; longer
# ones into rows of the longest's width.
ROW_WIDTH = 1 << 15


def _mix(lo, mid, hi, n) -> torch.Tensor:
    """A 64-bit hash of an exact key (three words and the length); int64
    arithmetic wraps."""
    if not isinstance(n, torch.Tensor):
        n = torch.full_like(lo, n)
    h = (lo * _M1 ^ (mid + 0x632BE59BD9B4E019) * _M2
         ^ (hi + 0x3C6EF372FE94F82B) * _M4 ^ n * _M3)
    return h ^ ((h >> 29) & ((1 << 35) - 1))


class Lookup:
    """Exact token lookup: a substring of at most 24 bytes -> its id, the
    last of equal tokens winning."""

    def __init__(self, tokens: Sequence[bytes], device):
        n = len(tokens)
        buf = np.zeros((n, L_MAX), np.uint8)
        lens = np.zeros(n, np.int64)
        for i, t in enumerate(tokens):
            if not 0 < len(t) <= L_MAX:
                raise ValueError(f"token of {len(t)} bytes")
            buf[i, : len(t)] = np.frombuffer(t, np.uint8)
            lens[i] = len(t)
        words = [torch.as_tensor(w.copy(), device=device)
                 for w in buf.view("<i8").T]
        ln = torch.as_tensor(lens, device=device)
        h = _mix(*words, ln)
        order = torch.argsort(h, stable=True)
        hs = h[order]
        last = torch.ones_like(hs, dtype=torch.bool)
        last[:-1] = hs[1:] != hs[:-1]
        same = ln[order][1:] == ln[order][:-1]
        for w in words:
            same &= w[order][1:] == w[order][:-1]
        if bool(((hs[1:] == hs[:-1]) & ~same).any()):
            raise RuntimeError("token hash collision")
        self.order, self.h = order[last], hs[last]
        self.words, self.len = words, ln
        self.max_len = int(lens.max(initial=1))

    def match(self, rows: torch.Tensor, room: torch.Tensor) -> torch.Tensor:
        """(R, W, max_len) int64 ids of the token starting at each
        position with each length, -1 where none or where it would leave
        the sample. rows: (R, W) uint8."""
        R, W = rows.shape
        L = self.max_len
        dev = rows.device
        pad = torch.zeros((R, W + L), dtype=torch.int64, device=dev)
        pad[:, :W] = rows.to(torch.int64)
        key = [torch.zeros((R, W), dtype=torch.int64, device=dev)
               for _ in range(3)]
        out = torch.full((R, W, L), -1, dtype=torch.int64, device=dev)
        for n in range(1, L + 1):
            key[(n - 1) // 8] |= pad[:, n - 1 : n - 1 + W] << (8 * ((n - 1) % 8))
            h = _mix(*key, n)
            at = torch.searchsorted(self.h, h).clamp(max=self.h.numel() - 1)
            cand = self.order[at]
            ok = (self.h[at] == h) & (self.len[cand] == n) & (room >= n)
            for w, k in zip(self.words, key):
                ok &= w[cand] == k
            out[:, :, n - 1] = torch.where(ok, cand, -1)
        return out


# Positions a CUDA graph of the Viterbi's position loop covers.
GRAPH_STEPS = 1024


def viterbi(ids: torch.Tensor, scores: torch.Tensor, start: torch.Tensor,
            dtype=torch.float64):
    """`reference/lattice.py` `viterbi`, the same three operations a
    position in the same order, so the same result bit for bit; on a GPU
    the position loop runs as a CUDA graph replayed over chunks of
    GRAPH_STEPS positions, which spares it a launch from the host for
    every operation (the loop is sequential in the position, and the
    longest sample sets its length)."""
    R, W, L = ids.shape
    dev = ids.device
    if dev.type != "cuda" or W < GRAPH_STEPS:
        return rl.viterbi(ids, scores, start, dtype)
    s = rl._scores(ids, scores, dtype)
    K = GRAPH_STEPS
    n_chunks = -(-W // K)
    # e[q - 1, j]: the tokens of length L - j ending at q; -inf past W.
    e = torch.full((n_chunks * K + L, L, R), float("-inf"), dtype=dtype,
                   device=dev)
    for n in range(1, L + 1):
        e[n - 1 : n - 1 + W, L - n] = s[:, :, n - 1].t()
    del s
    reset = torch.zeros((n_chunks * K + 1, R), dtype=torch.bool, device=dev)
    reset[: W + 1] = start.t()
    dp = torch.full((n_chunks * K + 1, R), float("-inf"), dtype=dtype,
                    device=dev)
    dp[0] = 0.0
    arg = torch.zeros((n_chunks * K + 1, R), dtype=torch.int64, device=dev)
    # The graph's own buffers: a chunk's scores and resets, the history
    # (L values before the chunk, then the chunk's), its outputs.
    e_s = torch.empty((K, L, R), dtype=dtype, device=dev)
    reset_s = torch.empty((K, R), dtype=torch.bool, device=dev)
    d_s = torch.full((L + K, R), float("-inf"), dtype=dtype, device=dev)
    d_s[L - 1] = 0.0
    dp_s = torch.empty((K, R), dtype=dtype, device=dev)
    arg_s = torch.empty((K, R), dtype=torch.int64, device=dev)
    cand = torch.empty((L, R), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def steps():
        for j in range(K):
            torch.add(d_s[j : j + L], e_s[j], out=cand)
            torch.max(cand, dim=0, out=(dp_s[j], arg_s[j]))
            torch.where(reset_s[j], zero, dp_s[j], out=d_s[L + j])

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        steps()  # warm-up before capture
    torch.cuda.current_stream(dev).wait_stream(side)
    d_s.fill_(float("-inf"))
    d_s[L - 1] = 0.0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    for c in range(n_chunks):
        q0 = c * K + 1  # the chunk's first dp index
        e_s.copy_(e[q0 - 1 : q0 - 1 + K])
        reset_s.copy_(reset[q0 : q0 + K])
        graph.replay()
        dp[q0 : q0 + K] = dp_s
        arg[q0 : q0 + K] = arg_s
        d_s[:L] = d_s[K:].clone()
    del graph
    dp, arg = dp[: W + 1], arg[: W + 1]
    bp = torch.where(torch.isfinite(dp), L - arg, 0)
    return dp.t().contiguous(), bp.t().to(torch.int8).contiguous()


def _blocks(samples: Sequence[bytes], block_bytes: int) -> List[List[int]]:
    """Sample indices in blocks: those up to ROW_WIDTH bytes, about
    block_bytes a block, then the longer ones in one."""
    short = [i for i, s in enumerate(samples) if 0 < len(s) <= ROW_WIDTH]
    long_ = [i for i, s in enumerate(samples) if len(s) > ROW_WIDTH]
    out, cur, size = [], [], 0
    for i in short:
        cur.append(i)
        size += len(samples[i])
        if size >= block_bytes:
            out.append(cur)
            cur, size = [], 0
    out += [b for b in (cur, long_) if b]
    return out


def pair_counts(vocabs: Sequence[Sequence[Tuple[bytes, float]]],
                samples: Sequence[bytes], device, dtype=torch.float64,
                block_bytes: int = 1 << 23) -> List[dict]:
    """For each vocabulary (a list of (bytes, score)), the adjacent id
    pairs of every sample's best segmentation in `dtype`: a dict with
    `keys` and `counts` (int64, keys (a << 32) | b ascending), each
    sample's tokens (`tokens`, int64 (n,)) and the distinct keys of the
    samples of at most ROW_WIDTH bytes (`short_distinct`). The
    vocabularies' rows run through each block's position loop
    together."""
    lookups = [Lookup([t[0] for t in v], device) for v in vocabs]
    offs = np.cumsum([0] + [len(v) for v in vocabs])
    scores = torch.tensor([t[1] for v in vocabs for t in v],
                          dtype=torch.float64, device=device)
    keys: List[list] = [[] for _ in vocabs]
    short: List[list] = [[] for _ in vocabs]
    ntok = np.zeros((len(vocabs), len(samples)), np.int64)
    for block in _blocks(samples, block_bytes):
        docs = [samples[i] for i in block]
        rows, room, start, where = rl.pack_rows(
            docs, ROW_WIDTH if max(map(len, docs)) <= ROW_WIDTH else 0)
        rows_t = torch.as_tensor(rows, device=device)
        room_t = torch.as_tensor(room, device=device)
        R, W = rows.shape
        L = max(lk.max_len for lk in lookups)
        ids = torch.full((len(vocabs) * R, W, L), -1, dtype=torch.int64,
                         device=device)
        for k, lk in enumerate(lookups):
            got = lk.match(rows_t, room_t)
            ids[k * R : (k + 1) * R, :, : got.shape[2]] = torch.where(
                got >= 0, got + int(offs[k]), -1)
            del got
        start_t = torch.as_tensor(start, device=device).repeat(len(vocabs),
                                                               1)
        _, bp = viterbi(ids, scores, start_t, dtype)
        where_all = [(r + k * R, a, b) for k in range(len(vocabs))
                     for r, a, b in where]
        rr, ss, nn = rl.row_paths(bp, where_all)
        del bp
        tok = ids[torch.as_tensor(rr, device=device),
                  torch.as_tensor(ss, device=device),
                  torch.as_tensor(nn - 1, device=device)].cpu().numpy()
        del ids
        # Each token's sample: tokens in (row, start) order, samples by
        # their first byte.
        W1 = W + 1
        pos = rr * W1 + ss
        order = np.argsort(pos)
        pos, tok = pos[order], tok[order]
        firsts = np.array([r * W1 + a for r, a, _ in where_all], np.int64)
        sorder = np.argsort(firsts)
        slot = sorder[np.searchsorted(firsts[sorder], pos, side="right") - 1]
        sample = np.asarray(block * len(vocabs), np.int64)[slot]
        vocab_of = slot // len(block)
        tok -= offs[vocab_of]
        same = slot[1:] == slot[:-1]
        pairs = (tok[:-1] << 32) | tok[1:]
        for k in range(len(vocabs)):
            keep = same & (vocab_of[:-1] == k)
            keys[k].append(pairs[keep])
            short[k].append(np.full(int(keep.sum()), W <= ROW_WIDTH))
            ntok[k] += np.bincount(sample[vocab_of == k],
                                   minlength=len(samples))
    out = []
    for k in range(len(vocabs)):
        all_keys = (np.concatenate(keys[k]) if keys[k]
                    else np.zeros(0, np.int64))
        in_short = (np.concatenate(short[k]) if short[k]
                    else np.zeros(0, bool))
        uniq, counts = np.unique(all_keys, return_counts=True)
        out.append({"keys": uniq, "counts": counts.astype(np.int64),
                    "tokens": ntok[k],
                    "short_distinct": np.unique(all_keys[in_short]).size})
    return out


# The fine pattern set, from upstream's definitions (src/regex.rs).
_PUNCT = r"[!-/:-@\[-`{-~]"  # POSIX [:punct:] in ASCII
_OPERATORS = [
    "+", "-", "*", "/", "%", "&", "|", "^", "!", "~", "&&", "||", "==",
    "!=", "!==", "<", ">", "<=", ">=", "<<", ">>", ">>>", "++", "--", "+=",
    "-=", "*=", "/=", "%=", "&=", "|=", "^=", "=>", "->", ".", "...", "?",
    "=", ":=", "[]", "()",
]
FINE = {
    "any-char": r".",
    "space-lowercase-word": r" ?[a-z]+",
    "space-uppercase-word": r" ?[A-Z]+",
    "space-capitalized-word": r" ?[A-Z][a-z]+",
    "english-contraction": r"'(?:re|ve|s|d|ll|t|m)",
    "chinese-word": r"[\u3400-\u4DBF\u4E00-\u9FFF]+",
    "indent": r"[ ]+|[\t]+",
    "space-operator-space":
        " ?(?:" + "|".join(map(re.escape, _OPERATORS)) + ") ?",
    "space-punct-space": f" ?{_PUNCT} ?",
}


def allow_fn(names: Sequence[str]):
    """Whether a token's bytes, decoded with replacement, match one of the
    named patterns whole."""
    pats = [re.compile(FINE[n]) for n in names]

    def ok(value: bytes) -> bool:
        text = value.decode("utf-8", errors="replace")
        return any(p.fullmatch(text) for p in pats)

    return ok


def select(vocab: Sequence[Tuple[bytes, float]], keys: np.ndarray,
           counts: np.ndarray, step: int, max_len: int, scale: float,
           allow, refused: set) -> List[Tuple[bytes, float]]:
    """The tokens one pass appends: the pairs by count descending, equal
    counts in ascending key, each pair of tokens a and b merged into a +
    b scored (score_a + score_b) x scale, skipping (and remembering in
    `refused`) a pair whose bytes are longer than max_len or fail
    `allow`, until `step` tokens are made or the pairs run out."""
    out: List[Tuple[bytes, float]] = []
    for i in np.lexsort((keys, -counts)).tolist():
        if len(out) == step:
            break
        k = int(keys[i])
        a, b = k >> 32, k & 0xFFFFFFFF
        if (a, b) in refused:
            continue
        value = vocab[a][0] + vocab[b][0]
        if len(value) > max_len or not allow(value):
            refused.add((a, b))
            continue
        out.append((value, (vocab[a][1] + vocab[b][1]) * scale))
    return out


def l1(got: Dict[int, int], ref_keys: np.ndarray,
       ref_counts: np.ndarray) -> float:
    """sum |c - c_ref| / sum c_ref over the union of the keys."""
    ref = dict(zip(ref_keys.tolist(), ref_counts.tolist()))
    diff = sum(abs(got.get(k, 0) - c) for k, c in ref.items())
    diff += sum(c for k, c in got.items() if k not in ref)
    return diff / max(sum(ref.values()), 1)


def top_l1(got: Dict[int, int], ref_keys: np.ndarray,
           ref_counts: np.ndarray, n: int) -> float:
    """The same over the reference's first n pairs (count descending,
    equal counts in ascending key)."""
    top = np.lexsort((ref_keys, -ref_counts))[:n]
    ref = ref_counts[top]
    diff = sum(abs(got.get(int(k), 0) - int(c))
               for k, c in zip(ref_keys[top], ref))
    return diff / max(int(ref.sum()), 1)
