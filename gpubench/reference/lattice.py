"""Plain reference of the unigram model's lattice passes, in torch ops.

It follows the semantics of upstream TokenGeeX (src/model.rs,
src/lattice.rs, src/prune.rs) and shares no code with the program under
test: tokens are found by an exact lookup of each substring's bytes, the
dynamic programs run position by position over rows of samples, and
everything is computed in the dtype asked for (float64 for the
reference, bfloat16 for the control that must fail).

Rows: a row holds whole samples back to back; `room[r, q]` is the number
of bytes from position q to the end of q's sample (0 in padding), so no
token crosses a sample boundary, and `start[r, q]` marks the first byte
of a sample. The dynamic programs reset at sample starts.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np
import torch

L_MAX = 16
_M1 = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
_M2 = -4417276706812531889  # 0xC2B2AE3D27D4EB4F as int64
_M3 = 1609587929392839161   # 0x165667B19E3779F9


def _mix(lo: torch.Tensor, hi: torch.Tensor, n) -> torch.Tensor:
    """A 64-bit hash of an exact key (lo, hi, n); int64 arithmetic wraps."""
    if not isinstance(n, torch.Tensor):
        n = torch.full_like(lo, n)
    h = lo * _M1 ^ (hi + 0x632BE59BD9B4E019) * _M2 ^ n * _M3
    return h ^ ((h >> 29) & ((1 << 35) - 1))


class Lookup:
    """Exact token lookup: a substring of <= 16 bytes -> its id, the last
    of equal tokens winning (upstream's HashMap::insert)."""

    def __init__(self, tokens: Sequence[bytes], device):
        n = len(tokens)
        buf = np.zeros((n, 16), np.uint8)
        lens = np.zeros(n, np.int64)
        for i, t in enumerate(tokens):
            if not 0 < len(t) <= L_MAX:
                raise ValueError(f"token of {len(t)} bytes")
            buf[i, : len(t)] = np.frombuffer(t, np.uint8)
            lens[i] = len(t)
        words = buf.view("<i8")
        lo = torch.as_tensor(words[:, 0].copy(), device=device)
        hi = torch.as_tensor(words[:, 1].copy(), device=device)
        ln = torch.as_tensor(lens, device=device)
        h = _mix(lo, hi, ln)
        # Later duplicates win: keep the last id of each key.
        order = torch.argsort(h, stable=True)
        hs = h[order]
        last = torch.ones_like(hs, dtype=torch.bool)
        last[:-1] = hs[1:] != hs[:-1]
        same = (lo[order][1:] == lo[order][:-1]) & \
            (hi[order][1:] == hi[order][:-1]) & (ln[order][1:] == ln[order][:-1])
        if bool(((hs[1:] == hs[:-1]) & ~same).any()):
            raise RuntimeError("token hash collision")
        self.order, self.h = order[last], hs[last]
        self.lo, self.hi, self.len = lo, hi, ln

    def match(self, rows: torch.Tensor, room: torch.Tensor) -> torch.Tensor:
        """(R, W, 16) int64 ids of the token starting at each position with
        each length 1..16, -1 where none or where it would leave the
        sample. rows: (R, W) uint8."""
        R, W = rows.shape
        pad = torch.zeros((R, W + L_MAX), dtype=torch.int64,
                          device=rows.device)
        pad[:, :W] = rows.to(torch.int64)
        lo = torch.zeros((R, W), dtype=torch.int64, device=rows.device)
        hi = torch.zeros_like(lo)
        out = torch.full((R, W, L_MAX), -1, dtype=torch.int64,
                         device=rows.device)
        for n in range(1, L_MAX + 1):
            b = pad[:, n - 1 : n - 1 + W] << (8 * ((n - 1) % 8))
            if n <= 8:
                lo = lo | b
            else:
                hi = hi | b
            h = _mix(lo, hi, n)
            at = torch.searchsorted(self.h, h).clamp(max=self.h.numel() - 1)
            cand = self.order[at]
            ok = ((self.h[at] == h) & (self.lo[cand] == lo)
                  & (self.hi[cand] == hi) & (self.len[cand] == n)
                  & (room >= n))
            out[:, :, n - 1] = torch.where(ok, cand, -1)
        return out


def pack_rows(samples: Sequence[bytes], width: int = 0):
    """Samples packed whole into rows (first fit, longest first) of
    `width` bytes (at least the longest sample): (rows (R, W) uint8,
    room (R, W) int64, start (R, W + 1) bool, where: per sample (row,
    first, end))."""
    lens = [len(s) for s in samples]
    W = max([width, 1] + lens)
    order = sorted(range(len(samples)), key=lambda i: -lens[i])
    free: List[Tuple[int, int]] = []  # heap of (-free bytes, row)
    fill: List[int] = []
    where = [(0, 0, 0)] * len(samples)
    for i in order:
        n = lens[i]
        if free and -free[0][0] >= n:
            _, r = heapq.heappop(free)
        else:
            r = len(fill)
            fill.append(0)
        where[i] = (r, fill[r], fill[r] + n)
        fill[r] += n
        heapq.heappush(free, (-(W - fill[r]), r))
    R = max(len(fill), 1)
    rows = np.zeros((R, W), np.uint8)
    room = np.zeros((R, W), np.int64)
    start = np.zeros((R, W + 1), bool)
    for i, (r, a, b) in enumerate(where):
        rows[r, a:b] = np.frombuffer(samples[i], np.uint8)
        room[r, a:b] = np.arange(b - a, 0, -1)
        start[r, a] = True
    return rows, room, start, where


def _scores(ids: torch.Tensor, scores: torch.Tensor, dtype) -> torch.Tensor:
    s = scores.to(dtype)[ids.clamp(min=0)]
    return s.masked_fill(ids < 0, float("-inf"))


def viterbi(ids: torch.Tensor, scores: torch.Tensor, start: torch.Tensor,
            dtype=torch.float64):
    """Best segmentation scores: (dp_end (R, W + 1), bp (R, W + 1) int8).
    dp_end[r, q] is the best score of q's sample up to q (the value before
    the reset at a following sample's start); bp[r, q] the length of the
    last token of that path, 0 where q is unreachable. On exact ties the
    longest token wins (upstream's strict > over candidates in ascending
    start). The loop runs position-major, three launches a position."""
    R, W, L = ids.shape
    dev = ids.device
    s = _scores(ids, scores, dtype)
    # End-indexed: e[q - 1, j] holds the tokens of length L - j ending at q.
    e = torch.full((W + L, L, R), float("-inf"), dtype=dtype, device=dev)
    for n in range(1, L + 1):
        e[n - 1 : n - 1 + W, L - n] = s[:, :, n - 1].t()
    del s
    d = torch.full((L + W + 1, R), float("-inf"), dtype=dtype, device=dev)
    d[L] = 0.0
    dp = torch.full((W + 1, R), float("-inf"), dtype=dtype, device=dev)
    dp[0] = 0.0
    arg = torch.zeros((W + 1, R), dtype=torch.int64, device=dev)
    reset = start.t().contiguous()
    zero = torch.zeros((), dtype=dtype, device=dev)
    cand = torch.empty((L, R), dtype=dtype, device=dev)
    for q in range(1, W + 1):
        torch.add(d[q : q + L], e[q - 1], out=cand)
        torch.max(cand, dim=0, out=(dp[q], arg[q]))
        torch.where(reset[q], zero, dp[q], out=d[L + q])
    bp = torch.where(torch.isfinite(dp), L - arg, 0)
    return dp.t().contiguous(), bp.t().to(torch.int8).contiguous()


def backtrack(bp: np.ndarray, ends: np.ndarray):
    """Tokens of each row's best path from ends[r] back to 0 (through
    every sample before it in the row): (rows, starts, lengths) of every
    token, all rows walked at once."""
    pos = ends.astype(np.int64).copy()
    rr, ss, nn = [], [], []
    live = pos > 0
    while live.any():
        r = np.flatnonzero(live)
        n = bp[r, pos[r]].astype(np.int64)
        if (n <= 0).any():
            raise ValueError("backtrack through an unreachable position")
        pos[r] -= n
        rr.append(r)
        ss.append(pos[r].copy())
        nn.append(n)
        live = pos > 0
    if not rr:
        z = np.zeros(0, np.int64)
        return z, z, z
    return np.concatenate(rr), np.concatenate(ss), np.concatenate(nn)


def row_paths(bp: torch.Tensor, where):
    """(row, start, length) of every token of every sample's best path,
    walking each row from its last sample's end to 0 (paths cross sample
    boundaries, which every path passes)."""
    bp_h = bp.cpu().numpy()
    R = bp_h.shape[0]
    ends = np.zeros(R, np.int64)
    for r, _, b in where:
        ends[r] = max(ends[r], b)
    return backtrack(bp_h, ends)


def e_step(ids: torch.Tensor, scores: torch.Tensor, n: torch.Tensor,
           dropout: float, gen: torch.Generator, V: int,
           dtype=torch.float64):
    """Expected token counts of one sample (snippet) per row: the rows'
    forward-backward over every segmentation, each token of 2 bytes or
    more dropped with probability `dropout` (upstream's populate_nodes).
    n: (R,) the snippets' lengths. Returns (counts (V,) float64, Z (R,)).
    Counts add up in float64 whatever `dtype` the lattice takes."""
    R, W, L = ids.shape
    dev = ids.device
    s = _scores(ids, scores, dtype)
    if dropout > 0.0:
        u = torch.rand((R, W, L), generator=gen, device=dev)
        drop = u < dropout
        drop[:, :, 0] = False
        s = s.masked_fill(drop, float("-inf"))
    ninf = float("-inf")
    # Forward: a[q] = lse over tokens ending at q.
    e = torch.full((R, W + L, L), ninf, dtype=dtype, device=dev)
    for k in range(1, L + 1):
        e[:, k - 1 : k - 1 + W, L - k] = s[:, :, k - 1]
    a = torch.full((R, L + W + 1), ninf, dtype=dtype, device=dev)
    a[:, L] = 0.0
    for q in range(1, W + 1):
        a[:, L + q] = torch.logsumexp(a[:, q : q + L] + e[:, q - 1], dim=1)
    alpha = a[:, L:]
    z = alpha.gather(1, n[:, None]).squeeze(1)
    # Backward: b[q] = lse over tokens starting at q; b[n] = 0.
    b = torch.full((R, W + 1 + L), ninf, dtype=dtype, device=dev)
    cols = torch.arange(W + 1, device=dev)
    b[:, : W + 1] = torch.where(cols[None, :] == n[:, None],
                                torch.zeros((), dtype=dtype, device=dev),
                                torch.tensor(ninf, dtype=dtype, device=dev))
    for q in range(W - 1, -1, -1):
        val = torch.logsumexp(s[:, q] + b[:, q + 1 : q + 1 + L], dim=1)
        b[:, q] = torch.where(q == n, b[:, q], val)
    beta = b
    counts = torch.zeros(V + 1, dtype=torch.float64, device=dev)
    for k in range(1, L + 1):
        m = alpha[:, :W] + s[:, :, k - 1] + beta[:, k : k + W] - z[:, None]
        w = torch.exp(m.to(torch.float64))
        idk = ids[:, :, k - 1]
        ok = (idk >= 0) & torch.isfinite(m)
        counts.index_add_(0, torch.where(ok, idk, V).reshape(-1),
                          torch.where(ok, w, 0.0).reshape(-1))
    return counts[:V], z


def snippet_rows(samples: Sequence[bytes], cap: int):
    """Samples cut into snippets of at most `cap` bytes at offsets 0, cap,
    2 cap, ... (upstream src/prune.rs:75-83), one a row: (rows (R, cap)
    uint8, room (R, cap), lengths (R,))."""
    snippets = [s[o : o + cap] for s in samples
                for o in range(0, len(s), cap) if s]
    R = len(snippets)
    rows = np.zeros((R, cap), np.uint8)
    lens = np.array([len(x) for x in snippets], np.int64)
    flat = np.frombuffer(b"".join(snippets), np.uint8)
    col = np.arange(cap)
    mask = col[None, :] < lens[:, None]
    rows[mask] = flat
    room = np.where(mask, lens[:, None] - col[None, :], 0)
    return rows, room, lens


def token_rows(tokens: Sequence[bytes]):
    """Each token's own bytes as a row of 16: (rows, room, lengths)."""
    R = len(tokens)
    rows = np.zeros((R, L_MAX), np.uint8)
    lens = np.array([len(t) for t in tokens], np.int64)
    flat = np.frombuffer(b"".join(tokens), np.uint8)
    col = np.arange(L_MAX)
    mask = col[None, :] < lens[:, None]
    rows[mask] = flat
    room = np.where(mask, lens[:, None] - col[None, :], 0)
    return rows, room, lens


def alternatives(tokens: Sequence[bytes], scores: torch.Tensor,
                 lookup: Lookup, dtype=torch.float64):
    """For each token, the best segmentation of its own bytes without the
    whole-token entry, M, and upstream's nbest(2) rule on it
    (src/prune.rs:179-203): no M keeps the token with no alternatives,
    s_W >= s_M keeps it with M's ids, s_W < s_M neither keeps it nor gives
    alternatives. Returns (s_w, s_m: (V,) float64 sums of the scores, s_m
    -inf where no M; keep (V,) bool, decided in `dtype`; paths: M's ids,
    [] where none)."""
    dev = scores.device
    rows, room, lens = token_rows(tokens)
    ids = lookup.match(torch.as_tensor(rows, device=dev),
                       torch.as_tensor(room, device=dev))
    V = len(tokens)
    ln = torch.as_tensor(lens, device=dev)
    r = torch.arange(V, device=dev)
    whole = ids[r, 0, ln - 1].clone()
    ids[r, 0, ln - 1] = -1
    start = torch.zeros((V, L_MAX + 1), dtype=torch.bool, device=dev)
    start[:, 0] = True
    dp, bp = viterbi(ids, scores, start, dtype)
    s_m_low = dp[r, ln]
    s_w_low = scores.to(dtype)[whole]
    keep = ~(torch.isfinite(s_m_low) & (s_w_low < s_m_low))
    ok = torch.isfinite(s_m_low).cpu().numpy()
    ends = np.where(ok, lens, 0)
    rr, ss, nn = backtrack(bp.cpu().numpy(), ends)
    tok = ids.cpu().numpy()[rr, ss, nn - 1]
    # Paths come out last token first: order each row's tokens by start.
    order = np.lexsort((ss, rr))
    rr, tok = rr[order], tok[order]
    bounds = np.searchsorted(rr, np.arange(V + 1))
    tok_l = tok.tolist()
    paths = [tok_l[bounds[i]:bounds[i + 1]] for i in range(V)]
    sc = scores.to(torch.float64).cpu().numpy()
    s_m = np.array([sc[p].sum() if p else -np.inf for p in paths])
    s_w = sc[whole.cpu().numpy()]
    return s_w, s_m, keep.cpu().numpy(), paths


def encode(samples: Sequence[bytes], lookup: Lookup, scores: torch.Tensor,
           dtype=torch.float64, want_ids: bool = True):
    """Viterbi segmentation of each sample: (best scores (n,) as computed
    in `dtype`, then float64; the ids of each best path, or None)."""
    dev = scores.device
    rows, room, start, where = pack_rows(samples)
    ids = lookup.match(torch.as_tensor(rows, device=dev),
                       torch.as_tensor(room, device=dev))
    dp, bp = viterbi(ids, scores, torch.as_tensor(start, device=dev), dtype)
    dp_h = dp.to(torch.float64).cpu().numpy()
    best = np.array([dp_h[r, b] if b > a else 0.0 for r, a, b in where])
    if not want_ids:
        return best, None
    rr, ss, nn = row_paths(bp, where)
    tok = ids.cpu().numpy()[rr, ss, nn - 1]
    W1 = dp_h.shape[1]
    key = rr * W1 + ss
    order = np.argsort(key, kind="stable")
    key, tok = key[order], tok[order]
    tok_l = tok.tolist()
    out = []
    for r, a, b in where:
        lo, hi = np.searchsorted(key, [r * W1 + a, r * W1 + b])
        out.append(tok_l[lo:hi])
    return best, out
