"""Lattice DPs over probed scores: the Hopper kernels and their plain
twins.

Counterpart of tokengeex_tpu/ops/lattice_pallas.py: `viterbi_chunk`,
`forward_chunk` and `backward_chunk`, built from csrc/<name>.cu, and of
the XLA scan `_backward_betas_impl` of tokengeex_tpu/ops/lattice_jax.py
(the betas). Four scans run over the whole row width: `viterbi_scan`
(csrc/viterbi_chunk.cu, encode and the frequency pass), and the E-step's
`forward_scan` (csrc/forward_chunk.cu), `backward_betas_scan` and
`backward_marginal_scan` (csrc/backward_chunk.cu). They read a
start-indexed (W, L, B) score cache directly, draw the dropout coins in
the kernel, and cut each row into independent chains at sample
boundaries and padding (`seg`, see ops/lattice.py `chain_bounds`).
`viterbi_chunk`, `forward_chunk`, `backward_chunk` (the marginals) and
`backward_betas_chunk` are the same four kernels over one end-indexed /
start-indexed chunk. Each
`*_plain` function is the same recurrence in plain PyTorch, used for
tensors on the CPU and as the reference the kernel is held against on the
card. The plain log-sum-exp twins sum over lengths in ascending order, as
the kernels do, so on the card the two differ only where the device's
`exp`/`log` differ from the kernel's `expf`/`logf`.

Layout: the port keeps rows minor, so one thread per row reads coalesced.
  score (C, L, B) f32  scores, NEG or -inf for no match: end-indexed for
                       the forward chunk DPs, start-indexed for the
                       backward ones and for the whole-width cache
  starts (C, B) f32    1.0 where dp index q+1 starts a sample
  ends (C, B) f32      1.0 where a sample ends at dp index q
  hist (L, B) f32      the last L DP values, hist[j] = dp[p - 1 - j]
  seg (K+1, B) int32   chain bounds: chain k covers [seg[k], seg[k+1])
  du (pad+W+pad, B)    int32 dropout words, row pad + p for start p
The JAX kernels' (G, C, L, 128) lane groups hold the same numbers with
row = g * 128 + lane.

Tie-breaking matches the reference: on equal candidates the LARGEST token
length wins; a step with no candidate gives dp = NEG and best_l = 1.

`viterbi_scan`, `forward_scan` and `backward_marginal_scan` also take
float64 streams (the f64 / exact conformance route): the kernels' double
instantiations, and the twins in float64, with the same NEG sentinel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from . import hashing as H

NEG = float(np.float32(-3.0e38))  # sentinel "-inf" that survives f32 math
MAX_LEN = 64  # longest token length the kernels are instantiated for
_ODD = 2654435761  # dropout per-length mixer


def dropout_threshold_half(dropout: float) -> int:
    """The coin threshold `thr >>> 1` as a non-negative int."""
    return min(int(dropout * (1 << 32)), (1 << 32) - 1) >> 1


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _roll_insert(hist: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """hist[j] <- hist[j-1], hist[0] <- row."""
    return torch.cat([row[None], hist[:-1]], dim=0)


def _fresh_hist(L: int, B: int, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(L, B) history at an inner chain start: a post-reset 0, then NEG."""
    hist = torch.full((L, B), NEG, dtype=dtype, device=device)
    hist[0] = 0.0
    return hist


def _viterbi_steps(score: torch.Tensor, starts: torch.Tensor,
                   hist0: torch.Tensor,
                   restart: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The max-plus recurrence over an end-indexed (n, L, B) slab, scores
    clamped to NEG as the kernels read them; a row's history restarts
    fresh at each step where `restart` is set. Returns dp, best_l and the
    history after the last step."""
    C, L, B = score.shape
    score = score.clamp(min=NEG)
    hist = hist0.clone()
    fresh = _fresh_hist(L, B, score.device, score.dtype)
    jrow = torch.arange(L, device=score.device)[:, None]
    neg = torch.tensor(NEG, dtype=score.dtype, device=score.device)
    dp = torch.empty((C, B), dtype=score.dtype, device=score.device)
    best_l = torch.empty((C, B), dtype=torch.int32, device=score.device)
    for q in range(C):
        if restart is not None:
            hist = torch.where(restart[q], fresh, hist)
        s = score[q]
        cand = hist + s
        m = cand.max(dim=0).values
        is_max = (cand >= m) & (s > NEG)
        jbest = torch.where(is_max, jrow, -1).max(dim=0).values
        ok = jbest >= 0
        m = torch.where(ok, m, neg)
        dp[q] = m
        best_l[q] = torch.where(ok, jbest + 1, 1).to(torch.int32)
        carry = torch.where(starts[q] > 0.5, torch.zeros_like(m), m)
        hist = _roll_insert(hist, carry)
    return dp, best_l, hist


def viterbi_chunk_plain(score: torch.Tensor, starts: torch.Tensor,
                        hist0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _viterbi_steps(score, starts, hist0)


def _check_slab(score: torch.Tensor, rows: dict, hist0: torch.Tensor) -> bool:
    """Validate a (C, L, B) slab, its (C, B) row streams and the (L, B)
    history. Returns True when the caller is to launch the CUDA kernel,
    False for CPU tensors (the plain version)."""
    _check(score.dim() == 3, f"score must be (C, L, B), got {tuple(score.shape)}")
    C, L, B = score.shape
    for name, t in rows.items():
        _check(tuple(t.shape) == (C, B), f"{name} must be {(C, B)}")
    _check(tuple(hist0.shape) == (L, B), f"hist0 must be {(L, B)}")
    named = {"score": score, **rows, "hist0": hist0}
    for name, t in named.items():
        _check(t.dtype == torch.float32, f"{name} must be float32")
        _check(t.device == score.device, f"{name} is on {t.device}")
    if score.device.type == "cpu":
        return False
    _check(score.device.type == "cuda", f"unsupported device {score.device}")
    _check(1 <= L <= MAX_LEN, f"token length {L} outside 1..{MAX_LEN}")
    for name, t in named.items():
        _check(t.is_contiguous(), f"{name} must be contiguous")
    return True


def _launch(name: str, *args) -> None:
    """Call a kernel's C entry point on the current stream of the device
    of the first tensor argument; raise if the launch was refused."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn = _build.load(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def viterbi_chunk(score: torch.Tensor, starts: torch.Tensor,
                  hist0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of Viterbi DP. Returns dp (C, B) f32, best_l (C, B) int32
    and the next history (L, B) f32.

    CUDA tensors launch csrc/viterbi_chunk.cu on the current stream; CPU
    tensors run `viterbi_chunk_plain`."""
    if not _check_slab(score, {"starts": starts}, hist0):
        return viterbi_chunk_plain(score, starts, hist0)
    C, L, B = score.shape
    dev = score.device
    dp = torch.empty((C, B), dtype=torch.float32, device=dev)
    best_l = torch.empty((C, B), dtype=torch.int32, device=dev)
    hist = torch.empty((L, B), dtype=torch.float32, device=dev)
    if B == 0:
        return dp, best_l, hist
    if C == 0:
        return dp, best_l, hist0.clone()
    _launch("viterbi_chunk", score, starts, hist0, dp, best_l, hist, C, L, B)
    viterbi_chunk.launches += 1
    return dp, best_l, hist


viterbi_chunk.launches = 0


def _lse_step(cand: torch.Tensor) -> torch.Tensor:
    """The kernels' NEG-guarded log-sum-exp over dim 0 of (L, B): max
    shift, then a sum over lengths in ascending order (the kernels'
    order, so on the card both round alike)."""
    m = cand.max(dim=0).values
    has = m > NEG * 0.5
    safe = torch.where(has, m, torch.zeros_like(m))
    e = torch.exp(cand - safe)
    t = e[0]
    for j in range(1, cand.shape[0]):
        t = t + e[j]
    return torch.where(has, safe + torch.log(t), torch.full_like(m, NEG))


def _inner_bounds(seg: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """(n + 1, B) bool, True at the inner chain bounds seg[1..K-1] below n:
    where the kernels start a chain from `_fresh_hist`."""
    if seg is None or seg.shape[0] <= 2:
        return None
    mark = torch.zeros((n + 1, seg.shape[1]), dtype=torch.bool,
                       device=seg.device)
    mark.scatter_(0, seg[1:-1].long(), True)
    mark[n] = False
    return mark


def _forward_steps(score: torch.Tensor, starts: torch.Tensor,
                   hist0: torch.Tensor,
                   restart: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward recurrence over an end-indexed (n, L, B) slab; a row's
    history restarts fresh at each step where `restart` is set."""
    C, L, B = score.shape
    score = score.clamp(min=NEG)
    hist = hist0.clone()
    fresh = _fresh_hist(L, B, score.device, score.dtype)
    a = torch.empty((C, B), dtype=score.dtype, device=score.device)
    for q in range(C):
        if restart is not None:
            hist = torch.where(restart[q], fresh, hist)
        lse = _lse_step(hist + score[q])
        a[q] = lse
        hist = _roll_insert(
            hist, torch.where(starts[q] > 0.5, torch.zeros_like(lse), lse))
    return a, hist


def _backward_steps(score: torch.Tensor, ends: torch.Tensor,
                    hist0: torch.Tensor,
                    restart: Optional[torch.Tensor] = None,
                    az: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """The betas recurrence over a start-indexed (n, L, B) slab, positions
    descending; a row's history restarts fresh at step q where
    `restart[q + 1]` is set (a chain bound at q + 1). With az = (a, z),
    each (n, B), also the marginals exp(max(a + s + hist - z, NEG)) from
    the history before each step. Returns the betas, the history after
    the last step and the marginals (or None)."""
    C, L, B = score.shape
    score = score.clamp(min=NEG)
    hist = hist0.clone()
    fresh = _fresh_hist(L, B, score.device, score.dtype)
    betas = torch.empty((C, B), dtype=score.dtype, device=score.device)
    marg = torch.empty_like(score) if az is not None else None
    for q in range(C - 1, -1, -1):
        if restart is not None:
            hist = torch.where(restart[q + 1], fresh, hist)
        s = score[q]
        if az is not None:
            marg[q] = torch.exp(torch.clamp_min(az[0][q] + s + hist - az[1][q],
                                                NEG))
        lse = _lse_step(s + hist)
        betas[q] = torch.where(ends[q] > 0.5, torch.zeros_like(lse), lse)
        hist = _roll_insert(hist, betas[q])
    return betas, hist, marg


def forward_chunk_plain(score: torch.Tensor, starts: torch.Tensor,
                        hist0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _forward_steps(score, starts, hist0)


def forward_chunk(score: torch.Tensor, starts: torch.Tensor,
                  hist0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the forward log-sum-exp DP over an end-indexed slab.
    Returns the forward values a (C, B) f32 (NEG where no path reaches)
    and the next history (L, B) f32.

    CUDA tensors launch csrc/forward_chunk.cu (one chain per row) on the
    current stream; CPU tensors run `forward_chunk_plain`."""
    if not _check_slab(score, {"starts": starts}, hist0):
        return forward_chunk_plain(score, starts, hist0)
    C, L, B = score.shape
    dev = score.device
    a = torch.empty((C, B), dtype=torch.float32, device=dev)
    hist = torch.empty((L, B), dtype=torch.float32, device=dev)
    if B == 0:
        return a, hist
    if C == 0:
        return a, hist0.clone()
    _launch("forward_scan", score, starts, hist0, None, None, a, hist, C, L,
            B, 1, 0, 0, 0, 0)
    forward_chunk.launches += 1
    return a, hist


forward_chunk.launches = 0


def backward_chunk_plain(score: torch.Tensor, a: torch.Tensor,
                         z: torch.Tensor, ends: torch.Tensor,
                         hist0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    _, hist, marg = _backward_steps(score, ends, hist0, az=(a, z))
    return marg, hist


def backward_chunk(score: torch.Tensor, a: torch.Tensor, z: torch.Tensor,
                   ends: torch.Tensor, hist0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the backward log-sum-exp DP, positions descending,
    over a START-indexed slab. a (C, B) holds the forward value of a token
    starting at each position (0 at sample starts), z (C, B) its sample's
    normaliser, ends (C, B) 1.0 where a sample ends, hist0 (L, B) the betas
    of the L positions after the chunk. Returns the marginals
    marg (C, L, B) = exp(max(a + score + beta - z, NEG)) and the next
    history (L, B).

    CUDA tensors launch csrc/backward_chunk.cu's marginal scan (one chain
    per row) on the current stream, and its marginals are a (C, L, B) view
    of (C, B, L) memory (`backward_marginal_scan`); CPU tensors run
    `backward_chunk_plain`."""
    if not _check_slab(score, {"a": a, "z": z, "ends": ends}, hist0):
        return backward_chunk_plain(score, a, z, ends, hist0)
    C, L, B = score.shape
    dev = score.device
    marg = torch.empty((C, B, L), dtype=torch.float32, device=dev)
    hist = torch.empty((L, B), dtype=torch.float32, device=dev)
    if B == 0:
        return marg.transpose(1, 2), hist
    if C == 0:
        return marg.transpose(1, 2), hist0.clone()
    _launch("backward_chunk", score, a, z, ends, hist0, marg, hist, C, L, B)
    backward_chunk.launches += 1
    return marg.transpose(1, 2), hist


backward_chunk.launches = 0


def backward_betas_chunk_plain(score: torch.Tensor, ends: torch.Tensor,
                               hist0: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _backward_steps(score, ends, hist0)[:2]


def backward_betas_chunk(score: torch.Tensor, ends: torch.Tensor,
                         hist0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`backward_chunk`'s recurrence without the marginals: returns the
    post-reset betas (C, B) f32 (0 where a sample ends, NEG where no path
    reaches) and the next history (L, B).

    CUDA tensors launch csrc/backward_chunk.cu's betas scan (one chain
    per row) on the current stream; CPU tensors run
    `backward_betas_chunk_plain`."""
    if not _check_slab(score, {"ends": ends}, hist0):
        return backward_betas_chunk_plain(score, ends, hist0)
    C, L, B = score.shape
    dev = score.device
    betas = torch.empty((C, B), dtype=torch.float32, device=dev)
    hist = torch.empty((L, B), dtype=torch.float32, device=dev)
    if B == 0:
        return betas, hist
    if C == 0:
        return betas, hist0.clone()
    _launch("backward_betas_scan", score, ends, hist0, None, None, betas,
            hist, C, L, B, 1, 0, 0, 0)
    backward_betas_chunk.launches += 1
    return betas, hist


backward_betas_chunk.launches = 0


# -- the whole-width scans over a start-indexed score cache --


def _dropped(du: torch.Tensor, dropout: float, row: int, n: int,
             L: int) -> torch.Tensor:
    """(n, L, B) bool: the token of length j+1 whose start has its word
    at du[row + i] is dropped (never a single byte)."""
    odd = H.wrap_i32(torch.arange(1, L + 1, dtype=torch.int64,
                                  device=du.device) * _ODD)
    u = H.srl_i32(H.mul_i32(du[row : row + n][:, None, :],
                            odd[None, :, None]), 1)
    lens = torch.arange(1, L + 1, device=du.device)[None, :, None]
    return (u < dropout_threshold_half(dropout)) & (lens > 1)


def _scan_cache(cache: torch.Tensor, du: Optional[torch.Tensor],
                dropout: float, pad: int, lead: int = 0) -> torch.Tensor:
    """The cache as the kernels read it: clamped to NEG, dropped tokens
    NEG. Its first `lead` rows hold the tokens starting before 0."""
    n, L, _ = cache.shape
    score = cache.clamp(min=NEG)
    if du is not None and dropout > 0.0:
        score = torch.where(_dropped(du, dropout, pad - lead, n, L), NEG,
                            score)
    return score


def _end_view(start: torch.Tensor, n: int, lead: int = 0) -> torch.Tensor:
    """End-indexed (n, L, B) view of a start-indexed (lead + n, L, B)
    cache: row j at step q is the token starting at q - j, NEG where that
    start lies before -lead."""
    _, L, B = start.shape
    score = start.new_full((n, L, B), NEG)
    for j in range(L):
        lo = max(j - lead, 0)  # the first step whose token is in the cache
        if lo < n:
            score[lo:, j] = start[lead + lo - j : lead + n - j, j]
    return score


def forward_scan_plain(cache: torch.Tensor, starts: torch.Tensor,
                       hist0: torch.Tensor, seg: Optional[torch.Tensor] = None,
                       du: Optional[torch.Tensor] = None, *,
                       dropout: float = 0.0, pad: int = 0) -> torch.Tensor:
    W = cache.shape[0]
    score = _end_view(_scan_cache(cache, du, dropout, pad), W)
    return _forward_steps(score, starts, hist0, _inner_bounds(seg, W))[0]


def viterbi_scan_plain(cache: torch.Tensor, starts: torch.Tensor,
                       hist0: torch.Tensor, seg: Optional[torch.Tensor] = None,
                       du: Optional[torch.Tensor] = None, *,
                       dropout: float = 0.0, pad: int = 0, lead: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = cache.shape[0] - lead
    score = _end_view(_scan_cache(cache, du, dropout, pad, lead), n, lead)
    return _viterbi_steps(score, starts, hist0, _inner_bounds(seg, n))[:2]


def backward_betas_scan_plain(cache: torch.Tensor, ends: torch.Tensor,
                              hist0: torch.Tensor,
                              seg: Optional[torch.Tensor] = None,
                              du: Optional[torch.Tensor] = None, *,
                              dropout: float = 0.0,
                              pad: int = 0) -> torch.Tensor:
    W = cache.shape[0]
    return _backward_steps(_scan_cache(cache, du, dropout, pad), ends, hist0,
                           _inner_bounds(seg, W))[0]


def backward_marginal_scan_plain(cache: torch.Tensor, a: torch.Tensor,
                                 z: torch.Tensor, ends: torch.Tensor,
                                 hist0: torch.Tensor,
                                 seg: Optional[torch.Tensor] = None,
                                 du: Optional[torch.Tensor] = None, *,
                                 dropout: float = 0.0, pad: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    W = cache.shape[0]
    betas, _, marg = _backward_steps(_scan_cache(cache, du, dropout, pad),
                                     ends, hist0, _inner_bounds(seg, W),
                                     az=(a, z))
    return marg, betas


def _check_seg(seg: torch.Tensor, B: int, W: int, device) -> None:
    """Chain bounds (K+1, B) int32, K >= 1, contiguous on `device`. On
    the CPU their values are checked too: row 0 is 0, row K is W and no
    row falls below the one before. Bounds on the card are not read back,
    which would cost a synchronisation per launch; the kernels clamp each
    chain into [0, W] (csrc/scan_lanes.cuh `tgx_chain`), so bad bounds
    there give wrong values but touch no memory outside the buffers."""
    _check(seg.dim() == 2 and seg.shape[0] >= 2 and seg.shape[1] == B,
           f"seg must be (K+1, {B}) with K >= 1, got {tuple(seg.shape)}")
    _check(seg.dtype == torch.int32, f"seg must be torch.int32, got {seg.dtype}")
    _check(seg.device == device, f"seg is on {seg.device}")
    _check(seg.is_contiguous(), "seg must be contiguous")
    if seg.device.type == "cpu":
        _check(bool((seg[0] == 0).all()) and bool((seg[-1] == W).all())
               and bool((seg[1:] >= seg[:-1]).all()),
               f"seg must rise from 0 to {W} without falling")


def _check_scan(cache: torch.Tensor, flags: torch.Tensor,
                hist0: torch.Tensor, seg: Optional[torch.Tensor],
                du: Optional[torch.Tensor], dropout: float,
                pad: int, lead: int = 0, rows: Optional[dict] = None,
                f64: bool = False) -> bool:
    """Validate a whole-width scan's arguments (a cache of lead + W
    positions, and besides `flags` the (W, B) streams `rows`, by name,
    every float stream of the cache's type: float32, or float64 where the
    scan has a double instantiation, `f64`); returns True when the caller
    is to launch the CUDA kernel, False for CPU tensors. Unlike the chunk
    wrappers, contiguity is required on every device."""
    _check(cache.dim() == 3, f"cache must be (W, L, B), got {tuple(cache.shape)}")
    _, L, B = cache.shape
    _check(0 <= lead <= min(L, cache.shape[0]),
           f"lead {lead} outside 0..{min(L, cache.shape[0])}")
    W = cache.shape[0] - lead
    ft = cache.dtype if f64 and cache.dtype == torch.float64 \
        else torch.float32
    named = {"cache": (cache, ft, None),
             "flags": (flags, ft, (W, B)),
             "hist0": (hist0, ft, (L, B))}
    for name, t in (rows or {}).items():
        named[name] = (t, ft, (W, B))
    if seg is not None:
        _check_seg(seg, B, W, cache.device)
    if dropout > 0.0:
        _check(du is not None, "dropout > 0 needs du")
        _check(pad >= L, f"pad {pad} must be >= L {L}")
        _check(du.dim() == 2 and du.shape[0] >= pad + W and du.shape[1] == B,
               f"du must be (>= pad + {W}, {B}), got {tuple(du.shape)}")
        named["du"] = (du, torch.int32, None)
    for name, (t, dtype, shape) in named.items():
        if shape is not None:
            _check(tuple(t.shape) == shape,
                   f"{name} must be {shape}, got {tuple(t.shape)}")
        _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _check(t.device == cache.device, f"{name} is on {t.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    if cache.device.type == "cpu":
        return False
    _check(cache.device.type == "cuda", f"unsupported device {cache.device}")
    _check(1 <= L <= MAX_LEN, f"token length {L} outside 1..{MAX_LEN}")
    return True


def forward_scan(cache: torch.Tensor, starts: torch.Tensor,
                 hist0: torch.Tensor, seg: Optional[torch.Tensor] = None,
                 du: Optional[torch.Tensor] = None, *, dropout: float = 0.0,
                 pad: int = 0) -> torch.Tensor:
    """The forward log-sum-exp DP over the whole width of a START-indexed
    (W, L, B) score cache (-inf or NEG for no match): the token of length
    j+1 ending at dp index q+1 is cache[q - j, j]. starts (W, B) is 1.0
    where dp index q+1 starts a sample, hist0 (L, B) the history before
    position 0. `seg` (K+1, B) cuts each row into chains at sample starts
    or padding bytes (chain k from seg[k], the first from hist0, the
    others from a reset);
    None runs one chain per row. With dropout > 0 a token of length > 1
    starting at p is dropped by its coin from du[pad + p]. Returns the
    forward values a (W, B) f32, NEG where no path reaches. Every float
    stream in float64 runs the double instantiation (the f64 / exact
    route), counted in `forward_scan.launches_f64`.

    CUDA tensors launch csrc/forward_chunk.cu on the current stream; CPU
    tensors run `forward_scan_plain`."""
    if not _check_scan(cache, starts, hist0, seg, du, dropout, pad,
                       f64=True):
        return forward_scan_plain(cache, starts, hist0, seg, du,
                                  dropout=dropout, pad=pad)
    W, L, B = cache.shape
    a = torch.empty((W, B), dtype=cache.dtype, device=cache.device)
    if W == 0 or B == 0:
        return a
    use_drop = dropout > 0.0
    f64 = cache.dtype == torch.float64
    _launch("forward_scan_f64" if f64 else "forward_scan", cache, starts,
            hist0, seg, du if use_drop else None, a, None, W, L, B,
            1 if seg is None else seg.shape[0] - 1, 1, pad,
            dropout_threshold_half(dropout) if use_drop else 0, int(use_drop))
    if f64:
        forward_scan.launches_f64 += 1
    else:
        forward_scan.launches += 1
    return a


forward_scan.launches = 0
forward_scan.launches_f64 = 0


def backward_betas_scan(cache: torch.Tensor, ends: torch.Tensor,
                        hist0: torch.Tensor,
                        seg: Optional[torch.Tensor] = None,
                        du: Optional[torch.Tensor] = None, *,
                        dropout: float = 0.0, pad: int = 0) -> torch.Tensor:
    """The betas recurrence, positions descending, over the whole width of
    a START-indexed (W, L, B) score cache. ends (W, B) is 1.0 where a
    sample ends at dp index q, hist0 (L, B) the betas after position W.
    `seg` (K+1, B) cuts each row into chains at sample ends or padding
    bytes (chain k covers [seg[k], seg[k+1]), from hist0 where seg[k+1]
    == W and from a reset otherwise); None runs one chain per row. Dropout
    as in `forward_scan`. Returns the post-reset betas (W, B) f32 (0 where a
    sample ends, NEG where no path reaches).

    CUDA tensors launch csrc/backward_chunk.cu's betas scan on the current
    stream; CPU tensors run `backward_betas_scan_plain`."""
    if not _check_scan(cache, ends, hist0, seg, du, dropout, pad):
        return backward_betas_scan_plain(cache, ends, hist0, seg, du,
                                         dropout=dropout, pad=pad)
    W, L, B = cache.shape
    betas = torch.empty((W, B), dtype=torch.float32, device=cache.device)
    if W == 0 or B == 0:
        return betas
    use_drop = dropout > 0.0
    _launch("backward_betas_scan", cache, ends, hist0, seg,
            du if use_drop else None, betas, None, W, L, B,
            1 if seg is None else seg.shape[0] - 1, pad,
            dropout_threshold_half(dropout) if use_drop else 0, int(use_drop))
    backward_betas_scan.launches += 1
    return betas


backward_betas_scan.launches = 0


def backward_marginal_scan(cache: torch.Tensor, a: torch.Tensor,
                           z: torch.Tensor, ends: torch.Tensor,
                           hist0: torch.Tensor,
                           seg: Optional[torch.Tensor] = None,
                           du: Optional[torch.Tensor] = None, *,
                           dropout: float = 0.0, pad: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`backward_betas_scan` with the token marginals: over the whole
    width of a START-indexed (W, L, B) score cache, a (W, B) the forward
    value of a token starting at each position (0 at sample starts), z
    (W, B) its sample's normaliser, ends, hist0, `seg` (the backward
    `chain_bounds`) and dropout as in `backward_betas_scan`. Returns the
    marginals marg (W, L, B) = exp(max(a + score + beta - z, NEG)) (0
    where the token is masked or dropped) and the post-reset betas (W, B).
    Every float stream in float64 runs the double instantiation, counted
    in `backward_marginal_scan.launches_f64`.

    CUDA tensors launch csrc/backward_chunk.cu's marginal scan on the
    current stream; its marginals are a (W, L, B) view of (W, B, L)
    memory (`marg.transpose(1, 2)` is contiguous), in which a warp's
    stores are whole lines. CPU tensors run
    `backward_marginal_scan_plain`."""
    if not _check_scan(cache, ends, hist0, seg, du, dropout, pad,
                       rows={"a": a, "z": z}, f64=True):
        return backward_marginal_scan_plain(cache, a, z, ends, hist0, seg,
                                            du, dropout=dropout, pad=pad)
    W, L, B = cache.shape
    marg = torch.empty((W, B, L), dtype=cache.dtype, device=cache.device)
    betas = torch.empty((W, B), dtype=cache.dtype, device=cache.device)
    if W == 0 or B == 0:
        return marg.transpose(1, 2), betas
    use_drop = dropout > 0.0
    f64 = cache.dtype == torch.float64
    _launch("backward_marginal_scan_f64" if f64 else "backward_marginal_scan",
            cache, a, z, ends, hist0, seg, du if use_drop else None, marg,
            betas, None, W, L, B, 1 if seg is None else seg.shape[0] - 1,
            pad, dropout_threshold_half(dropout) if use_drop else 0,
            int(use_drop))
    if f64:
        backward_marginal_scan.launches_f64 += 1
    else:
        backward_marginal_scan.launches += 1
    return marg.transpose(1, 2), betas


backward_marginal_scan.launches = 0
backward_marginal_scan.launches_f64 = 0


def viterbi_scan(cache: torch.Tensor, starts: torch.Tensor,
                 hist0: torch.Tensor, seg: Optional[torch.Tensor] = None,
                 du: Optional[torch.Tensor] = None, *, dropout: float = 0.0,
                 pad: int = 0, lead: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Viterbi (max-plus) DP over the whole width of a START-indexed
    (lead + W, L, B) score cache (-inf or NEG for no match): the token of
    length j+1 ending at dp index q+1 is cache[lead + q - j, j]; the first
    `lead` (<= L) rows hold the tokens starting before position 0 (a
    chained window's carried tail). starts (W, B) is 1.0 where dp index
    q+1 starts a sample, hist0 (L, B) the history before position 0.
    `seg` (K+1, B), the forward's `chain_bounds`, cuts each row into
    chains (the first from hist0, the others from a reset); None runs one
    chain per row. Dropout as in `forward_scan`. Returns dp (W, B) f32
    (NEG where no path reaches) and best_l (W, B) int32 (ties go to the
    longest token; 1 where no path reaches). Every float stream in float64
    runs the double instantiation, counted in `viterbi_scan.launches_f64`.

    CUDA tensors launch csrc/viterbi_chunk.cu on the current stream; CPU
    tensors run `viterbi_scan_plain`."""
    if not _check_scan(cache, starts, hist0, seg, du, dropout, pad, lead,
                       f64=True):
        return viterbi_scan_plain(cache, starts, hist0, seg, du,
                                  dropout=dropout, pad=pad, lead=lead)
    _, L, B = cache.shape
    W = cache.shape[0] - lead
    dp = torch.empty((W, B), dtype=cache.dtype, device=cache.device)
    best_l = torch.empty((W, B), dtype=torch.int32, device=cache.device)
    if W == 0 or B == 0:
        return dp, best_l
    use_drop = dropout > 0.0
    f64 = cache.dtype == torch.float64
    _launch("viterbi_scan_f64" if f64 else "viterbi_scan", cache, starts,
            hist0, seg, du if use_drop else None, dp, best_l, None, W, L, B,
            1 if seg is None else seg.shape[0] - 1, 1, lead, pad,
            dropout_threshold_half(dropout) if use_drop else 0, int(use_drop))
    if f64:
        viterbi_scan.launches_f64 += 1
    else:
        viterbi_scan.launches += 1
    return dp, best_l


viterbi_scan.launches = 0
viterbi_scan.launches_f64 = 0
