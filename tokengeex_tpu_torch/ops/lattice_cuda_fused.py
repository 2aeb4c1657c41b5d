"""Vocabulary probe fused with the lattice DPs: the Hopper kernels and
their plain twins.

Counterpart of tokengeex_tpu/ops/lattice_pallas_fused.py:
`fused_forward_chunk` (kind "viterbi" or "logsumexp", end-indexed probe,
csrc/fused_forward.cu) and `fused_backward_chunk` (start-indexed probe
with the backward betas, csrc/fused_backward.cu). Each `*_plain` function
computes the same probe and recurrence in plain PyTorch, for tensors on
the CPU and as the reference the kernel is held against on the card.

Semantics match the JAX kernel: the same hash family (ops/hashing.py),
T1 wins over T2, an empty T1 slot (score sentinel NEG_BITS) never counts,
a hit counts only with a score above NEG / 2, a token is valid only if it
fits the current sample run (`rl` ending at the token's end for the
forward, `fr` starting at its start for the backward), and the dropout
coin is keyed on the token's start position. The probe reads the (H, 2) `[check, score]` rows
of both cuckoo tables directly: the JAX kernel's linear scan over every
table row was a VMEM layout and gives the same hits.

All three (`fused_forward_chunk` of either kind, `fused_backward_chunk`)
are chained, lane-parallel scans over the whole
width: `seg` (K+1, B) cuts each row into independent chains at sample
boundaries and padding (ops/lattice.py `chain_bounds`: the forward's
bounds for the forward, the backward's for the betas); None runs one chain
per row. Their twins restart the history, the run lengths and the probe's
validity at the inner bounds exactly as the kernels do, and give the
one-chain-per-row values bit for bit (tests/test_torch_fused_scan.py).

Layout: every per-row array is (position, row) so a warp's rows read
coalesced; the DeviceBatch arrays are transposed once per call.
  p1, p2      (pad + W + 1 + pad, B) int32 prefix hashes
  rinv1/2     (pad + W,) int32 inverse powers
  sid, du     (pad + W + pad, B) int32 sample ids / dropout words
  is_start, is_end  (W + 1, B) uint8
  hist0 (L, B) f32 DP carry, rl0 (B,) int32 run-length carry
  seg (K+1, B) int32 chain bounds
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import hashing as H
from .lattice_cuda import (_ODD, MAX_LEN, NEG, _backward_steps, _check,
                           _check_seg, _forward_steps, _inner_bounds,
                           _launch, _viterbi_steps, dropout_threshold_half)

# Empty-slot score sentinel (f32 -3.0e38) as int32 bits.
NEG_BITS = int(np.array([-3.0e38], np.float32).view(np.int32)[0])


def run_lengths(inb: torch.Tensor, stb: torch.Tensor, rl0: torch.Tensor,
                restart: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(W, B) in-sample run length ending at each byte: the closed form of
    rl = inb ? (stb ? 1 : rl + 1) : 0 carried from rl0. Where `restart`
    (W, B) is set (a chain's first byte), rl restarts from 0 before the
    byte."""
    W = inb.shape[0]
    q = torch.arange(W, device=inb.device, dtype=torch.int64)[:, None]
    if restart is not None:
        stb = stb | restart
    event = torch.where(~inb | stb, q, -1)
    base = torch.cummax(event, dim=0).values
    inb_at = inb.gather(0, base.clamp(min=0))
    rl = torch.where(base < 0, rl0.to(torch.int64)[None, :] + q + 1,
                     torch.where(inb_at, q - base + 1, q - base))
    return rl.to(torch.int32)


def start_run_lengths(inb: torch.Tensor, st_next: torch.Tensor,
                      restart_next: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(W, B) in-sample run length STARTING at each byte with no internal
    sample start: the closed form of fr = inb ? 1 + (st_next ? 0 : fr') : 0
    walked from the right, fr' the next byte's (0 past the width).
    st_next[q] is the start flag at dp index q + 1; where `restart_next`
    (W, B) is set (a chain bound at q + 1), fr' counts as 0."""
    W = inb.shape[0]
    q = torch.arange(W, device=inb.device, dtype=torch.int64)[:, None]
    nxt = torch.cat([inb[1:], torch.zeros_like(inb[:1])])
    # The run through q stops after q at a sample start or an outside byte.
    stop = st_next | ~nxt
    if restart_next is not None:
        stop = stop | restart_next
    last = torch.cummin(torch.where(stop, q, W).flip(0), dim=0).values.flip(0)
    return torch.where(inb, last - q + 1, 0).to(torch.int32)


def _probe_score(t1_fast, t2_fast, fp1, fp2, valid, du_s, lens, bits: int,
                 dropout: float) -> torch.Tensor:
    """The fused kernels' probe of (fingerprint, length) points: T1 wins
    over T2, an empty T1 slot never counts, a hit counts only when valid,
    with its dropout coin (keyed on the token's start word du_s) not
    drawn, and with a score above NEG / 2; NEG otherwise."""
    a1 = H.wrap_i32(lens * int(H.IDX_A1))[None, :, None]
    a2 = H.wrap_i32(lens * int(H.IDX_A2))[None, :, None]
    shift = 32 - bits
    idx1 = H.srl_i32(H.mul_i32(fp1 ^ a1, H.i32(int(H.IDX_M1))), shift).long()
    idx2 = H.srl_i32(H.mul_i32(fp2 ^ a2, H.i32(int(H.IDX_M2))), shift).long()
    c1, s1 = t1_fast[:, 0][idx1], t1_fast[:, 1][idx1]
    c2, s2 = t2_fast[:, 0][idx2], t2_fast[:, 1][idx2]
    check = H.check_i32(fp1, fp2)
    sb = torch.full_like(fp1, NEG_BITS)
    sb = torch.where(c2 == check, s2, sb)
    sb = torch.where((c1 == check) & (s1 != NEG_BITS), s1, sb)
    if dropout > 0.0:
        odd = H.wrap_i32(lens * _ODD)[None, :, None]
        u = H.srl_i32(H.mul_i32(du_s, odd), 1)
        coin = u < dropout_threshold_half(dropout)
        valid = valid & ~(coin & (lens[None, :, None] > 1))
    sf = sb.view(torch.float32)
    return torch.where(valid & (sf > NEG * 0.5), sf,
                       torch.tensor(NEG, dtype=torch.float32,
                                    device=fp1.device))


def fused_probe_plain(t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start,
                      du, rl0, *, L: int, bits: int, pad: int,
                      dropout: float = 0.0,
                      restart: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, L, B) end-indexed scores (NEG for no token) and the (W, B) run
    lengths, exactly as the fused forward kernels form them; `restart`
    (W, B) marks the chains' first bytes, where rl restarts."""
    W = is_start.shape[0] - 1
    dev = p1.device
    q = torch.arange(W, device=dev)
    j = torch.arange(L, device=dev)
    sp = pad + q[:, None] - j[None, :]  # (W, L) padded start positions
    e1 = p1[pad + 1 : pad + 1 + W][:, None, :]
    e2 = p2[pad + 1 : pad + 1 + W][:, None, :]
    fp1 = H.mul_i32(H.sub_i32(e1, p1[sp]), rinv1[sp][:, :, None])
    fp2 = H.mul_i32(H.sub_i32(e2, p2[sp]), rinv2[sp][:, :, None])
    lens = torch.arange(1, L + 1, dtype=torch.int64, device=dev)
    inb = sid[pad : pad + W] >= 0
    rl = run_lengths(inb, is_start[:W] != 0, rl0, restart)
    valid = lens.to(torch.int32)[None, :, None] <= rl[:, None, :]
    score = _probe_score(t1_fast, t2_fast, fp1, fp2, valid,
                         du[sp] if dropout > 0.0 else None, lens, bits,
                         dropout)
    return score, rl


def _hist_from_values(a: torch.Tensor, is_start: torch.Tensor,
                     hist0: torch.Tensor) -> torch.Tensor:
    """(L, B) forward history after the last of W steps, from the values
    a (W, B): hist[j] is the carry of step W-1-j (0 where dp index W-j
    starts a sample, else a[W-1-j]), and hist0[j-W] before the first
    step; the recurrence's own history, bit for bit."""
    W, L = a.shape[0], hist0.shape[0]
    n = min(W, L)
    carry = torch.where(is_start[W - n + 1 : W + 1] != 0, 0.0, a[W - n :])
    return torch.cat([carry.flip(0), hist0[: L - n]])


def fused_forward_chunk_plain(kind, t1_fast, t2_fast, p1, p2, rinv1, rinv2,
                              sid, is_start, du, hist0, rl0, *, L: int,
                              bits: int, pad: int, dropout: float = 0.0,
                              seg: Optional[torch.Tensor] = None):
    W = is_start.shape[0] - 1
    inner = _inner_bounds(seg, W)
    score, rl = fused_probe_plain(
        t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start, du, rl0, L=L,
        bits=bits, pad=pad, dropout=dropout,
        restart=None if inner is None else inner[:W])
    starts = is_start[1:].to(torch.float32)
    if kind == "viterbi":
        dp, best_l, _ = _viterbi_steps(score, starts, hist0, inner)
    else:
        dp, best_l = _forward_steps(score, starts, hist0, inner)[0], None
    hist = _hist_from_values(dp, is_start, hist0)
    rl_out = rl[-1].clone() if rl.shape[0] else rl0.clone()
    return dp, best_l, hist, rl_out


def _check_fused(pad: int, L: int, bits: int, shapes: dict, device,
                 seg: Optional[torch.Tensor]) -> bool:
    """Validate the fused kernels' arguments (`shapes`: name -> (tensor,
    shape, dtype)) and the chain bounds `seg`; returns True when the
    caller is to launch the CUDA kernel, False for CPU tensors (the plain
    version)."""
    _check(pad >= L, f"pad {pad} must be >= L {L}")
    _check(1 <= bits <= 31, f"bits {bits} outside 1..31")
    _check(shapes["t1_fast"][0].shape[0] == 1 << bits,
           "tables must hold 2^bits rows")
    for name, (t, shape, dtype) in shapes.items():
        _check(tuple(t.shape) == shape,
               f"{name} must be {shape}, got {tuple(t.shape)}")
        _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _check(t.device == device, f"{name} is on {t.device}")
    if seg is not None:
        W1, B = shapes["is_start"][1]
        _check_seg(seg, B, W1 - 1, device)
    if device.type == "cpu":
        return False
    _check(device.type == "cuda", f"unsupported device {device}")
    _check(1 <= L <= MAX_LEN, f"token length {L} outside 1..{MAX_LEN}")
    for name, (t, _, _) in shapes.items():
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(shapes["t1_fast"][0].data_ptr() % 8 == 0
           and shapes["t2_fast"][0].data_ptr() % 8 == 0,
           "tables must be 8-byte aligned")
    return True


def _stream_shapes(t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start,
                   du, W: int, B: int, pad: int, use_drop: bool) -> dict:
    T = 2 * pad + W
    shapes = {"p1": (p1, (T + 1, B), torch.int32),
              "p2": (p2, (T + 1, B), torch.int32),
              "rinv1": (rinv1, (pad + W,), torch.int32),
              "rinv2": (rinv2, (pad + W,), torch.int32),
              "sid": (sid, (T, B), torch.int32),
              "is_start": (is_start, (W + 1, B), torch.uint8),
              "t1_fast": (t1_fast, (t1_fast.shape[0], 2), torch.int32),
              "t2_fast": (t2_fast, (t1_fast.shape[0], 2), torch.int32)}
    if use_drop:
        _check(du is not None, "dropout > 0 needs du")
        shapes["du"] = (du, (T, B), torch.int32)
    return shapes


def _drop_args(dropout: float) -> tuple:
    """The kernels' dropout flag and coin threshold."""
    use_drop = dropout > 0.0
    return int(use_drop), dropout_threshold_half(dropout) if use_drop else 0


def fused_forward_chunk(kind: str, t1_fast: torch.Tensor,
                        t2_fast: torch.Tensor, p1: torch.Tensor,
                        p2: torch.Tensor, rinv1: torch.Tensor,
                        rinv2: torch.Tensor, sid: torch.Tensor,
                        is_start: torch.Tensor, du: Optional[torch.Tensor],
                        hist0: torch.Tensor, rl0: torch.Tensor, *, L: int,
                        bits: int, pad: int, dropout: float = 0.0,
                        seg: Optional[torch.Tensor] = None):
    """Fused probe + forward DP over the whole row width. kind="viterbi"
    returns dp (W, B) f32, best_l (W, B) int32, hist (L, B) f32 and rl (B,)
    int32; kind="logsumexp" returns the forward values a (W, B) f32 (NEG
    where no path reaches), None, hist and rl. `seg` (K+1, B), the
    forward's `chain_bounds`, cuts the rows into chains (chain 0 from
    hist0 and rl0, every other from a reset); None runs one chain per
    row. The kernel writes dp (or a), best_l and rl; hist is rebuilt from
    the values (`_hist_from_values`), on the card as in the twin.

    CUDA tensors launch csrc/fused_forward.cu on the current stream; CPU
    tensors run `fused_forward_chunk_plain`."""
    _check(kind in ("viterbi", "logsumexp"), f"unknown kind {kind!r}")
    W = is_start.shape[0] - 1
    B = is_start.shape[1]
    use_drop = dropout > 0.0
    shapes = _stream_shapes(t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid,
                            is_start, du, W, B, pad, use_drop)
    shapes["hist0"] = (hist0, (L, B), torch.float32)
    shapes["rl0"] = (rl0, (B,), torch.int32)
    dev = p1.device
    if not _check_fused(pad, L, bits, shapes, dev, seg):
        return fused_forward_chunk_plain(
            kind, t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start, du,
            hist0, rl0, L=L, bits=bits, pad=pad, dropout=dropout, seg=seg)
    lse = kind == "logsumexp"
    dp = torch.empty((W, B), dtype=torch.float32, device=dev)
    best_l = None if lse else torch.empty((W, B), dtype=torch.int32,
                                          device=dev)
    rl = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return dp, best_l, hist0.clone(), rl
    if W == 0:
        return dp, best_l, hist0.clone(), rl0.clone()
    streams = (t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start,
               du if use_drop else None, hist0, rl0, seg, dp)
    K = 1 if seg is None else seg.shape[0] - 1
    if lse:
        _launch("fused_forward_lse", *streams, rl, W, L, B, K, pad, bits,
                *_drop_args(dropout))
    else:
        _launch("fused_forward", *streams, best_l, rl, W, L, B, K, pad, bits,
                *_drop_args(dropout))
    fused_forward_chunk.launches += 1
    return dp, best_l, _hist_from_values(dp, is_start, hist0), rl


fused_forward_chunk.launches = 0


def fused_backward_probe_plain(t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid,
                               is_start, du, *, L: int, bits: int, pad: int,
                               dropout: float = 0.0,
                               restart_next: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """(W, L, B) START-indexed scores (NEG for no token), exactly as the
    fused backward kernel forms them: row j at q is the token of length
    j+1 beginning at byte q, valid while it fits the run starting there
    (`restart_next` (W, B) marks a chain bound at q + 1, where the run
    ends)."""
    W = is_start.shape[0] - 1
    dev = p1.device
    q = torch.arange(W, device=dev)
    j = torch.arange(L, device=dev)
    sp = pad + q
    ep = sp[:, None] + 1 + j[None, :]  # (W, L) padded end positions
    fp1 = H.mul_i32(H.sub_i32(p1[ep], p1[sp][:, None, :]),
                    rinv1[sp][:, None, None])
    fp2 = H.mul_i32(H.sub_i32(p2[ep], p2[sp][:, None, :]),
                    rinv2[sp][:, None, None])
    lens = torch.arange(1, L + 1, dtype=torch.int64, device=dev)
    fr = start_run_lengths(sid[pad : pad + W] >= 0, is_start[1:] != 0,
                           restart_next)
    valid = lens.to(torch.int32)[None, :, None] <= fr[:, None, :]
    return _probe_score(t1_fast, t2_fast, fp1, fp2, valid,
                        du[sp][:, None, :] if dropout > 0.0 else None, lens,
                        bits, dropout)


def betas_hist0(is_end_w: torch.Tensor, L: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(L, B) initial beta history: beta[W] = 0 where a sample ends at the
    width, NEG otherwise."""
    hist = torch.full((L, is_end_w.shape[0]), NEG, dtype=dtype,
                      device=is_end_w.device)
    hist[0] = torch.where(is_end_w, 0.0, NEG)
    return hist


def fused_backward_chunk_plain(t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid,
                               is_start, is_end, du, *, L: int, bits: int,
                               pad: int, dropout: float = 0.0,
                               seg: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    W = is_start.shape[0] - 1
    inner = _inner_bounds(seg, W)
    score = fused_backward_probe_plain(
        t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start, du, L=L,
        bits=bits, pad=pad, dropout=dropout,
        restart_next=None if inner is None else inner[1:])
    return _backward_steps(score, is_end[:W].to(torch.float32),
                           betas_hist0(is_end[W] != 0, L), inner)[0]


def fused_backward_chunk(t1_fast: torch.Tensor, t2_fast: torch.Tensor,
                         p1: torch.Tensor, p2: torch.Tensor,
                         rinv1: torch.Tensor, rinv2: torch.Tensor,
                         sid: torch.Tensor, is_start: torch.Tensor,
                         is_end: torch.Tensor, du: Optional[torch.Tensor],
                         *, L: int, bits: int, pad: int,
                         dropout: float = 0.0,
                         seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused start-indexed probe + backward betas over the whole row
    width, positions descending. Returns the post-reset betas (W, B) f32
    (0 where a sample ends, NEG where no path reaches). `seg` (K+1, B),
    the backward's `chain_bounds`, cuts each row into chains (the last
    from the row's end, every other from a reset); None runs one chain
    per row.

    CUDA tensors launch csrc/fused_backward.cu on the current stream; CPU
    tensors run `fused_backward_chunk_plain`."""
    W = is_start.shape[0] - 1
    B = is_start.shape[1]
    use_drop = dropout > 0.0
    shapes = _stream_shapes(t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid,
                            is_start, du, W, B, pad, use_drop)
    shapes["is_end"] = (is_end, (W + 1, B), torch.uint8)
    dev = p1.device
    if not _check_fused(pad, L, bits, shapes, dev, seg):
        return fused_backward_chunk_plain(
            t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start, is_end,
            du, L=L, bits=bits, pad=pad, dropout=dropout, seg=seg)
    betas = torch.empty((W, B), dtype=torch.float32, device=dev)
    if B == 0 or W == 0:
        return betas
    K = 1 if seg is None else seg.shape[0] - 1
    _launch("fused_backward", t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid,
            is_start, is_end, du if use_drop else None, seg, betas, W, L, B,
            K, pad, bits, *_drop_args(dropout))
    fused_backward_chunk.launches += 1
    return betas


fused_backward_chunk.launches = 0
