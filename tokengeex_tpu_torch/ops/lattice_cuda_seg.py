"""Segsum over the sorted-hit order: the Hopper kernels and their plain
twins.

Counterpart of tokengeex_tpu/ops/lattice_pallas_fused.py `seg_weights`,
and of the XLA program around it, tokengeex_tpu/ops/lattice_jax.py
`_segsum_expected_impl` (the alpha - Z plane, the telescoping score
differences with block anchors, the interval sums and the accumulate). The
kernels are in csrc/seg_weights.cu, three entries: `seg_weights` reads one
length's streams (the Pallas kernel's counterpart); `seg_weights_gather`
takes every token length of a row group in one launch, builds and gathers
each hit's streams itself and sums the blocks that lie wholly inside one
segment; `seg_sums` turns those into the (nbins + 1,) accumulator. The
plain twins take the same Hillis-Steele scan steps as the kernels and as
the Pallas kernel's `_lane_cumsum`, so the three round alike and differ
only where `exp` does, and add the segments' pieces in the kernels' order.

Layout: flat (H,) f32 streams in sorted-hit order, H a multiple of
SEG_BLK = 128; the JAX kernel's (ntiles, 64, 128) tiles hold the same
numbers row-major. A SegStruct (`ops/lattice.py`) lays the lengths end to
end: `meta` (2L+1,) int32 holds each length's first block (L+1 entries,
the last the block count) and then its hit count.

A segment's sum is its head (its first block's total minus the in-block
sum before it), the totals of the blocks wholly inside it and its tail
(the in-block sum at its end), or within one block a difference of two
in-block sums. The whole blocks are summed in fixed point (truncated to
2^-mid_bits, int64), where any order of adds gives the same bits; the
pieces are added in double, raised to 0 where rounding takes the sum
below (a sum of marginals), and rounded once to float. (The JAX package
takes an f32 TwoSum prefix of the block totals and its differences, and
keeps such a sum at its -ulp.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import hashing as H
from .lattice_cuda import _ODD, _check, _launch, dropout_threshold_half

SEG_BLK = 128  # hits per in-block scan


def _lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 1 of (n, 128): steps of stride 1,
    2, ..., 64, each adding the value `stride` places back (0 before the
    block start)."""
    lanes = torch.arange(SEG_BLK, device=x.device)
    for k in (1, 2, 4, 8, 16, 32, 64):
        x = x + torch.where(lanes >= k, torch.roll(x, k, dims=1), 0.0)
    return x


def seg_weights_plain(r0: torch.Tensor, r1: torch.Tensor, d2: torch.Tensor,
                      n_hit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    H = r0.shape[0]
    ss = _lane_cumsum(d2.reshape(-1, SEG_BLK))
    w = torch.exp(r0.reshape(-1, SEG_BLK) + r1.reshape(-1, SEG_BLK) + ss)
    idx = torch.arange(H, device=r0.device).reshape(-1, SEG_BLK)
    cf = _lane_cumsum(torch.where(idx < n_hit, w, 0.0))
    return cf.reshape(-1), cf[:, -1].contiguous()


def seg_weights(r0: torch.Tensor, r1: torch.Tensor, d2: torch.Tensor,
                n_hit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per block of 128 sorted hits: ss = in-block inclusive cumsum of
    d2, w = exp(r0 + r1 + ss) zeroed at index >= n_hit, cf = in-block
    inclusive cumsum of w, t = block totals. r0 / r1 / d2 are (H,) f32;
    returns cf (H,) and t (H / 128,).

    CUDA tensors launch csrc/seg_weights.cu on the current stream; CPU
    tensors run `seg_weights_plain`."""
    _check(r0.dim() == 1 and r0.shape[0] % SEG_BLK == 0,
           f"r0 must be (H,) with H a multiple of {SEG_BLK}, "
           f"got {tuple(r0.shape)}")
    named = {"r0": r0, "r1": r1, "d2": d2}
    for name, t in named.items():
        _check(t.shape == r0.shape, f"{name} must be {tuple(r0.shape)}")
        _check(t.dtype == torch.float32, f"{name} must be float32")
        _check(t.device == r0.device, f"{name} is on {t.device}")
    n_hit = int(n_hit)
    if r0.device.type == "cpu":
        return seg_weights_plain(r0, r1, d2, n_hit)
    _check(r0.device.type == "cuda", f"unsupported device {r0.device}")
    for name, t in named.items():
        _check(t.is_contiguous(), f"{name} must be contiguous")
    H = r0.shape[0]
    cf = torch.empty_like(r0)
    t = torch.empty((H // SEG_BLK,), dtype=torch.float32, device=r0.device)
    if H == 0:
        return cf, t
    _launch("seg_weights", r0, r1, d2, cf, t, H, n_hit)
    seg_weights.launches += 1
    return cf, t


seg_weights.launches = 0


MID_LIMIT = 256.0  # a whole block's total above this poisons its segment
_POISON = -(2**63)  # the sign bit of a segment's fixed-point sum


def mid_bits(seg) -> int:
    """Fixed-point bits of a SegStruct's whole-block sums: a segment's
    blocks, each at most MID_LIMIT (two per hit), sum below 2^62 within
    the longest length's capacity."""
    return 61 - max(p.shape[0] for p in seg.perm).bit_length()


def seg_col1(A: torch.Tensor, end_index: torch.Tensor,
             is_start: torch.Tensor) -> torch.Tensor:
    """(B, W) alpha - Z: Z the sample's total A[b, end_index] (0 where not
    finite or below -1e37), alpha 0 at a sample start (A there holds the
    previous sample's total)."""
    W = end_index.shape[1]
    Z = torch.gather(A, 1, end_index.long().clamp(0, W))
    Z = torch.where(torch.isfinite(Z) & (Z > -1e37), Z, 0.0)
    return torch.where(is_start[:, :W], 0.0, A[:, :W]) - Z


def seg_score_pad(score_rows: torch.Tensor) -> torch.Tensor:
    """(nbins + 1,) scores clamped at -200 (removed and empty slots carry
    the -3e38 sentinel, which would wreck the telescoping sums; their
    weights are exp(x - 200) = 0), the pad slot nbins 0."""
    sc = torch.clamp(score_rows[:-1].view(torch.float32), min=-200.0)
    return torch.cat([sc, sc.new_zeros(1)])


def seg_differences(seg, sc_pad: torch.Tensor) -> torch.Tensor:
    """(H,) telescoping score differences over the sorted hits of every
    length: between consecutive occurring slots, at each slot's segment
    start (pad entries land in a dropped cell)."""
    L = len(seg.perm)
    Hn = seg.perm_flat.shape[0]
    boff = seg.meta[: L + 1].long()[:, None] * SEG_BLK
    cap = boff[1:] - boff[:-1]
    pre = seg.pre_pos.long()
    start = torch.where(seg.end_pos.long() != cap,
                        torch.where(pre == cap, 0, pre + 1) + boff[:-1], Hn)
    sc_occ = sc_pad[seg.occ_slot.long()]
    dvals = sc_occ - torch.cat([sc_occ[:, :1], sc_occ[:, :-1]], dim=1)
    d = torch.zeros(Hn + 1, dtype=torch.float32, device=sc_pad.device)
    d.index_add_(0, start.reshape(-1), dvals.reshape(-1))
    return d[:Hn]


def _whole_block_sums(seg, t: torch.Tensor) -> torch.Tensor:
    """(L * OC,) int64: each segment's blocks that lie wholly inside it,
    their totals summed at 2^-mid_bits (truncated); the sign bit set where
    one is not <= MID_LIMIT (NaN, inf, or more than marginals in [0, 1]
    can sum to), which makes the segment's count NaN."""
    L, OC = seg.occ_slot.shape
    boff = seg.meta[: L + 1].long()
    blocks = torch.arange(t.shape[0], device=t.device)
    l0 = torch.searchsorted(boff[1:].contiguous(), blocks, right=True)
    cap = (boff[l0 + 1] - boff[l0]) * SEG_BLK
    lstart = (blocks - boff[l0]) * SEG_BLK
    o0 = seg.blk_occ.long()
    ent = l0 * OC + o0.clamp(max=OC - 1)
    en = seg.end_pos.reshape(-1).long()[ent]
    whole = (o0 < OC) & (en != cap) & (en >= lstart + SEG_BLK - 1)
    good = t <= MID_LIMIT
    q = (torch.where(good, t.double(), 0.0)
         * 2.0 ** mid_bits(seg)).long()
    mid = torch.zeros(L * OC, dtype=torch.int64, device=t.device)
    mid.index_add_(0, ent[whole], q[whole])
    bad = torch.zeros(L * OC, dtype=torch.bool, device=t.device)
    bad[ent[whole & ~good]] = True
    return torch.where(bad, mid | _POISON, mid)


def seg_weights_gather_plain(seg, A: torch.Tensor, end_index: torch.Tensor,
                             is_start: torch.Tensor, bt: torch.Tensor,
                             score_rows: torch.Tensor,
                             du: Optional[torch.Tensor] = None, *,
                             dropout: float = 0.0, pad: int = 0
                             ) -> Tuple[torch.Tensor, ...]:
    B, W = end_index.shape
    L = len(seg.perm)
    m = seg.meta.tolist()
    boff, n_hit = m[: L + 1], m[L + 1 :]
    col1 = seg_col1(A, end_index, is_start).reshape(-1)
    sc_pad = seg_score_pad(score_rows)
    d = seg_differences(seg, sc_pad)
    anchor = sc_pad[seg.blk_flat.long()]
    btp = torch.nn.functional.pad(bt, (0, L), value=float("-inf"))
    cf, t = [], []
    for l0 in range(L):
        lo, hi = boff[l0] * SEG_BLK, boff[l0 + 1] * SEG_BLK
        pos = seg.perm_flat[lo:hi].long()
        beta = btp[:, l0 + 1 : l0 + 1 + W]
        if du is not None and dropout > 0.0 and l0 > 0:
            u = H.srl_i32(H.mul_i32(du[:, pad : pad + W],
                                    (l0 + 1) * _ODD % (1 << 32)), 1)
            beta = torch.where(u < dropout_threshold_half(dropout),
                               float("-inf"), beta)
        d2 = d[lo:hi].clone()
        d2[::SEG_BLK] = anchor[boff[l0] : boff[l0 + 1]]
        c, tt = seg_weights_plain(col1[pos], beta.reshape(-1)[pos], d2,
                                  n_hit[l0])
        cf.append(c)
        t.append(tt)
    cf, t = torch.cat(cf), torch.cat(t)
    acc = torch.zeros(score_rows.shape[0], dtype=torch.float32,
                      device=A.device)
    return cf, t, _whole_block_sums(seg, t), acc


def _check_seg(seg) -> Tuple[int, int, int]:
    """Check a SegStruct's arrays; returns (H, L, OC)."""
    perm = seg.perm_flat
    _check(perm.dim() == 1 and perm.shape[0] % SEG_BLK == 0,
           f"perm_flat must be (H,) with H a multiple of {SEG_BLK}, "
           f"got {tuple(perm.shape)}")
    Hn = perm.shape[0]
    _check(seg.occ_slot.dim() == 2,
           f"occ_slot must be (L, OC), got {tuple(seg.occ_slot.shape)}")
    L, OC = seg.occ_slot.shape
    _check(len(seg.perm) == L and sum(p.shape[0] for p in seg.perm) == Hn,
           f"perm must hold {L} lengths of {Hn} hits in all")
    named = {"perm_flat": (perm, (Hn,)),
             "blk_flat": (seg.blk_flat, (Hn // SEG_BLK,)),
             "blk_occ": (seg.blk_occ, (Hn // SEG_BLK,)),
             "occ_slot": (seg.occ_slot, (L, OC)),
             "pre_pos": (seg.pre_pos, (L, OC)),
             "end_pos": (seg.end_pos, (L, OC)),
             "nxt": (seg.nxt, (L, OC)),
             "meta": (seg.meta, (2 * L + 1,))}
    for name, (x, shape) in named.items():
        _check(tuple(x.shape) == shape,
               f"{name} must be {shape}, got {tuple(x.shape)}")
        _check(x.dtype == torch.int32, f"{name} must be int32, got {x.dtype}")
        _check(x.device == perm.device, f"{name} is on {x.device}")
        _check(x.is_contiguous(), f"{name} must be contiguous")
    return Hn, L, OC


def seg_weights_gather(seg, A: torch.Tensor, end_index: torch.Tensor,
                       is_start: torch.Tensor, bt: torch.Tensor,
                       score_rows: torch.Tensor,
                       du: Optional[torch.Tensor] = None, *,
                       dropout: float = 0.0, pad: int = 0
                       ) -> Tuple[torch.Tensor, ...]:
    """`seg_weights` for every token length of a row group's SegStruct
    `seg` at once (`ops/lattice.py`: its hits sorted by slot, laid end to
    end as `meta` says), the streams made in the kernel. The hit at flat
    position b * W + w of length index l0 takes r0 = alpha - Z
    (`seg_col1` of the forward values A (B, W+1) f32, the sample ends
    end_index (B, W) int32 and starts is_start (B, W+1) bool), r1 =
    bt[b, w + l0 + 1] (the betas, (B, W+1) f32; -inf past the width, and
    where dropout > 0 and the token's coin from du[b, pad + w] ((B, >=
    pad + W) int32) drops it), and the telescoping differences of
    `seg_differences` over the scores of score_rows ((nbins + 1,) int32
    f32 bits, clamped by `seg_score_pad`) with each block's anchor at its
    first hit. Returns cf (H,), t (H / 128,), equal to `seg_weights` on
    each length's streams, the whole-block sums (L * OC,) int64 of
    `_whole_block_sums`, and the accumulator (nbins + 1,) f32, zeroed, for
    `seg_sums`.

    CUDA tensors launch csrc/seg_weights.cu (one cooperative launch) on
    the current stream; CPU tensors run `seg_weights_gather_plain`."""
    Hn, L, OC = _check_seg(seg)
    _check(end_index.dim() == 2,
           f"end_index must be (B, W), got {tuple(end_index.shape)}")
    B, W = end_index.shape
    _check(score_rows.dim() == 1 and score_rows.shape[0] >= 1,
           f"score_rows must be (nbins + 1,), got {tuple(score_rows.shape)}")
    dev = seg.perm_flat.device
    named = {"A": (A, torch.float32, (B, W + 1)),
             "end_index": (end_index, torch.int32, (B, W)),
             "is_start": (is_start, torch.bool, (B, W + 1)),
             "bt": (bt, torch.float32, (B, W + 1)),
             "score_rows": (score_rows, torch.int32, None)}
    use_drop = dropout > 0.0
    if use_drop:
        _check(du is not None, "dropout > 0 needs du")
        _check(du.dim() == 2 and du.shape[0] == B and du.shape[1] >= pad + W,
               f"du must be ({B}, >= {pad + W}), got {tuple(du.shape)}")
        named["du"] = (du, torch.int32, None)
    for name, (x, dtype, shape) in named.items():
        if shape is not None:
            _check(tuple(x.shape) == shape,
                   f"{name} must be {shape}, got {tuple(x.shape)}")
        _check(x.dtype == dtype, f"{name} must be {dtype}, got {x.dtype}")
        _check(x.device == dev, f"{name} is on {x.device}")
        _check(x.is_contiguous(), f"{name} must be contiguous")
    if dev.type == "cpu":
        return seg_weights_gather_plain(seg, A, end_index, is_start, bt,
                                        score_rows, du, dropout=dropout,
                                        pad=pad)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(B * W < 2**31, f"B * W = {B * W} must stay below 2^31")
    col1 = torch.empty((B, W), dtype=torch.float32, device=dev)
    cf = torch.empty((Hn,), dtype=torch.float32, device=dev)
    t = torch.empty((Hn // SEG_BLK,), dtype=torch.float32, device=dev)
    mid = torch.empty((L * OC,), dtype=torch.int64, device=dev)
    acc = torch.empty((score_rows.shape[0],), dtype=torch.float32, device=dev)
    _launch("seg_weights_gather", seg.perm_flat, seg.blk_flat, seg.blk_occ,
            seg.occ_slot, seg.pre_pos, seg.end_pos, seg.meta, A, end_index,
            is_start, bt, score_rows, du if use_drop else None, col1, cf, t,
            mid, acc, Hn, L, OC, W, B, score_rows.shape[0] - 1,
            du.shape[1] if use_drop else 0, pad,
            mid_bits(seg),
            dropout_threshold_half(dropout) if use_drop else 0,
            int(use_drop))
    seg_weights_gather.launches += 1
    return cf, t, mid, acc


seg_weights_gather.launches = 0


def segment_sums_plain(seg, cf: torch.Tensor, t: torch.Tensor,
                       mid: torch.Tensor) -> torch.Tensor:
    """(L, OC) f32: the sum of the marginals over each entry's segment (0
    for pads), from `seg_weights_gather`'s cf, t and whole-block sums, in
    the kernel's order: within one block cf[end] - cf[start - 1], else
    (head + mid) + tail, each in double, 0 where below 0 (the in-block
    scans are not monotone: over a run of zero weights cf can fall by an
    ulp), rounded once."""
    L, OC = seg.occ_slot.shape
    boff = seg.meta[: L + 1].long()
    cap = ((boff[1:] - boff[:-1]) * SEG_BLK)[:, None]
    first = (boff[:-1] * SEG_BLK)[:, None]
    pre, end = seg.pre_pos.long(), seg.end_pos.long()
    real = end != cap
    s = torch.where(real, torch.where(pre == cap, 0, pre + 1), 0)
    e = torch.where(real, end, 0)
    gs, ge = first + s, first + e
    cfd = cf.double()
    opened = s % SEG_BLK != 0
    prev = torch.where(opened, cfd[(gs - 1).clamp(min=0)], 0.0)
    ce = cfd[ge]
    head = torch.where(opened, t.double()[gs // SEG_BLK] - prev, 0.0)
    m = mid.view(L, OC)
    md = torch.where(m >= 0, m.double()
                     * 2.0 ** -mid_bits(seg),
                     float("nan"))
    tail = torch.where(e % SEG_BLK != SEG_BLK - 1, ce, 0.0)
    v = torch.where(gs // SEG_BLK == ge // SEG_BLK, ce - prev,
                    (head + md) + tail)
    # Never below 0 (the scans' rounding can take a difference below by an
    # ulp); NaN stays NaN.
    return torch.where(real & ~(v < 0), v, 0.0).float()


def seg_sums_plain(seg, cf: torch.Tensor, t: torch.Tensor, mid: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    v = segment_sums_plain(seg, cf, t, mid).reshape(-1)
    occ = seg.occ_slot.reshape(-1).long()
    nxt = seg.nxt.reshape(-1).long()
    lead = torch.nonzero(nxt >= -1).reshape(-1)
    acc[occ[lead]] = v[lead]
    # A slot at a second length (a hash false positive): its shortest
    # length's entry adds the later ones, in ascending length.
    cur = torch.nonzero(nxt >= 0).reshape(-1)
    nx = nxt[cur]
    while cur.numel():
        acc[occ[cur]] = acc[occ[cur]] + v[nx]
        n2 = nxt[nx]
        keep = n2 <= -3
        cur, nx = cur[keep], -3 - n2[keep]
    return acc


def seg_sums(seg, cf: torch.Tensor, t: torch.Tensor, mid: torch.Tensor,
             acc: torch.Tensor) -> torch.Tensor:
    """The (nbins + 1,) accumulator of a row group from
    `seg_weights_gather`'s outputs (its acc, zeroed there): each occurring
    slot's count, the `segment_sums_plain` of its entry, or, for a slot
    that occurs at more than one length, their float sum in ascending
    length (the `nxt` chain of the SegStruct). Stores, no adds: the
    lengths' slots are otherwise disjoint. Fills acc in place and returns
    it.

    CUDA tensors launch csrc/seg_weights.cu on the current stream; CPU
    tensors run `seg_sums_plain`."""
    Hn, L, OC = _check_seg(seg)
    dev = seg.perm_flat.device
    named = {"cf": (cf, torch.float32, (Hn,)),
             "t": (t, torch.float32, (Hn // SEG_BLK,)),
             "mid": (mid, torch.int64, (L * OC,)),
             "acc": (acc, torch.float32, None)}
    for name, (x, dtype, shape) in named.items():
        if shape is not None:
            _check(tuple(x.shape) == shape,
                   f"{name} must be {shape}, got {tuple(x.shape)}")
        _check(x.dtype == dtype, f"{name} must be {dtype}, got {x.dtype}")
        _check(x.device == dev, f"{name} is on {x.device}")
        _check(x.is_contiguous(), f"{name} must be contiguous")
    _check(acc.dim() == 1, f"acc must be (nbins + 1,), got {tuple(acc.shape)}")
    if dev.type == "cpu":
        return seg_sums_plain(seg, cf, t, mid, acc)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _launch("seg_sums", cf, t, mid, seg.occ_slot, seg.pre_pos, seg.end_pos,
            seg.nxt, seg.meta, acc, L, OC,
            mid_bits(seg))
    seg_sums.launches += 1
    return acc


seg_sums.launches = 0
