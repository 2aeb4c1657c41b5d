"""Segsum weights over the sorted-hit order: the Hopper kernel and its
plain twins.

Counterpart of tokengeex_tpu/ops/lattice_pallas_fused.py `seg_weights`,
and of the per-length gathers around it in tokengeex_tpu/ops/lattice_jax.py
`_segsum_expected_impl`. The kernel is csrc/seg_weights.cu, with two
entries: `seg_weights` reads one length's streams, `seg_weights_gather`
takes every token length of a row group in one launch and gathers each
hit's streams itself. The plain twins take the same Hillis-Steele scan
steps as the kernel and as the Pallas kernel's `_lane_cumsum`, so the
three round alike and differ only where `exp` does.

Layout: flat (H,) f32 streams in sorted-hit order, H a multiple of
SEG_BLK = 128; the JAX kernel's (ntiles, 64, 128) tiles hold the same
numbers row-major. `seg_weights_gather` lays the lengths end to end:
`meta` (2L+1,) int32 holds each length's first block (L+1 entries, the
last the block count) and then its hit count.
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


def seg_weights_gather_plain(perm: torch.Tensor, col1: torch.Tensor,
                             bt: torch.Tensor, d: torch.Tensor,
                             anchor: torch.Tensor, meta: torch.Tensor,
                             du: Optional[torch.Tensor] = None, *,
                             dropout: float = 0.0, pad: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, W = col1.shape
    L = (meta.shape[0] - 1) // 2
    m = meta.tolist()
    boff, n_hit = m[: L + 1], m[L + 1 :]
    btp = torch.nn.functional.pad(bt, (0, L), value=float("-inf"))
    cf, t = [], []
    for l0 in range(L):
        lo, hi = boff[l0] * SEG_BLK, boff[l0 + 1] * SEG_BLK
        pos = perm[lo:hi].long()
        beta = btp[:, l0 + 1 : l0 + 1 + W]
        if du is not None and dropout > 0.0 and l0 > 0:
            u = H.srl_i32(H.mul_i32(du[:, pad : pad + W],
                                    (l0 + 1) * _ODD % (1 << 32)), 1)
            beta = torch.where(u < dropout_threshold_half(dropout),
                               float("-inf"), beta)
        d2 = d[lo:hi].clone()
        d2[::SEG_BLK] = anchor[boff[l0] : boff[l0 + 1]]
        c, tt = seg_weights_plain(col1.reshape(-1)[pos],
                                  beta.reshape(-1)[pos], d2, n_hit[l0])
        cf.append(c)
        t.append(tt)
    return torch.cat(cf), torch.cat(t)


def seg_weights_gather(perm: torch.Tensor, col1: torch.Tensor,
                       bt: torch.Tensor, d: torch.Tensor,
                       anchor: torch.Tensor, meta: torch.Tensor,
                       du: Optional[torch.Tensor] = None, *,
                       dropout: float = 0.0, pad: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`seg_weights` for every token length of a row group at once, its
    streams gathered per hit. perm (H,) int32 holds the lengths' sorted
    hit positions b * W + w end to end, as `meta` (2L+1,) int32 lays them
    out (each length's first block, L+1 entries, then its hit count);
    the hit of length index l0 takes r0 = col1[b, w] (alpha - Z, (B, W)
    f32), r1 = bt[b, w + l0 + 1] (the betas, (B, W+1) f32; -inf past the
    width, and where dropout > 0 and the token's coin from du[b, pad + w]
    ((B, >= pad + W) int32) drops it), and d2 = d (H,) but anchor
    (H / 128,) at each block's first hit. Returns cf (H,) and t
    (H / 128,), equal to `seg_weights` on each length's streams.

    CUDA tensors launch csrc/seg_weights.cu on the current stream; CPU
    tensors run `seg_weights_gather_plain`."""
    _check(perm.dim() == 1 and perm.shape[0] % SEG_BLK == 0,
           f"perm must be (H,) with H a multiple of {SEG_BLK}, "
           f"got {tuple(perm.shape)}")
    _check(col1.dim() == 2, f"col1 must be (B, W), got {tuple(col1.shape)}")
    B, W = col1.shape
    Hn = perm.shape[0]
    _check(meta.dim() == 1 and meta.shape[0] >= 3 and meta.shape[0] % 2 == 1,
           f"meta must be (2L+1,), got {tuple(meta.shape)}")
    L = (meta.shape[0] - 1) // 2
    named = {"perm": (perm, torch.int32, (Hn,)),
             "col1": (col1, torch.float32, (B, W)),
             "bt": (bt, torch.float32, (B, W + 1)),
             "d": (d, torch.float32, (Hn,)),
             "anchor": (anchor, torch.float32, (Hn // SEG_BLK,)),
             "meta": (meta, torch.int32, (2 * L + 1,))}
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
        _check(x.device == perm.device, f"{name} is on {x.device}")
        _check(x.is_contiguous(), f"{name} must be contiguous")
    if perm.device.type == "cpu":
        return seg_weights_gather_plain(perm, col1, bt, d, anchor, meta, du,
                                        dropout=dropout, pad=pad)
    _check(perm.device.type == "cuda", f"unsupported device {perm.device}")
    _check(B * W < 2**31, f"B * W = {B * W} must stay below 2^31")
    cf = torch.empty((Hn,), dtype=torch.float32, device=perm.device)
    t = torch.empty((Hn // SEG_BLK,), dtype=torch.float32, device=perm.device)
    if Hn == 0:
        return cf, t
    _launch("seg_weights_gather", perm, col1, bt, du if use_drop else None,
            d, anchor, meta, cf, t, Hn, L, W, B,
            du.shape[1] if use_drop else 0, pad,
            dropout_threshold_half(dropout) if use_drop else 0,
            int(use_drop))
    seg_weights_gather.launches += 1
    return cf, t


seg_weights_gather.launches = 0
