"""Segsum weights over the sorted-hit order: the Hopper kernel and its
plain twin.

Counterpart of tokengeex_tpu/ops/lattice_pallas_fused.py `seg_weights`.
The kernel is csrc/seg_weights.cu; `seg_weights_plain` takes the same
Hillis-Steele scan steps as the kernel and as the Pallas kernel's
`_lane_cumsum`, so the three round alike and differ only where `exp`
does.

Layout: flat (H,) f32 streams in sorted-hit order, H a multiple of
SEG_BLK = 128; the JAX kernel's (ntiles, 64, 128) tiles hold the same
numbers row-major.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .lattice_cuda import _check, _launch

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
