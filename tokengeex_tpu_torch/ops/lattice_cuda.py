"""Viterbi DP over a probed score slab: the Hopper kernel and its plain twin.

Counterpart of tokengeex_tpu/ops/lattice_pallas.py (`viterbi_chunk`). The
kernel is csrc/viterbi_chunk.cu; `viterbi_chunk_plain` is the same
recurrence in plain PyTorch, used for tensors on the CPU and as the
reference the kernel is held against on the card.

Layout: the port keeps rows minor, so one thread per row reads coalesced.
  score (C, L, B) f32  end-indexed scores, NEG for no match
  starts (C, B) f32    1.0 where dp index q+1 starts a sample
  hist (L, B) f32      the last L dp values, hist[j] = dp[p - 1 - j]
The JAX kernel's (G, C, L, 128) lane groups hold the same numbers with
row = g * 128 + lane.

Tie-breaking matches the reference: on equal candidates the LARGEST token
length wins; a step with no candidate gives dp = NEG and best_l = 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build

NEG = float(np.float32(-3.0e38))  # sentinel "-inf" that survives f32 math
MAX_LEN = 64  # longest token length the kernels are instantiated for


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def viterbi_chunk_plain(score: torch.Tensor, starts: torch.Tensor,
                        hist0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    C, L, B = score.shape
    hist = hist0.clone()
    jrow = torch.arange(L, device=score.device)[:, None]
    neg = torch.tensor(NEG, dtype=torch.float32, device=score.device)
    dp = torch.empty((C, B), dtype=torch.float32, device=score.device)
    best_l = torch.empty((C, B), dtype=torch.int32, device=score.device)
    for q in range(C):
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
        hist = torch.cat([carry[None], hist[: L - 1]], dim=0)
    return dp, best_l, hist


def viterbi_chunk(score: torch.Tensor, starts: torch.Tensor,
                  hist0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of Viterbi DP. Returns dp (C, B) f32, best_l (C, B) int32
    and the next history (L, B) f32.

    CUDA tensors launch csrc/viterbi_chunk.cu on the current stream; CPU
    tensors run `viterbi_chunk_plain`."""
    _check(score.dim() == 3, f"score must be (C, L, B), got {tuple(score.shape)}")
    C, L, B = score.shape
    _check(tuple(starts.shape) == (C, B), f"starts must be {(C, B)}")
    _check(tuple(hist0.shape) == (L, B), f"hist0 must be {(L, B)}")
    for name, t in (("score", score), ("starts", starts), ("hist0", hist0)):
        _check(t.dtype == torch.float32, f"{name} must be float32")
        _check(t.device == score.device, f"{name} is on {t.device}")
    if score.device.type == "cpu":
        return viterbi_chunk_plain(score, starts, hist0)
    _check(score.device.type == "cuda", f"unsupported device {score.device}")
    _check(1 <= L <= MAX_LEN, f"token length {L} outside 1..{MAX_LEN}")
    for name, t in (("score", score), ("starts", starts), ("hist0", hist0)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    dev = score.device
    dp = torch.empty((C, B), dtype=torch.float32, device=dev)
    best_l = torch.empty((C, B), dtype=torch.int32, device=dev)
    hist = torch.empty((L, B), dtype=torch.float32, device=dev)
    if B == 0:
        return dp, best_l, hist
    if C == 0:
        return dp, best_l, hist0.clone()
    fn = _build.load("viterbi_chunk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(score.data_ptr(), starts.data_ptr(), hist0.data_ptr(),
                dp.data_ptr(), best_l.data_ptr(), hist.data_ptr(),
                C, L, B, stream)
    if rc != 0:
        raise RuntimeError(f"viterbi_chunk launch failed: CUDA error {rc}")
    viterbi_chunk.launches += 1
    return dp, best_l, hist


viterbi_chunk.launches = 0
