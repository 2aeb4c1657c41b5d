"""Lattice DPs over a probed score slab: the Hopper kernels and their
plain twins.

Counterpart of tokengeex_tpu/ops/lattice_pallas.py: `viterbi_chunk`,
`forward_chunk` and `backward_chunk`, each built from csrc/<name>.cu, and
`backward_betas_chunk`, the betas-only mode of csrc/backward_chunk.cu
(the XLA scan `_backward_betas_impl` of tokengeex_tpu/ops/lattice_jax.py
on the TPU). Each
`*_plain` function is the same recurrence in plain PyTorch, used for
tensors on the CPU and as the reference the kernel is held against on the
card. The plain log-sum-exp twins sum over lengths in ascending order, as
the kernels do, so on the card the two differ only where the device's
`exp`/`log` differ from the kernel's `expf`/`logf`.

Layout: the port keeps rows minor, so one thread per row reads coalesced.
  score (C, L, B) f32  scores, NEG for no match: end-indexed for the
                       forward DPs, start-indexed for `backward_chunk`
  starts (C, B) f32    1.0 where dp index q+1 starts a sample
  hist (L, B) f32      the last L DP values, hist[j] = dp[p - 1 - j]
The JAX kernels' (G, C, L, 128) lane groups hold the same numbers with
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


def _roll_insert(hist: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """hist[j] <- hist[j-1], hist[0] <- row."""
    return torch.cat([row[None], hist[:-1]], dim=0)


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
        hist = _roll_insert(hist, carry)
    return dp, best_l, hist


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


def forward_chunk_plain(score: torch.Tensor, starts: torch.Tensor,
                        hist0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    C, L, B = score.shape
    hist = hist0.clone()
    a = torch.empty((C, B), dtype=torch.float32, device=score.device)
    for q in range(C):
        lse = _lse_step(hist + score[q])
        a[q] = lse
        hist = _roll_insert(
            hist, torch.where(starts[q] > 0.5, torch.zeros_like(lse), lse))
    return a, hist


def forward_chunk(score: torch.Tensor, starts: torch.Tensor,
                  hist0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the forward log-sum-exp DP over an end-indexed slab.
    Returns the forward values a (C, B) f32 (NEG where no path reaches)
    and the next history (L, B) f32.

    CUDA tensors launch csrc/forward_chunk.cu on the current stream; CPU
    tensors run `forward_chunk_plain`."""
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
    _launch("forward_chunk", score, starts, hist0, a, hist, C, L, B)
    forward_chunk.launches += 1
    return a, hist


forward_chunk.launches = 0


def backward_chunk_plain(score: torch.Tensor, a: torch.Tensor,
                         z: torch.Tensor, ends: torch.Tensor,
                         hist0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    C, L, B = score.shape
    hist = hist0.clone()
    marg = torch.empty_like(score)
    for q in range(C - 1, -1, -1):
        s = score[q]
        marg[q] = torch.exp(torch.clamp_min(a[q] + s + hist - z[q], NEG))
        lse = _lse_step(s + hist)
        hist = _roll_insert(
            hist, torch.where(ends[q] > 0.5, torch.zeros_like(lse), lse))
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

    CUDA tensors launch csrc/backward_chunk.cu on the current stream; CPU
    tensors run `backward_chunk_plain`."""
    if not _check_slab(score, {"a": a, "z": z, "ends": ends}, hist0):
        return backward_chunk_plain(score, a, z, ends, hist0)
    C, L, B = score.shape
    dev = score.device
    marg = torch.empty((C, L, B), dtype=torch.float32, device=dev)
    hist = torch.empty((L, B), dtype=torch.float32, device=dev)
    if B == 0:
        return marg, hist
    if C == 0:
        return marg, hist0.clone()
    _launch("backward_chunk", score, a, z, ends, hist0, marg, hist, C, L, B)
    backward_chunk.launches += 1
    return marg, hist


backward_chunk.launches = 0


def backward_betas_chunk_plain(score: torch.Tensor, ends: torch.Tensor,
                               hist0: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    C, L, B = score.shape
    hist = hist0.clone()
    betas = torch.empty((C, B), dtype=torch.float32, device=score.device)
    for q in range(C - 1, -1, -1):
        lse = _lse_step(score[q] + hist)
        betas[q] = torch.where(ends[q] > 0.5, torch.zeros_like(lse), lse)
        hist = _roll_insert(hist, betas[q])
    return betas, hist


def backward_betas_chunk(score: torch.Tensor, ends: torch.Tensor,
                         hist0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`backward_chunk`'s recurrence without the marginals: returns the
    post-reset betas (C, B) f32 (0 where a sample ends, NEG where no path
    reaches) and the next history (L, B).

    CUDA tensors launch csrc/backward_chunk.cu in its betas mode on the
    current stream; CPU tensors run `backward_betas_chunk_plain`."""
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
    _launch("backward_betas_chunk", score, ends, hist0, betas, hist, C, L, B)
    backward_betas_chunk.launches += 1
    return betas, hist


backward_betas_chunk.launches = 0
