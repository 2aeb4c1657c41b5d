"""Vocabulary probe fused with the Viterbi DP: the Hopper kernel and its
plain twin.

Counterpart of tokengeex_tpu/ops/lattice_pallas_fused.py
(`fused_forward_chunk`, kind="viterbi"). The kernel is
csrc/fused_forward.cu; `fused_forward_chunk_plain` computes the same
probe and relaxation in plain PyTorch, for tensors on the CPU and as the
reference the kernel is held against on the card.

Semantics match the JAX kernel: the same hash family (ops/hashing.py),
T1 wins over T2, an empty T1 slot (score sentinel NEG_BITS) never counts,
a hit counts only with a score above NEG / 2, a token is valid only if it
fits the current sample run (`rl`), and the dropout coin is keyed on the
token's start position. The probe reads the (H, 2) `[check, score]` rows
of both cuckoo tables directly: the JAX kernel's linear scan over every
table row was a VMEM layout and gives the same hits.

Layout: every per-row array is (position, row) so a thread per row reads
coalesced; the DeviceBatch arrays are transposed once per call.
  p1, p2      (pad + W + 1 + pad, B) int32 prefix hashes
  rinv1/2     (pad + W,) int32 inverse powers
  sid, du     (pad + W + pad, B) int32 sample ids / dropout words
  is_start    (W + 1, B) uint8
  hist0 (L, B) f32 DP carry, rl0 (B,) int32 run-length carry
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from . import hashing as H
from .lattice_cuda import MAX_LEN, NEG, _check, viterbi_chunk_plain

# Empty-slot score sentinel (f32 -3.0e38) as int32 bits.
NEG_BITS = int(np.array([-3.0e38], np.float32).view(np.int32)[0])

_ODD = 2654435761  # dropout per-length mixer


def dropout_threshold_half(dropout: float) -> int:
    """The coin threshold `thr >>> 1` as a non-negative int."""
    return min(int(dropout * (1 << 32)), (1 << 32) - 1) >> 1


def run_lengths(inb: torch.Tensor, stb: torch.Tensor,
                rl0: torch.Tensor) -> torch.Tensor:
    """(W, B) in-sample run length ending at each byte: the closed form of
    rl = inb ? (stb ? 1 : rl + 1) : 0 carried from rl0."""
    W = inb.shape[0]
    q = torch.arange(W, device=inb.device, dtype=torch.int64)[:, None]
    event = torch.where(~inb | stb, q, -1)
    base = torch.cummax(event, dim=0).values
    inb_at = inb.gather(0, base.clamp(min=0))
    rl = torch.where(base < 0, rl0.to(torch.int64)[None, :] + q + 1,
                     torch.where(inb_at, q - base + 1, q - base))
    return rl.to(torch.int32)


def fused_probe_plain(t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start,
                      du, rl0, *, L: int, bits: int, pad: int,
                      dropout: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, L, B) end-indexed scores (NEG for no token) and the (W, B) run
    lengths, exactly as the fused kernel forms them."""
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
    a1 = H.wrap_i32(lens * int(H.IDX_A1))[None, :, None]
    a2 = H.wrap_i32(lens * int(H.IDX_A2))[None, :, None]
    shift = 32 - bits
    idx1 = H.srl_i32(H.mul_i32(fp1 ^ a1, H.i32(int(H.IDX_M1))), shift).long()
    idx2 = H.srl_i32(H.mul_i32(fp2 ^ a2, H.i32(int(H.IDX_M2))), shift).long()
    c1, s1 = t1_fast[:, 0][idx1], t1_fast[:, 1][idx1]
    c2, s2 = t2_fast[:, 0][idx2], t2_fast[:, 1][idx2]
    sb = torch.full_like(fp1, NEG_BITS)
    sb = torch.where(c2 == fp2, s2, sb)
    sb = torch.where((c1 == fp2) & (s1 != NEG_BITS), s1, sb)

    inb = sid[pad : pad + W] >= 0
    rl = run_lengths(inb, is_start[:W] != 0, rl0)
    valid = lens.to(torch.int32)[None, :, None] <= rl[:, None, :]
    if dropout > 0.0:
        odd = H.wrap_i32(lens * _ODD)[None, :, None]
        u = H.srl_i32(H.mul_i32(du[sp], odd), 1)
        coin = u < dropout_threshold_half(dropout)
        valid = valid & ~(coin & (lens[None, :, None] > 1))
    sf = sb.view(torch.float32)
    score = torch.where(valid & (sf > NEG * 0.5), sf,
                        torch.tensor(NEG, dtype=torch.float32, device=dev))
    return score, rl


def fused_forward_chunk_plain(kind, t1_fast, t2_fast, p1, p2, rinv1, rinv2,
                              sid, is_start, du, hist0, rl0, *, L: int,
                              bits: int, pad: int, dropout: float = 0.0):
    score, rl = fused_probe_plain(t1_fast, t2_fast, p1, p2, rinv1, rinv2,
                                  sid, is_start, du, rl0, L=L, bits=bits,
                                  pad=pad, dropout=dropout)
    dp, best_l, hist = viterbi_chunk_plain(
        score, is_start[1:].to(torch.float32), hist0)
    rl_out = rl[-1].clone() if rl.shape[0] else rl0.clone()
    return dp, best_l, hist, rl_out


def fused_forward_chunk(kind: str, t1_fast: torch.Tensor,
                        t2_fast: torch.Tensor, p1: torch.Tensor,
                        p2: torch.Tensor, rinv1: torch.Tensor,
                        rinv2: torch.Tensor, sid: torch.Tensor,
                        is_start: torch.Tensor, du: Optional[torch.Tensor],
                        hist0: torch.Tensor, rl0: torch.Tensor, *, L: int,
                        bits: int, pad: int, dropout: float = 0.0):
    """Fused probe + Viterbi DP over the whole row width. Returns dp (W, B)
    f32, best_l (W, B) int32, hist (L, B) f32 and rl (B,) int32.

    CUDA tensors launch csrc/fused_forward.cu on the current stream; CPU
    tensors run `fused_forward_chunk_plain`."""
    if kind != "viterbi":
        raise NotImplementedError(
            "fused_forward_chunk(kind='logsumexp') is the EM forward pass, "
            "still to port (ROADMAP.md, kernels 4b)")
    W = is_start.shape[0] - 1
    B = is_start.shape[1]
    T = 2 * pad + W
    use_drop = dropout > 0.0
    _check(pad >= L, f"pad {pad} must be >= L {L}")
    _check(1 <= bits <= 31, f"bits {bits} outside 1..31")
    shapes = {"p1": (p1, (T + 1, B), torch.int32),
              "p2": (p2, (T + 1, B), torch.int32),
              "rinv1": (rinv1, (pad + W,), torch.int32),
              "rinv2": (rinv2, (pad + W,), torch.int32),
              "sid": (sid, (T, B), torch.int32),
              "is_start": (is_start, (W + 1, B), torch.uint8),
              "hist0": (hist0, (L, B), torch.float32),
              "rl0": (rl0, (B,), torch.int32),
              "t1_fast": (t1_fast, (t1_fast.shape[0], 2), torch.int32),
              "t2_fast": (t2_fast, (t1_fast.shape[0], 2), torch.int32)}
    if use_drop:
        _check(du is not None, "dropout > 0 needs du")
        shapes["du"] = (du, (T, B), torch.int32)
    _check(t1_fast.shape[0] == 1 << bits, "tables must hold 2^bits rows")
    for name, (t, shape, dtype) in shapes.items():
        _check(tuple(t.shape) == shape,
               f"{name} must be {shape}, got {tuple(t.shape)}")
        _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _check(t.device == p1.device, f"{name} is on {t.device}")
    if p1.device.type == "cpu":
        return fused_forward_chunk_plain(
            kind, t1_fast, t2_fast, p1, p2, rinv1, rinv2, sid, is_start, du,
            hist0, rl0, L=L, bits=bits, pad=pad, dropout=dropout)
    _check(p1.device.type == "cuda", f"unsupported device {p1.device}")
    _check(1 <= L <= MAX_LEN, f"token length {L} outside 1..{MAX_LEN}")
    for name, (t, _, _) in shapes.items():
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(t1_fast.data_ptr() % 8 == 0 and t2_fast.data_ptr() % 8 == 0,
           "tables must be 8-byte aligned")
    dev = p1.device
    dp = torch.empty((W, B), dtype=torch.float32, device=dev)
    best_l = torch.empty((W, B), dtype=torch.int32, device=dev)
    hist = torch.empty((L, B), dtype=torch.float32, device=dev)
    rl = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return dp, best_l, hist, rl
    if W == 0:
        return dp, best_l, hist0.clone(), rl0.clone()
    fn = _build.load("fused_forward")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(t1_fast.data_ptr(), t2_fast.data_ptr(), p1.data_ptr(),
                p2.data_ptr(), rinv1.data_ptr(), rinv2.data_ptr(),
                sid.data_ptr(), is_start.data_ptr(),
                du.data_ptr() if use_drop else None,
                hist0.data_ptr(), rl0.data_ptr(), dp.data_ptr(),
                best_l.data_ptr(), hist.data_ptr(), rl.data_ptr(),
                W, L, B, pad, bits, int(use_drop),
                dropout_threshold_half(dropout) if use_drop else 0, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_forward_chunk launch failed: CUDA error {rc}")
    fused_forward_chunk.launches += 1
    return dp, best_l, hist, rl


fused_forward_chunk.launches = 0
