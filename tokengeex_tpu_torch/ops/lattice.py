"""Device lattice ops for batched Viterbi encode, in PyTorch.

Counterpart of the encode half of tokengeex_tpu/ops/lattice_jax.py. The
dynamic lattice becomes dense tensors over a packed byte stream:

  - substrings are fingerprinted from per-row prefix hashes and matched
    against the vocabulary's hash tables (ops/match_table.py);
  - the Viterbi DP  dp[p] = max_l dp[p-l] + score(p-l, l)  runs over
    positions carrying only the last L dp values (L = longest token);
  - sample boundaries inside the packed stream reset the DP, which gives
    the reference's independent-sample semantics with fixed shapes.

Two routes, picked by table size (`has_vscan`):

  - "fused" (bits <= VSCAN_MAX_BITS): the probe runs inside the DP
    kernel (ops/lattice_cuda_fused.py);
  - "slab": `_match_slab` probes a (B, L, C) score slab per chunk of C
    positions with plain tensor ops ("bucket" mode when the table has
    the single-probe buckets), and ops/lattice_cuda.py `viterbi_chunk`
    runs the DP over it.

Ties keep the longest token (reference src/model.rs:83-110). Token ids
are not formed on the device: `backtrack` resolves them on the host from
the matched byte spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..core.types import NoPathError
from ..utils.packing import PackedBatch
from . import hashing as H
from . import lattice_cuda as lc
from . import lattice_cuda_fused as lcf
from .match_table import TokenTable, _entry_arrays

NEG_INF = float("-inf")
NEG = lc.NEG


# Largest cuckoo table (log2 entries per side) that takes the fused probe
# route: vocabularies up to 16,384 tokens, the JAX package's default
# routing rule (its vscan layout).
VSCAN_MAX_BITS = 15


def check_f32(dtype=None, probe: Optional[str] = None) -> None:
    """Raise for the float64 / exact-probe conformance mode, which is
    not ported yet."""
    if (dtype is not None and dtype != torch.float32) or probe == "exact":
        raise NotImplementedError(
            f"dtype={dtype}, probe={probe!r}: the float64 / exact-probe "
            "conformance mode is not ported yet (ROADMAP.md, modules "
            "still to port: 'f64 / exact mode')")


class PhaseTimer:
    """Host seconds per phase of a pass. Synchronises the device at each
    phase boundary so device work is charged to the phase that queued
    it; pass one only when the split is wanted."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = defaultdict(float)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0


def phase(timer: Optional[PhaseTimer], name: str):
    return timer(name) if timer is not None else contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class DeviceBatch:
    """Device-resident packed corpus (see utils/packing.py)."""

    p1: torch.Tensor  # (B, L + W+1 + L) int32 prefix hashes (R1), offset L
    p2: torch.Tensor  # same for R2
    sid: torch.Tensor  # (B, L + W + L) int32 sample ids, -2 out of range
    is_start: torch.Tensor  # (B, W+1) bool
    is_end: torch.Tensor  # (B, W+1) bool
    end_index: torch.Tensor  # (B, W) int32
    rinv1: torch.Tensor  # (L + W,) int32: R1^-p at offset L
    rinv2: torch.Tensor  # (L + W,) int32
    width: int
    pad: int  # = L used for padding offsets


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Vocabulary hash tables on the device.

      t1_fast, t2_fast  (H, 2) int32 cuckoo rows [check = fp2, f32 score
                        bits]; empty rows hold check 0 and the -3e38
                        score sentinel
      t_bucket          (Hb, 16) int32 single-probe buckets of 8
                        interleaved [check, score] entries, or None
      scores            (V,) f32 per-id scores
    """

    t1_fast: torch.Tensor
    t2_fast: torch.Tensor
    scores: torch.Tensor
    bits: int
    max_len: int
    vocab_size: int
    t_bucket: Optional[torch.Tensor] = None
    bk_bits: int = 0
    bk_salt: int = 0

    @staticmethod
    def from_table(tbl: TokenTable, device) -> "DeviceTables":
        scores64 = tbl.scores_f64

        def fast(t: np.ndarray) -> np.ndarray:
            fp2 = t[:, 1].astype(np.uint32)
            tid = t[:, 3].astype(np.uint32)
            empty = tid == np.uint32(0xFFFFFFFF)
            score = np.where(
                empty, np.float32(-3.0e38),
                scores64[np.where(empty, 0, tid)].astype(np.float32))
            return np.stack([fp2.view(np.int32), score.view(np.int32)],
                            axis=1)

        assert tbl.vocab_size < (1 << 24), "id packing needs vocab < 16M"
        return DeviceTables.from_numpy(
            {"t1_fast": fast(tbl.t1), "t2_fast": fast(tbl.t2),
             "t_bucket": tbl.bk, "scores": tbl.scores},
            (tbl.bits, tbl.max_token_len, tbl.vocab_size, tbl.bk_bits,
             tbl.bk_salt), device)

    @staticmethod
    def from_numpy(arrays: Mapping[str, Optional[np.ndarray]], meta,
                   device) -> "DeviceTables":
        """Tables from host arrays: `arrays` holds t1_fast, t2_fast,
        t_bucket (or None / empty) and scores; `meta` is (bits, max_len,
        vocab_size, bk_bits, bk_salt). With the JAX DeviceTables fields
        turned into numpy, both packages run on the very same tables."""
        bits, max_len, vocab_size, bk_bits, bk_salt = meta

        def dev(a, dtype):
            return torch.as_tensor(np.array(a, copy=True),
                                   device=device).to(dtype).contiguous()

        tb = arrays.get("t_bucket")
        return DeviceTables(
            t1_fast=dev(arrays["t1_fast"], torch.int32),
            t2_fast=dev(arrays["t2_fast"], torch.int32),
            scores=dev(np.asarray(arrays["scores"], np.float32),
                       torch.float32),
            bits=int(bits), max_len=int(max_len),
            vocab_size=int(vocab_size),
            t_bucket=(dev(tb, torch.int32)
                      if tb is not None and np.size(tb) else None),
            bk_bits=int(bk_bits), bk_salt=int(bk_salt),
        )

    @property
    def num_slots(self) -> int:
        return 2 * (1 << self.bits)

    @property
    def bk_num_slots(self) -> int:
        return 8 * (1 << self.bk_bits)


def has_vscan(tbl: DeviceTables) -> bool:
    """True when the table is small enough for the fused probe route."""
    return tbl.bits <= VSCAN_MAX_BITS


# ---------------------------------------------------------------------------
# Batch preparation
# ---------------------------------------------------------------------------

_PREP_CONSTS: dict = {}
_CHAIN_CONSTS: dict = {}


def _consts_on(device, arrays) -> tuple:
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _prep_consts(W: int, L: int, device):
    """Per-width hash constants on the device (made once)."""
    key = (W, L, str(device))
    if key not in _PREP_CONSTS:
        pow1 = H.powers_u32(H.R1, W).view(np.int32)
        pow2 = H.powers_u32(H.R2, W).view(np.int32)
        rinv1 = np.pad(H.powers_u32(H.R1_INV, W), (L, 0),
                       constant_values=1).view(np.int32)
        rinv2 = np.pad(H.powers_u32(H.R2_INV, W), (L, 0),
                       constant_values=1).view(np.int32)
        _PREP_CONSTS[key] = _consts_on(device, (pow1, pow2, rinv1, rinv2))
    return _PREP_CONSTS[key]


def _prefix_hashes(b32: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """(B, n) bytes -> (B, n+1) int32 prefix hashes P[p] = sum_{k<p} b R^k."""
    zero = torch.zeros((b32.shape[0], 1), dtype=torch.int32,
                       device=b32.device)
    return torch.cat([zero, H.cumsum_i32(H.mul_i32(b32, pw[None, :]), 1)],
                     dim=1)


def _device_prep(bytes_u8: torch.Tensor, flags_u8: torch.Tensor, consts,
                 L: int):
    """Derive all DeviceBatch arrays on the device from the compact host
    inputs: raw bytes plus flags (bit0 = sample start at a dp index,
    bit1 = sample end). Prefix hashes are int32 cumsums that wrap mod
    2^32; end indices a reverse cummin."""
    pow1, pow2, rinv1, rinv2 = consts
    B, W = bytes_u8.shape
    b32 = bytes_u8.to(torch.int32)
    p1 = _prefix_hashes(b32, pow1)
    p2 = _prefix_hashes(b32, pow2)

    is_start = (flags_u8 & 1).bool()  # (B, W+1)
    is_end = (flags_u8 & 2).bool()
    starts_cnt = torch.cumsum(is_start[:, :W], dim=1, dtype=torch.int32)
    ends_cnt = torch.cumsum(is_end[:, :W], dim=1, dtype=torch.int32)
    inside = starts_cnt > ends_cnt
    sid = torch.where(inside, starts_cnt - 1, -2).to(torch.int32)

    # end_index[p] = smallest dp index q >= p+1 with is_end[q].
    idx = torch.arange(W + 1, dtype=torch.int32, device=bytes_u8.device)
    marked = torch.where(is_end, idx[None, :], 2**30).to(torch.int32)
    next_end = torch.cummin(marked.flip(1), dim=1).values.flip(1)
    end_index = torch.where(inside, next_end[:, 1:], 0).to(torch.int32)

    pad = (L, L)
    return (
        torch.nn.functional.pad(p1, pad), torch.nn.functional.pad(p2, pad),
        torch.nn.functional.pad(sid, pad, value=-2),
        is_start, is_end, end_index, rinv1, rinv2,
    )


def _is_end_from_spans(packed: PackedBatch) -> np.ndarray:
    out = np.zeros((packed.rows, packed.width + 1), dtype=bool)
    for r, s, e, _, _ in packed.spans:
        out[r, e] = True
    return out


def host_batch_inputs(packed: PackedBatch):
    """Host (numpy) compact inputs: raw bytes + boundary flags."""
    B, W = packed.bytes_arr.shape
    flags = np.zeros((B, W + 1), dtype=np.uint8)
    flags[packed.is_start] |= 1
    flags[_is_end_from_spans(packed)] |= 2
    return packed.bytes_arr, flags


def prepare_batch(packed: PackedBatch, L: int, device) -> DeviceBatch:
    """Build the device-resident batch from a packed corpus view."""
    bytes_arr, flags = host_batch_inputs(packed)
    gbytes = torch.as_tensor(bytes_arr, device=device)
    gflags = torch.as_tensor(flags, device=device)
    B, W = gbytes.shape
    p1, p2, sid, is_start, is_end, end_index, rinv1, rinv2 = _device_prep(
        gbytes, gflags, _prep_consts(W, L, device), L)
    return DeviceBatch(
        p1=p1, p2=p2, sid=sid, is_start=is_start, is_end=is_end,
        end_index=end_index, rinv1=rinv1, rinv2=rinv2, width=W, pad=L,
    )


def _chain_consts(W: int, L: int, device):
    """Origin-shifted constants: the hash stream starts at the tail
    (virtual position -L), so exponents run over the full L+W span and
    the inverse powers cover the left pad with REAL values instead of
    the 1-filled pad of the ordinary layout."""
    key = (W, L, str(device))
    if key not in _CHAIN_CONSTS:
        _CHAIN_CONSTS[key] = _consts_on(device, (
            H.powers_u32(H.R1, L + W).view(np.int32),
            H.powers_u32(H.R2, L + W).view(np.int32),
            H.powers_u32(H.R1_INV, L + W).view(np.int32),
            H.powers_u32(H.R2_INV, L + W).view(np.int32)))
    return _CHAIN_CONSTS[key]


def _chained_prep(rows_u8, n_valid, has_tail, consts, L: int, W: int):
    pow1, pow2, rinv1, rinv2 = consts
    B = rows_u8.shape[0]
    dev = rows_u8.device
    b32 = rows_u8.to(torch.int32)
    p1 = torch.nn.functional.pad(_prefix_hashes(b32, pow1), (0, L))
    p2 = torch.nn.functional.pad(_prefix_hashes(b32, pow2), (0, L))

    pos = torch.arange(L + W, dtype=torch.int32, device=dev)[None, :]
    body_idx = pos - L
    rid = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    nv = n_valid[:, None]
    in_tail = has_tail[:, None] & (pos < L) & (nv > 0)
    in_body = (body_idx >= 0) & (body_idx < nv)
    sid = torch.where(in_tail | in_body, rid, -2).to(torch.int32)
    sid = torch.nn.functional.pad(sid, (0, L), value=-2)

    dp_idx = torch.arange(W + 1, dtype=torch.int32, device=dev)[None, :]
    active = nv > 0
    is_start = (dp_idx == 0) & active & ~has_tail[:, None]
    is_end = (dp_idx == nv) & active
    end_index = torch.where((dp_idx[:, :W] < nv) & active, nv,
                            0).to(torch.int32)
    return p1, p2, sid, is_start, is_end, end_index, rinv1, rinv2


def prepare_chained_batch(rows: np.ndarray, n_valid: np.ndarray,
                          has_tail: np.ndarray, L: int, W: int,
                          device) -> DeviceBatch:
    """Device batch for chained long-sample windows.

    rows: (B, L+W) uint8 = [previous window's last L bytes | body];
    n_valid: body byte count per row (0 = inactive row);
    has_tail: whether the left L bytes are real context (False for the
    first window of a sample — its pad bytes are zeros and invalid).
    """
    p1, p2, sid, is_start, is_end, end_index, rinv1, rinv2 = _chained_prep(
        torch.as_tensor(rows, device=device),
        torch.as_tensor(n_valid.astype(np.int32), device=device),
        torch.as_tensor(has_tail, device=device),
        _chain_consts(W, L, device), L, W)
    return DeviceBatch(
        p1=p1, p2=p2, sid=sid, is_start=is_start, is_end=is_end,
        end_index=end_index, rinv1=rinv1, rinv2=rinv2, width=W, pad=L,
    )


# ---------------------------------------------------------------------------
# Match slab
# ---------------------------------------------------------------------------


def _len_mix(L: int, mult: int, device) -> torch.Tensor:
    """(L,) int32 per-length constants l * mult mod 2^32, l = 1..L."""
    lens = torch.arange(1, L + 1, dtype=torch.int64, device=device)
    return H.wrap_i32(lens * int(mult))


def _match_slab(
    tbl: DeviceTables,
    batch: DeviceBatch,
    start: int,  # first global position of the slab
    n_pos: int,  # slab length
    L: int,
    drop_u: Optional[torch.Tensor] = None,  # (B, L+W+L) int32, padded like sid
    dropout: float = 0.0,
    mode: str = "fast",  # "bucket" | "fast" ("em" is an alias of "fast")
    end_indexed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match arrays for global positions [start, start+n_pos).

    Returns (score, slot) of shape (B, L, n_pos), row j = token length
    l = j+1, score -inf where no token matches. Start-indexed: column q
    describes the token BEGINNING at position start+q. End-indexed: the
    token ENDING at dp index start+q+1 (beginning at start+q-j).

    mode="bucket": one 16-word bucket row per probe, slot = bucket*8+k;
    mode="fast": one (check, score) row per cuckoo table, T1 first, slot
    = idx1 or H + idx2. Misses get slot num_slots / bk_num_slots.
    """
    check_f32(probe=mode)
    if mode not in ("bucket", "fast", "em"):
        raise ValueError(f"unknown probe mode {mode!r}")
    dev = batch.p1.device
    off = batch.pad + start  # offset into padded arrays
    base = off - (L if end_indexed else 0)
    p1s = batch.p1[:, base : base + n_pos + L + 1]
    p2s = batch.p2[:, base : base + n_pos + L + 1]
    sids = batch.sid[:, base : base + n_pos + L]
    q = torch.arange(n_pos, device=dev)[None, :]
    j = torch.arange(L, device=dev)[:, None]

    if end_indexed:
        # Token of length l = j+1 ending at dp index start+q+1 begins at
        # slab column L - j + q (the slab starts at global start - L).
        cols = L - j + q  # (L, n)
        endv1 = p1s[:, None, L + 1 : L + 1 + n_pos]
        endv2 = p2s[:, None, L + 1 : L + 1 + n_pos]
        ridx = off - j + q  # rinv / dropout index of the token start
        fp1 = H.mul_i32(H.sub_i32(endv1, p1s[:, cols]), batch.rinv1[ridx][None])
        fp2 = H.mul_i32(H.sub_i32(endv2, p2s[:, cols]), batch.rinv2[ridx][None])
        sid0 = sids[:, cols]
        sid_last = sids[:, None, L : L + n_pos]
        valid = (sid_last >= 0) & (sid_last == sid0)
        drop_base = (drop_u[:, ridx] if dropout > 0.0 and drop_u is not None
                     else None)
    else:
        base1 = p1s[:, None, :n_pos]
        base2 = p2s[:, None, :n_pos]
        ends = j + 1 + q
        rinv1 = batch.rinv1[off : off + n_pos][None, None, :]
        rinv2 = batch.rinv2[off : off + n_pos][None, None, :]
        fp1 = H.mul_i32(H.sub_i32(p1s[:, ends], base1), rinv1)
        fp2 = H.mul_i32(H.sub_i32(p2s[:, ends], base2), rinv2)
        sid0 = sids[:, None, :n_pos]
        sid_last = sids[:, j + q]
        valid = (sid0 >= 0) & (sid_last == sid0)
        drop_base = (drop_u[:, off : off + n_pos][:, None, :]
                     if dropout > 0.0 and drop_u is not None else None)

    lens = torch.arange(1, L + 1, device=dev)[None, :, None]
    if drop_base is not None:
        # Dropout keys on the token's START position, mixed per length.
        odd = _len_mix(L, lcf._ODD, dev)[None, :, None]
        u = H.srl_i32(H.mul_i32(drop_base, odd), 1)
        tt = lcf.dropout_threshold_half(dropout)
        valid = valid & ~((u < tt) & (lens > 1))

    a1 = _len_mix(L, int(H.IDX_A1), dev)[None, :, None]
    a2 = _len_mix(L, int(H.IDX_A2), dev)[None, :, None]
    m1 = H.i32(int(H.IDX_M1))
    m2 = H.i32(int(H.IDX_M2))
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    if mode == "bucket":
        # Descending k makes entry 0 win; build rejects duplicate
        # (bucket, fp2) pairs, so at most one entry truly matches.
        idxb = H.srl_i32(H.mul_i32((fp1 ^ a1) ^ H.i32(tbl.bk_salt), m1),
                         32 - tbl.bk_bits)
        rows = idxb.long()
        score = torch.full(fp1.shape, -3.0e38, dtype=torch.float32,
                           device=dev)
        slot = torch.full(fp1.shape, tbl.bk_num_slots, dtype=torch.int32,
                          device=dev)
        for k in range(7, -1, -1):
            c = tbl.t_bucket[:, 2 * k][rows]
            sk = tbl.t_bucket[:, 2 * k + 1][rows].view(torch.float32)
            m = (c == fp2) & (sk > -1.0e38)
            score = torch.where(m, sk, score)
            slot = torch.where(m, idxb * 8 + k, slot)
        ok = (score > -1.0e38) & valid
        return (torch.where(ok, score, neg),
                torch.where(ok, slot, tbl.bk_num_slots))

    shift = 32 - tbl.bits
    idx1 = H.srl_i32(H.mul_i32(fp1 ^ a1, m1), shift)
    idx2 = H.srl_i32(H.mul_i32(fp2 ^ a2, m2), shift)
    c1 = tbl.t1_fast[:, 0][idx1.long()]
    s1 = tbl.t1_fast[:, 1][idx1.long()].view(torch.float32)
    c2 = tbl.t2_fast[:, 0][idx2.long()]
    s2 = tbl.t2_fast[:, 1][idx2.long()].view(torch.float32)
    # Empty slots store check 0 with the sentinel score; a probe with
    # fp2 == 0 must fall through to t2, not mask its match.
    match1 = (c1 == fp2) & (s1 > -1.0e38) & valid
    match2 = (c2 == fp2) & (s2 > -1.0e38) & valid
    score = torch.where(match1, s1, torch.where(match2, s2, neg))
    score = torch.where(score <= -1.0e38, neg, score)
    slot = torch.where(match1, idx1,
                       torch.where(match2, idx2 + (1 << tbl.bits),
                                   tbl.num_slots))
    slot = torch.where(score > -1.0e38, slot, tbl.num_slots)
    return score, slot.to(torch.int32)


def _probe_mode(tbl: DeviceTables) -> str:
    return "bucket" if tbl.t_bucket is not None else "fast"


# ---------------------------------------------------------------------------
# Viterbi drivers
# ---------------------------------------------------------------------------


def _hist0(batch: DeviceBatch, L: int, carry) -> torch.Tensor:
    """(B, L) initial history: hist[:, j] = dp[-j]; rows whose carry mask
    is set take the previous window's last L dp values bit-exactly."""
    B = batch.p1.shape[0]
    dev = batch.p1.device
    hist0 = torch.full((B, L), NEG_INF, dtype=torch.float32, device=dev)
    hist0[:, 0] = torch.where(batch.is_start[:, 0], 0.0, NEG_INF)
    if carry is not None:
        mask, carry_hist = carry
        hist0 = torch.where(mask[:, None], carry_hist.to(torch.float32),
                            hist0)
    return hist0


def _finish(dp: torch.Tensor) -> torch.Tensor:
    return torch.where(dp <= NEG * 0.5, NEG_INF, dp)


def _scan_forward(
    tbl: DeviceTables,
    batch: DeviceBatch,
    C: int = 512,
    drop_u: Optional[torch.Tensor] = None,
    dropout: float = 0.0,
    probe: Optional[str] = None,
    carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    timer: Optional[PhaseTimer] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab route: per chunk of C positions, probe an end-indexed score
    slab and run `viterbi_chunk` over it; the history carries across
    chunks. carry = (mask (B,), hist0 (B, L)) chains the DP across
    fixed-width windows of one long sample (prepare_chained_batch).
    Returns dp (B, W) f32 (-inf where unreachable) and best_l (B, W)."""
    B = batch.p1.shape[0]
    W = batch.width
    L = tbl.max_len
    if W % C:
        raise ValueError(f"chunk {C} does not divide width {W}")
    mode = probe or _probe_mode(tbl)
    hist = _hist0(batch, L, carry).clamp(min=NEG).t().contiguous()
    starts = batch.is_start[:, 1:].t().to(torch.float32)  # (W, B)
    dps, bls = [], []
    for cs in range(0, W, C):
        with phase(timer, "probe"):
            score_e, _ = _match_slab(tbl, batch, cs, C, L, drop_u, dropout,
                                     mode=mode, end_indexed=True)
            score_e = score_e.clamp(min=NEG).permute(2, 1, 0).contiguous()
        with phase(timer, "kernel"):
            dp_c, bl_c, hist = lc.viterbi_chunk(
                score_e, starts[cs : cs + C].contiguous(), hist)
        dps.append(dp_c)
        bls.append(bl_c)
    dp = torch.cat(dps, dim=0).t()
    best_l = torch.cat(bls, dim=0).t()
    return _finish(dp), best_l


def fused_inputs(tbl: DeviceTables, batch: DeviceBatch,
                 drop_u: Optional[torch.Tensor] = None,
                 dropout: float = 0.0,
                 carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Positional arguments of `lattice_cuda_fused.fused_forward_chunk`
    (after `kind`) for one batch, in its (position, row) layout."""
    L = tbl.max_len
    pad = batch.pad
    use_drop = drop_u is not None and dropout > 0.0
    hist = _hist0(batch, L, carry).clamp(min=NEG).t().contiguous()
    rl0 = torch.where(batch.sid[:, pad - 1] >= 0, L, 0).to(torch.int32)
    return (tbl.t1_fast, tbl.t2_fast,
            batch.p1.t().contiguous(), batch.p2.t().contiguous(),
            batch.rinv1, batch.rinv2, batch.sid.t().contiguous(),
            batch.is_start.t().to(torch.uint8).contiguous(),
            drop_u.t().contiguous() if use_drop else None,
            hist, rl0)


def _scan_forward_fused(
    tbl: DeviceTables,
    batch: DeviceBatch,
    drop_u: Optional[torch.Tensor] = None,
    dropout: float = 0.0,
    carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    timer: Optional[PhaseTimer] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused route: fingerprints, probe and DP in one kernel over the
    whole row width. Semantics identical to `_scan_forward`."""
    use_drop = drop_u is not None and dropout > 0.0
    with phase(timer, "prep"):
        args = fused_inputs(tbl, batch, drop_u, dropout, carry)
    with phase(timer, "kernel"):
        dp, best_l, _, _ = lcf.fused_forward_chunk(
            "viterbi", *args, L=tbl.max_len, bits=tbl.bits, pad=batch.pad,
            dropout=dropout if use_drop else 0.0)
    return _finish(dp.t()), best_l.t()


def viterbi(tbl: DeviceTables, batch: DeviceBatch, C: int = 256,
            dtype=None, drop_u=None, dropout: float = 0.0,
            backend: str = "slab", probe: Optional[str] = None,
            carry=None, timer: Optional[PhaseTimer] = None):
    """dp scores + backpointers for the packed batch.

    Returns (dp, best_l), each (B, W), indexed by dp index p-1.
    backend "slab" probes score slabs and runs `viterbi_chunk`; "fused"
    runs the fused probe kernel (tables with has_vscan only). `carry`
    chains windows of long samples (see _scan_forward)."""
    check_f32(dtype, probe)
    if backend == "fused":
        if not has_vscan(tbl):
            raise ValueError("fused backend needs bits <= VSCAN_MAX_BITS")
        return _scan_forward_fused(tbl, batch, drop_u, dropout, carry, timer)
    if backend != "slab":
        raise ValueError(f"unknown backend {backend!r}")
    return _scan_forward(tbl, batch, C, drop_u, dropout, probe, carry, timer)


def pick_span_values(A: torch.Tensor, rows_idx, ends_idx) -> np.ndarray:
    """A[rows_idx[k], ends_idx[k]] per span, on the host."""
    if len(rows_idx) == 0:
        return np.zeros(0, dtype=np.float32)
    r = torch.as_tensor(np.asarray(rows_idx, np.int64), device=A.device)
    e = torch.as_tensor(np.asarray(ends_idx, np.int64), device=A.device)
    return A[r, e].cpu().numpy()


# ---------------------------------------------------------------------------
# Host-side backtracking
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _host_powers(r: int, n: int) -> np.ndarray:
    return H.powers_u32(np.uint32(r), n)


def _token_keys(fp1: np.ndarray, fp2: np.ndarray,
                lens: np.ndarray) -> np.ndarray:
    """One uint64 key per (fp1, fp2, len) token identity."""
    with np.errstate(over="ignore"):
        mixed = fp1 ^ (lens.astype(np.uint32) * np.uint32(0x9E3779B9))
    return (mixed.astype(np.uint64) << np.uint64(32)) | fp2.astype(np.uint64)


class TokenIndex:
    """Vectorised bytes -> id lookup built from `token_to_id` (later ids
    win, as in the dict): tokens are keyed by their two 32-bit
    fingerprints and length, the identity the device probe matches on."""

    def __init__(self, token_to_id: Mapping[bytes, int]):
        by_bytes = {b: i for b, i in token_to_id.items() if b}
        max_len = max((len(b) for b in by_bytes), default=1)
        fp1, fp2, lens, ids = _entry_arrays(by_bytes, max_len)
        keys = _token_keys(fp1, fp2, lens)
        n = keys.size
        if np.unique(keys).size != n:
            raise ValueError("two vocabulary tokens share a fingerprint key")
        # Open addressing with linear probing at load <= 1/4, filled in
        # vectorised rounds: round p places, per free slot home + p, the
        # first key still pending, so no probe chain has a hole.
        bits = max(4, int(np.ceil(np.log2(max(4 * n, 1)))))
        self.mask = (1 << bits) - 1
        self.shift = np.uint64(64 - bits)
        self.slot_key = np.zeros(1 << bits, dtype=np.uint64)
        self.slot_id = np.full(1 << bits, -1, dtype=np.int64)
        home = self._home(keys)
        pending = np.arange(n)
        self.max_probe = 0
        while pending.size:
            slot = (home[pending] + self.max_probe) & self.mask
            free = self.slot_id[slot] < 0
            taken, first = np.unique(slot[free], return_index=True)
            won = pending[free][first]
            self.slot_key[taken] = keys[won]
            self.slot_id[taken] = ids[won].astype(np.int64)
            pending = np.setdiff1d(pending, won, assume_unique=True)
            self.max_probe += 1

    def _home(self, keys: np.ndarray) -> np.ndarray:
        with np.errstate(over="ignore"):
            h = keys * np.uint64(0x9E3779B97F4A7C15)
        return (h >> self.shift).astype(np.int64)

    def _find(self, q: np.ndarray) -> np.ndarray:
        res = np.full(q.size, -1, dtype=np.int64)
        todo = np.arange(q.size)
        slot = self._home(q)
        for _ in range(self.max_probe):
            hit = (self.slot_key[slot] == q[todo]) & (self.slot_id[slot] >= 0)
            res[todo[hit]] = self.slot_id[slot[hit]]
            todo, slot = todo[~hit], (slot[~hit] + 1) & self.mask
            if not todo.size:
                break
        return res

    def lookup(self, rows: np.ndarray, r: np.ndarray, end: np.ndarray,
               length: np.ndarray) -> np.ndarray:
        """Ids of the tokens rows[r, end-length : end]. Fingerprints come
        from per-row prefix hashes, fp = (P[end] - P[start]) * R^-start,
        the device formula, so each token costs a few gathers."""
        if r.size == 0:
            return np.zeros(0, dtype=np.int64)
        W = rows.shape[1]
        start = end - length
        b = rows.astype(np.uint32)
        fps = []
        for R, R_INV in ((H.R1, H.R1_INV), (H.R2, H.R2_INV)):
            with np.errstate(over="ignore"):
                P = np.zeros((rows.shape[0], W + 1), dtype=np.uint32)
                np.cumsum(b * _host_powers(int(R), W)[None, :], axis=1,
                          dtype=np.uint32, out=P[:, 1:])
                fps.append((P[r, end] - P[r, start])
                           * _host_powers(int(R_INV), W)[start])
        fp1, fp2 = fps
        ids = self._find(_token_keys(fp1, fp2, length))
        if (ids < 0).any():
            raise KeyError("backtrack: a matched span is not a vocabulary "
                           "token (model/table mismatch)")
        return ids


def backtrack(
    packed: PackedBatch,
    dp: np.ndarray,
    best_l: np.ndarray,
    token_to_id: Union[Mapping[bytes, int], TokenIndex],
    raise_no_path: bool = True,
) -> List[Optional[List[int]]]:
    """Recover token id sequences per span from device outputs.

    All spans step back together (one vectorised step per token of the
    longest span), marking token ends on a grid; ids are then looked up
    in one pass, in position order. An unreachable
    span end raises NoPath(len, len) like the reference's dp[n].start ==
    None case (src/model.rs:112-127), or gives None with
    raise_no_path=False. `dp` is the full (B, W) array or the 1-D
    per-span dp values at each span end."""
    index = (token_to_id if isinstance(token_to_id, TokenIndex)
             else TokenIndex(token_to_id))
    n = len(packed.spans)
    if n == 0:
        return []
    sp = np.asarray([s[:3] for s in packed.spans], dtype=np.int64)
    r, s, e = sp[:, 0], sp[:, 1], sp[:, 2]
    dp_end = (dp[:n] if dp.ndim == 1
              else dp[r, np.maximum(e - 1, 0)]).astype(np.float64)
    nonempty = e > s
    dead = nonempty & ~np.isfinite(dp_end)
    if raise_no_path and dead.any():
        k = int(np.nonzero(dead)[0][0])
        raise NoPathError(int(e[k] - s[k]), int(e[k] - s[k]))
    live = np.nonzero(nonempty & ~dead)[0]

    out: List[Optional[List[int]]] = [
        [] if not dead[k] else None for k in range(n)]
    if live.size == 0:
        return out
    # Walk: every live span steps back one token per iteration, marking
    # token ends on a flat (B*W) grid (cell r*W + p-1 for dp index p);
    # finished spans park on a sentinel cell of length 0.
    B, W = best_l.shape
    sentinel = B * W
    flat_bl = np.append(best_l.reshape(-1).astype(np.int64), 0)
    mark = np.zeros(sentinel + 1, dtype=bool)
    cur = r[live] * W + e[live] - 1
    stop = r[live] * W + s[live]  # token ends stay at dp index > s
    step = 0
    while cur.size:
        mark[cur] = True
        cur = cur - flat_bl[cur]
        cur = np.where(cur >= stop, cur, sentinel)
        step += 1
        if step % 32 == 0:
            going = cur != sentinel
            cur, stop = cur[going], stop[going]
    # Marked cells in row-major order are the tokens of every span in
    # (row, position) order; spans never overlap, so each span's tokens
    # are one contiguous run.
    tok = np.flatnonzero(mark[:sentinel])
    ids = index.lookup(packed.bytes_arr, tok // W, tok % W + 1, flat_bl[tok])
    by_pos = live[np.argsort(r[live] * (W + 1) + s[live], kind="stable")]
    bounds = np.searchsorted(tok, r[by_pos] * W + e[by_pos] - 1,
                             side="right")
    for k, part in zip(by_pos, np.split(ids, bounds[:-1])):
        out[int(k)] = part.tolist()
    return out

