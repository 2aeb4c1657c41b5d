"""Device lattice ops for batched Viterbi encode and the EM E-step, in
PyTorch.

Counterpart of tokengeex_tpu/ops/lattice_jax.py (encode, the per-pass
E-step: `match_cache`, `forward`, `backward_expected`, `fold_expected`,
the probe-once session's ops: the dense rank space, `score_from_slots`,
`SegStruct`, `backward_betas`, `segsum_expected`, `estep_cached`,
`estep_fused`, `viterbi_cached`, and the device frequency counts,
`viterbi_freq`, as `viterbi_walk`). The dynamic lattice becomes dense tensors
over a packed byte stream:

  - substrings are fingerprinted from per-row prefix hashes and matched
    against the vocabulary's hash tables (ops/match_table.py);
  - the Viterbi DP  dp[p] = max_l dp[p-l] + score(p-l, l)  runs over
    positions carrying only the last L dp values (L = longest token);
  - sample boundaries inside the packed stream reset the DP, which gives
    the reference's independent-sample semantics with fixed shapes.

Two routes, picked by table size (`has_vscan`):

  - "fused" (bits <= VSCAN_MAX_BITS): the probe runs inside the DP
    kernel (ops/lattice_cuda_fused.py);
  - "slab": `match_cache` probes the group once, start-indexed, in one
    launch of csrc/match_probe.cu (ops/lattice_cuda_probe.py; "bucket"
    mode when the table has the single-probe buckets; its twin
    `match_cache_plain` runs `_match_slab` chunk by chunk), and
    ops/lattice_cuda.py `viterbi_scan` runs the DP over it in one
    whole-width launch.

Both Viterbi kernels cut each row into independent chains at sample
starts and padding (`chain_bounds`) and draw the dropout coins in the
kernel.

Ties keep the longest token (reference src/model.rs:83-110). Token ids
are formed on the device: `viterbi_walk` (csrc/viterbi_walk.cu) walks
every span's backpointers, a row's segments in parallel, over a span
index each group makes once (`walk_index`), and resolves each token's id
with the exact tables (`t1_exact`, `t2_exact`), counting the ids (the
frequency pass, `walk_counts`) or writing them into one flat buffer,
span after span (encode, `walk_ids`; merge's pair count keeps the buffer
on the device, `walk_ids_device`). Samples longer than the encode width,
scanned in chained windows, are walked across their windows on the device
too (`chained_walk`, csrc/viterbi_walk.cu's chained entry), their ids
resolved from the windows' own bytes. The host `backtrack` stays as the
reference they are held against.

The E-step probes each row group once (`match_cache`, start-indexed,
without dropout), runs the forward log-sum-exp DP over that cache in one
whole-width launch (`forward_scan`: it reads the cache end-indexed and
draws the dropout coins itself, each row cut into independent chains at
sample starts and padding by `chain_bounds`), then the backward DP with
the token marginals over it in one whole-width launch as well
(`backward_marginal_scan`, cut at sample ends and padding), and adds the
marginals into bins that the host folds to token ids: token-id bins in
the exact mode (`fold_expected`), dense-rank bins otherwise
(`fold_expected_rank`).

The session (train/device_session.py) keeps each group's probe slots,
remapped once to a dense rank space, and a `SegStruct` that sorts the
group's hits by rank once. Its later E-steps re-gather scores per cached
rank (`estep_cached`: `forward_scan` and `backward_betas_scan`, one
launch each over the whole width) or re-probe inside the fused kernels
(`estep_fused`: the same chained scans with the probe inside, one launch
each), run the backward pass for betas only, and turn them
into counts with the scatter-free `segsum_expected` (csrc/seg_weights.cu,
one launch per group over every token length's hits).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.types import NoPathError
from ..utils.device import upload
from ..utils.packing import PackedBatch
from ..utils.trace import PhaseTimer, count, phase
from . import hashing as H
from . import lattice_cuda as lc
from . import lattice_cuda_fused as lcf
from . import lattice_cuda_probe as lcp
from .lattice_cuda_seg import SEG_BLK, seg_sums, seg_weights_gather
from .match_table import _NEG_SCORE_BITS, TokenTable, _entry_arrays

NEG_INF = float("-inf")
NEG = lc.NEG


# Largest cuckoo table (log2 entries per side) that takes the fused probe
# route: vocabularies up to 16,384 tokens, the JAX package's default
# routing rule (its vscan layout).
VSCAN_MAX_BITS = 15



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

      t1_fast, t2_fast  (H, 2) int32 cuckoo rows [check, f32 score
                        bits], check = fp2 ^ rotl(fp1, 16)
                        (ops/hashing.py `host_check`; the JAX package
                        checks fp2 alone, which T2's slot, a function of
                        fp2, half fixes); empty rows hold check 0 and
                        the -3e38 score sentinel. The table builder
                        (ops/match_table.py) pins every (T1 slot, check
                        word) cluster that would shadow a T2 token into
                        T2, so each token resolves to itself
      t1_exact, t2_exact  (H, 4) int32 rows [fp1, fp2, len<<24 | id, 0];
                        empty rows hold 0xFFFFFFFF in the id word. The
                        backpointer walk (`viterbi_walk`) resolves a
                        token's id with them; None in tables made without
                        them
      t_bucket          (Hb, 16) int32 single-probe buckets of 8
                        interleaved [check, score] entries, or None
      bk_filter         the buckets' miss filter (ops/lattice_cuda_probe.py
                        `BucketFilter`: one byte a row, derived from
                        t_bucket itself, refused for any other), or None
                        where the probe takes its gather branch
      scores            (V,) per-id scores at the tables' float type:
                        float64 for the f64 / exact route (the exact
                        probe gathers them by id), float32 otherwise
      slot_to_id, slot_len        host (2H,) int64 token id (-1 empty) and
                                  length of each cuckoo slot (T1 then T2)
      bk_slot_to_id, bk_slot_len  host (8 Hb,) int64, the same per bucket
                                  slot, or None
    The slot maps fold slot-indexed E-step counts to token ids; the
    tables a session binds on its resident layout carry none.
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
    slot_to_id: Optional[np.ndarray] = None
    slot_len: Optional[np.ndarray] = None
    bk_slot_to_id: Optional[np.ndarray] = None
    bk_slot_len: Optional[np.ndarray] = None
    t1_exact: Optional[torch.Tensor] = None
    t2_exact: Optional[torch.Tensor] = None
    bk_filter: Optional[lcp.BucketFilter] = None

    @staticmethod
    def from_table(tbl: TokenTable, device,
                   dtype: torch.dtype = torch.float32) -> "DeviceTables":
        """The tables of `tbl` on `device`, the per-id scores at `dtype`
        (float64 keeps the reference's f64 scores for the exact probe).
        Counts `tables.uploaded`: a whole table crosses to the device."""
        count("tables.uploaded", 1)
        scores64 = tbl.scores_f64

        def fast(t: np.ndarray) -> np.ndarray:
            tid = t[:, 3].astype(np.uint32)
            empty = tid == np.uint32(0xFFFFFFFF)
            check = np.where(empty, np.uint32(0),
                             H.host_check(t[:, 0], t[:, 1]))
            score = np.where(
                empty, np.float32(-3.0e38),
                scores64[np.where(empty, 0, tid)].astype(np.float32))
            return np.stack([check.view(np.int32), score.view(np.int32)],
                            axis=1)

        def exact(t: np.ndarray) -> np.ndarray:
            fp1 = t[:, 0].astype(np.uint32)
            fp2 = t[:, 1].astype(np.uint32)
            length = t[:, 2].astype(np.uint32)
            tid = t[:, 3].astype(np.uint32)
            empty = tid == np.uint32(0xFFFFFFFF)
            idlen = (length << np.uint32(24)) | (tid & np.uint32(0xFFFFFF))
            idlen = np.where(empty, np.uint32(0xFFFFFFFF), idlen)
            return np.stack([fp1.view(np.int32), fp2.view(np.int32),
                             idlen.view(np.int32),
                             np.zeros_like(fp1).view(np.int32)], axis=1)

        def slots(t: np.ndarray):
            tid = t[:, 3].astype(np.uint32)
            empty = tid == np.uint32(0xFFFFFFFF)
            return (np.where(empty, -1, tid.astype(np.int64)),
                    np.where(empty, 0, t[:, 2].astype(np.uint32)
                             .astype(np.int64)))

        ids1, lens1 = slots(tbl.t1)
        ids2, lens2 = slots(tbl.t2)
        assert tbl.vocab_size < (1 << 24), "id packing needs vocab < 16M"
        return DeviceTables.from_numpy(
            {"t1_fast": fast(tbl.t1), "t2_fast": fast(tbl.t2),
             "t1_exact": exact(tbl.t1), "t2_exact": exact(tbl.t2),
             "t_bucket": tbl.bk,
             "scores": scores64 if dtype == torch.float64 else tbl.scores,
             "slot_to_id": np.concatenate([ids1, ids2]),
             "slot_len": np.concatenate([lens1, lens2]),
             "bk_slot_to_id": tbl.bk_ids, "bk_slot_len": tbl.bk_lens},
            (tbl.bits, tbl.max_token_len, tbl.vocab_size, tbl.bk_bits,
             tbl.bk_salt), device)

    @staticmethod
    def from_numpy(arrays: Mapping[str, Optional[np.ndarray]], meta,
                   device) -> "DeviceTables":
        """Tables from host arrays: `arrays` holds t1_fast, t2_fast,
        t_bucket (or None / empty) and scores, and optionally the exact
        tables t1_exact and t2_exact and the host slot maps slot_to_id,
        slot_len, bk_slot_to_id and bk_slot_len; float64 scores stay
        float64 (the exact route's), any other become float32; the
        buckets' miss filter is derived from t_bucket on `device` where
        the kernel's filtered branch reads it (lattice_cuda_probe
        `has_filter`);
        `meta` is (bits, max_len, vocab_size, bk_bits, bk_salt). With the
        JAX DeviceTables fields turned into numpy, both packages run on the
        very same tables and fold counts through the same slot maps."""
        bits, max_len, vocab_size, bk_bits, bk_salt = meta

        def dev(a, dtype):
            return upload(np.array(a, copy=True),
                          device).to(dtype).contiguous()

        def host(name):
            a = arrays.get(name)
            return None if a is None else np.asarray(a, dtype=np.int64)

        tb = arrays.get("t_bucket")
        t_bucket = (dev(tb, torch.int32)
                    if tb is not None and np.size(tb) else None)

        def opt(name):
            a = arrays.get(name)
            return None if a is None else dev(a, torch.int32)

        return DeviceTables(
            t1_fast=dev(arrays["t1_fast"], torch.int32),
            t2_fast=dev(arrays["t2_fast"], torch.int32),
            scores=(dev(arrays["scores"], torch.float64)
                    if np.asarray(arrays["scores"]).dtype == np.float64
                    else dev(np.asarray(arrays["scores"], np.float32),
                             torch.float32)),
            bits=int(bits), max_len=int(max_len),
            vocab_size=int(vocab_size),
            t_bucket=t_bucket,
            bk_bits=int(bk_bits), bk_salt=int(bk_salt),
            slot_to_id=host("slot_to_id"), slot_len=host("slot_len"),
            bk_slot_to_id=host("bk_slot_to_id"),
            bk_slot_len=host("bk_slot_len"),
            t1_exact=opt("t1_exact"), t2_exact=opt("t2_exact"),
            bk_filter=(lcp.BucketFilter.of(t_bucket)
                       if t_bucket is not None
                       and lcp.has_filter(int(bk_bits)) else None),
        )

    @property
    def num_slots(self) -> int:
        return 2 * (1 << self.bits)

    @property
    def bk_num_slots(self) -> int:
        return 8 * (1 << self.bk_bits)


# The id word's length byte (len << 24) as int32, and an empty row's word.
_LEN_BITS = -(1 << 24)
_EMPTY_WORD = -1


@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    """A TokenTable's slot layout kept on the device, from which a
    vocabulary that `TokenTable.rebind` accepts is bound without uploading
    the tables again. Slots never move, so a binding changes only each
    table token's id (or removes it) and its score: `id_map` maps the new
    vocabulary's tokens to the table's ids on the host, and `bind` takes
    that map and the new scores and gathers every table word from the
    base's on the device. It writes fresh tensors, so a DeviceTables
    already handed out never changes under its holder. The words equal
    `DeviceTables.from_table(tbl.rebind(vocab))`'s bit for bit; the host
    slot maps, which no session route reads, are left out."""

    base: DeviceTables  # the table's own binding (`from_table`)
    # (2H,) int32 base id of each cuckoo slot (T1 then T2), n_ids where
    # empty; bk_ids the same per bucket slot, (8 Hb,)
    slot_ids: torch.Tensor
    bk_ids: Optional[torch.Tensor]
    n_ids: int  # the base vocabulary's size: the id map's empty entry
    # bytes -> base id of each token the table holds: the last of a
    # duplicated byte string, none empty or longer than max_len (`build`)
    ids: dict

    @staticmethod
    def of(tbl: TokenTable, device,
           dtype: torch.dtype = torch.float32) -> "ResidentLayout":
        base = DeviceTables.from_table(tbl, device, dtype)
        n = len(tbl.token_bytes)

        def ids(slot_to_id):
            # Only the occupied slots cross, and scatter on the device.
            occ = np.nonzero(slot_to_id >= 0)[0]
            out = torch.full(slot_to_id.shape, n, dtype=torch.int32,
                             device=device)
            out[upload(occ, device)] = upload(
                slot_to_id[occ].astype(np.int32), device)
            return out

        return ResidentLayout(
            base=base, slot_ids=ids(base.slot_to_id),
            bk_ids=(ids(base.bk_slot_to_id) if base.t_bucket is not None
                    else None),
            n_ids=n,
            ids={b: i for i, b in enumerate(tbl.token_bytes)
                 if 0 < len(b) <= tbl.max_token_len})

    def id_map(self, values: Sequence[bytes]) -> np.ndarray:
        """(n_ids + 1,) int64: the id that the tokens `values` give each
        base id, -1 where none of them has its bytes (and at n_ids, the
        empty slot's entry). As in `TokenTable.rebind`, a duplicated byte
        string takes its last id, a token the table would not hold (empty,
        or longer than max_len) maps nothing, and one it would hold but
        does not raises ValueError."""
        n = len(values)
        old = np.fromiter(map(self.ids.get, values, itertools.repeat(-1)),
                          dtype=np.int64, count=n)
        found = np.nonzero(old >= 0)[0]
        if found.size < n:
            # Every token the table holds is found, so only the others are
            # measured: one of 1 to max_len bytes among them is unknown.
            L = self.base.max_len
            missing = [values[i] for i in np.nonzero(old < 0)[0].tolist()
                       if 0 < len(values[i]) <= L]
            if missing:
                raise ValueError(
                    f"rebind: {len(set(missing))} tokens not in the "
                    f"original table (e.g. {missing[0]!r}); rebuild instead")
        lut = np.full(self.n_ids + 1, -1, dtype=np.int64)
        # The largest new id per base id: the last duplicate, whatever
        # order numpy writes repeated indices in.
        np.maximum.at(lut, old[found], found)
        return lut

    def bind(self, lut: np.ndarray, scores64: np.ndarray,
             dtype: torch.dtype) -> DeviceTables:
        """The tables of the vocabulary whose id map is `lut` (`id_map`)
        and whose per-id scores are `scores64` (f64), those at `dtype`."""
        base = self.base
        dev = base.t1_fast.device
        V = int(scores64.shape[0])
        assert V < (1 << 24), "id packing needs vocab < 16M"
        assert lut.shape == (self.n_ids + 1,) and lut[self.n_ids] == -1
        new_of = upload(lut.astype(np.int32), dev)
        s32 = upload(scores64.astype(np.float32), dev)
        # Score words by id, the empty sentinel at index V.
        words = torch.cat([s32.view(torch.int32),
                           upload([_NEG_SCORE_BITS], dev, torch.int32)])

        def slots(ids):
            """New ids of base slots (-1: removed or empty) and each one's
            score word."""
            nid = new_of[ids]
            alive = nid >= 0
            return nid, alive, words[torch.where(alive, nid, V)]

        H = 1 << base.bits
        nid, alive, score = slots(self.slot_ids)
        base_fast = torch.cat([base.t1_fast, base.t2_fast])
        fast = torch.stack([torch.where(alive, base_fast[:, 0], 0), score],
                           dim=1)
        exact = None
        if base.t1_exact is not None:
            base_exact = torch.cat([base.t1_exact, base.t2_exact])
            fps = torch.where(alive[:, None], base_exact[:, :2], 0)
            idlen = torch.where(alive, (base_exact[:, 2] & _LEN_BITS) | nid,
                                _EMPTY_WORD)
            exact = torch.cat([fps, idlen[:, None],
                               torch.zeros_like(idlen)[:, None]], dim=1)
        t_bucket = None
        if base.t_bucket is not None:
            _, _, bk_score = slots(self.bk_ids)
            t_bucket = torch.stack(
                [base.t_bucket[:, 0::2], bk_score.view(-1, 8)],
                dim=2).reshape(base.t_bucket.shape)
        scores = (upload(scores64, dev) if dtype == torch.float64
                  else s32)
        return DeviceTables(
            t1_fast=fast[:H], t2_fast=fast[H:], scores=scores,
            bits=base.bits, max_len=base.max_len, vocab_size=V,
            t_bucket=t_bucket, bk_bits=base.bk_bits, bk_salt=base.bk_salt,
            t1_exact=None if exact is None else exact[:H],
            t2_exact=None if exact is None else exact[H:],
            bk_filter=(lcp.BucketFilter.of(t_bucket)
                       if t_bucket is not None
                       and lcp.has_filter(base.bk_bits) else None))


def has_vscan(tbl: DeviceTables) -> bool:
    """True when the table is small enough for the fused probe route."""
    return tbl.bits <= VSCAN_MAX_BITS


# ---------------------------------------------------------------------------
# Batch preparation
# ---------------------------------------------------------------------------

_PREP_CONSTS: dict = {}
_CHAIN_CONSTS: dict = {}


def _consts_on(device, arrays) -> tuple:
    return tuple(upload(a, device) for a in arrays)


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


def prepare_batch_inputs(packed: PackedBatch, device):
    """Compact device inputs (~2 bytes per corpus byte): raw bytes and
    boundary flags, which a session caches across passes."""
    bytes_arr, flags = host_batch_inputs(packed)
    return upload(bytes_arr, device), upload(flags, device)


def prepare_batch(packed: PackedBatch, L: int, device) -> DeviceBatch:
    """Build the device-resident batch from a packed corpus view."""
    return prepare_batch_from_inputs(*prepare_batch_inputs(packed, device), L)


def prepare_batch_from_inputs(gbytes: torch.Tensor, gflags: torch.Tensor,
                              L: int) -> DeviceBatch:
    """Derive the full DeviceBatch from compact device inputs."""
    device = gbytes.device
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
    return prepare_chained_batch_from(
        upload(rows, device), upload(n_valid.astype(np.int32), device),
        upload(has_tail, device), L, W)


def prepare_chained_batch_from(rows: torch.Tensor, n_valid: torch.Tensor,
                               has_tail: torch.Tensor, L: int,
                               W: int) -> DeviceBatch:
    """`prepare_chained_batch` from its inputs already on the device:
    rows (B, L+W) uint8, n_valid (B,) int32, has_tail (B,) bool."""
    p1, p2, sid, is_start, is_end, end_index, rinv1, rinv2 = _chained_prep(
        rows, n_valid, has_tail, _chain_consts(W, L, rows.device), L, W)
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
    mode: str = "fast",  # "bucket" | "fast" ("em" is an alias) | "exact"
    end_indexed: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match arrays for global positions [start, start+n_pos).

    Returns (score, aux) of shape (B, L, n_pos), row j = token length
    l = j+1, score -inf where no token matches, at `dtype`. Start-indexed:
    column q describes the token BEGINNING at position start+q.
    End-indexed: the token ENDING at dp index start+q+1 (beginning at
    start+q-j).

    mode="bucket": one 16-word bucket row per probe, aux = the slot
    bucket*8+k; mode="fast": one (check, score) row per cuckoo table, T1
    first, aux = the slot idx1 or H + idx2. Misses get slot num_slots /
    bk_num_slots. mode="exact": one (fp1, fp2, len << 24 | id) row per
    cuckoo table (t1_exact, t2_exact), both fingerprints and the length
    checked, aux = the token id (-1 for a miss), the score gathered by id
    from the tables' scores (the f64 / exact conformance route).
    """
    if mode not in ("bucket", "fast", "em", "exact"):
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

    if mode == "exact":
        return _exact_probe(tbl, fp1, fp2, valid, lens, a1, a2, m1, m2,
                            dtype)

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
        return (torch.where(ok, score, neg).to(dtype),
                torch.where(ok, slot, tbl.bk_num_slots))

    shift = 32 - tbl.bits
    idx1 = H.srl_i32(H.mul_i32(fp1 ^ a1, m1), shift)
    idx2 = H.srl_i32(H.mul_i32(fp2 ^ a2, m2), shift)
    c1 = tbl.t1_fast[:, 0][idx1.long()]
    s1 = tbl.t1_fast[:, 1][idx1.long()].view(torch.float32)
    c2 = tbl.t2_fast[:, 0][idx2.long()]
    s2 = tbl.t2_fast[:, 1][idx2.long()].view(torch.float32)
    # Empty slots store check 0 with the sentinel score; a probe with
    # check 0 must fall through to t2, not mask its match.
    check = H.check_i32(fp1, fp2)
    match1 = (c1 == check) & (s1 > -1.0e38) & valid
    match2 = (c2 == check) & (s2 > -1.0e38) & valid
    score = torch.where(match1, s1, torch.where(match2, s2, neg))
    score = torch.where(score <= -1.0e38, neg, score)
    slot = torch.where(match1, idx1,
                       torch.where(match2, idx2 + (1 << tbl.bits),
                                   tbl.num_slots))
    slot = torch.where(score > -1.0e38, slot, tbl.num_slots)
    return score.to(dtype), slot.to(torch.int32)


def _exact_probe(tbl: DeviceTables, fp1, fp2, valid, lens, a1, a2, m1, m2,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_match_slab`'s exact mode: a T1 or T2 row matches when it holds
    both fingerprints and the length (its word 2 shifted right logically
    by 24); the id is word 2's low 24 bits, T1 first; the score is
    gathered by id at `dtype`, -inf for a miss."""
    if tbl.t1_exact is None or tbl.t2_exact is None:
        raise ValueError("the exact probe needs the tables' exact rows "
                         "(DeviceTables.from_table makes them)")
    shift = 32 - tbl.bits
    idx1 = H.srl_i32(H.mul_i32(fp1 ^ a1, m1), shift).long()
    idx2 = H.srl_i32(H.mul_i32(fp2 ^ a2, m2), shift).long()
    ids = torch.full(fp1.shape, -1, dtype=torch.int32, device=fp1.device)
    for t, idx in ((tbl.t2_exact, idx2), (tbl.t1_exact, idx1)):
        row = t[idx]  # (..., 4); T1 last, so that it wins
        hit = ((row[..., 0] == fp1) & (row[..., 1] == fp2)
               & (H.srl_i32(row[..., 2], 24) == lens))
        ids = torch.where(hit, row[..., 2] & 0xFFFFFF, ids)
    ids = torch.where(valid, ids, -1)
    found = ids >= 0
    score = torch.where(found, tbl.scores[ids.clamp(min=0).long()],
                        torch.tensor(NEG_INF, dtype=tbl.scores.dtype,
                                     device=fp1.device)).to(dtype)
    return score, ids


def _probe_mode(tbl: DeviceTables, dtype: Optional[torch.dtype] = None
                ) -> str:
    """The probe a table and float type resolve to: exact for float64,
    else bucket where the table has the buckets, else fast."""
    if dtype == torch.float64:
        return "exact"
    return "bucket" if tbl.t_bucket is not None else "fast"


def match_cache(
    tbl: DeviceTables,
    batch: DeviceBatch,
    C: int = 512,
    probe: Optional[str] = None,
    lead: int = 0,
    slots: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Probe the whole batch once: start-indexed (score, slot), each
    (lead + W, L, B) in the kernels' slab layout (positions major, rows
    minor), so that `forward` and `backward_expected` share one probe.
    Column lead + p, row j describes the token of length j+1 beginning at
    position p (the first `lead` <= pad columns the tokens beginning in
    the left pad: a chained window's tail); -inf score and slot = the
    miss index where nothing matches. slots=False keeps the scores only
    (slot None). The cache holds no dropout: its readers draw the coins.
    Scores are at `dtype` (float32 by default); float64 resolves the
    exact probe, whose slots are token ids (-1 for a miss).

    CUDA tensors launch csrc/match_probe.cu once on the current stream
    (ops/lattice_cuda_probe.py `match_probe`); CPU tensors run
    `match_cache_plain`, its twin, in chunks of C positions."""
    if batch.width % C:
        raise ValueError(f"chunk {C} does not divide width {batch.width}")
    dtype = dtype or torch.float32
    mode = probe or _probe_mode(tbl, dtype)
    if not lcp.check_probe(tbl, batch, mode, lead, dtype):
        return match_cache_plain(tbl, batch, C, mode, lead, slots, dtype)
    return lcp.match_probe(tbl, batch, mode, lead, slots, dtype)


def match_cache_plain(
    tbl: DeviceTables,
    batch: DeviceBatch,
    C: int = 512,
    probe: Optional[str] = None,
    lead: int = 0,
    slots: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`match_cache` in plain torch ops on any device: `_match_slab` over
    chunks of C positions (the first `lead` positions one chunk), each
    permuted into the (lead + W, L, B) caches. The twin the kernel is
    held against bit for bit."""
    B = batch.p1.shape[0]
    W = batch.width
    L = tbl.max_len
    if W % C:
        raise ValueError(f"chunk {C} does not divide width {W}")
    if not 0 <= lead <= batch.pad:
        raise ValueError(f"lead {lead} outside 0..{batch.pad}")
    dtype = dtype or torch.float32
    mode = probe or _probe_mode(tbl, dtype)
    dev = batch.p1.device
    score = torch.empty((lead + W, L, B), dtype=dtype, device=dev)
    slot = (torch.empty((lead + W, L, B), dtype=torch.int32, device=dev)
            if slots else None)
    spans = [(cs, C) for cs in range(0, W, C)]
    if lead:
        spans.insert(0, (-lead, lead))
    for cs, n in spans:
        s, a = _match_slab(tbl, batch, cs, n, L, mode=mode, dtype=dtype)
        score[lead + cs : lead + cs + n] = s.permute(2, 1, 0)
        if slots:
            slot[lead + cs : lead + cs + n] = a.permute(2, 1, 0)
    return score, slot


def _dropout_keep_window(drop_u: torch.Tensor, dropout: float, L: int,
                         pad: int, start: int, span: int) -> torch.Tensor:
    """(span, L, B) keep-mask for start positions [start, start+span) of a
    dropout-free `match_cache` cache: the coins of `_match_slab`'s
    dropout (keyed on the token's start position, mixed per length)."""
    dev = drop_u.device
    base = drop_u[:, pad + start : pad + start + span].t()[:, None, :]
    odd = _len_mix(L, lcf._ODD, dev)[None, :, None]
    u = H.srl_i32(H.mul_i32(base, odd), 1)
    lens = torch.arange(1, L + 1, device=dev)[None, :, None]
    return ~((u < lcf.dropout_threshold_half(dropout)) & (lens > 1))


# Positions per segment of the whole-width scans: each row's chains start
# at the first sample boundary or padding byte at or after every multiple
# of it.
SCAN_SEGMENT = 1024


def chain_bounds(batch: DeviceBatch, segment: int = SCAN_SEGMENT
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K+1, B) int32 chain bounds of the forward and the backward scans,
    K = ceil(W / segment): row k of the forward's is the first sample
    start or padding byte at or after k * segment, of the backward's the
    first sample end or padding byte (W where there is none); row 0 is 0
    and row K is W. Chain k covers [bounds[k], bounds[k+1]). The probe
    masks every token that crosses a sample boundary or covers a padding
    byte, so chains cut there give the one-chain-per-row DP bit for bit;
    padding (an empty row, a row's tail) cuts every segment, and a sample
    longer than a segment keeps its chain running. Pass-invariant: a
    session builds them once per group."""
    W = batch.width
    B = batch.p1.shape[0]
    dev = batch.p1.device
    K = max(1, -(-W // segment))
    idx = torch.arange(W, dtype=torch.int32, device=dev)
    cols = torch.arange(1, K, device=dev) * segment

    def bounds(flag: torch.Tensor) -> torch.Tensor:
        marked = torch.where(flag, idx[None, :], W).to(torch.int32)
        nxt = torch.cummin(marked.flip(1), dim=1).values.flip(1)
        return torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                          nxt[:, cols],
                          torch.full((B, 1), W, dtype=torch.int32,
                                     device=dev)], dim=1).t().contiguous()

    outside = batch.sid[:, batch.pad : batch.pad + W] < 0
    return (bounds(batch.is_start[:, :W] | outside),
            bounds(batch.is_end[:, :W] | outside))


def _scan_drop(drop_u: Optional[torch.Tensor], dropout: float) -> dict:
    """The scans' dropout arguments: the words in their (position, row)
    layout and the rate, or none."""
    if drop_u is None or dropout <= 0.0:
        return {}
    return {"du": drop_u.t().contiguous(), "dropout": dropout}


# ---------------------------------------------------------------------------
# Viterbi drivers
# ---------------------------------------------------------------------------


def _hist0(batch: DeviceBatch, L: int, carry,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L) initial history: hist[:, j] = dp[-j]; rows whose carry mask
    is set take the previous window's last L dp values bit-exactly."""
    B = batch.p1.shape[0]
    dev = batch.p1.device
    hist0 = torch.full((B, L), NEG_INF, dtype=dtype, device=dev)
    hist0[:, 0] = torch.where(batch.is_start[:, 0], 0.0, NEG_INF)
    if carry is not None:
        mask, carry_hist = carry
        hist0 = torch.where(mask[:, None], carry_hist.to(dtype), hist0)
    return hist0


def _finish(dp: torch.Tensor) -> torch.Tensor:
    return torch.where(dp <= NEG * 0.5, NEG_INF, dp)


def _scan_viterbi(
    tbl: DeviceTables,
    batch: DeviceBatch,
    drop_u: Optional[torch.Tensor] = None,
    dropout: float = 0.0,
    probe: Optional[str] = None,
    carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    timer: Optional[PhaseTimer] = None,
    cache: Optional[torch.Tensor] = None,
    chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    C: int = 512,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab route: probe the group once, start-indexed and without
    dropout (scores only, at `dtype`; `cache`, a start-indexed (W, L, B)
    score cache, skips the probe), then run `viterbi_scan` once over the
    whole width,
    the rows cut into chains by the forward bounds of `chains`
    (`chain_bounds`, made here when not given), drawing the dropout coins
    in the kernel. carry = (mask (B,), hist0 (B, L)) chains the DP across
    fixed-width windows of one long sample (prepare_chained_batch): it is
    chain 0's history, and the cache then also holds the L tokens
    starting in the carried tail. Returns dp (B, W) f32 (-inf where
    unreachable) and best_l (B, W)."""
    L = tbl.max_len
    lead = 0
    if cache is None:
        lead = L if carry is not None else 0
        with phase(timer, "probe"):
            cache = match_cache(tbl, batch, C, probe, lead=lead,
                                slots=False, dtype=dtype)[0]
    with phase(timer, "kernel"):
        if chains is None:
            chains = chain_bounds(batch)
        dp, best_l = lc.viterbi_scan(
            cache, batch.is_start[:, 1:].t().to(cache.dtype).contiguous(),
            _hist0(batch, L, carry, cache.dtype).clamp(min=NEG).t()
            .contiguous(), chains[0], pad=batch.pad, lead=lead,
            **_scan_drop(drop_u, dropout))
    return _finish(dp.t()), best_l.t()


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
    kind: str = "viterbi",
    chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Fused route: fingerprints, probe and DP in one kernel over the
    whole row width, its rows cut into chains by the forward bounds of
    `chains` (`chain_bounds`, made here when not given). Semantics
    identical to the slab route: (dp, best_l) for Viterbi, the forward
    values A (B, W+1) with A[:, 0] prepended for log-sum-exp."""
    use_drop = drop_u is not None and dropout > 0.0
    with phase(timer, "prep"):
        args = fused_inputs(tbl, batch, drop_u, dropout, carry)
        seg = (chains if chains is not None else chain_bounds(batch))[0]
    with phase(timer, "kernel" if kind == "viterbi" else "forward"):
        dp, best_l, _, _ = lcf.fused_forward_chunk(
            kind, *args, L=tbl.max_len, bits=tbl.bits, pad=batch.pad,
            dropout=dropout if use_drop else 0.0, seg=seg)
    if kind == "viterbi":
        return _finish(dp.t()), best_l.t()
    a0 = torch.where(batch.is_start[:, :1], 0.0, NEG_INF)
    return torch.cat([a0, _finish(dp.t())], dim=1)


def _check_fused_backend(tbl: DeviceTables, cache) -> None:
    if not has_vscan(tbl):
        raise ValueError("fused backend needs bits <= VSCAN_MAX_BITS")
    if cache is not None:
        raise ValueError("the fused backend probes in-kernel: no cache")


def viterbi(tbl: DeviceTables, batch: DeviceBatch, C: int = 256,
            dtype=None, drop_u=None, dropout: float = 0.0,
            backend: str = "slab", probe: Optional[str] = None,
            carry=None, timer: Optional[PhaseTimer] = None,
            chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """dp scores + backpointers for the packed batch.

    Returns (dp, best_l), each (B, W), indexed by dp index p-1.
    backend "slab" probes the group once (in chunks of C positions) and
    runs `viterbi_scan` over it; "fused" runs the fused probe kernel
    (tables with has_vscan only; f32 and the fast probe only). Both cut
    the rows into chains by `chains` (`chain_bounds`, made here when not
    given). `carry` chains windows of long samples (see _scan_viterbi).
    dtype float64 (the f64 / exact route) takes the exact probe and the
    double `viterbi_scan`; probe "exact" alone gathers f32 scores by id."""
    if backend == "fused" and (dtype == torch.float64 or probe == "exact"):
        raise ValueError("the fused kernels are f32 with the fast probe: "
                         "the f64 / exact route takes backend='slab'")
    if backend == "fused":
        _check_fused_backend(tbl, None)
        return _scan_forward_fused(tbl, batch, drop_u, dropout, carry, timer,
                                   chains=chains)
    if backend != "slab":
        raise ValueError(f"unknown backend {backend!r}")
    return _scan_viterbi(tbl, batch, drop_u, dropout, probe, carry, timer,
                         chains=chains, C=C, dtype=dtype)


def forward(tbl: DeviceTables, batch: DeviceBatch,
            cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            C: int = 512, drop_u: Optional[torch.Tensor] = None,
            dropout: float = 0.0, timer: Optional[PhaseTimer] = None,
            backend: str = "slab",
            chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> torch.Tensor:
    """EM forward pass: A (B, W+1), the log-probability of all
    segmentations of each prefix of its sample, -inf where no path
    reaches (reference: src/lattice.rs:245-312). backend "slab" runs
    `forward_scan` once over the whole width of the `match_cache` result
    `cache`, its rows cut into chains by `chains` (`chain_bounds`, made
    here when not given; C is unused); "fused" probes inside the fused
    kernel (tables with has_vscan only; no cache), its rows cut by
    `chains` too."""
    if backend == "fused":
        _check_fused_backend(tbl, cache)
        return _scan_forward_fused(tbl, batch, drop_u, dropout, timer=timer,
                                   kind="logsumexp", chains=chains)
    if backend != "slab":
        raise ValueError(f"unknown backend {backend!r}")
    if cache is None:
        raise ValueError("the slab backend reads a match_cache cache")
    ft = cache[0].dtype
    with phase(timer, "forward"):
        if chains is None:
            chains = chain_bounds(batch)
        a = lc.forward_scan(
            cache[0], batch.is_start[:, 1:].t().to(ft).contiguous(),
            _hist0(batch, tbl.max_len, None, ft).clamp(min=NEG).t()
            .contiguous(), chains[0], pad=batch.pad,
            **_scan_drop(drop_u, dropout))
        a = _finish(a.t())
    a0 = torch.where(batch.is_start[:, :1], 0.0, NEG_INF).to(ft)
    return torch.cat([a0, a], dim=1)


# Scratch bins past the last slot that take the probe misses (marginal 0).
MISS_BINS = 4096


def _marginal_inputs(batch: DeviceBatch, A: torch.Tensor, L: int):
    """The marginal scan's (W, B) a, z and ends and its (L, B) history
    for a batch and its forward values A (B, W+1)."""
    W = batch.width
    # Per-position normaliser z[p] = A[end of the sample holding p].
    z = torch.gather(A, 1, batch.end_index.long())
    z = torch.where(torch.isfinite(z) & (z > -1e37), z, 0.0)
    # A[p] at a boundary holds the PREVIOUS sample's total; tokens
    # starting at p belong to the next sample, whose forward value is the
    # post-reset 0.
    a = torch.where(batch.is_start[:, :W], 0.0, A[:, :W]).clamp(min=NEG)
    ends = batch.is_end[:, :W].t().to(A.dtype).contiguous()
    # hist[j] = beta[p + 1 + j]; a token ending exactly at W sees beta[W]
    # = 0 when a sample ends there.
    return (a.t().contiguous(), z.t().contiguous(), ends,
            lcf.betas_hist0(batch.is_end[:, W], L, A.dtype))


def backward_expected(
    tbl: DeviceTables,
    batch: DeviceBatch,
    A: torch.Tensor,
    cache: Tuple[torch.Tensor, torch.Tensor],
    C: int = 512,
    drop_u: Optional[torch.Tensor] = None,
    dropout: float = 0.0,
    probe: Optional[str] = None,
    nbins: Optional[int] = None,
    timer: Optional[PhaseTimer] = None,
    chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Expected-count accumulator: the marginals
    exp(A[p] + score + beta[p+l] - z) of every matched token occurrence,
    added into its probe slot (reference: src/lattice.rs:245-312).
    `backward_marginal_scan` walks the whole width of the `match_cache`
    result `cache` once, its rows cut into chains by the backward bounds
    of `chains` (`chain_bounds`, made here when not given), drawing the
    dropout coins itself (a masked or dropped token's marginal is 0); A is
    `forward`'s result over the same cache and dropout words. The
    marginals are added into the bins C positions at a time, which bounds
    the scatter's index temporaries, with the slots read in the order the
    kernel lays the marginals out, (position, row, length). Returns a
    (nbins,) slot-indexed tensor at the cache's float type (bucket slots
    in "bucket" mode, cuckoo slots in "fast" mode, token ids in "exact"
    mode, the f64 route's; the session passes slots remapped to ranks and
    nbins the rank space's). Fold token ids to per-token counts with
    `fold_expected`, ranks with `fold_expected_rank`."""
    B = batch.p1.shape[0]
    W = batch.width
    L = tbl.max_len
    if W % C:
        raise ValueError(f"chunk {C} does not divide width {W}")
    mode = probe or _probe_mode(tbl, cache[0].dtype)
    if mode == "exact":
        nbins = tbl.vocab_size
    elif nbins is None:
        nbins = tbl.bk_num_slots if mode == "bucket" else tbl.num_slots
    dev = A.device
    with phase(timer, "backward"):
        if chains is None:
            chains = chain_bounds(batch)
        marg, _ = lc.backward_marginal_scan(
            cache[0], *_marginal_inputs(batch, A, L), chains[1],
            pad=batch.pad, **_scan_drop(drop_u, dropout))
    with phase(timer, "scatter"):
        acc = torch.zeros(nbins + MISS_BINS, dtype=marg.dtype, device=dev)
        # Most probe points miss; sending every miss to one address would
        # serialise the atomic adds there, so they spread over scratch
        # bins.
        spread = nbins + (torch.arange(C * L * B, dtype=torch.int32,
                                       device=dev) & (MISS_BINS - 1))
        marg = marg.transpose(1, 2)  # the kernel's (W, B, L) memory
        for cs in range(0, W, C):
            bins = cache[1][cs : cs + C].transpose(1, 2).reshape(-1)
            bins = torch.where((bins >= nbins) | (bins < 0), spread, bins)
            acc.index_add_(0, bins, marg[cs : cs + C].reshape(-1))
    return acc[:nbins]


def fused_bwd_inputs(tbl: DeviceTables, batch: DeviceBatch,
                     drop_u: Optional[torch.Tensor] = None,
                     dropout: float = 0.0):
    """Positional arguments of `lattice_cuda_fused.fused_backward_chunk`
    for one batch, in its (position, row) layout."""
    use_drop = drop_u is not None and dropout > 0.0
    return (tbl.t1_fast, tbl.t2_fast,
            batch.p1.t().contiguous(), batch.p2.t().contiguous(),
            batch.rinv1, batch.rinv2, batch.sid.t().contiguous(),
            batch.is_start.t().to(torch.uint8).contiguous(),
            batch.is_end.t().to(torch.uint8).contiguous(),
            drop_u.t().contiguous() if use_drop else None)


def backward_betas(tbl: DeviceTables, batch: DeviceBatch,
                   cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   C: int = 512, drop_u: Optional[torch.Tensor] = None,
                   dropout: float = 0.0, timer: Optional[PhaseTimer] = None,
                   backend: str = "slab",
                   chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """(B, W+1) log-betas per dp index, post sample-end reset (0 at a
    sample end), -inf where no path reaches: the backward recurrence of
    `backward_expected` without marginals (reference:
    src/lattice.rs:245-312 backward_scores). Bt[:, W] is 0 where a
    sample ends at the width. backend "slab" runs `backward_betas_scan`
    once over the whole width of the `match_cache` result `cache`, its
    rows cut into chains by `chains` (`chain_bounds`, made here when not
    given; C is unused); "fused" runs `fused_backward_chunk` over the
    whole width, its rows cut the same way (tables with has_vscan only; no
    cache). Feeds `segsum_expected`."""
    W = batch.width
    L = tbl.max_len
    use_drop = drop_u is not None and dropout > 0.0
    bW = torch.where(batch.is_end[:, W], 0.0, NEG_INF)[:, None]
    if backend == "fused":
        _check_fused_backend(tbl, cache)
        with phase(timer, "prep"):
            args = fused_bwd_inputs(tbl, batch, drop_u, dropout)
            if chains is None:
                chains = chain_bounds(batch)
        with phase(timer, "backward"):
            bt = lcf.fused_backward_chunk(
                *args, L=L, bits=tbl.bits, pad=batch.pad,
                dropout=dropout if use_drop else 0.0, seg=chains[1])
        return torch.cat([_finish(bt.t()), bW], dim=1)
    if backend != "slab":
        raise ValueError(f"unknown backend {backend!r}")
    if cache is None:
        raise ValueError("the slab backend reads a match_cache cache")
    with phase(timer, "backward"):
        if chains is None:
            chains = chain_bounds(batch)
        out = lc.backward_betas_scan(
            cache[0], batch.is_end[:, :W].t().to(torch.float32).contiguous(),
            lcf.betas_hist0(batch.is_end[:, W], L), chains[1], pad=batch.pad,
            **_scan_drop(drop_u, dropout))
    return torch.cat([_finish(out.t()), bW], dim=1)


# ---------------------------------------------------------------------------
# Dense rank space: a vocabulary-sized remap of the sparse probe slots
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankSpace:
    """Dense remap of the bucket probe's sparse slot space (~16x the
    vocabulary: 8 slots per bucket at mean load <= 0.5).

    Slots never move while a vocabulary shrinks (TokenTable.rebind), so a
    session remaps each group's cached slots ONCE through a static lut
    into [0, n): rank r = the r-th occupied slot of the session's initial
    table, miss -> n_pad. Every later pass gathers scores from an
    (n_pad + 1,) rank-indexed column and adds counts into (n_pad,) bins."""

    lut: np.ndarray  # (bk_num_slots + 1,) int32: slot -> rank; miss -> n_pad
    occ: np.ndarray  # (n,) int64 occupied slots, ascending
    n_pad: int       # pow2 >= n; the rank-space miss sentinel


def build_rank_space(tbl: TokenTable) -> RankSpace:
    """Rank space of a host TokenTable's bucket layout (the f32 default
    probe). Build from the session's initial table: rebinds only empty
    slots out, so the initial occupancy covers every later binding."""
    assert tbl.bk is not None, "rank space requires the bucket layout"
    nbins = 8 * (1 << tbl.bk_bits)
    occ = np.nonzero(tbl.bk_ids >= 0)[0]
    n = int(occ.size)
    n_pad = max(16, 1 << (max(n, 1) - 1).bit_length())
    lut = np.full(nbins + 1, n_pad, dtype=np.int32)
    lut[occ] = np.arange(n, dtype=np.int32)
    return RankSpace(lut=lut, occ=occ, n_pad=n_pad)


_NEG_INF_BITS = int(np.array([NEG_INF], np.float32).view(np.int32)[0])


def rank_score_rows(rank: RankSpace, tbl: DeviceTables) -> torch.Tensor:
    """(n_pad + 1,) int32 f32-score bits per rank of `tbl`'s binding, read
    from its device buckets (bucket slot s holds its score at word
    2 s + 1), the -inf miss sentinel last (and on unused ranks). Removed
    tokens' slots carry the empty sentinel (<= -1e38), which
    `score_from_slots` maps to -inf. The JAX package packs this x16 above
    2^17 ranks, a layout for the TPU's gather engine; the per-rank values
    are these."""
    dev = tbl.t_bucket.device
    col = torch.full((rank.n_pad + 1,), _NEG_INF_BITS, dtype=torch.int32,
                     device=dev)
    col[: rank.occ.size] = tbl.t_bucket.view(-1)[
        upload(2 * rank.occ + 1, dev)]
    return col


def slot_score_rows(tbl: DeviceTables) -> torch.Tensor:
    """(num_slots + 1,) int32 f32-score bits per probe slot of the default
    probe (bucket when the table has it, else the two cuckoo tables), the
    -inf miss sentinel last."""
    neg = upload([_NEG_INF_BITS], tbl.t1_fast.device, torch.int32)
    if tbl.t_bucket is not None:
        return torch.cat([tbl.t_bucket[:, 1::2].reshape(-1), neg])
    return torch.cat([tbl.t1_fast[:, 1], tbl.t2_fast[:, 1], neg])


def rows_nbins(score_rows: torch.Tensor) -> int:
    """Bin count of a score column: one trailing miss entry."""
    return int(score_rows.shape[0]) - 1


def rank_to_ids(rank: RankSpace, tbl: TokenTable) -> np.ndarray:
    """(n,) CURRENT token id per rank (-1 for rebind-removed tokens)."""
    return np.asarray(tbl.bk_ids[rank.occ], dtype=np.int64)


def remap_slots(lut: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Probe slots -> ranks through the (bk_num_slots + 1,) lut; paid once
    per (session, group)."""
    return lut[slots.long()]


def fold_expected_rank(acc, rank_ids: np.ndarray,
                       vocab_size: int) -> np.ndarray:
    """Fold a rank-indexed count accumulator to per-token counts (V,) f64
    on the host."""
    if isinstance(acc, torch.Tensor):
        acc = acc.detach().cpu().numpy()
    acc = np.asarray(acc, dtype=np.float64)
    n = rank_ids.shape[0]
    expected = np.zeros(vocab_size, dtype=np.float64)
    valid = rank_ids >= 0
    np.add.at(expected, rank_ids[valid], acc[:n][valid])
    return expected


def score_from_slots(score_rows: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """Current scores for a cached slot (or rank) array of any shape: one
    gather per element from the score column, and scores <= -1e38 (empty
    or removed slots, the miss sentinel) -> -inf, as the probe gives."""
    s = score_rows[slots.long()].view(torch.float32)
    return torch.where(s <= -1.0e38, NEG_INF, s)


# ---------------------------------------------------------------------------
# Scatter-free expected counts: SegStruct + segsum
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegStruct:
    """Per-length sorted-hit structure for scatter-free EM counts, built
    ONCE per row group from the session's cached (dropout-free) slots;
    the (position, length) -> slot matching is static while the
    vocabulary only shrinks. Hits are flat positions b * W + w of the
    (B, W) plane of one length. Per length row l0 (token length l0+1):

      perm:     L-tuple of (cap_l,) int32, flat positions sorted by slot
                (stable), truncated to a pow2 capacity >= the hit count;
                misses (slot == nbins) sort to the tail
      pre_pos:  (L, OC) int32 over the occurring slots: sorted index just
                before the slot's segment, or cap_l when it starts at 0
                (and for pad entries)
      end_pos:  (L, OC) int32, index of the segment's last element, cap_l
                for pad entries
      n_hit:    L host ints, the real hits per length
      occ_slot: (L, OC) int32, the slots occurring at this length,
                ascending, padded with nbins
      blk_slot: L-tuple of (cap_l / SEG_BLK,) int32, slot of the hit at
                each block start (nbins past the hits)

    The lengths' perm and blk_slot lie end to end in perm_flat and
    blk_flat (the tuples are views of them), so that one launch reads
    every length; meta (2L+1,) int32, on the device, holds each length's
    first block (L+1 entries, the last the block count) and then its hit
    count (`lattice_cuda_seg.seg_weights_gather`). Two more arrays, which
    the JAX package's SegStruct has not, serve the port's kernels:

      blk_occ:  (H / SEG_BLK,) int32, per block of blk_flat the entry o of
                its length whose segment holds the block's first hit (the
                first o with end_pos >= the block's start; OC past them)
      nxt:      (L, OC) int32, the entries of one slot across lengths: >= 0
                the slot's first entry (its shortest length), which occurs
                again at flat entry l0 * OC + o = nxt; -1 its first and
                only entry; -2 a pad, or a later entry that is the slot's
                last; <= -3 a later entry, the slot occurring again at
                -3 - nxt. One token has one length, so a slot occurs at a
                second only through a hash false positive of the probe.
    """

    perm: tuple
    pre_pos: torch.Tensor
    end_pos: torch.Tensor
    n_hit: tuple
    occ_slot: torch.Tensor
    blk_slot: tuple
    perm_flat: torch.Tensor
    blk_flat: torch.Tensor
    meta: torch.Tensor
    blk_occ: torch.Tensor
    nxt: torch.Tensor

    def nbytes(self) -> int:
        return 4 * (sum(int(p.numel()) for p in self.perm)
                    + int(self.pre_pos.numel()) + int(self.end_pos.numel())
                    + int(self.occ_slot.numel())
                    + sum(int(b.numel()) for b in self.blk_slot)
                    + int(self.blk_occ.numel()) + int(self.nxt.numel()))

    @staticmethod
    def est_bytes(B: int, L: int, W: int) -> int:
        # perm dominates: 4 B per (position, length) before compaction.
        return L * B * W * 4


def seg_cap(n_hit: int) -> int:
    """Pow2-quantized per-length hit capacity."""
    cap = SEG_BLK
    while cap < n_hit:
        cap *= 2
    return cap


def build_seg_struct(slots: torch.Tensor, nbins: int) -> SegStruct:
    """Sort each length plane of a cached (W, L, B) slot (or rank) array
    by slot, stably, in the JAX package's flat order (b * W + w), so the
    structure equals its `build_seg_struct` field for field. One host
    sync per build, for the per-length hit and occupancy counts."""
    W, L, B = slots.shape
    BW = B * W
    dev = slots.device
    flat = slots.permute(1, 2, 0).reshape(L, BW)
    srt, perm = torch.sort(flat, dim=1, stable=True)
    grid = torch.arange(nbins + 1, dtype=srt.dtype, device=dev)
    ss = torch.searchsorted(srt, grid.expand(L, -1).contiguous())
    present = ss[:, 1:] > ss[:, :-1]
    counts = torch.cat([ss[:, nbins], present.sum(dim=1)]).tolist()
    n_hit, n_occ = counts[:L], counts[L:]
    OC = max(8, 1 << (max(max(n_occ), 1) - 1).bit_length())
    caps = [min(seg_cap(n), BW) for n in n_hit]
    occ2, pre2, end2 = [], [], []
    for l0, cap in enumerate(caps):
        pre = torch.where(present[l0] & (ss[l0, :-1] > 0),
                          torch.clamp(ss[l0, :-1] - 1, max=cap), cap)
        end = torch.where(present[l0], torch.clamp(ss[l0, 1:] - 1, max=cap),
                          cap)
        sent = torch.full((1,), cap, dtype=pre.dtype, device=dev)
        occ = torch.nonzero(present[l0]).reshape(-1)
        occ = torch.cat([occ, occ.new_full((OC - occ.numel(),), nbins)])
        occ2.append(occ.to(torch.int32))
        pre2.append(torch.cat([pre, sent])[occ].to(torch.int32))
        end2.append(torch.cat([end, sent])[occ].to(torch.int32))
    perm_flat = torch.cat([perm[l0, :cap] for l0, cap in enumerate(caps)]
                          ).to(torch.int32)
    blk_flat = torch.cat([torch.clamp(srt[l0, :cap:SEG_BLK], max=nbins)
                          for l0, cap in enumerate(caps)]).to(torch.int32)
    nblk = [cap // SEG_BLK for cap in caps]
    boff = np.concatenate([[0], np.cumsum(nblk)]).tolist()
    occ_slot, end_pos = torch.stack(occ2), torch.stack(end2)
    # Ends ascend with o (pads, at the cap, last).
    blk_occ = torch.cat([torch.searchsorted(
        end_pos[l0], torch.arange(0, cap, SEG_BLK, dtype=torch.int32,
                                  device=dev)) for l0, cap in enumerate(caps)])
    return SegStruct(perm=torch.split(perm_flat, caps),
                     pre_pos=torch.stack(pre2), end_pos=end_pos,
                     n_hit=tuple(n_hit), occ_slot=occ_slot,
                     blk_slot=torch.split(blk_flat, nblk),
                     perm_flat=perm_flat, blk_flat=blk_flat,
                     meta=upload(boff + list(n_hit), dev, torch.int32),
                     blk_occ=blk_occ.to(torch.int32),
                     nxt=_slot_chains(occ_slot, end_pos, caps))


def _slot_chains(occ_slot: torch.Tensor, end_pos: torch.Tensor,
                 caps) -> torch.Tensor:
    """SegStruct.nxt: each slot's real entries in ascending length."""
    L, OC = occ_slot.shape
    cap = upload(caps, end_pos.device, end_pos.dtype)
    ent = torch.nonzero((end_pos != cap[:, None]).reshape(-1)).reshape(-1)
    # A stable sort by slot keeps each slot's entries in ascending length.
    order = torch.sort(occ_slot.reshape(-1)[ent], stable=True)
    ent = ent[order.indices]
    again = order.values[1:] == order.values[:-1]
    has_next = torch.cat([again, again.new_zeros(1)])
    first = torch.cat([again.new_ones(1), ~again])
    after = torch.cat([ent[1:], ent.new_zeros(1)])
    val = torch.where(first, torch.where(has_next, after, -1),
                      torch.where(has_next, -3 - after, -2))
    nxt = torch.full((L * OC,), -2, dtype=torch.int64, device=end_pos.device)
    nxt[ent] = val
    return nxt.view(L, OC).to(torch.int32)


def segsum_expected(tbl: DeviceTables, batch: DeviceBatch, A: torch.Tensor,
                    Bt: torch.Tensor, seg: SegStruct,
                    score_rows: torch.Tensor,
                    drop_u: Optional[torch.Tensor] = None,
                    dropout: float = 0.0,
                    timer: Optional[PhaseTimer] = None) -> torch.Tensor:
    """Scatter-free expected counts over a group's sorted hits: the same
    (nbins,) accumulator as `backward_expected` (reference:
    src/lattice.rs:245-312), nbins = rows_nbins(score_rows).

    Two launches a group (csrc/seg_weights.cu): `seg_weights_gather` takes
    every length's hits at once, gathers each hit's alpha - Z and beta in
    sorted order, expands the score term over the sorted hits from the
    (nbins,) score vector by telescoping differences between consecutive
    occurring slots plus one anchor per block, and takes the in-block scans
    of the TRUE marginal exp(A + score + beta - Z) in [0, 1]; `seg_sums`
    makes each slot's count from the scans of its segment. Factoring
    exp(score) out of the sum let a rare token sharing a block with
    e^40-scale neighbours lose its whole count to rounding."""
    nbins = rows_nbins(score_rows)
    use_drop = drop_u is not None and dropout > 0.0
    with phase(timer, "segsum"):
        cf, t, mid, acc = seg_weights_gather(
            seg, A, batch.end_index, batch.is_start, Bt, score_rows,
            drop_u if use_drop else None,
            dropout=dropout if use_drop else 0.0, pad=batch.pad)
        acc = seg_sums(seg, cf, t, mid, acc)
    return acc[:nbins]


# ---------------------------------------------------------------------------
# The session's composite ops
# ---------------------------------------------------------------------------


def estep_cached(tbl: DeviceTables, batch: DeviceBatch, slots: torch.Tensor,
                 score_rows: torch.Tensor, seg: Optional[SegStruct] = None,
                 C: int = 512, drop_u: Optional[torch.Tensor] = None,
                 dropout: float = 0.0, timer: Optional[PhaseTimer] = None,
                 chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(A, expected-count accumulator) for a group whose (W, L, B) slots
    (or ranks) are cached: scores re-gathered per cached slot, the forward
    scan, then the betas scan and `segsum_expected` when `seg` is given,
    else `backward_expected` into the bins of `score_rows`. `chains` are
    the group's `chain_bounds` (made here when not given)."""
    with phase(timer, "regather"):
        cache = (score_from_slots(score_rows, slots), slots)
    if chains is None:
        chains = chain_bounds(batch)
    A = forward(tbl, batch, cache, C, drop_u, dropout, timer, chains=chains)
    if seg is not None:
        Bt = backward_betas(tbl, batch, cache, C, drop_u, dropout, timer,
                            chains=chains)
        return A, segsum_expected(tbl, batch, A, Bt, seg, score_rows,
                                  drop_u, dropout, timer)
    return A, backward_expected(tbl, batch, A, cache, C, drop_u, dropout,
                                nbins=rows_nbins(score_rows), timer=timer,
                                chains=chains)


def estep_fused(tbl: DeviceTables, batch: DeviceBatch, seg: SegStruct,
                score_rows: torch.Tensor, drop_u: Optional[torch.Tensor] = None,
                dropout: float = 0.0, timer: Optional[PhaseTimer] = None,
                chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(A, expected-count accumulator) with the probe fused into both
    scans (tables with has_vscan only) and the counts from the group's
    SegStruct. `chains` are the group's `chain_bounds` (made here when not
    given)."""
    if chains is None:
        chains = chain_bounds(batch)
    A = forward(tbl, batch, drop_u=drop_u, dropout=dropout, timer=timer,
                backend="fused", chains=chains)
    Bt = backward_betas(tbl, batch, drop_u=drop_u, dropout=dropout,
                        timer=timer, backend="fused", chains=chains)
    return A, segsum_expected(tbl, batch, A, Bt, seg, score_rows, drop_u,
                              dropout, timer)


def viterbi_cached(tbl: DeviceTables, batch: DeviceBatch,
                   slots: torch.Tensor, score_rows: torch.Tensor,
                   timer: Optional[PhaseTimer] = None,
                   chains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(dp, best_l) for a group whose slots are cached: scores re-gathered
    per cached slot, then `viterbi_scan` once over the whole width, its
    rows cut by `chains` (`chain_bounds`, made here when not given)."""
    with phase(timer, "regather"):
        cache = score_from_slots(score_rows, slots)
    return _scan_viterbi(tbl, batch, timer=timer, cache=cache, chains=chains)


def pick_span_values_device(A: torch.Tensor, rows_idx,
                            ends_idx) -> torch.Tensor:
    """A[rows_idx[k], ends_idx[k]] per span, left on A's device."""
    r = upload(np.asarray(rows_idx, np.int64), A.device)
    e = upload(np.asarray(ends_idx, np.int64), A.device)
    return A[r, e]


def fold_expected(acc: torch.Tensor) -> np.ndarray:
    """An exact-mode `backward_expected` accumulator, indexed by token id
    already, as per-token counts (V,) f64 on the host (the f64 session's
    fold; a rank-indexed accumulator folds by `fold_expected_rank`)."""
    return acc.detach().cpu().numpy().astype(np.float64)


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


# ---------------------------------------------------------------------------
# Backpointer walk on the device
# ---------------------------------------------------------------------------

# Segment length of the walk's decomposition (csrc/viterbi_walk.cu): at
# least twice the longest token (MAX_LEN = 64).
WALK_SEGMENT = 256


@dataclasses.dataclass(frozen=True)
class WalkIndex:
    """A row group's spans, indexed once for `viterbi_walk`: the (n,)
    int32 rows, starts and ends in the caller's order (dp indices); the
    non-empty spans of rows in [0, B) sorted by (row, start) (`order`) with
    each row's range in it (`row_ptr`, (B + 1,)); int64 copies of the rows
    and of the end cells for picking span-end dp values; the spans'
    lengths on the host (`lengths`, int64 numpy); and `cap`, an upper
    bound of the tokens (one per byte of the spans clamped into [0, W]),
    the length of the flat id buffer."""

    rows: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    order: torch.Tensor
    row_ptr: torch.Tensor
    rows_l: torch.Tensor
    last: torch.Tensor
    nonempty: torch.Tensor
    lengths: np.ndarray
    cap: int
    B: int
    W: int

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    def dp_ends(self, dp: torch.Tensor) -> torch.Tensor:
        """The dp value at each span's end (its last cell)."""
        return dp[self.rows_l, self.last]


def walk_index(spans, B: int, W: int, device) -> WalkIndex:
    """Index packed spans (5-tuples, (row, start, end) triples or an (n, 3)
    array) of a (B, W) row group for `viterbi_walk`, on `device`; made
    once per group by its owner (DeviceCorpus, the session)."""
    sp = np.asarray([s[:3] for s in spans] if not isinstance(spans, np.ndarray)
                    else spans[:, :3], dtype=np.int64).reshape(-1, 3)
    r, s, e = sp[:, 0], sp[:, 1], sp[:, 2]
    live = np.nonzero((e > s) & (r >= 0) & (r < B))[0]
    order = live[np.lexsort((s[live], r[live]))]
    row_ptr = np.searchsorted(r[order], np.arange(B + 1))
    ce = np.clip(e, 0, W)
    cs = np.clip(s, 0, None)
    t = upload(sp.astype(np.int32), device)

    def dev(a, dtype):
        return upload(np.ascontiguousarray(a).astype(dtype), device)

    return WalkIndex(
        rows=t[:, 0].contiguous(), starts=t[:, 1].contiguous(),
        ends=t[:, 2].contiguous(), order=dev(order, np.int32),
        row_ptr=dev(row_ptr, np.int32), rows_l=dev(np.clip(r, 0, None),
                                                    np.int64),
        last=dev(np.maximum(e - 1, 0), np.int64), nonempty=dev(e > s, bool),
        lengths=e - s, cap=int(np.maximum(ce - np.minimum(cs, ce), 0).sum()),
        B=B, W=W)


def _walk_probe(bl: torch.Tensor, p1, p2, rinv1, rinv2, t1, t2,
                pos: torch.Tensor, bits: int, pad: int,
                V: int) -> torch.Tensor:
    """Ids of the tokens ending at flat positions `pos` (b * W + p) of the
    (B, W) backpointers, by the exact probe (lattice_jax.py
    `_viterbi_freq_impl`): fingerprints over the token's span on both hash
    streams, T1's row if its fp1, fp2 and length match, else T2's, else V."""
    W = bl.shape[1]
    r = pos // W
    e = pos % W + 1
    l = bl[r, e - 1].clamp(min=1)
    st = e - l
    fp1 = H.mul_i32(H.sub_i32(p1[r, pad + e], p1[r, pad + st]),
                    rinv1[pad + st])
    fp2 = H.mul_i32(H.sub_i32(p2[r, pad + e], p2[r, pad + st]),
                    rinv2[pad + st])
    l32 = l.to(torch.int32)
    shift = 32 - bits
    i1 = H.srl_i32(H.mul_i32(fp1 ^ H.mul_i32(l32, int(H.IDX_A1)),
                             int(H.IDX_M1)), shift)
    i2 = H.srl_i32(H.mul_i32(fp2 ^ H.mul_i32(l32, int(H.IDX_A2)),
                             int(H.IDX_M2)), shift)
    e1, e2 = t1[i1.long()], t2[i2.long()]

    def hit(row: torch.Tensor) -> torch.Tensor:
        return ((row[:, 0] == fp1) & (row[:, 1] == fp2)
                & (H.srl_i32(row[:, 2], 24) == l32))

    return torch.where(hit(e1), e1[:, 2] & 0xFFFFFF,
                       torch.where(hit(e2), e2[:, 2] & 0xFFFFFF, V))


def _positions_in_order(span: torch.Tensor, from_end: torch.Tensor,
                        pos: torch.Tensor, ntok: torch.Tensor
                        ) -> torch.Tensor:
    """Recorded tokens (span, index from the span's end, flat position)
    into one (total,) buffer, span after span, each in position order."""
    incl = torch.cumsum(ntok.long(), 0)
    out = torch.empty(int(incl[-1]) if incl.numel() else 0,
                      dtype=torch.int64, device=pos.device)
    out[incl[span] - 1 - from_end] = pos
    return out


def walk_positions_plain(best_l: torch.Tensor, index: WalkIndex,
                         ok: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step-by-step walk: every span whose `ok` flag is set steps back
    from its end together, one vectorised step per token of the longest
    span. Returns each token's end as a flat position b * W + p, span after
    span in the index's span order and in position order within a span,
    and the (n,) int32 tokens per span."""
    B, W = best_l.shape
    dev = best_l.device
    flat_bl = best_l.to(torch.int64).reshape(-1).clamp(min=1)
    r, s, e = index.rows.long(), index.starts.long(), index.ends.long()
    ntok = torch.zeros(index.n, dtype=torch.int32, device=dev)
    idx = torch.nonzero((e > s) & ok.bool()).flatten()
    cur = r * W + e - 1  # the cell of the next token's end
    stop = r * W + s
    spans, from_end, pos = [], [], []
    while idx.numel():
        c = cur[idx]
        spans.append(idx)
        from_end.append(ntok[idx].long())
        pos.append(c)
        ntok[idx] += 1
        cur[idx] = c - flat_bl[c]
        idx = idx[cur[idx] >= stop[idx]]
    if not spans:
        return torch.zeros(0, dtype=torch.int64, device=dev), ntok
    return (_positions_in_order(torch.cat(spans), torch.cat(from_end),
                                torch.cat(pos), ntok), ntok)


def walk_positions_segmented(best_l: torch.Tensor, index: WalkIndex,
                             ok: torch.Tensor, max_len: int,
                             segment: int = WALK_SEGMENT
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain emulation of csrc/viterbi_walk.cu's decomposition, with the
    same outputs as `walk_positions_plain`:

      (a) the exit tables: from every entry t < max_len of every segment
          (g S, g S + S], walk down to the first node <= g S; record the
          exit offset and the tokens;
      (b) the composition: from each span's end, a segment whose bottom
          lies at or above the span's start and that is entered at one of
          its top max_len nodes is crossed by one table lookup (and
          recorded with its real entry and the tokens before it); any
          other piece is walked step by step down to the segment's bottom
          or the span's start;
      (c) the recorded segments walked again from their real entries.

    The CPU tests hold it against the step-by-step walk."""
    B, W = best_l.shape
    L, S = int(max_len), int(segment)
    dev = best_l.device
    bl = best_l.to(torch.int64).clamp(min=1)
    NS = -(-W // S)
    rowsel = torch.arange(B, device=dev)[:, None]
    # (a) One (B, NS * L) walk; an entry above W is never entered.
    g = torch.arange(NS, device=dev).repeat_interleave(L)
    lo = (g * S)[None, :].expand(B, -1)
    q = (lo + S - torch.arange(L, device=dev).repeat(NS)).clone()
    q = torch.where(q > W, lo, q)
    tn = torch.zeros_like(q)
    while True:
        live = q > lo
        if not bool(live.any()):
            break
        step = bl[rowsel, (q - 1).clamp(min=0)]
        q = torch.where(live, q - step, q)
        tn += live
    tx = lo - q

    # (b) The composition, one step or one table lookup per iteration.
    r, s, e = index.rows.long(), index.starts.long(), index.ends.long()
    ntok = torch.zeros(index.n, dtype=torch.int64, device=dev)
    qs = e.clone()
    direct_to = e.clone()  # a piece walked step by step stops here
    tokens = ([], [], [])  # span, index from the end, position
    segs = ([], [], [])  # span, real entry, tokens before it
    act = torch.nonzero((e > s) & ok.bool()).flatten()
    while act.numel():
        qa, sa, ra = qs[act], s[act], r[act]
        ga = (qa - 1) // S
        la = ga * S
        ta = la + S - qa
        cont = qa > direct_to[act]
        tab = ~cont & (la >= sa) & (ta < L)
        start = ~cont & ~tab
        direct_to[act[start]] = torch.maximum(la, sa)[start]
        # Table lookups.
        k = act[tab]
        if k.numel():
            j = ga[tab] * L + ta[tab]
            for lst, v in zip(segs, (k, qa[tab], ntok[k])):
                lst.append(v)
            ntok[k] += tn[ra[tab], j]
            qs[k] = la[tab] - tx[ra[tab], j]
        # Steps.
        step = cont | start
        k = act[step]
        if k.numel():
            qk = qa[step]
            for lst, v in zip(tokens, (k, ntok[k], ra[step] * W + qk - 1)):
                lst.append(v)
            qs[k] = qk - bl[ra[step], qk - 1]
            ntok[k] += 1
        act = act[qs[act] > s[act]]

    # (c) The recorded segments, from their real entries.
    if segs[0]:
        k, qk, nb = (torch.cat(v) for v in segs)
        lo_k = ((qk - 1) // S) * S
        while k.numel():
            for lst, v in zip(tokens, (k, nb, r[k] * W + qk - 1)):
                lst.append(v)
            qk = qk - bl[r[k], qk - 1]
            nb = nb + 1
            go = qk > lo_k
            k, qk, nb, lo_k = k[go], qk[go], nb[go], lo_k[go]
    ntok = ntok.to(torch.int32)
    if not tokens[0]:
        return torch.zeros(0, dtype=torch.int64, device=dev), ntok
    return (_positions_in_order(*(torch.cat(v) for v in tokens), ntok),
            ntok)


def viterbi_walk_plain(best_l, p1, p2, rinv1, rinv2, t1_exact, t2_exact,
                       index: WalkIndex, *, ok, bits: int, pad: int,
                       vocab_size: int, max_len: Optional[int] = None,
                       ids: bool = False):
    """The twin of `viterbi_walk`: the step-by-step walk
    (`walk_positions_plain`), then every token's id at once. `max_len`,
    the kernel's table reach, does not enter the plain walk."""
    pos, ntok = walk_positions_plain(best_l, index, ok)
    tid = _walk_probe(best_l.to(torch.int64), p1, p2, rinv1, rinv2,
                      t1_exact, t2_exact, pos, bits, pad, vocab_size)
    if not ids:
        return torch.bincount(tid, minlength=vocab_size + 1).to(torch.int32)
    flat = torch.zeros(index.cap, dtype=torch.int32, device=best_l.device)
    flat[: tid.numel()] = tid.to(torch.int32)
    return flat, ntok, torch.cumsum(ntok, 0, dtype=torch.int32)


def viterbi_walk(best_l, p1, p2, rinv1, rinv2, t1_exact, t2_exact,
                 index: WalkIndex, *, ok, bits: int, pad: int,
                 vocab_size: int, max_len: int, ids: bool = False):
    """Walk the backpointers of every span of `index` whose `ok` flag is
    set (whole samples, the non-empty spans of a row disjoint) from its end
    to its start and resolve each token's id with the exact tables.

    best_l (B, W) uint8 / int8 / int32, any strides, values at most
    max_len (the longest token; a larger value walks correctly but
    slowly); p1, p2 (B, pad + W + 1 + pad) int32 prefix hashes and rinv1,
    rinv2 (pad + W,) int32, as in DeviceBatch; t1_exact, t2_exact (H, 4)
    int32 (DeviceTables); index the group's `walk_index`; ok (n,) bool,
    False for spans not to walk (unreachable ends). Count mode returns
    (V + 1,) int32 token counts, bin V counting tokens no table row matches
    (a model/table mismatch). ids=True returns a (index.cap,) int32 buffer
    whose first ntok.sum() entries are the spans' ids (V for a token no
    table row matches), span after span in the index's span order, each
    in position order, the rest 0, ntok (n,) int32 and
    incl (n,) int32, the inclusive cumsum of ntok (span k's ids at
    [incl[k] - ntok[k], incl[k])).

    CUDA tensors launch csrc/viterbi_walk.cu on the current stream, with
    segments of WALK_SEGMENT positions: a tiled copy of best_l to (B, W)
    bytes when a row's elements are not adjacent, then the walk (count
    mode: one launch; ids mode: a launch for the token counts, one cumsum
    for the offsets and a launch for the ids). `viterbi_walk.launches`
    counts every kernel launch, `viterbi_walk.calls` every call that
    launched. CPU tensors run `viterbi_walk_plain`."""
    lc._check(best_l.dim() == 2, "best_l must be (B, W)")
    lc._check(best_l.dtype in (torch.uint8, torch.int8, torch.int32),
              f"best_l must be uint8, int8 or int32, got {best_l.dtype}")
    B, W = best_l.shape
    n = index.n
    named = {"p1": p1, "p2": p2, "rinv1": rinv1, "rinv2": rinv2,
             "t1_exact": t1_exact, "t2_exact": t2_exact, "rows": index.rows,
             "starts": index.starts, "ends": index.ends,
             "order": index.order, "row_ptr": index.row_ptr}
    for name, t in named.items():
        lc._check(t.dtype == torch.int32, f"{name} must be int32")
        lc._check(t.device == best_l.device, f"{name} is on {t.device}")
    lc._check((index.B, index.W) == (B, W) and
              tuple(index.row_ptr.shape) == (B + 1,),
              f"the walk index is of a ({index.B}, {index.W}) group, "
              f"best_l is {(B, W)}")
    lc._check(tuple(p1.shape) == (B, 2 * pad + W + 1) and
              p2.shape == p1.shape, f"p1, p2 must be {(B, 2 * pad + W + 1)}")
    lc._check(tuple(rinv1.shape) == (pad + W,) and rinv2.shape == rinv1.shape,
              f"rinv1, rinv2 must be {(pad + W,)}")
    lc._check(t1_exact.dim() == 2 and t1_exact.shape[1] == 4 and
              t2_exact.shape == t1_exact.shape and
              t1_exact.shape[0] == 1 << bits,
              f"exact tables must be ({1 << bits}, 4)")
    lc._check(tuple(ok.shape) == (n,) and ok.device == best_l.device,
              f"ok must be ({n},) on {best_l.device}")
    lc._check(1 <= max_len <= lc.MAX_LEN,
              f"max_len {max_len} outside 1..{lc.MAX_LEN}")
    kw = dict(bits=bits, pad=pad, vocab_size=vocab_size, ok=ok, ids=ids)
    if best_l.device.type == "cpu":
        if n:
            lc._check(bool(((index.rows >= 0) & (index.rows < B)
                             & (index.starts >= 0)
                             & (index.starts <= index.ends)
                             & (index.ends <= W)).all()),
                      "spans outside the (B, W) batch")
        return viterbi_walk_plain(best_l, p1, p2, rinv1, rinv2, t1_exact,
                                  t2_exact, index, **kw)
    lc._check(best_l.device.type == "cuda",
              f"unsupported device {best_l.device}")
    lc._check(W < 0xFFFF, f"width {W} beyond the walk's 65,534")
    for name, t in named.items():
        lc._check(t.is_contiguous(), f"{name} must be contiguous")
    dev = best_l.device
    ok8 = (ok if ok.dtype == torch.bool and ok.is_contiguous()
           else ok.to(torch.uint8).contiguous())
    live = index.order.numel() > 0 and B > 0
    if live and best_l.stride(1) != 1:
        # A row's backpointers lie apart (the Viterbi kernels' (W, B)
        # layout): one tiled pass makes them (B, W) bytes, which every
        # block then stages with 16-byte loads.
        rows = torch.empty((B, W), dtype=torch.uint8, device=dev)
        lc._launch("walk_rows", best_l, rows, best_l.stride(0),
                   best_l.stride(1), best_l.element_size(), B, W)
        viterbi_walk.launches += 1
        best_l = rows
    if live:
        viterbi_walk.calls += 1
    args = (best_l, p1, p2, rinv1, rinv2, t1_exact, t2_exact,
            index.row_ptr, index.order, index.starts, index.ends, ok8)
    shape = (best_l.stride(0), best_l.stride(1), best_l.element_size(), B,
             W, p1.stride(0), pad, bits, vocab_size, max_len, WALK_SEGMENT)
    if not ids:
        counts = torch.zeros(vocab_size + 1, dtype=torch.int32, device=dev)
        if live:
            lc._launch("viterbi_walk", *args, counts, None, None, None,
                       None, *shape, 0)
            viterbi_walk.launches += 1
        return counts
    ntok = torch.zeros(n, dtype=torch.int32, device=dev)
    flat = torch.zeros(index.cap, dtype=torch.int32, device=dev)
    if live:
        # The first launch leaves each row's exit tables for the second.
        tabs = torch.empty(B * 4 * -(-W // WALK_SEGMENT) * max_len,
                           dtype=torch.uint8, device=dev)
        lc._launch("viterbi_walk", *args, None, ntok, None, None, tabs,
                   *shape, 1)
        incl = torch.cumsum(ntok, 0, dtype=torch.int32)
        lc._launch("viterbi_walk", *args, None, ntok, incl, flat, tabs,
                   *shape, 2)
        viterbi_walk.launches += 2
    else:
        incl = torch.zeros(n, dtype=torch.int32, device=dev)
    return flat, ntok, incl


viterbi_walk.launches = 0
viterbi_walk.calls = 0


def exact_tables(tbl: DeviceTables) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t1_exact, t2_exact), the rows the walks resolve ids with."""
    if tbl.t1_exact is None or tbl.t2_exact is None:
        raise ValueError("the tables carry no exact rows (t1_exact, "
                         "t2_exact): build them with DeviceTables.from_table")
    return tbl.t1_exact, tbl.t2_exact


def _walk_tables(tbl: DeviceTables, batch: DeviceBatch) -> tuple:
    return ((batch.p1, batch.p2, batch.rinv1, batch.rinv2,
             *exact_tables(tbl)),
            {"bits": tbl.bits, "pad": batch.pad,
             "vocab_size": tbl.vocab_size, "max_len": tbl.max_len})


def walk_counts(tbl: DeviceTables, batch: DeviceBatch, best_l: torch.Tensor,
                index: WalkIndex, ok: torch.Tensor) -> torch.Tensor:
    """(V + 1,) int32 Viterbi counts of the spans' tokens on the device
    (`viterbi_walk`, count mode); bin V counts mismatches."""
    args, kw = _walk_tables(tbl, batch)
    return viterbi_walk(best_l, *args, index, ok=ok, **kw)


def walk_ids(tbl: DeviceTables, batch: DeviceBatch, dp: torch.Tensor,
             best_l: torch.Tensor, index: WalkIndex,
             timer: Optional[PhaseTimer] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Token ids of the spans of `index` (the group's `walk_index`), in
    its order, walked on the device: the counterpart of `backtrack` that
    reads back only the span-end dp values, the per-span token counts and
    the flat id buffer the walk writes. Returns the flat int32 ids and the
    (n,) int64 tokens per span, -1 for an unreachable non-empty span (0
    for an empty one); the caller splits them (estep_device._place_ids)."""
    if index.n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    flat, ntok, _, dead = walk_ids_device(tbl, batch, dp, best_l, index,
                                          timer=timer)
    with phase(timer, "readback"):
        dead_h = dead.cpu().numpy()
        ntok_h = ntok.cpu().numpy().astype(np.int64)
        flat = flat[: int(ntok_h.sum())].cpu().numpy()
    ntok_h[dead_h] = -1
    return flat, ntok_h


def walk_ids_device(tbl: DeviceTables, batch: DeviceBatch, dp: torch.Tensor,
                    best_l: torch.Tensor, index: WalkIndex,
                    timer: Optional[PhaseTimer] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The walk of `walk_ids` with nothing read back (merge's pair count
    keeps the ids on the device): (flat, ntok, incl, dead), flat the
    (index.cap,) int32 ids, ntok the (n,) int32 tokens per span, incl
    their inclusive cumsum (the ids launch's own offsets) and dead (n,)
    bool, a non-empty span whose end dp is not finite (not walked: no
    path)."""
    with phase(timer, "walk"):
        finite = torch.isfinite(index.dp_ends(dp))
        args, kw = _walk_tables(tbl, batch)
        flat, ntok, incl = viterbi_walk(
            best_l, *args, index, ok=finite & index.nonempty, ids=True,
            **kw)
    return flat, ntok, incl, index.nonempty & ~finite


# ---------------------------------------------------------------------------
# The chained windows' walk on the device
# ---------------------------------------------------------------------------


def backpointer_bytes(best_l: torch.Tensor, out: torch.Tensor) -> None:
    """A window's backpointers best_l (B, W), uint8 / int8 / int32 with any
    strides (the Viterbi kernels' (W, B) layout), into `out`, a contiguous
    (B, W) uint8 tensor on its device: on the card one launch of
    csrc/viterbi_walk.cu's tiled copy (counted in `chained_walk.launches`),
    on the CPU a copy."""
    lc._check(best_l.dim() == 2 and tuple(out.shape) == tuple(best_l.shape)
              and out.dtype == torch.uint8 and out.is_contiguous()
              and out.device == best_l.device,
              "out must be a contiguous uint8 tensor of best_l's shape "
              "and device")
    lc._check(best_l.dtype in (torch.uint8, torch.int8, torch.int32),
              f"best_l must be uint8, int8 or int32, got {best_l.dtype}")
    if best_l.device.type != "cuda":
        out.copy_(best_l)
        return
    B, W = best_l.shape
    if B and W:
        lc._launch("walk_rows", best_l, out, best_l.stride(0),
                   best_l.stride(1), best_l.element_size(), B, W)
        chained_walk.launches += 1


def _window_index(nwin: torch.Tensor, NW: int):
    """(win0, wsample) int32 of a flat window list: each sample's first
    window (the exclusive cumsum of nwin) and each window's sample."""
    nw = nwin.long()
    win0 = torch.cumsum(nw, 0) - nw
    wsample = torch.repeat_interleave(
        torch.arange(nw.numel(), device=nw.device), nw, output_size=NW)
    return win0.to(torch.int32), wsample.to(torch.int32)


def chained_walk_plain(bl, rows, nwin, last_n, ok, t1_exact, t2_exact, *,
                       bits: int, vocab_size: int, cap: int):
    """The twin of `chained_walk`: the windows k of every sample from the
    last, the spans (0, entry] of the samples walked there, by the segment
    decomposition's plain emulation (`walk_positions_segmented`); a
    window's leftmost token gives the next window's entry, and every
    token's id comes from the window's hash streams, made from its bytes
    (`_walk_probe`)."""
    NW, W = bl.shape
    L = rows.shape[1] - W
    dev = bl.device
    nw = nwin.long()
    win0 = _window_index(nwin, NW)[0].long()
    live = ok.bool() & (nw > 0)
    ntok = torch.zeros(NW, dtype=torch.int32, device=dev)
    bad = torch.zeros(nw.numel(), dtype=torch.bool, device=dev)
    entry = last_n.long().clone()
    pow1, pow2, rinv1, rinv2 = _chain_consts(W, L, dev)
    parts = []
    K = int(nw.max()) if nw.numel() else 0
    for k in range(K - 1, -1, -1):
        rs = torch.nonzero(live & (nw > k)).flatten()
        if not rs.numel():
            continue
        win = win0[rs] + k
        n = rs.numel()
        blk = bl[win].to(torch.int64)
        spans = np.stack([np.arange(n), np.zeros(n, np.int64),
                          entry[rs].cpu().numpy()], 1)
        index = walk_index(spans, n, W, dev)
        pos, nt = walk_positions_segmented(
            blk, index, torch.ones(n, dtype=torch.bool, device=dev), L)
        # The leftmost token [q - l, q) of each span: the walk enters the
        # window before at W + q - l.
        first = pos[torch.cumsum(nt.long(), 0) - nt.long()]
        q = first % W + 1
        entry[rs] = W + q - blk.reshape(-1)[first].clamp(min=1)
        ntok[win] = nt
        b32 = rows[win].to(torch.int32)
        ids = _walk_probe(blk, _prefix_hashes(b32, pow1),
                          _prefix_hashes(b32, pow2), rinv1, rinv2, t1_exact,
                          t2_exact, pos, bits, L, vocab_size)
        span_of = torch.repeat_interleave(torch.arange(n, device=dev),
                                          nt.long())
        bad[rs[span_of[ids >= vocab_size]]] = True
        parts.append((win, nt.long(), ids))
    incl = torch.cumsum(ntok.long(), 0)
    flat = torch.zeros(cap, dtype=torch.int32, device=dev)
    for win, nt, ids in parts:
        # Window w's ids go to [incl[w] - ntok[w], incl[w]).
        shift = incl[win] - torch.cumsum(nt, 0)
        flat[torch.repeat_interleave(shift, nt)
             + torch.arange(ids.numel(), device=dev)] = ids.to(torch.int32)
    return flat, ntok, bad


def chained_walk(bl, rows, nwin, last_n, ok, t1_exact, t2_exact, *,
                 bits: int, vocab_size: int, cap: int):
    """Token ids of the samples scanned in chained windows, walked across
    their windows on the device (csrc/viterbi_walk.cu `tgx_chained_walk`).

    The windows form one flat list, the windows of sample after sample:
    sample r's window k is window win0[r] + k, win0 the exclusive cumsum of
    nwin, so a sample pays for its own windows alone. bl (NW, W) uint8,
    each window's backpointers (`backpointer_bytes`), values at most L;
    rows (NW, L + W) uint8, the windows' rows [the previous window's last
    L bytes | body] (`prepare_chained_batch`); nwin (R,) int32 the windows
    of each sample, summing to NW (not checked on the card, where the sum
    would wait for the queue); last_n (R,) int32 the body bytes of its last
    window; ok (R,) bool, False for a sample not to walk (an unreachable
    end); t1_exact, t2_exact (H, 4) int32, H = 2^bits (DeviceTables); cap
    at least the tokens (the samples' bytes). Returns flat (cap,) int32,
    every sample's ids in order, sample after sample, each in position
    order (V for a token no table row holds), the rest 0; ntok (NW,) int32,
    the tokens ending in each window (so sample r's ids are the sum of its
    windows' after those of the samples before it); bad (R,) bool, True
    where a sample's ids hold V.

    CUDA tensors launch csrc/viterbi_walk.cu on the current stream: the
    entries (a block a sample crosses its windows from the last by their
    exit tables), one cumsum, and the ids (a block a window), counted in
    `chained_walk.launches`; nothing is read back. CPU tensors run
    `chained_walk_plain`."""
    lc._check(bl.dim() == 2 and bl.dtype == torch.uint8,
              "bl must be (NW, W) uint8")
    NW, W = bl.shape
    L = rows.shape[1] - W if rows.dim() == 2 else 0
    lc._check(rows.dtype == torch.uint8 and rows.shape[0] == NW
              and 1 <= L <= lc.MAX_LEN,
              f"rows must be ({NW}, L + {W}) uint8, L in 1..{lc.MAX_LEN}")
    named = {"nwin": nwin, "last_n": last_n, "t1_exact": t1_exact,
             "t2_exact": t2_exact}
    for name, t in named.items():
        lc._check(t.dtype == torch.int32, f"{name} must be int32")
    for name, t in dict(named, rows=rows, ok=ok).items():
        lc._check(t.device == bl.device, f"{name} is on {t.device}")
    R = nwin.shape[0] if nwin.dim() == 1 else -1
    lc._check(R >= 0 and tuple(last_n.shape) == (R,)
              and tuple(ok.shape) == (R,), "nwin, last_n, ok must be (R,)")
    lc._check(t1_exact.dim() == 2 and t1_exact.shape[1] == 4 and
              t2_exact.shape == t1_exact.shape and
              t1_exact.shape[0] == 1 << bits,
              f"exact tables must be ({1 << bits}, 4)")
    kw = dict(bits=bits, vocab_size=vocab_size, cap=cap)
    if bl.device.type == "cpu":
        lc._check(int(nwin.sum()) == NW, f"nwin must sum to {NW} windows")
        return chained_walk_plain(bl, rows, nwin, last_n, ok, t1_exact,
                                  t2_exact, **kw)
    lc._check(bl.device.type == "cuda", f"unsupported device {bl.device}")
    lc._check(W < 0xFFFF, f"width {W} beyond the walk's 65,534")
    for name, t in dict(named, bl=bl, rows=rows).items():
        lc._check(t.is_contiguous(), f"{name} must be contiguous")
    dev = bl.device
    ok8 = ok.to(torch.uint8).contiguous()
    ntok = torch.zeros(NW, dtype=torch.int32, device=dev)
    flat = torch.zeros(cap, dtype=torch.int32, device=dev)
    bad = torch.zeros(R, dtype=torch.uint8, device=dev)
    if NW and R:
        win0, wsample = _window_index(nwin, NW)
        entry = torch.empty(NW, dtype=torch.int32, device=dev)
        tabs = torch.empty(NW * 4 * -(-W // WALK_SEGMENT) * L,
                           dtype=torch.uint8, device=dev)
        shape = (NW, R, W, L, bits, vocab_size, WALK_SEGMENT)
        lc._launch("chained_walk", bl, rows, nwin, win0, None, last_n, ok8,
                   None, None, entry, ntok, None, None, None, tabs, *shape, 0)
        incl = torch.cumsum(ntok, 0, dtype=torch.int32)
        lc._launch("chained_walk", bl, rows, None, None, wsample, None, ok8,
                   t1_exact, t2_exact, entry, ntok, incl, flat, bad, tabs,
                   *shape, 1)
        chained_walk.launches += 2
    return flat, ntok, bad.bool()


chained_walk.launches = 0
