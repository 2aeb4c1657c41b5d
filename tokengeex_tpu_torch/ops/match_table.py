"""Cuckoo-hashed token table: the TPU-native vocabulary index.

Replaces the reference's byte trie + per-position prefix search
(reference: src/trie.rs:22-64, src/model.rs:34-55) with a dense,
gather-friendly structure: two hash tables T1/T2 of packed rows
[fp1, fp2, len, id]; a substring matches the vocabulary iff one of its
two candidate slots carries both 32-bit fingerprints and the length.
Lookup is exactly 2 row-gathers per (position, length) pair, with no
data-dependent control flow — ideal for XLA/Pallas.

Collision guarantees, enforced by construction in `TokenTable.build`:

  - Exact probe (the walk's id lookup, the f64 route): distinct
    vocabulary tokens with identical (fp1, fp2, len) triples (~2^-64 per
    pair) are detected and rejected with an error -- they would be
    indistinguishable to every probe.
  - Fast probe (1 row gather per table, checking the 32-bit check word
    `hashing.host_check(fp1, fp2)` = fp2 ^ rotl(fp1, 16)): a token stored
    in t2 whose t1 slot holds another token with the same check word
    (but another fp2) would be silently "shadowed" -- scored and counted
    as the t1 occupant (~2^-32 per co-slotted pair). Build detects it by
    probing every vocabulary token through an exact emulation of the
    device probe and repairs it by pinning the whole (t1 slot, check
    word) cluster into t2 (each member then resolves at its own t2 slot
    because the t1 check always misses), re-verifying until every token
    resolves to itself.

Corpus substrings not in the vocabulary can still falsely match the fast
probe, with ~2^-32 probability per probe of an occupied slot. That is
one-off statistical noise, unlike vocabulary shadowing, which would bias
every occurrence of a token for the whole run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.types import ScoredToken
from . import hashing as H


class CuckooBuildError(RuntimeError):
    pass


@dataclasses.dataclass
class TokenTable:
    """Host/device representation of a vocabulary for matching."""

    t1: np.ndarray  # (H, 4) int32 rows: fp1, fp2, len, id (id == -1 empty)
    t2: np.ndarray  # (H, 4) int32
    bits: int  # log2(H)
    scores: np.ndarray  # (V,) float32 log-prob scores
    scores_f64: np.ndarray  # (V,) float64
    max_token_len: int  # L: longest token in bytes
    vocab_size: int
    token_bytes: Optional[list] = None  # bytes per id (enables rebind)
    # Single-probe bucket structure (the fast path): 8-way buckets as
    # x16 rows [check0, score0, ..., check7, score7]; one row gather
    # resolves a probe. Built with a salt retried until no bucket
    # overflows 8 entries and no two entries in a bucket share fp2.
    bk: Optional[np.ndarray] = None  # (Hb, 16) int32
    bk_ids: Optional[np.ndarray] = None  # (Hb * 8,) int64 ids, -1 empty
    bk_lens: Optional[np.ndarray] = None  # (Hb * 8,) int64
    bk_bits: int = 0
    bk_salt: int = 0

    def rebind(self, vocab: Sequence[ScoredToken]) -> "TokenTable":
        """Bind the SAME slot layout to a new vocabulary whose token set
        is a subset of the one this table was built from (EM rescoring
        and prune-round removals only rescore/remove tokens). Slots
        never move, so device probe caches keyed on slots stay valid
        across passes and rounds; removed tokens become empty slots
        (the probe falls through past them). Raises on tokens the
        original table never contained."""
        assert self.token_bytes is not None, "built without token_bytes"
        new_of = {}
        for i, t in enumerate(vocab):
            if 0 < len(t.value) <= self.max_token_len:
                new_of[t.value] = i
        known = set()
        lut = np.full(len(self.token_bytes) + 1, -1, dtype=np.int64)
        for old_id, b in enumerate(self.token_bytes):
            ni = new_of.get(b, -1)
            if ni >= 0:
                known.add(b)
                lut[old_id] = ni
        missing = set(new_of) - known
        if missing:
            raise ValueError(
                f"rebind: {len(missing)} tokens not in the original "
                f"table (e.g. {next(iter(missing))!r}); rebuild instead")

        def remap(t: np.ndarray) -> np.ndarray:
            out = t.copy()
            ids = t[:, 3]
            occupied = ids != np.uint32(0xFFFFFFFF)
            old = np.where(occupied, ids, 0).astype(np.int64)
            new = lut[old]
            dead = occupied & (new < 0)
            out[:, 3] = np.where(
                occupied & (new >= 0), new.astype(np.uint32),
                np.uint32(0xFFFFFFFF))
            # Dead rows keep fp/len but are empty for the probe; zero
            # the fps so they match the canonical empty pattern.
            out[dead, :3] = 0
            return out

        scores64 = np.array([t.score for t in vocab], dtype=np.float64)
        token_bytes = [t.value for t in vocab]
        bk = bk_ids = None
        if self.bk is not None:
            # Same buckets/salt (slots stable); rescore + clear removed.
            bk = self.bk.copy()
            occ = self.bk_ids >= 0
            new = np.where(occ, lut[np.where(occ, self.bk_ids, 0)], -1)
            score_col = np.full(self.bk_ids.shape[0], _NEG_SCORE_BITS,
                                dtype=np.int32)
            alive = new >= 0
            score_col[alive] = scores64[new[alive]].astype(
                np.float32).view(np.int32)
            bk[:, 1::2] = score_col.reshape(bk.shape[0], 8)
            bk_ids = new
        return TokenTable(
            t1=remap(self.t1), t2=remap(self.t2), bits=self.bits,
            scores=scores64.astype(np.float32), scores_f64=scores64,
            max_token_len=self.max_token_len, vocab_size=len(vocab),
            token_bytes=token_bytes,
            bk=bk, bk_ids=bk_ids, bk_lens=self.bk_lens,
            bk_bits=self.bk_bits, bk_salt=self.bk_salt,
        )

    @staticmethod
    def build(vocab: Sequence[ScoredToken], max_probe_len: Optional[int] = None,
              min_bits: Optional[int] = None, min_len: Optional[int] = None,
              ) -> "TokenTable":
        """min_bits / min_len pad the table size and probe length so that
        shrinking vocabularies (EM prune rounds) keep identical device
        shapes — one compile serves every round."""
        v = len(vocab)
        max_len = max((len(t.value) for t in vocab), default=1)
        if max_probe_len is not None:
            max_len = min(max_len, max_probe_len)
        if min_len is not None:
            max_len = max(max_len, min_len)

        # Deduplicate: later ids win (reference: src/model.rs:20-23).
        by_bytes = {}
        for i, t in enumerate(vocab):
            if len(t.value) <= max_len and len(t.value) > 0:
                by_bytes[t.value] = i

        bits = max(8, int(np.ceil(np.log2(max(len(by_bytes), 1)))) + 1)
        if min_bits is not None:
            bits = max(bits, min_bits)

        entries = _entry_arrays(by_bytes, max_len)
        _check_fingerprint_uniqueness(by_bytes, entries)

        # Build → probe-verify → pin shadowed clusters → rebuild, until
        # every vocabulary token resolves to its own slot on both the
        # fast and EM probe emulations (see module docstring).
        pinned = np.zeros(0, dtype=np.int64)
        t1 = t2 = None
        for _ in range(8):
            try:
                t1, t2 = _build_cuckoo_vectorized(
                    by_bytes, bits, max_len, entries=entries, pinned=pinned)
            except CuckooBuildError:
                bits += 1
                pinned = np.zeros(0, dtype=np.int64)  # slots shift with bits
                continue
            bad = _shadowed_entries(entries, t1, t2, bits)
            if bad.size == 0:
                break
            pinned = _collision_clusters(entries, bits, bad, pinned)
        else:
            raise CuckooBuildError(
                "could not build a shadow-free token table")

        scores64 = np.array([t.score for t in vocab], dtype=np.float64)
        bk, bk_ids, bk_lens, bk_bits, bk_salt = _build_bucket(
            entries, scores64, len(by_bytes), min_bits=min_bits)
        return TokenTable(
            t1=t1,
            t2=t2,
            bits=bits,
            scores=scores64.astype(np.float32),
            scores_f64=scores64,
            max_token_len=max_len,
            vocab_size=v,
            token_bytes=[t.value for t in vocab],
            bk=bk, bk_ids=bk_ids, bk_lens=bk_lens,
            bk_bits=bk_bits, bk_salt=bk_salt,
        )


_NEG_SCORE_BITS = int(np.array([-3.0e38], np.float32).view(np.int32)[0])


def _build_bucket(entries, scores_f64: np.ndarray, n_tokens: int,
                  min_bits: Optional[int] = None):
    """Single-probe 8-way bucket table: (Hb, 16) rows of interleaved
    [check=fp2, f32 score bits] entries. Mean load is kept <= 0.5 per
    bucket so overflow (more than 8 entries) and intra-bucket fp2
    duplicates are astronomically rare; the salt retries until neither
    occurs, making every vocabulary token resolvable by construction
    (entry 0 wins ties in the probe's select chain, but duplicates are
    rejected so ties never involve two vocab tokens)."""
    fp1, fp2, lens, ids = entries
    n = fp1.shape[0]
    bits = max(6, int(np.ceil(np.log2(max(2 * n, 2)))))
    if min_bits is not None:
        bits = max(bits, min_bits)
    nbuckets = 1 << bits
    for salt in range(256):
        idx = _bucket_idx(fp1, lens, salt, bits)
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        if n:
            # position within bucket
            first = np.ones(n, dtype=bool)
            first[1:] = sidx[1:] != sidx[:-1]
            starts = np.nonzero(first)[0]
            k = np.arange(n) - np.repeat(starts, np.diff(
                np.append(starts, n)))
            if k.max(initial=0) > 7:
                continue
            key = (sidx.astype(np.uint64) << np.uint64(32)) | \
                fp2[order].astype(np.uint64)
            if np.unique(key).size != n:
                continue  # same (bucket, fp2) twice: irreconcilable
        else:
            k = np.zeros(0, dtype=np.int64)
        bk = np.zeros((nbuckets, 16), dtype=np.int32)
        bk[:, 1::2] = _NEG_SCORE_BITS
        bk_ids = np.full(nbuckets * 8, -1, dtype=np.int64)
        bk_lens = np.zeros(nbuckets * 8, dtype=np.int64)
        if n:
            scores32 = scores_f64[ids[order].astype(np.int64)].astype(
                np.float32).view(np.int32)
            bk[sidx, 2 * k] = fp2[order].view(np.int32)
            bk[sidx, 2 * k + 1] = scores32
            bk_ids[sidx * 8 + k] = ids[order].astype(np.int64)
            bk_lens[sidx * 8 + k] = lens[order].astype(np.int64)
        return bk, bk_ids, bk_lens, bits, salt
    raise CuckooBuildError("bucket table build failed (salt exhausted)")


def _bucket_idx(fp1, lens, salt, bits):
    return H.host_bucket_index(fp1, lens, salt, bits)


def _entry_arrays(by_bytes: dict, max_len: int):
    """Vectorized (fp1, fp2, lens, ids) for a token dict."""
    n = len(by_bytes)
    if n == 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z, z, z
    tokens = list(by_bytes.keys())
    ids = np.fromiter(by_bytes.values(), dtype=np.uint32, count=n)
    lens = np.fromiter((len(t) for t in tokens), dtype=np.uint32, count=n)
    mat = np.zeros((n, max_len), dtype=np.uint32)
    flat = np.frombuffer(b"".join(tokens), dtype=np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    cols = np.arange(max_len)
    valid = cols[None, :] < lens[:, None]
    idx = np.minimum(offs[:-1, None] + cols[None, :], len(flat) - 1)
    mat[valid] = flat[idx[valid]]

    pow1 = H.powers_u32(H.R1, max_len)
    pow2 = H.powers_u32(H.R2, max_len)
    with np.errstate(over="ignore"):
        fp1 = (mat * pow1[None, :] * valid).sum(axis=1, dtype=np.uint32)
        fp2 = (mat * pow2[None, :] * valid).sum(axis=1, dtype=np.uint32)
    return fp1, fp2, lens, ids


def _check_fingerprint_uniqueness(by_bytes: dict, entries) -> None:
    """Distinct tokens with identical (fp1, fp2, len) are irreparable —
    every probe path treats the triple as the token's identity."""
    fp1, fp2, lens, _ = entries
    if fp1.size < 2:
        return
    key = (fp1.astype(np.uint64) << np.uint64(32)) | fp2.astype(np.uint64)
    order = np.lexsort((lens, key))
    dup = (key[order][1:] == key[order][:-1]) & \
        (lens[order][1:] == lens[order][:-1])
    if dup.any():
        k = int(np.nonzero(dup)[0][0])
        tokens = list(by_bytes.keys())
        a, b = tokens[order[k]], tokens[order[k + 1]]
        raise CuckooBuildError(
            f"vocabulary fingerprint collision between {a!r} and {b!r}; "
            "the hash family cannot distinguish these tokens")


def _shadowed_entries(entries, t1: np.ndarray, t2: np.ndarray,
                      bits: int) -> np.ndarray:
    """Indices of entries that do NOT resolve to their own slot under an
    exact emulation of the device fast probe (ops/lattice.py
    `_match_slab`): a t1 row matches when its check word
    `host_check(fp1, fp2)` equals the probe's, else the probe falls
    through to t2, so a t1 resident with the same check word shadows a
    t2 entry."""
    fp1, fp2, lens, _ = entries
    if fp1.size == 0:
        return np.zeros(0, dtype=np.int64)
    idx1 = H.host_table_index(fp1, lens, H.IDX_A1, H.IDX_M1, bits)
    idx2 = H.host_table_index(fp2, lens, H.IDX_A2, H.IDX_M2, bits)
    row1 = t1[idx1]  # (n, 4) uint32
    row2 = t2[idx2]
    occ1 = row1[:, 3] != np.uint32(0xFFFFFFFF)
    occ2 = row2[:, 3] != np.uint32(0xFFFFFFFF)
    self1 = occ1 & (row1[:, 0] == fp1) & (row1[:, 1] == fp2) & (row1[:, 2] == lens)
    self2 = occ2 & (row2[:, 0] == fp1) & (row2[:, 1] == fp2) & (row2[:, 2] == lens)

    # Fast probe: a t1 match on the check word wins; fall through to t2.
    m1_fast = occ1 & (H.host_check(row1[:, 0], row1[:, 1])
                      == H.host_check(fp1, fp2))
    ok_fast = np.where(m1_fast, self1, self2)
    return np.nonzero(~ok_fast)[0].astype(np.int64)


def _collision_clusters(entries, bits: int, bad: np.ndarray,
                        pinned: np.ndarray) -> np.ndarray:
    """Expand shadowed entries to their full (idx1, check word) clusters
    and merge with the already-pinned set. Pinning every member of a
    cluster into t2 makes the t1 fast check miss for all of them."""
    fp1, fp2, lens, _ = entries
    idx1 = H.host_table_index(fp1, lens, H.IDX_A1, H.IDX_M1, bits)
    key = (idx1.astype(np.uint64) << np.uint64(32)) | \
        H.host_check(fp1, fp2).astype(np.uint64)
    bad_keys = np.unique(key[bad])
    members = np.nonzero(np.isin(key, bad_keys))[0].astype(np.int64)
    return np.union1d(pinned, members)


def _build_cuckoo_vectorized(by_bytes: dict, bits: int, max_len: int,
                             entries=None, pinned=None):
    """Vectorized BFS-style cuckoo construction.

    All pending entries are written to their current-table slot at once;
    losers of each slot (plus displaced occupants) move to the other
    table next round. Terminates when nothing is pending; a pending set
    that stops shrinking over many rounds means an insertion cycle
    (grow the table). ~100x faster than per-entry insertion at 500k
    vocab, which matters because tables are rebuilt every EM round.

    `pinned` entry indices are locked into t2 at their idx2 slot (the
    EM-probe shadow repair; see module docstring); their slots are off
    limits to everyone else.
    """
    n = len(by_bytes)
    size = 1 << bits
    if n == 0:
        t = np.zeros((size, 4), dtype=np.uint32)
        t[:, 3] = np.uint32(0xFFFFFFFF)
        return t, t.copy()

    fp1, fp2, lens, ids = entries if entries is not None else \
        _entry_arrays(by_bytes, max_len)

    idx1 = H.host_table_index(fp1, lens, H.IDX_A1, H.IDX_M1, bits)
    idx2 = H.host_table_index(fp2, lens, H.IDX_A2, H.IDX_M2, bits)

    rows = np.stack([fp1, fp2, lens, ids], axis=1).astype(np.uint32)
    slots = np.stack([idx1, idx2], axis=1)

    t1 = np.zeros((size, 4), dtype=np.uint32)
    t2 = np.zeros((size, 4), dtype=np.uint32)
    t1[:, 3] = np.uint32(0xFFFFFFFF)
    t2[:, 3] = np.uint32(0xFFFFFFFF)
    occupant = np.full((2, size), -1, dtype=np.int64)  # entry index per slot

    locked2 = np.zeros(size, dtype=bool)
    free = np.ones(n, dtype=bool)
    if pinned is not None and len(pinned):
        pinned = np.asarray(pinned, dtype=np.int64)
        pin_slots = slots[pinned, 1]
        if np.unique(pin_slots).size != pin_slots.size:
            raise CuckooBuildError("pinned entries contend for a t2 slot")
        occupant[1, pin_slots] = pinned
        locked2[pin_slots] = True
        free[pinned] = False

    pending = np.nonzero(free)[0].astype(np.int64)
    side = np.zeros(n, dtype=np.int64)  # which table each pending tries next
    max_rounds = 64 + 8 * bits
    for _ in range(max_rounds):
        if pending.size == 0:
            break
        s = side[pending]
        slot = slots[pending, s]
        # Entries aimed at a locked t2 slot bounce straight to t1.
        blocked = (s == 1) & locked2[slot]
        blk = pending[blocked]
        side[blk] ^= 1
        pending = pending[~blocked]
        s = s[~blocked]
        slot = slot[~blocked]
        prev = occupant[s, slot].copy()
        # numpy fancy assignment: the LAST pending entry targeting a
        # contested (side, slot) wins it.
        occupant[s, slot] = pending
        winners = occupant[s, slot] == pending
        losers = pending[~winners]
        evicted = prev[winners]
        evicted = evicted[evicted >= 0]
        side[losers] ^= 1
        if evicted.size:
            # Displaced occupants retry their other table.
            side[evicted] ^= 1
        pending = np.concatenate([losers, evicted, blk])
    else:
        raise CuckooBuildError("insertion cycle")

    occ1 = occupant[0]
    mask1 = occ1 >= 0
    t1[mask1] = rows[occ1[mask1]]
    occ2 = occupant[1]
    mask2 = occ2 >= 0
    t2[mask2] = rows[occ2[mask2]]
    return t1, t2


def _build_cuckoo(by_bytes: dict, bits: int):
    """Per-entry cuckoo insertion (reference implementation; kept as the
    differential check for the vectorized builder)."""
    size = 1 << bits
    t1 = np.zeros((size, 4), dtype=np.uint32)
    t2 = np.zeros((size, 4), dtype=np.uint32)
    t1[:, 3] = np.uint32(0xFFFFFFFF)  # id = -1 sentinel
    t2[:, 3] = np.uint32(0xFFFFFFFF)

    max_kicks = 64 + 8 * bits

    for value, tid in by_bytes.items():
        fp1, fp2 = H.host_fingerprints(value)
        entry = np.array([fp1, fp2, np.uint32(len(value)), np.uint32(tid)],
                         dtype=np.uint32)
        table, slot = t1, int(
            H.host_table_index(np.array([fp1]), np.array([len(value)]),
                               H.IDX_A1, H.IDX_M1, bits)[0]
        )
        placed = False
        for _ in range(max_kicks):
            row = table[slot]
            if row[3] == np.uint32(0xFFFFFFFF):
                table[slot] = entry
                placed = True
                break
            if row[0] == entry[0] and row[1] == entry[1] and row[2] == entry[2]:
                # Same key (duplicate token value): overwrite id.
                table[slot] = entry
                placed = True
                break
            # Evict and move the displaced entry to its other table.
            displaced = row.copy()
            table[slot] = entry
            entry = displaced
            if table is t1:
                # t2 indexes on fp2.
                table = t2
                slot = int(
                    H.host_table_index(entry[1:2], entry[2:3].astype(np.uint32),
                                       H.IDX_A2, H.IDX_M2, bits)[0]
                )
            else:
                table = t1
                slot = int(
                    H.host_table_index(entry[0:1], entry[2:3].astype(np.uint32),
                                       H.IDX_A1, H.IDX_M1, bits)[0]
                )
        if not placed:
            raise CuckooBuildError("insertion cycle")

    return t1, t2
