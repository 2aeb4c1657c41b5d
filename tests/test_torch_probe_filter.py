"""The bucket probe's miss filter and one-sector gathers, on the CPU.

csrc/match_probe.cu keeps one byte a bucket row in shared memory (at
bucket bits `FILTER_MIN_BITS`..`FILTER_MAX_BITS`): bit t < 7 for the tags of the row's entries that
differ from the empty pattern, bit 7 when any of entries 4-7 does. A
valid point whose tag bit is clear gathers nothing; the others read
entries 0-3 and, where none hits and bit 7 is set, entries 4-7. Held here
without a GPU:

  - the plain torch derivation (`bucket_filter_plain`, made by
    `DeviceTables.from_numpy`) against a numpy derivation from
    `TokenTable.bk`;
  - no placed entry's tag bit is clear, and a row placing an entry past 3
    has bit 7;
  - `bucket_probe_emulated` (the kernel's filtered, one-sector probe in
    plain torch, here) bit-equal to the twin `match_cache_plain`, at bits
    8-17, on a table rebound to a vocabulary that removes tokens, on a
    hand-made t_bucket whose rows hold 5-8 placed entries, some dead (the
    overflow bit sends those rows to the second sector), and above the
    filter's limit (the gather branch: the tables hold no filter);
  - chip_smoke.py's `filter_counts` (the shares it logs) counts what the
    emulation does;
  - a filter made for another t_bucket, or for this one before it was
    changed in place, is refused.

The file imports no JAX: the kernel's `cuda` cases in
tests/test_torch_probe.py take `overflow_table` from here.
"""

import dataclasses
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from tokengeex_tpu_torch import ScoredToken
from tokengeex_tpu_torch.ops import hashing as H
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.utils.packing import pack_samples

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ALPHABET = b"abcdef ()"
W, C = 512, 256
EMPTY_BITS = int(np.array([-3.0e38], np.float32).view(np.int32)[0])
# (tokens, min_bits) -> the bucket table's bk_bits: 8, 10, 12, 13, 17.
TABLES = {"bits8": (100, 8), "bits10": (300, None), "bits12": (2000, None),
          "bits13": (300, 13), "bits17": (300, 17)}


def _vocab(seed, n, max_len=8):
    rng = random.Random(seed)
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in ALPHABET]
    seen = {v for v, _ in vocab}
    while len(vocab) < n:
        w = bytes(rng.choice(ALPHABET) for _ in range(rng.randint(2, max_len)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    return [ScoredToken(v, s) for v, s in vocab]


def _samples(seed):
    """Many short samples (1-40 bytes), empty ones and one long run."""
    rng = random.Random(seed)
    out = ["".join(rng.choice("abcdef ()") for _ in range(rng.randint(1, 40))
                   ).encode() for _ in range(60)]
    return out + [b"", b"", b"a" * 300]


def _batches(seed, L, device="cpu"):
    """(batch, lead): packed short samples at lead 0, a chained window at
    lead L."""
    packed = lat.prepare_batch(pack_samples(_samples(seed), width=W,
                                            row_multiple=8), L, device)
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.frombuffer(ALPHABET, np.uint8), (16, L + W))
    n_valid = rng.integers(0, W + 1, 16).astype(np.int32)
    n_valid[:2] = 0
    has_tail = rng.random(16) < 0.6
    chained = lat.prepare_chained_batch(rows, n_valid, has_tail, L, W,
                                        device)
    return [(packed, 0), (chained, L)]


def _table(name):
    n, min_bits = TABLES[name]
    return TokenTable.build(_vocab(n, n), min_bits=min_bits)


def numpy_filter(bk: np.ndarray) -> np.ndarray:
    """The filter of bucket rows, in numpy."""
    chk = bk[:, 0::2].view(np.uint32).astype(np.uint64)
    placed = (bk[:, 0::2] != 0) | (bk[:, 1::2] != EMPTY_BITS)
    tag = (chk * np.uint64(7)) >> np.uint64(32)
    out = np.zeros(bk.shape[0], dtype=np.uint8)
    for k in range(8):
        bit = (np.uint8(1) << tag[:, k].astype(np.uint8)).astype(np.uint8)
        out |= np.where(placed[:, k], bit, np.uint8(0))
    out |= np.where(placed[:, 4:].any(axis=1), np.uint8(0x80), np.uint8(0))
    return out


def _probe_points(batch, L, lead, q0, n):
    """The kernel's points at positions q in [q0, q0 + n) of a probe at
    `lead` (stream index g = pad - lead + q): fp1 and fp2 (int32) and
    valid, each (n, L, B)."""
    g = batch.pad - lead + q0
    ends = (torch.arange(n)[:, None] + torch.arange(1, L + 1)[None, :])

    def fp(p, rinv):
        s = p[:, g : g + n + L]
        return H.mul_i32(H.sub_i32(s[:, ends], s[:, :n, None]),
                         rinv[g : g + n][None, :, None]).permute(1, 2, 0)

    sid = batch.sid[:, g : g + n + L - 1]
    sid0 = sid[:, :n, None]
    valid = (sid0 >= 0) & (sid[:, ends - 1] == sid0)
    return (fp(batch.p1, batch.rinv1), fp(batch.p2, batch.rinv2),
            valid.permute(1, 2, 0))


def bucket_probe_emulated(tbl, batch, lead=0, slots=True,
                          dtype=torch.float32, C=128):
    """The kernel's bucket probe in plain torch ops, C positions at a
    time: on the "filtered" branch a valid point gathers entries 0-3 only
    where its tag bit is set, and entries 4-7 only where none of 0-3 hit
    and the row's bit 7 is set; on the "gather" branch every valid point
    reads its whole row. Returns (score, slot, counts) like `match_probe`
    (slot None when slots=False), counts the valid points, the points that
    gathered and the gathers that read the second sector."""
    B, L = batch.p1.shape[0], tbl.max_len
    Q = lead + batch.width
    filtered = lcp.probe_branch(tbl, "bucket") == "filtered"
    if filtered:
        if tbl.bk_filter is None or not tbl.bk_filter.belongs_to(
                tbl.t_bucket):
            raise ValueError("the bucket filter was not derived from these "
                             "buckets")
        tags = tbl.bk_filter.tags.to(torch.int64)
    mix = H.wrap_i32(torch.arange(1, L + 1, dtype=torch.int64)
                     * int(H.IDX_A1))[None, :, None]
    score = torch.empty((Q, L, B), dtype=dtype)
    slot = torch.empty((Q, L, B), dtype=torch.int32)
    counts = {"valid": 0, "gathered": 0, "second_sector": 0}
    for q0 in range(0, Q, C):
        n = min(C, Q - q0)
        fp1, fp2, valid = _probe_points(batch, L, lead, q0, n)
        row = H.srl_i32(H.mul_i32(fp1 ^ mix ^ H.i32(tbl.bk_salt),
                                  H.i32(int(H.IDX_M1))),
                        32 - tbl.bk_bits).long()

        def sector(ks):
            k_hit = torch.full(row.shape, -1, dtype=torch.int64)
            s_hit = torch.zeros(row.shape, dtype=torch.float32)
            for k in reversed(ks):  # descending: the smallest k wins
                c = tbl.t_bucket[:, 2 * k][row]
                s = tbl.t_bucket[:, 2 * k + 1][row].view(torch.float32)
                m = (c == fp2) & (s > -1.0e38)
                k_hit = torch.where(m, k, k_hit)
                s_hit = torch.where(m, s, s_hit)
            return k_hit, s_hit

        if filtered:
            f = tags[row]
            live = valid & (((f >> lcp.filter_tag(fp2)) & 1) == 1)
            over = (f >> 7) == 1
        else:
            live, over = valid, torch.ones_like(valid)
        k0, s0 = sector(range(4))
        second = live & (k0 < 0) & over
        k1, s1 = sector(range(4, 8))
        k = torch.where(k0 >= 0, k0, torch.where(second, k1, -1))
        hit = live & (k >= 0)
        score[q0 : q0 + n] = torch.where(
            hit, torch.where(k0 >= 0, s0, s1),
            torch.tensor(float("-inf"))).to(dtype)
        slot[q0 : q0 + n] = torch.where(hit, row * 8 + k,
                                        tbl.bk_num_slots).to(torch.int32)
        counts["valid"] += int(valid.sum())
        counts["gathered"] += int(live.sum())
        counts["second_sector"] += int((second if filtered else live).sum())
    return score, slot if slots else None, counts


def overflow_table(device="cpu", dtype=torch.float32, seed=5, bits=5):
    """DeviceTables of one vocabulary whose buckets are remade at `bits`:
    each row holds 5-8 of the tokens that land there, every other row
    after an empty entry 0, and every third placed token is dead (its
    check kept, the -3e38 score: a removed token, as `TokenTable.rebind`
    leaves it). The cuckoo and exact rows, and the scores at `dtype`,
    stay the table's own; `DeviceTables.from_table` makes the rest, the
    filter included. Returns the tables and the host buckets."""
    pt = TokenTable.build(_vocab(seed, 600))
    by_row = {}
    for i, t in enumerate(pt.token_bytes):
        fp1, fp2 = H.host_fingerprints(t)
        row = int(H.host_bucket_index(np.array([fp1]), np.array([len(t)]),
                                      pt.bk_salt, bits)[0])
        by_row.setdefault(row, {})[int(fp2)] = i
    bk = np.zeros((1 << bits, 16), dtype=np.int32)
    bk[:, 1::2] = EMPTY_BITS
    bk_ids = np.full((1 << bits) * 8, -1, dtype=np.int64)
    bk_lens = np.zeros((1 << bits) * 8, dtype=np.int64)
    placed = 0
    for row, entries in sorted(by_row.items()):
        hole = row % 2
        n = min(5 + (row // 2) % 4, 8 - hole)
        for k, (fp2, i) in enumerate(list(entries.items())[:n], start=hole):
            bk[row, 2 * k] = np.array([fp2], np.uint32).view(np.int32)[0]
            placed += 1
            if placed % 3:
                bk[row, 2 * k + 1] = pt.scores[i:i + 1].view(np.int32)[0]
                bk_ids[row * 8 + k] = i
                bk_lens[row * 8 + k] = len(pt.token_bytes[i])
    pt = dataclasses.replace(pt, bk=bk, bk_ids=bk_ids, bk_lens=bk_lens,
                             bk_bits=bits)
    return lat.DeviceTables.from_table(pt, device, dtype), bk


def _equal_to_twin(dt, batch, lead, dtype=torch.float32):
    want = lat.match_cache_plain(dt, batch, C, "bucket", lead, True, dtype)
    got = bucket_probe_emulated(dt, batch, lead, True, dtype, C=64)
    assert got[0].dtype == dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    only = bucket_probe_emulated(dt, batch, lead, False, dtype)
    assert only[1] is None and torch.equal(only[0], want[0])
    assert only[2] == got[2]
    return want, got[2]


@pytest.mark.parametrize("name", list(TABLES))
def test_filter_equals_numpy(name):
    pt = _table(name)
    dt = lat.DeviceTables.from_table(pt, "cpu")
    assert dt.bk_bits == pt.bk_bits and dt.bk_filter.tags.dtype == torch.uint8
    np.testing.assert_array_equal(dt.bk_filter.tags.numpy(),
                                  numpy_filter(pt.bk))
    np.testing.assert_array_equal(
        lcp.bucket_filter_plain(torch.from_numpy(pt.bk)).numpy(),
        numpy_filter(pt.bk))


@pytest.mark.parametrize("name", list(TABLES) + ["overflow"])
def test_no_placed_entry_tag_is_clear(name):
    if name == "overflow":
        dt, bk = overflow_table()
        ids = dt.bk_slot_to_id
    else:
        pt = _table(name)
        dt, bk, ids = lat.DeviceTables.from_table(pt, "cpu"), pt.bk, pt.bk_ids
    tags = dt.bk_filter.tags.numpy().astype(np.int64)
    slots = np.nonzero(ids >= 0)[0]
    assert slots.size
    rows, ks = slots // 8, slots % 8
    chk = bk[rows, 2 * ks].view(np.uint32).astype(np.uint64)
    tag = ((chk * np.uint64(7)) >> np.uint64(32)).astype(np.int64)
    assert ((tags[rows] >> tag) & 1).all()
    assert ((tags[rows[ks >= 4]] >> 7) == 1).all()
    # A row of empty entries gathers nothing.
    empty = ~((bk[:, 0::2] != 0) | (bk[:, 1::2] != EMPTY_BITS)).any(axis=1)
    assert (tags[empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(TABLES))
def test_emulated_probe_equals_twin(name, dtype):
    pt = _table(name)
    dt = lat.DeviceTables.from_table(pt, "cpu")
    assert lcp.probe_branch(dt, "bucket") == "filtered"
    for batch, lead in _batches(pt.bk_bits, pt.max_token_len):
        want, counts = _equal_to_twin(dt, batch, lead, dtype)
        hits = int(torch.isfinite(want[0]).sum())
        assert 0 < hits <= counts["gathered"] < counts["valid"]
        assert counts["second_sector"] <= counts["gathered"] - hits
        if not (dt.bk_filter.tags >> 7).any():
            assert counts["second_sector"] == 0


def test_emulated_probe_on_a_rebound_table():
    """A table rebound to a vocabulary that drops tokens and rescores the
    rest: the dropped entries keep their checks with the -3e38 score, so
    their tag bits stay set, and the probe still equals the twin."""
    vocab = _vocab(7, 2000)
    pt = TokenTable.build(vocab)
    keep = [t for i, t in enumerate(vocab) if i < len(ALPHABET) or i % 3]
    keep = [ScoredToken(t.value, t.score - 0.25) for t in keep]
    rb = pt.rebind(keep)
    dt = lat.DeviceTables.from_table(rb, "cpu")
    dead = (pt.bk_ids >= 0) & (rb.bk_ids < 0)
    assert dead.any()
    np.testing.assert_array_equal(dt.bk_filter.tags.numpy(),
                                  numpy_filter(pt.bk))
    for batch, lead in _batches(7, pt.max_token_len):
        want, counts = _equal_to_twin(dt, batch, lead)
        # Some gathers find only the removed tokens: a miss after all.
        assert int(torch.isfinite(want[0]).sum()) < counts["gathered"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_emulated_probe_on_overflow_rows(dtype):
    dt, bk = overflow_table()
    per_row = ((bk[:, 0::2] != 0) | (bk[:, 1::2] != EMPTY_BITS)).sum(axis=1)
    assert per_row.min() >= 5 and per_row.max() == 8
    assert (dt.bk_filter.tags.numpy() >> 7 == 1).all()
    L = dt.max_len
    for batch, lead in _batches(11, L):
        want, counts = _equal_to_twin(dt, batch, lead, dtype)
        slot = want[1][torch.isfinite(want[0])]
        # Hits in entries 4-7 came through the second sector.
        assert bool(((slot % 8) >= 4).any())
        assert counts["second_sector"] > 0
    # Dead entries never hit.
    dead = (dt.bk_slot_to_id < 0) & (bk[:, 0::2].reshape(-1) != 0)
    assert dead.any()
    hit_slots = set(want[1][torch.isfinite(want[0])].tolist())
    assert not hit_slots & set(np.nonzero(dead)[0].tolist())


def test_emulated_gather_branch_above_the_limit():
    pt = TokenTable.build(_vocab(18, 300), min_bits=lcp.FILTER_MAX_BITS + 1)
    dt = lat.DeviceTables.from_table(pt, "cpu")
    assert dt.bk_bits == lcp.FILTER_MAX_BITS + 1
    assert lcp.probe_branch(dt, "bucket") == "gather"
    # The gather branch reads no filter, so the tables make none.
    assert dt.bk_filter is None
    for batch, lead in _batches(18, pt.max_token_len):
        _, counts = _equal_to_twin(dt, batch, lead)
        assert counts["gathered"] == counts["valid"] == \
            counts["second_sector"]


def test_probe_branch():
    dt = lat.DeviceTables.from_table(_table("bits17"), "cpu")
    assert lcp.probe_branch(dt, "bucket") == "filtered"
    for mode in ("fast", "em", "exact"):
        assert lcp.probe_branch(dt, mode) == "gather"
    # A table too small for 16-byte filter copies.
    tiny = dataclasses.replace(dt, bk_bits=3)
    assert lcp.probe_branch(tiny, "bucket") == "gather"


@pytest.mark.parametrize("bits", [3, 4, 6, 17, 18])
def test_tables_hold_a_filter_only_for_the_filtered_branch(bits):
    """DeviceTables derive the filter where the kernel's filtered branch
    reads it, and only there; without one, the bucket probe (the twin on
    the CPU) still runs and equals the emulation's gather branch. Bits 3
    and 4 are hand-made buckets (the build makes 6 and up)."""
    if bits < 6:
        dt, _ = overflow_table(seed=bits, bits=bits)
    else:
        dt = lat.DeviceTables.from_table(
            TokenTable.build(_vocab(bits, 20 if bits == 6 else 300),
                             min_bits=bits), "cpu")
    assert dt.bk_bits == bits
    assert lcp.has_filter(bits) == (lcp.FILTER_MIN_BITS <= bits
                                    <= lcp.FILTER_MAX_BITS)
    assert (dt.bk_filter is not None) == lcp.has_filter(bits)
    assert lcp.probe_branch(dt, "bucket") == (
        "filtered" if lcp.has_filter(bits) else "gather")
    batch, lead = _batches(bits, dt.max_len)[1]
    got = lat.match_cache(dt, batch, C=C, probe="bucket", lead=lead)
    emu = bucket_probe_emulated(dt, batch, lead)
    assert torch.equal(got[0], emu[0]) and torch.equal(got[1], emu[1])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["bits12", "bits17", "overflow"])
def test_chip_smoke_filter_counts_match_the_emulation(name):
    """chip_smoke.py logs the filter's rule as `filter_counts` finds it:
    the valid points and the gathers as the emulation counts them, and the
    gathers in rows with bit 7, which bound its second-sector reads."""
    cs = _chip_smoke()
    dt = (overflow_table()[0] if name == "overflow"
          else lat.DeviceTables.from_table(_table(name), "cpu"))
    for batch, lead in _batches(3, dt.max_len):
        n = cs.filter_counts(dt, batch, lead, C=96)
        emu = bucket_probe_emulated(dt, batch, lead, False)[2]
        assert (n["valid"], n["gathered"]) == (emu["valid"],
                                               emu["gathered"])
        assert emu["second_sector"] <= n["overflow_rows"] <= n["gathered"]
        if name == "overflow":
            assert n["overflow_rows"] == n["gathered"] > 0


@pytest.mark.parametrize("case", ["other_table", "replaced_buckets",
                                  "changed_in_place", "missing"])
def test_foreign_filter_refused(case):
    pt = _table("bits10")
    dt = lat.DeviceTables.from_table(pt, "cpu")
    other = lat.DeviceTables.from_table(pt, "cpu")
    if case == "other_table":
        # The same rows, another tensor: its filter is not this one's.
        dt = dataclasses.replace(dt, bk_filter=other.bk_filter)
    elif case == "replaced_buckets":
        dt = dataclasses.replace(dt, t_bucket=other.t_bucket)
    elif case == "changed_in_place":
        dt.t_bucket[0, 1] = 0
    else:
        dt = dataclasses.replace(dt, bk_filter=None)
    batch, _ = _batches(10, pt.max_token_len)[0]
    with pytest.raises(ValueError, match="filter"):
        lat.match_cache(dt, batch, C=C, probe="bucket")
    with pytest.raises(ValueError, match="filter"):
        bucket_probe_emulated(dt, batch)
    # The other modes do not read the filter.
    lat.match_cache(dt, batch, C=C, probe="fast")
