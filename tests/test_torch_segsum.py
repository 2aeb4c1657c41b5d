"""The session's segsum in two launches per row group, against the JAX
package's, on the CPU.

`seg_weights_gather` (csrc/seg_weights.cu) takes every token length of a
group's `SegStruct` at once, laid end to end, builds and gathers each hit's
streams itself and sums the blocks that lie wholly inside one segment;
`seg_sums` makes each slot's count. The twins' cf and t are held bit for
bit against `seg_weights_plain` run per length on the streams the JAX
package builds (`_segsum_expected_impl`: the [alpha - Z, beta] plane
gathered by the sorted hits, the per-length telescoping differences with
block anchors); each length's segment sums against double sums of the
same cf and t; `segsum_expected`'s counts against
`lattice_jax.segsum_expected` at dropout 0 and 0.1, on the cases' lattices
and on hand-made slots (a length with no hits, a slot over many blocks, a
rare token beside e^40-larger neighbours, removed slots, pads, a slot at
two lengths); the lengths' slots disjoint; the SegStruct's flat layout;
the wrappers' argument checks. tests/test_torch_cuda.py holds the kernels
against the twins on a GPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokengeex_tpu.ops import lattice_jax as lj

from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs

from test_torch_session_ops import (C, _case_for, _drops,  # noqa: F401
                                    fused_case, slab_case)

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

SEG_BLK = lcs.SEG_BLK
NEG_BITS = int(np.array([-np.inf], np.float32).view(np.int32)[0])


def _group(case, dropout):
    """The case's SegStruct, forward values, betas and dropout words."""
    tbl, pb = case["tbl"], case["pb"]
    _, pdu = _drops(case, dropout, 9)
    seg = lat.build_seg_struct(case["slots"], case["rank"].n_pad)
    cache = (lat.score_from_slots(case["rows"], case["slots"]), case["slots"])
    A = lat.forward(tbl, pb, cache, drop_u=pdu, dropout=dropout)
    Bt = lat.backward_betas(tbl, pb, cache, drop_u=pdu, dropout=dropout)
    return seg, A, Bt, pdu


def _gather_args(pb, A, Bt, seg, rows):
    return (seg, A, pb.end_index, pb.is_start, Bt, rows)


def _per_length_streams(pb, A, Bt, seg, score_rows, pdu, dropout, l0):
    """Length l0's (r0, r1, d2) as the JAX package's segsum builds them."""
    W = pb.width
    L = len(seg.perm)
    B = A.shape[0]
    nbins = lat.rows_nbins(score_rows)
    Z = torch.gather(A, 1, pb.end_index.long())
    Z = torch.where(torch.isfinite(Z) & (Z > -1e37), Z, 0.0)
    a = torch.where(pb.is_start[:, :W], 0.0, A[:, :W])
    beta = torch.nn.functional.pad(Bt, (0, L), value=float("-inf"))
    beta = beta[:, l0 + 1 : l0 + 1 + W]
    if dropout and l0 > 0:
        du = pdu[:, pb.pad : pb.pad + W].numpy().astype(np.uint32)
        odd = np.uint32(((l0 + 1) * 2654435761) % (1 << 32))
        thr = np.uint32(min(int(dropout * (1 << 32)), (1 << 32) - 1)) >> 1
        dropped = ((du * odd) >> np.uint32(1)) < thr
        beta = torch.where(torch.as_tensor(dropped), float("-inf"), beta)
    T = torch.stack([a - Z, beta], dim=-1).reshape(B * W, 2)
    perm = seg.perm[l0].long()
    rows = T[perm]
    Hc = perm.shape[0]
    pre, end = seg.pre_pos[l0], seg.end_pos[l0]
    start = torch.where(end != Hc, torch.where(pre == Hc, 0, pre + 1),
                        Hc).long()
    sc = torch.clamp(score_rows[:nbins].view(torch.float32), min=-200.0)
    sc_pad = torch.cat([sc, sc.new_zeros(1)])
    sc_occ = sc_pad[seg.occ_slot[l0].long()]
    dvals = sc_occ - torch.cat([sc_occ[:1], sc_occ[:-1]])
    d = torch.zeros(Hc + 1).index_add_(0, start, dvals)
    anchors = sc_pad[seg.blk_slot[l0].long()]
    d2 = torch.cat([anchors[:, None], d[:Hc].reshape(-1, SEG_BLK)[:, 1:]],
                   dim=1).reshape(-1)
    return rows[:, 0].contiguous(), rows[:, 1].contiguous(), d2


def _segment_sums_one_length(cf, t, pre_pos, end_pos):
    """One length's segment sums in double: its block totals summed by a
    prefix, plus the in-block sums at the ends (0 for pads, and where the
    scans' rounding takes a sum below 0)."""
    cap = cf.shape[0]
    pre, end = pre_pos.long(), end_pos.long()
    real = end != cap
    s = torch.where(real, torch.where(pre == cap, 0, pre + 1), 0)
    e = torch.where(real, end, 0)
    P = torch.cat([torch.zeros(1, dtype=torch.float64),
                   torch.cumsum(t.double(), dim=0)])
    cfd = cf.double()
    prev = torch.where(s % SEG_BLK != 0, cfd[(s - 1).clamp(min=0)], 0.0)
    v = (P[e // SEG_BLK] - P[s // SEG_BLK]) + (cfd[e] - prev)
    return torch.where(real, v.clamp(min=0.0), 0.0)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("name", ["fused", "slab"])
def test_seg_weights_gather_equals_per_length(request, name, dropout):
    case = _case_for(request, name)
    pb, rows = case["pb"], case["rows"]
    seg, A, Bt, pdu = _group(case, dropout)
    before = lcs.seg_weights_gather.launches, lcs.seg_sums.launches
    cf, t, mid, acc = lcs.seg_weights_gather(
        *_gather_args(pb, A, Bt, seg, rows), pdu, dropout=dropout,
        pad=pb.pad)
    sums = lcs.segment_sums_plain(seg, cf, t, mid)
    acc = lcs.seg_sums(seg, cf, t, mid, acc)
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert (lcs.seg_weights_gather.launches, lcs.seg_sums.launches) == before
    assert acc.shape == rows.shape and float(acc[-1]) == 0.0
    off = 0
    for l0, n_hit in enumerate(seg.n_hit):
        Hc = seg.perm[l0].shape[0]
        want_cf, want_t = lcs.seg_weights_plain(
            *_per_length_streams(pb, A, Bt, seg, rows, pdu, dropout, l0),
            n_hit)
        assert torch.equal(cf[off : off + Hc], want_cf)
        assert torch.equal(t[off // SEG_BLK : (off + Hc) // SEG_BLK], want_t)
        # The block sums restart at each length; a double sum of the same
        # scans, up to the float rounding and the fixed point's 2^-bits.
        want = _segment_sums_one_length(want_cf, want_t, seg.pre_pos[l0],
                                        seg.end_pos[l0])
        np.testing.assert_allclose(sums[l0].double().numpy(), want.numpy(),
                                   rtol=2.0**-23, atol=1e-9)
        real = seg.end_pos[l0] != Hc
        assert torch.equal(acc[seg.occ_slot[l0][real].long()],
                           sums[l0][real])
        off += Hc
    assert off == cf.shape[0] and float(t.max()) > 1.0
    assert int((mid > 0).sum()) > 0  # whole blocks inside one segment


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("name", ["fused", "slab"])
def test_segsum_matches_jax(request, name, dropout):
    """segsum alone, on the JAX package's own forward values and betas."""
    case = _case_for(request, name)
    dt, jb = case["dt"], case["jb"]
    jdu, pdu = _drops(case, dropout, 9)
    nbins = case["rank"].n_pad
    jseg = lj.build_seg_struct(case["jslots"], nbins)
    jcache = (lj.score_from_slots(case["jrows"], case["jslots"]),
              case["jslots"])
    jA = lj.forward(dt, jb, C=C, drop_u=jdu, dropout=dropout, cache=jcache)
    jBt = lj.backward_betas(dt, jb, C=C, drop_u=jdu, dropout=dropout,
                            cache=jcache)
    want = lj.segsum_expected(dt, jb, jA, jBt, jseg, case["jrows"],
                              drop_u=jdu, dropout=dropout)
    got = lat.segsum_expected(case["tbl"], case["pb"],
                              torch.as_tensor(np.array(jA)),
                              torch.as_tensor(np.array(jBt)),
                              lat.build_seg_struct(case["slots"], nbins),
                              case["rows"], pdu, dropout)
    assert got.shape == (nbins,) and float(got.sum()) > 100
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# -- hand-made slots --

NBINS = 1000  # slots 0..999, the miss 1000


def _planted(case, kind, seed=4):
    """(B, L, W) slots of the case's batch, made by hand, and the scores
    of NBINS slots. Every slot has one length (slot % L) but where `kind`
    says otherwise; ~15 % of the (position, length) points hit."""
    B, W = case["pb"].end_index.shape
    L = case["tbl"].max_len
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, NBINS // L, (B, L, W)) * L + np.arange(L)[None, :,
                                                                     None]
    slots = np.where(rng.random((B, L, W)) < 0.15, slots, NBINS)
    scores = rng.uniform(-3.0, 0.0, NBINS).astype(np.float32)
    if kind == "empty_length":
        slots[:, 3] = NBINS
    elif kind == "long_slot":
        # One slot at 3,000 points of length 2: its segment spans ~24
        # blocks (and some blocks lie wholly inside it).
        pts = rng.choice(B * W, 3000, replace=False)
        slots[pts // W, 1, pts % W] = 5 * L + 1
    elif kind == "rare":
        # A rare token whose score is 40 below its sorted neighbours',
        # each with ~900 points at length 1 over several blocks.
        for k, s in enumerate((20 * L, 21 * L, 22 * L)):
            pts = rng.choice(B * W, 900, replace=False)
            slots[pts // W, 0, pts % W] = s
        scores[[20 * L, 22 * L]] = -0.5
        scores[21 * L] = -40.5
    elif kind == "removed":
        # Removed and empty slots read the -3e38 sentinel (clamped to
        # -200: their weights are 0) or -inf.
        scores[::7] = -3.0e38
        scores[3::11] = -np.inf
    elif kind == "pads":
        # Few slots at most lengths and many at one: most entries pads.
        keep = np.isin(slots % L, [0]) | np.isin(slots, [1, 2, 3, 4, 5, 6])
        slots = np.where(keep, slots, NBINS)
    elif kind == "two_lengths":
        # A hash false positive: slot 7 * L + 2 (length 3) also at length
        # 6 and 9 (a chain of three), slot 9 * L at length 5.
        for l0, s, n in ((5, 7 * L + 2, 200), (8, 7 * L + 2, 50),
                         (4, 9 * L, 300)):
            pts = rng.choice(B * W, n, replace=False)
            slots[pts // W, l0, pts % W] = s
    bits = np.concatenate([scores.view(np.int32), [NEG_BITS]]).astype(np.int32)
    return slots.astype(np.int32), bits


def _planted_segsum(case, slots, bits, dropout, seed=5):
    """(port, JAX) counts of hand-made slots over random forward values and
    betas (marginals up to ~1), and the port's SegStruct."""
    pb, jb = case["pb"], case["jb"]
    B, W = pb.end_index.shape
    rng = np.random.default_rng(seed)
    A = rng.uniform(-3.0, 0.0, (B, W + 1)).astype(np.float32)
    Bt = rng.uniform(-9.0, -3.0, (B, W + 1)).astype(np.float32)
    Bt[rng.random((B, W + 1)) < 0.05] = -np.inf
    jdu, pdu = _drops(case, dropout, 9)
    jseg = lj.build_seg_struct(jnp.asarray(slots), NBINS)
    want = lj.segsum_expected(case["dt"], jb, jnp.asarray(A), jnp.asarray(Bt),
                              jseg, jnp.asarray(np.stack([bits, 0 * bits], 1)),
                              drop_u=jdu, dropout=dropout)
    seg = lat.build_seg_struct(
        torch.as_tensor(np.ascontiguousarray(slots.transpose(2, 1, 0))), NBINS)
    got = lat.segsum_expected(case["tbl"], pb, torch.as_tensor(A),
                              torch.as_tensor(Bt), seg, torch.as_tensor(bits),
                              pdu, dropout)
    return got.numpy(), np.asarray(want), seg


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["empty_length", "long_slot", "rare",
                                  "removed", "pads", "two_lengths"])
def test_segsum_edge_cases_match_jax(slab_case, kind, dropout):
    slots, bits = _planted(slab_case, kind)
    got, want, seg = _planted_segsum(slab_case, slots, bits, dropout)
    L = len(seg.perm)
    assert got.shape == want.shape == (NBINS,) and float(want.sum()) > 10
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # No count below zero (the JAX package's keeps a -ulp where the
    # in-block scans fall over zero weights).
    assert (got >= 0).all()
    caps = [p.shape[0] for p in seg.perm]
    nxt = seg.nxt.numpy()
    if kind == "empty_length":
        assert seg.n_hit[3] == 0 and caps[3] == SEG_BLK
        assert (seg.end_pos[3] == SEG_BLK).all() and (nxt[3] == -2).all()
    elif kind == "long_slot":
        o = int(np.flatnonzero(seg.occ_slot[1].numpy() == 5 * L + 1)[0])
        pre, end = int(seg.pre_pos[1, o]), int(seg.end_pos[1, o])
        assert end // SEG_BLK - (pre + 1) // SEG_BLK >= 20
        assert got[5 * L + 1] > 1.0
    elif kind == "rare":
        o = int(np.flatnonzero(seg.occ_slot[0].numpy() == 21 * L)[0])
        pre, end = int(seg.pre_pos[0, o]), int(seg.end_pos[0, o])
        assert end // SEG_BLK - (pre + 1) // SEG_BLK >= 5
        assert got[21 * L] >= 0 and got[20 * L] > 1.0 and got[22 * L] > 1.0
    elif kind == "removed":
        # Their weights underflow to 0; only the in-block scans' rounding
        # is left of their counts.
        assert np.abs(got[::7]).max() < 1e-4 and np.abs(got[3::11]).max() < 1e-4
    elif kind == "pads":
        n_occ = (seg.end_pos != torch.tensor(caps)[:, None]).sum(1)
        assert seg.occ_slot.shape[1] >= 8 * int(n_occ[1:].max())
        assert (nxt[seg.end_pos.numpy() == np.array(caps)[:, None]] == -2).all()
    elif kind == "two_lengths":
        # The slot's shortest length leads its chain; the later entries
        # are skipped by the stores and summed in ascending length.
        first = [int(np.flatnonzero(seg.occ_slot[l0].numpy() == s)[0])
                 for l0, s in ((2, 7 * L + 2), (5, 7 * L + 2),
                               (8, 7 * L + 2), (0, 9 * L), (4, 9 * L))]
        OC = seg.occ_slot.shape[1]
        a, b, c, d, e = (l0 * OC + o for l0, o in
                         zip((2, 5, 8, 0, 4), first))
        assert nxt.reshape(-1)[[a, b, c, d, e]].tolist() == [
            b, -3 - c, -2, e, -2]
        assert got[7 * L + 2] > want[7 * L + 2] * 0.99 > 0


def test_occurring_slots_of_lengths_are_disjoint(slab_case, fused_case):
    """One token has one length, so each occurring slot (the rank space's
    and the raw probe slots') occurs at one length, its token's: the
    accumulator takes stores. A slot at a second length would take a hash
    false positive of the probe; `nxt` chains it (test above)."""
    for case in (slab_case, fused_case):
        rank, pt = case["rank"], case["pt"]
        lens = np.asarray(pt.bk_lens)  # a slot's token length
        for slots, nbins, length_of in (
                (case["slots"], rank.n_pad, lambda r: lens[rank.occ[r]]),
                (case["raw"], 8 << pt.bk_bits, lambda s: lens[s])):
            seg = lat.build_seg_struct(slots, nbins)
            caps = torch.tensor([p.shape[0] for p in seg.perm])[:, None]
            real = seg.end_pos != caps
            seen = {}
            for l0 in range(len(seg.perm)):
                occ = seg.occ_slot[l0][real[l0]].numpy()
                assert (length_of(occ) == l0 + 1).all()
                for s in occ.tolist():
                    assert seen.setdefault(s, l0) == l0
            assert len(seen) > 100
            assert ((seg.nxt == -1) == real).all()
            assert ((seg.nxt == -2) == ~real).all()


def test_seg_struct_lays_lengths_end_to_end(slab_case):
    seg = lat.build_seg_struct(slab_case["slots"], slab_case["rank"].n_pad)
    L = len(seg.perm)
    caps = [p.shape[0] for p in seg.perm]
    assert all(c % SEG_BLK == 0 for c in caps)
    assert seg.perm_flat.shape == (sum(caps),)
    assert seg.blk_flat.shape == seg.blk_occ.shape == (sum(caps) // SEG_BLK,)
    base = seg.perm_flat.data_ptr()
    off = 0
    for l0, (p, b, cap) in enumerate(zip(seg.perm, seg.blk_slot, caps)):
        assert p.data_ptr() == base + 4 * off  # views, not copies
        assert torch.equal(b, seg.blk_flat[off // SEG_BLK :
                                           (off + cap) // SEG_BLK])
        # blk_occ: the entry whose segment holds each block's first hit.
        o = seg.blk_occ[off // SEG_BLK : (off + cap) // SEG_BLK].long()
        starts = torch.arange(0, cap, SEG_BLK)
        inside = starts < seg.n_hit[l0]
        assert (o[~inside] >= (seg.end_pos[l0] != cap).sum()).all()
        oi = o[inside]
        pre = seg.pre_pos[l0][oi].long()
        assert (seg.end_pos[l0][oi] >= starts[inside]).all()
        assert (torch.where(pre == cap, -1, pre) < starts[inside]).all()
        assert torch.equal(seg.occ_slot[l0][oi], b[inside])
        off += cap
    blocks = np.concatenate([[0], np.cumsum(caps) // SEG_BLK])
    assert seg.meta.tolist() == blocks.tolist() + list(seg.n_hit)
    assert seg.meta.shape == (2 * L + 1,)
    assert seg.nxt.shape == seg.occ_slot.shape and seg.nxt.dtype == torch.int32


def test_seg_weights_gather_rejects_bad_input(slab_case):
    pb = slab_case["pb"]
    seg, A, Bt, _ = _group(slab_case, 0.0)
    rows = slab_case["rows"]
    du = torch.zeros(tuple(pb.sid.shape), dtype=torch.int32)
    args = _gather_args(pb, A, Bt, seg, rows)
    lcs.seg_weights_gather(*args, du, dropout=0.1, pad=pb.pad)  # accepted
    end_index, is_start = pb.end_index, pb.is_start
    rep = dataclasses.replace
    bad = [
        ((rep(seg, perm_flat=seg.perm_flat[:-1]), A, end_index, is_start, Bt,
          rows), {}),
        ((rep(seg, perm_flat=seg.perm_flat.long()), A, end_index, is_start,
          Bt, rows), {}),
        ((rep(seg, blk_occ=seg.blk_occ[:-1]), A, end_index, is_start, Bt,
          rows), {}),
        ((rep(seg, nxt=seg.nxt[:, :-1]), A, end_index, is_start, Bt, rows),
         {}),
        ((rep(seg, meta=seg.meta[:-1]), A, end_index, is_start, Bt, rows),
         {}),
        ((rep(seg, pre_pos=seg.pre_pos.t().contiguous().t()), A, end_index,
          is_start, Bt, rows), {}),
        ((seg, A[:, :-1].contiguous(), end_index, is_start, Bt, rows), {}),
        ((seg, A.double(), end_index, is_start, Bt, rows), {}),
        ((seg, A, end_index.long(), is_start, Bt, rows), {}),
        ((seg, A, end_index, is_start.int(), Bt, rows), {}),
        ((seg, A, end_index, is_start, Bt[:, :-1].contiguous(), rows), {}),
        ((seg, A, end_index, is_start, Bt, rows.float()), {}),
        ((seg, A, end_index, is_start, Bt, rows.to("meta")), {}),
        ((seg, A.t().contiguous().t(), end_index, is_start, Bt, rows), {}),
        ((seg, A, end_index, is_start, Bt, rows), {"dropout": 0.1}),
        ((seg, A, end_index, is_start, Bt, rows, du[:, :-1]),
         {"dropout": 0.1, "pad": pb.pad + 1}),
    ]
    for a, kw in bad:
        with pytest.raises(ValueError):
            lcs.seg_weights_gather(*a, **kw)


def test_seg_sums_rejects_bad_input(slab_case):
    pb = slab_case["pb"]
    seg, A, Bt, _ = _group(slab_case, 0.0)
    cf, t, mid, acc = lcs.seg_weights_gather(
        *_gather_args(pb, A, Bt, seg, slab_case["rows"]))
    lcs.seg_sums(seg, cf, t, mid, acc.clone())  # accepted
    bad = [
        (seg, cf[:-1], t, mid, acc),
        (seg, cf.double(), t, mid, acc),
        (seg, cf, t[:-1], mid, acc),
        (seg, cf, t, mid.int(), acc),
        (seg, cf, t, mid[:-1], acc),
        (seg, cf, t, mid, acc.double()),
        (seg, cf, t, mid, acc[:, None]),
        (seg, cf, t, mid, acc.to("meta")),
        (dataclasses.replace(seg, occ_slot=seg.occ_slot.long()), cf, t, mid,
         acc),
    ]
    for a in bad:
        with pytest.raises(ValueError):
            lcs.seg_sums(*a)
