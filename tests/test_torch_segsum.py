"""The session's segsum as one launch per row group, against the JAX
package's, on the CPU.

`seg_weights_gather` (csrc/seg_weights.cu) takes every token length of a
group's `SegStruct` at once, laid end to end, and gathers each hit's
streams itself. Its twin's cf and t are held bit for bit against
`seg_weights_plain` run per length on the streams the JAX package builds
(`_segsum_expected_impl`: the [alpha - Z, beta] plane gathered by the
sorted hits, the per-length telescoping differences with block anchors);
the per-length block prefix of `_interval_from_blocks` against the
single-length formula bit for bit; `segsum_expected`'s counts against
`lattice_jax.segsum_expected` at dropout 0 and 0.1; the SegStruct's flat
layout; the wrapper's argument checks. tests/test_torch_cuda.py holds the
kernel against the twin on a GPU.
"""

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


def _group(case, dropout):
    """The case's SegStruct, forward values, betas and dropout words."""
    tbl, pb = case["tbl"], case["pb"]
    _, pdu = _drops(case, dropout, 9)
    seg = lat.build_seg_struct(case["slots"], case["rank"].n_pad)
    cache = (lat.score_from_slots(case["rows"], case["slots"]), case["slots"])
    A = lat.forward(tbl, pb, cache, drop_u=pdu, dropout=dropout)
    Bt = lat.backward_betas(tbl, pb, cache, drop_u=pdu, dropout=dropout)
    return seg, A, Bt, pdu


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


def _interval_one_length(cf, t, pre_pos, end_pos):
    """The single-length interval sums (one length's cf and t, its cap
    the sentinel)."""
    p = torch.cumsum(t.double(), dim=0)
    hi = p.float()
    lo = (p - hi.double()).float()
    zero = cf.new_zeros(1)
    hip = torch.cat([zero, hi[:-1], zero])
    lop = torch.cat([zero, lo[:-1], zero])
    cfp = torch.cat([cf, zero])
    end, pre = end_pos.long(), pre_pos.long()
    be, bb = end // SEG_BLK, pre // SEG_BLK
    a, b = hip[be], -hip[bb]
    s = a + b
    a1 = s - b
    b1 = s - a1
    err = (a - a1) + (b - b1)
    return s + (err + (lop[be] - lop[bb]) + (cfp[end] - cfp[pre]))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("name", ["fused", "slab"])
def test_seg_weights_gather_equals_per_length(request, name, dropout):
    case = _case_for(request, name)
    pb, rows = case["pb"], case["rows"]
    seg, A, Bt, pdu = _group(case, dropout)
    args = lat.seg_weight_inputs(pb, A, Bt, seg, rows)
    before = lcs.seg_weights_gather.launches
    cf, t = lcs.seg_weights_gather(*args, pdu, dropout=dropout, pad=pb.pad)
    # CPU tensors take the plain twin: no kernel launch is counted.
    assert lcs.seg_weights_gather.launches == before
    sums = lat._interval_from_blocks(cf, t, seg)
    off = 0
    for l0, n_hit in enumerate(seg.n_hit):
        Hc = seg.perm[l0].shape[0]
        want_cf, want_t = lcs.seg_weights_plain(
            *_per_length_streams(pb, A, Bt, seg, rows, pdu, dropout, l0),
            n_hit)
        assert torch.equal(cf[off : off + Hc], want_cf)
        assert torch.equal(t[off // SEG_BLK : (off + Hc) // SEG_BLK], want_t)
        # The block prefix restarts at each length.
        assert torch.equal(sums[l0], _interval_one_length(
            want_cf, want_t, seg.pre_pos[l0], seg.end_pos[l0]))
        off += Hc
    assert off == cf.shape[0] and float(t.max()) > 1.0


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


def test_seg_struct_lays_lengths_end_to_end(slab_case):
    seg = lat.build_seg_struct(slab_case["slots"], slab_case["rank"].n_pad)
    L = len(seg.perm)
    caps = [p.shape[0] for p in seg.perm]
    assert all(c % SEG_BLK == 0 for c in caps)
    assert seg.perm_flat.shape == (sum(caps),)
    assert seg.blk_flat.shape == (sum(caps) // SEG_BLK,)
    base = seg.perm_flat.data_ptr()
    off = 0
    for p, b, cap in zip(seg.perm, seg.blk_slot, caps):
        assert p.data_ptr() == base + 4 * off  # views, not copies
        assert torch.equal(b, seg.blk_flat[off // SEG_BLK :
                                           (off + cap) // SEG_BLK])
        off += cap
    blocks = np.concatenate([[0], np.cumsum(caps) // SEG_BLK])
    assert seg.meta.tolist() == blocks.tolist() + list(seg.n_hit)
    assert seg.meta.shape == (2 * L + 1,)


def test_seg_weights_gather_rejects_bad_input(slab_case):
    pb = slab_case["pb"]
    seg, A, Bt, _ = _group(slab_case, 0.0)
    args = lat.seg_weight_inputs(pb, A, Bt, seg, slab_case["rows"])
    du = torch.zeros(tuple(pb.sid.shape), dtype=torch.int32)
    lcs.seg_weights_gather(*args, du, dropout=0.1, pad=pb.pad)  # accepted
    perm, col1, bt, d, anchor, meta = args
    bad = [
        ((perm[:-1], col1, bt, d, anchor, meta), {}),
        ((perm.long(), col1, bt, d, anchor, meta), {}),
        ((perm, col1, bt[:, :-1].contiguous(), d, anchor, meta), {}),
        ((perm, col1.double(), bt, d, anchor, meta), {}),
        ((perm, col1, bt, d[:-1], anchor, meta), {}),
        ((perm, col1, bt, d, anchor[:-1], meta), {}),
        ((perm, col1, bt, d, anchor, meta[:-1]), {}),
        ((perm, col1.t().contiguous().t(), bt, d, anchor, meta), {}),
        ((perm, col1, bt, d, anchor.to("meta"), meta), {}),
        ((perm, col1, bt, d, anchor, meta), {"dropout": 0.1}),
        ((perm, col1, bt, d, anchor, meta, du[:, :-1]),
         {"dropout": 0.1, "pad": pb.pad + 1}),
    ]
    for a, kw in bad:
        with pytest.raises(ValueError):
            lcs.seg_weights_gather(*a, **kw)
