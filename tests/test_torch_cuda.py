"""The port's CUDA kernels against their plain PyTorch twins, on a GPU.

Every test here is marked `cuda` and skips where no GPU is present (the
kernels have no CPU mode). The file imports only the port, so it runs on
a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import random

import numpy as np
import pytest
import torch

from tokengeex_tpu_torch import Lattice, Model, ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs
from tokengeex_tpu_torch.core.redfa import compile_dfa
from tokengeex_tpu_torch.ops import dfa_device as dd
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
from tokengeex_tpu_torch.train.generate import VocabularyGenerator
from tokengeex_tpu_torch.train.patterns import (PATTERNS, build_allow_regex,
                                                load_patterns)
from tokengeex_tpu_torch.utils.packing import pack_samples

TOL = {"a": 1e-5, "marg": 1e-5, "hist": 1e-6, "betas": 1e-5, "cf": 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _corpus(n_vocab, seed=0, max_len=11):
    rng = random.Random(seed)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "mi", "value",
             "def", "return", "data", "self", "print"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 60))
                        ).encode() for _ in range(300)]
    vocab = [ScoredToken(bytes([b]), rng.uniform(-11.0, -9.0))
             for b in sorted(set(b"".join(samples)))]
    seen = {t.value for t in vocab}
    while len(vocab) < n_vocab:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, max_len)]
        if w not in seen:
            seen.add(w)
            vocab.append(ScoredToken(w, rng.uniform(-9.0, -1.0)))
    return Model(vocab), samples


@pytest.mark.cuda
@pytest.mark.parametrize("L", [5, 16, 40])
def test_cuda_viterbi_chunk_matches_twin(cuda_device, L):
    g = torch.Generator().manual_seed(L)
    C, B = 256, 300
    s = torch.round(torch.empty(C, L, B).uniform_(-12, -1, generator=g) * 2) / 2
    s[torch.rand(C, L, B, generator=g) < 0.4] = lc.NEG
    s[5] = lc.NEG
    starts = (torch.rand(C, B, generator=g) < 0.05).float()
    hist0 = torch.round(torch.empty(L, B).uniform_(-30, 0, generator=g) * 2) / 2
    args = (s, starts, hist0)
    want = lc.viterbi_chunk_plain(*args)
    before = lc.viterbi_chunk.launches
    got = lc.viterbi_chunk(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert lc.viterbi_chunk.launches == before + 1
    for g_, w in zip(got, want):
        assert torch.equal(g_.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout,max_len", [(0.0, 11), (0.3, 11), (0.3, 40)])
def test_cuda_fused_forward_matches_twin(cuda_device, dropout, max_len):
    model, samples = _corpus(600, max_len=max_len)
    tbl = lat.DeviceTables.from_table(TokenTable.build(model.vocab),
                                      cuda_device)
    assert lat.has_vscan(tbl)
    batch = lat.prepare_batch(pack_samples(samples, width=1024,
                                           row_multiple=128),
                              tbl.max_len, cuda_device)
    du = None
    if dropout:
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        du = torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                           generator=gen, dtype=torch.int32,
                           device=cuda_device)
    args = lat.fused_inputs(tbl, batch, du, dropout)
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    want = lcf.fused_forward_chunk_plain("viterbi", *args, **kw)
    got = lcf.fused_forward_chunk("viterbi", *args, **kw)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hints", [None, (16, None)])
def test_cuda_encode_matches_cpu(cuda_device, hints):
    model, samples = _corpus(600, seed=1)
    long = b" ".join(samples)[:3000]
    mixed = samples + [b"", long]
    counts = (lc.viterbi_scan.launches, lcf.fused_forward_chunk.launches)
    got = ed.encode_corpus_device(model, mixed, table_hints=hints,
                                  max_width=1024, device=cuda_device)
    launched = (lc.viterbi_scan.launches - counts[0],
                lcf.fused_forward_chunk.launches - counts[1])
    assert launched[1 if hints is None else 0] > 0
    want = ed.encode_corpus_device(model, mixed, table_hints=hints,
                                   max_width=1024, device="cpu")
    assert got == want
    assert all(model.decode_bytes(ids) == s for ids, s in zip(got, mixed))


def _lse_slab(L, seed):
    """A seeded (C, L, B) slab with 40 % NEG holes and a step with no
    candidate, sample boundaries, a history, and forward values and
    normalisers that keep the backward pass's marginals near [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    C, B = 256, 300  # B is not a multiple of the 32-row block
    s = torch.round(torch.empty(C, L, B).uniform_(-12, -1, generator=g) * 2) / 2
    s[torch.rand(C, L, B, generator=g) < 0.4] = lc.NEG
    s[5] = lc.NEG
    bounds = (torch.rand(C, B, generator=g) < 0.05).float()
    hist0 = torch.round(torch.empty(L, B).uniform_(-30, 0, generator=g) * 2) / 2
    a = torch.empty(C, B).uniform_(-1, 0, generator=g)
    z = torch.empty(C, B).uniform_(0, 1, generator=g)
    return s, bounds, hist0, a, z


def _assert_close(got, want, rtol):
    got, want = got.cpu(), want.cpu()
    fin = want > lc.NEG * 0.5
    assert torch.equal(got > lc.NEG * 0.5, fin)
    np.testing.assert_allclose(got[fin].numpy(), want[fin].numpy(), rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 13, 32])
def test_cuda_forward_chunk_matches_twin(cuda_device, L):
    s, starts, hist0, _, _ = _lse_slab(L, L)
    want = lc.forward_chunk_plain(s, starts, hist0)
    before = lc.forward_chunk.launches
    got = lc.forward_chunk(*(t.to(cuda_device) for t in (s, starts, hist0)))
    torch.cuda.synchronize()
    assert lc.forward_chunk.launches == before + 1
    _assert_close(got[0], want[0], TOL["a"])
    _assert_close(got[1], want[1], TOL["hist"])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 13, 32])
def test_cuda_backward_chunk_matches_twin(cuda_device, L):
    s, ends, hist0, a, z = _lse_slab(L, L + 100)
    want = lc.backward_chunk_plain(s, a, z, ends, hist0)
    before = lc.backward_chunk.launches
    got = lc.backward_chunk(*(t.to(cuda_device)
                              for t in (s, a, z, ends, hist0)))
    torch.cuda.synchronize()
    assert lc.backward_chunk.launches == before + 1
    assert float(want[0].max()) > 1e-3
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=TOL["marg"], atol=1e-37)
    _assert_close(got[1], want[1], TOL["hist"])


@pytest.mark.cuda
@pytest.mark.parametrize("hints,probe", [(None, None), ((16, None), "fast")])
def test_cuda_e_step_matches_cpu(cuda_device, hints, probe):
    model, samples = _corpus(600, seed=2)
    counts = (lc.forward_scan.launches, lc.backward_marginal_scan.launches)
    got = ed.run_e_step_device(model, samples, dropout=0.0, max_snippet=1024,
                               probe=probe, table_hints=hints,
                               device=cuda_device)
    # Each scan once per row group.
    fwd = lc.forward_scan.launches - counts[0]
    assert fwd > 0 and lc.backward_marginal_scan.launches - counts[1] == fwd
    want = ed.run_e_step_device(model, samples, dropout=0.0,
                                max_snippet=1024, probe=probe,
                                table_hints=hints, device="cpu")
    _assert_counts_close(got, want, model, samples)


def _assert_counts_close(got, want, model, samples):
    """E-step counts on the card against the CPU plain run. The kernels
    equal their plain versions on the card, but the CPU's exp/log differ
    from the card's in the last ulp, which now and then flips the rounding
    of a forward or backward value; every marginal downstream moves by
    that ulp, relative. The tolerance is 4 ulps of the largest |z| (the
    f64 oracle's), as in chip_smoke.py's phase 3b, and the total is held
    to 1e-5."""
    zmax = 0.0
    for s in samples:
        for off in range(0, len(s), ed.DEVICE_EM_SNIPPET):
            lattice = Lattice(s[off : off + ed.DEVICE_EM_SNIPPET])
            model.oracle.populate_nodes(lattice, 0.0)
            z = lattice.populate_marginal([0.0] * model.vocab_size())
            zmax = max(zmax, abs(z))
    rtol = 4 * float(np.spacing(np.float32(zmax)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4)
    assert abs(got.sum() - want.sum()) <= 1e-5 * want.sum()


def _fused_batch(max_len, dropout, dev):
    """A 40-row batch (not a multiple of the 32-row block) of the
    `_corpus` vocabulary at token length max_len, its tables, and dropout
    words."""
    model, samples = _corpus(600, max_len=max_len)
    tbl = lat.DeviceTables.from_table(TokenTable.build(model.vocab), dev)
    assert lat.has_vscan(tbl) and tbl.max_len == max_len
    batch = lat.prepare_batch(pack_samples(samples, width=1024), max_len, dev)
    assert batch.p1.shape[0] % 32 != 0
    du = None
    if dropout:
        gen = torch.Generator(device=dev).manual_seed(max_len)
        du = torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                           generator=gen, dtype=torch.int32, device=dev)
    return tbl, batch, du


@pytest.mark.cuda
@pytest.mark.parametrize("dropout,max_len", [(0.0, 8), (0.3, 11), (0.3, 32)])
def test_cuda_fused_forward_logsumexp_matches_twin(cuda_device, dropout,
                                                   max_len):
    tbl, batch, du = _fused_batch(max_len, dropout, cuda_device)
    args = lat.fused_inputs(tbl, batch, du, dropout)
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    want = lcf.fused_forward_chunk_plain("logsumexp", *args, **kw)
    before = lcf.fused_forward_chunk.launches
    got = lcf.fused_forward_chunk("logsumexp", *args, **kw)
    torch.cuda.synchronize()
    assert lcf.fused_forward_chunk.launches == before + 1
    assert got[1] is None and torch.equal(got[3], want[3])
    _assert_close(got[0], want[0], TOL["a"])
    _assert_close(got[2], want[2], TOL["hist"])


@pytest.mark.cuda
@pytest.mark.parametrize("dropout,max_len", [(0.0, 8), (0.3, 11), (0.3, 32)])
def test_cuda_fused_backward_matches_twin(cuda_device, dropout, max_len):
    tbl, batch, du = _fused_batch(max_len, dropout, cuda_device)
    args = lat.fused_bwd_inputs(tbl, batch, du, dropout)
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    want = lcf.fused_backward_chunk_plain(*args, **kw)
    before = lcf.fused_backward_chunk.launches
    got = lcf.fused_backward_chunk(*args, **kw)
    torch.cuda.synchronize()
    assert lcf.fused_backward_chunk.launches == before + 1
    assert bool((want == 0).any())  # rows that pack several samples
    _assert_close(got, want, TOL["betas"])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 13, 32])
def test_cuda_backward_betas_chunk_matches_twin(cuda_device, L):
    s, ends, hist0, _, _ = _lse_slab(L, L + 200)
    want = lc.backward_betas_chunk_plain(s, ends, hist0)
    before = lc.backward_betas_chunk.launches
    got = lc.backward_betas_chunk(*(t.to(cuda_device)
                                    for t in (s, ends, hist0)))
    torch.cuda.synchronize()
    assert lc.backward_betas_chunk.launches == before + 1
    _assert_close(got[0], want[0], TOL["betas"])
    _assert_close(got[1], want[1], TOL["hist"])


def _scan_inputs(L, dropout, dev, direction):
    """A whole-width scan's arguments on a packed batch of the `_corpus`
    vocabulary at token length L: 48 rows (not a multiple of the 32-row
    warp), its start-indexed cache, chains cut every 64 positions, and
    dropout words."""
    model, samples = _corpus(600, max_len=L)
    tbl = lat.DeviceTables.from_table(
        TokenTable.build(model.vocab, min_bits=16), dev)
    assert tbl.max_len == L
    batch = lat.prepare_batch(pack_samples(samples, width=1024), L, dev)
    assert batch.p1.shape[0] % 32 != 0
    W = batch.width
    cache = lat.match_cache(tbl, batch, C=512)[0]
    fwd, bwd = lat.chain_bounds(batch, 64)
    if direction == "forward":
        args = (cache, batch.is_start[:, 1:].t().float().contiguous(),
                lat._hist0(batch, L, None).clamp(min=lc.NEG).t().contiguous(),
                fwd)
    else:
        args = (cache, batch.is_end[:, :W].t().float().contiguous(),
                lcf.betas_hist0(batch.is_end[:, W], L), bwd)
    kw = {"pad": batch.pad}
    if dropout:
        gen = torch.Generator(device=dev).manual_seed(L)
        du = torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                           generator=gen, dtype=torch.int32, device=dev)
        kw.update(du=du.t().contiguous(), dropout=dropout)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("L", [8, 16, 32])
def test_cuda_forward_scan_matches_twin(cuda_device, L, dropout):
    args, kw = _scan_inputs(L, dropout, cuda_device, "forward")
    want = lc.forward_scan_plain(*args, **kw)
    before = lc.forward_scan.launches
    got = lc.forward_scan(*args, **kw)
    torch.cuda.synchronize()
    assert lc.forward_scan.launches == before + 1
    _assert_close(got, want, TOL["a"])


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("L", [8, 16, 32])
def test_cuda_backward_betas_scan_matches_twin(cuda_device, L, dropout):
    args, kw = _scan_inputs(L, dropout, cuda_device, "backward")
    want = lc.backward_betas_scan_plain(*args, **kw)
    before = lc.backward_betas_scan.launches
    got = lc.backward_betas_scan(*args, **kw)
    torch.cuda.synchronize()
    assert lc.backward_betas_scan.launches == before + 1
    assert bool((want == 0).any())  # rows that pack several samples
    _assert_close(got, want, TOL["betas"])


def _marginal_inputs(L, dropout, dev):
    """The marginal scan's arguments on the batch `_scan_inputs` packs: its
    cache, the forward values of the same cache and dropout words, the
    backward chains cut every 64 positions, and the dropout keywords."""
    model, samples = _corpus(600, max_len=L)
    tbl = lat.DeviceTables.from_table(
        TokenTable.build(model.vocab, min_bits=16), dev)
    batch = lat.prepare_batch(pack_samples(samples, width=1024), L, dev)
    cache = lat.match_cache(tbl, batch, C=512)
    du, kw = None, {"pad": batch.pad}
    if dropout:
        gen = torch.Generator(device=dev).manual_seed(L)
        du = torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                           generator=gen, dtype=torch.int32, device=dev)
        kw.update(du=du.t().contiguous(), dropout=dropout)
    A = lat.forward(tbl, batch, cache, drop_u=du, dropout=dropout)
    return (cache[0], *lat._marginal_inputs(batch, A, L),
            lat.chain_bounds(batch, 64)[1]), kw


@pytest.mark.cuda
@pytest.mark.parametrize("chained", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("L", [8, 16, 32, 64])
def test_cuda_backward_marginal_scan_matches_twin(cuda_device, L, dropout,
                                                  chained):
    """The whole-width marginal scan, rows cut into chains every 64
    positions or one chain per row, equals its twin bit for bit: the
    marginals and the betas."""
    args, kw = _marginal_inputs(L, dropout, cuda_device)
    seg = args[5] if chained else None
    want = lc.backward_marginal_scan_plain(*args[:5], seg, **kw)
    before = lc.backward_marginal_scan.launches
    got = lc.backward_marginal_scan(*args[:5], seg, **kw)
    torch.cuda.synchronize()
    assert lc.backward_marginal_scan.launches == before + 1
    assert float(want[0].max()) > 0.5 and bool((want[1] == 0).any())
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


def _seg_case(dev, n_vocab=600, plant=False):
    """One packed group of the `_corpus` vocabulary in the session's
    rank space: its batch, tables, rank score rows, SegStruct and the
    forward values and betas over its cache (the scans on the card).
    `plant` puts two ranks at a second length too (as a hash false
    positive of the probe would), so that their SegStruct entries chain."""
    model, samples = _corpus(n_vocab, seed=3)
    table = TokenTable.build(model.vocab, min_bits=16)
    tbl = lat.DeviceTables.from_table(table, dev)
    batch = lat.prepare_batch(pack_samples(samples, width=1024), tbl.max_len,
                              dev)
    rank = lat.build_rank_space(table)
    _, raw = lat.match_cache(tbl, batch, C=512)
    slots = lat.remap_slots(torch.as_tensor(rank.lut, device=dev), raw)
    if plant:
        g = torch.Generator(device=dev).manual_seed(11)
        for l_from, l_to in ((1, 4), (2, 6), (2, 9)):
            r = int(slots[:, l_from][slots[:, l_from] < rank.n_pad][0])
            miss = slots[:, l_to] == rank.n_pad
            pick = miss & (torch.rand(miss.shape, generator=g, device=dev)
                           < 0.02)
            slots[:, l_to][pick] = r
    rows = lat.rank_score_rows(rank, tbl)
    cache = (lat.score_from_slots(rows, slots), slots)
    A = lat.forward(tbl, batch, cache)
    Bt = lat.backward_betas(tbl, batch, cache)
    return batch, tbl, rows, lat.build_seg_struct(slots, rank.n_pad), A, Bt


def _seg_du(batch, dropout, dev):
    if not dropout:
        return None
    gen = torch.Generator(device=dev).manual_seed(5)
    return torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                         generator=gen, dtype=torch.int32, device=dev)


def _assert_seg_kernels_match_twins(batch, rows, seg, A, Bt, du, dropout):
    """Both segsum kernels against their twins on the same inputs: every
    output equal bit for bit (NaN where the twin has NaN)."""
    args = (seg, A, batch.end_index, batch.is_start, Bt, rows, du)
    kw = {"dropout": dropout, "pad": batch.pad}
    want = lcs.seg_weights_gather_plain(*args, **kw)
    before = lcs.seg_weights_gather.launches, lcs.seg_sums.launches
    got = lcs.seg_weights_gather(*args, **kw)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, rtol=0, atol=0, equal_nan=True)
    want_acc = lcs.seg_sums_plain(seg, *want[:3], want[3].clone())
    got_acc = lcs.seg_sums(seg, *got[:3], got[3])
    torch.cuda.synchronize()
    assert (lcs.seg_weights_gather.launches, lcs.seg_sums.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got_acc, want_acc, rtol=0, atol=0,
                               equal_nan=True)
    return got, got_acc


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_cuda_seg_weights_gather_matches_twin(cuda_device, dropout):
    """Every length of a group in one launch, its streams made and gathered
    in the kernel, equals the twin bit for bit (cf, t, the whole-block
    sums, the zeroed accumulator); so do the sums of `seg_sums`."""
    batch, tbl, rows, seg, A, Bt = _seg_case(cuda_device)
    du = _seg_du(batch, dropout, cuda_device)
    got, acc = _assert_seg_kernels_match_twins(batch, rows, seg, A, Bt, du,
                                               dropout)
    assert len(seg.perm) == tbl.max_len and float(got[1].max()) > 1.0
    assert int((got[2] > 0).sum()) > 0 and float(acc.sum()) > 100
    assert bool((acc >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_cuda_seg_sums_chain_and_poison(cuda_device, dropout):
    """Ranks planted at a second length (their SegStruct entries chained)
    sum in ascending length as the twin sums them; betas raised by 5
    (marginals up to e^5: whole blocks over the fixed point's limit)
    poison their segments' sums to NaN in both."""
    batch, tbl, rows, seg, A, Bt = _seg_case(cuda_device, plant=True)
    assert int((seg.nxt >= 0).sum()) == 2 and int((seg.nxt <= -3).sum()) == 1
    du = _seg_du(batch, dropout, cuda_device)
    _assert_seg_kernels_match_twins(batch, rows, seg, A, Bt, du, dropout)
    got, acc = _assert_seg_kernels_match_twins(
        batch, rows, seg, A, Bt + 5.0, du, dropout)
    assert bool((got[2] < 0).any()) and bool(acc.isnan().any())


@pytest.mark.cuda
def test_cuda_segsum_two_calls_bit_equal(cuda_device):
    """No float atomics: two calls of segsum_expected give the same bits,
    two launches each."""
    batch, tbl, rows, seg, A, Bt = _seg_case(cuda_device)
    du = _seg_du(batch, 0.1, cuda_device)
    before = lcs.seg_weights_gather.launches, lcs.seg_sums.launches
    got = [lat.segsum_expected(tbl, batch, A, Bt, seg, rows, du, 0.1)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert (lcs.seg_weights_gather.launches, lcs.seg_sums.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got[0], got[1]) and float(got[0].sum()) > 100


@pytest.mark.cuda
def test_cuda_seg_kernels_reject_bad_input(cuda_device):
    """On the card the wrappers refuse what the kernels do not take, and
    never fall back to the twins."""
    import dataclasses

    batch, tbl, rows, seg, A, Bt = _seg_case(cuda_device)
    args = (seg, A, batch.end_index, batch.is_start, Bt, rows)
    cf, t, mid, acc = lcs.seg_weights_gather(*args)
    rep = dataclasses.replace
    for bad in ((rep(seg, nxt=seg.nxt.cpu()), *args[1:]),
                (seg, A.cpu(), *args[2:]),
                (seg, A, batch.end_index.long(), *args[3:]),
                (seg, *args[1:5], rows[:, None])):
        with pytest.raises(ValueError):
            lcs.seg_weights_gather(*bad)
    with pytest.raises(ValueError):
        lcs.seg_weights_gather(*args, dropout=0.1)  # no dropout words
    for bad in ((seg, cf.cpu(), t, mid, acc), (seg, cf, t, mid.int(), acc),
                (rep(seg, occ_slot=seg.occ_slot[:, :-1].contiguous()), cf, t,
                 mid, acc)):
        with pytest.raises(ValueError):
            lcs.seg_sums(*bad)
    before = lcs.seg_weights_gather.launches, lcs.seg_sums.launches
    plain = (lcs.seg_weights_gather_plain, lcs.seg_sums_plain)

    def refuse(*a, **k):
        raise AssertionError("a twin ran on the card")

    lcs.seg_weights_gather_plain = lcs.seg_sums_plain = refuse
    try:
        lat.segsum_expected(tbl, batch, A, Bt, seg, rows)
        torch.cuda.synchronize()
    finally:
        lcs.seg_weights_gather_plain, lcs.seg_sums_plain = plain
    assert (lcs.seg_weights_gather.launches, lcs.seg_sums.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_cuda_session_over_budget_matches_budgeted(cuda_device, dropout):
    """A session with no cache budget takes the per-pass branch on every
    pass (the marginal scan once per group) and counts what the budgeted
    session counts (segsum against scatter: rtol 1e-3 per token, 1e-4 on
    the total). The scatter's atomic adds land in no fixed order, so two
    passes agree to rounding, not bit for bit."""
    model, samples = _corpus(600, seed=2)
    want = DeviceTrainSession(model, samples, 1024, kernel="slab",
                              device=cuda_device).e_step(model, dropout, 3)
    before = (lc.backward_marginal_scan.launches,
              lcs.seg_weights_gather.launches, lcs.seg_sums.launches)
    sess = DeviceTrainSession(model, samples, 1024, kernel="slab",
                              cache_budget=0, device=cuda_device)
    got = [sess.e_step(model, dropout, 3) for _ in range(2)]
    groups = len(sess._groups())
    assert lc.backward_marginal_scan.launches - before[0] == 2 * groups
    assert lcs.seg_weights_gather.launches == before[1]
    assert lcs.seg_sums.launches == before[2]
    assert not sess.slot_cache
    for counts in got:
        np.testing.assert_allclose(counts, want, rtol=1e-3, atol=1e-4)
        assert abs(counts.sum() - want.sum()) <= 1e-4 * want.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("max_len", [8, 16, 32])
def test_cuda_fused_scans_with_chains_equal_twins(cuda_device, max_len,
                                                  dropout):
    """The fused log-sum-exp scans, rows cut into chains every 64
    positions and uncut, equal their twins bit for bit."""
    tbl, batch, du = _fused_batch(max_len, dropout, cuda_device)
    chains = lat.chain_bounds(batch, 64)
    assert bool((chains[0][1:-1] < batch.width).any())
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    fwd = lat.fused_inputs(tbl, batch, du, dropout)
    bwd = lat.fused_bwd_inputs(tbl, batch, du, dropout)
    for seg_f, seg_b in (chains, (None, None)):
        want = lcf.fused_forward_chunk_plain("logsumexp", *fwd, **kw,
                                             seg=seg_f)
        before = lcf.fused_forward_chunk.launches
        got = lcf.fused_forward_chunk("logsumexp", *fwd, **kw, seg=seg_f)
        torch.cuda.synchronize()
        assert lcf.fused_forward_chunk.launches == before + 1
        assert got[1] is None
        # The kernel writes a and rl; hist is rebuilt from a on both sides
        # (`_hist_from_values`), so only a and rl witness the kernel.
        for i in (0, 3):  # a, rl
            assert torch.equal(got[i], want[i])
        want = lcf.fused_backward_chunk_plain(*bwd, **kw, seg=seg_b)
        before = lcf.fused_backward_chunk.launches
        got = lcf.fused_backward_chunk(*bwd, **kw, seg=seg_b)
        torch.cuda.synchronize()
        assert lcf.fused_backward_chunk.launches == before + 1
        assert bool((want == 0).any()) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["fused_forward", "fused_backward",
                                  "forward_scan", "backward_betas_scan",
                                  "fused_viterbi", "viterbi_scan",
                                  "backward_marginal_scan"])
def test_cuda_scans_clamp_chain_bounds(cuda_device, scan):
    """Bounds on the card are not read back: every scan clamps a chain
    into [0, W]. Ends past the width give the valid chains' values, and
    bounds out of order launch and finish without a fault."""
    if scan.startswith("fused"):
        tbl, batch, _ = _fused_batch(16, 0.0, cuda_device)
        kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad)
        chains = lat.chain_bounds(batch, 64)
        if scan in ("fused_forward", "fused_viterbi"):
            args = lat.fused_inputs(tbl, batch)
            kind = "logsumexp" if scan == "fused_forward" else "viterbi"

            def run(seg):
                out = lcf.fused_forward_chunk(kind, *args, **kw, seg=seg)
                return out[0] if out[1] is None else torch.cat(
                    [out[0].view(torch.int32), out[1]])
            seg = chains[0]
        else:
            args = lat.fused_bwd_inputs(tbl, batch)

            def run(seg):
                return lcf.fused_backward_chunk(*args, **kw, seg=seg)
            seg = chains[1]
    elif scan == "viterbi_scan":
        args, kw = _scan_inputs(16, 0.0, cuda_device, "forward")
        seg = args[3]

        def run(seg):
            dp, best_l = lc.viterbi_scan(*args[:3], seg, **kw)
            return torch.cat([dp.view(torch.int32), best_l])
    elif scan == "backward_marginal_scan":
        args, kw = _marginal_inputs(16, 0.0, cuda_device)
        seg = args[5]

        def run(seg):
            marg, betas = lc.backward_marginal_scan(*args[:5], seg, **kw)
            return torch.cat([marg.reshape(-1), betas.reshape(-1)])
    else:
        direction = "forward" if scan == "forward_scan" else "backward"
        args, kw = _scan_inputs(16, 0.0, cuda_device, direction)
        fn = lc.forward_scan if scan == "forward_scan" else \
            lc.backward_betas_scan
        seg = args[3]

        def run(seg):
            return fn(*args[:3], seg, **kw)
    W = int(seg[-1, 0])
    want = run(seg)
    wide = seg.clone()
    wide[0] = -7
    wide[-1] = W + 100
    got = run(wide)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    tangled = seg.clone()
    tangled[1] = W + 5
    tangled[2] = -3
    run(tangled)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("chained", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("L", [8, 16, 32, 64])
def test_cuda_viterbi_scan_matches_twin(cuda_device, L, dropout, chained):
    """The whole-width Viterbi scan, rows cut into chains every 64
    positions or one chain per row, equals its twin bit for bit."""
    args, kw = _scan_inputs(L, dropout, cuda_device, "forward")
    seg = args[3] if chained else None
    want = lc.viterbi_scan_plain(*args[:3], seg, **kw)
    before = lc.viterbi_scan.launches
    got = lc.viterbi_scan(*args[:3], seg, **kw)
    torch.cuda.synchronize()
    assert lc.viterbi_scan.launches == before + 1
    assert bool((want[1] > 1).any()) and bool((want[0] <= lc.NEG / 2).any())
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


def _tied_cache(L, seed, dev, lead=0):
    """A (lead + 256, L, 300) start-indexed cache whose scores take three
    values (-2, -2.5, -3) with 30 % NEG holes, and a history of
    half-integers: equal candidates on lanes far apart, and on the two
    length tiles of one lane at L = 64."""
    g = torch.Generator().manual_seed(seed)
    n, B = 256, 300
    cache = -2.0 - 0.5 * torch.randint(0, 3, (lead + n, L, B), generator=g)
    cache[torch.rand(cache.shape, generator=g) < 0.3] = lc.NEG
    starts = (torch.rand(n, B, generator=g) < 0.05).float()
    hist = -0.5 * torch.randint(0, 40, (L, B), generator=g).float()
    return [t.to(dev).contiguous() for t in (cache.float(), starts, hist)]


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [0, 5])
@pytest.mark.parametrize("L", [16, 32, 64])
def test_cuda_viterbi_ties_across_lanes(cuda_device, L, lead):
    """Ties between lengths on different lanes and tiles go to the
    longest, as in the twins: the scan (with a cache reaching `lead`
    positions before 0) and the chunk API over its end-indexed view."""
    cache, starts, hist = _tied_cache(L, L + lead, cuda_device, lead)
    want = lc.viterbi_scan_plain(cache, starts, hist, lead=lead)
    got = lc.viterbi_scan(cache, starts, hist, lead=lead)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    # Longest lengths win in both tiles of a lane (L = 64: j and j + 32).
    assert bool((want[1] > L // 2).any()) and bool((want[1] > 1).any())
    end = lc._end_view(cache.clamp(min=lc.NEG), 256, lead).contiguous()
    want_c = lc.viterbi_chunk_plain(end, starts, hist)
    got_c = lc.viterbi_chunk(end, starts, hist)
    torch.cuda.synchronize()
    for g_, w in zip(got_c, want_c):
        assert torch.equal(g_, w)
    assert torch.equal(got_c[0], got[0]) and torch.equal(got_c[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("max_len", [8, 16, 32, 64])
def test_cuda_fused_viterbi_with_chains_equals_twin(cuda_device, max_len,
                                                    dropout):
    """The fused Viterbi kind, rows cut into chains every 64 positions and
    uncut, equals its twin bit for bit (dp, best_l and rl, the kernel's
    outputs; hist is rebuilt from dp on both sides)."""
    tbl, batch, du = _fused_batch(max_len, dropout, cuda_device)
    chains = lat.chain_bounds(batch, 64)
    assert bool((chains[0][1:-1] < batch.width).any())
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    args = lat.fused_inputs(tbl, batch, du, dropout)
    for seg in (chains[0], None):
        want = lcf.fused_forward_chunk_plain("viterbi", *args, **kw, seg=seg)
        before = lcf.fused_forward_chunk.launches
        got = lcf.fused_forward_chunk("viterbi", *args, **kw, seg=seg)
        torch.cuda.synchronize()
        assert lcf.fused_forward_chunk.launches == before + 1
        for i in (0, 1, 3):  # dp, best_l, rl
            assert torch.equal(got[i], want[i])
        assert bool((want[1] > 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("H,n_tail", [(1 << 16, 1), (1 << 12, 100)])
def test_cuda_seg_weights_matches_twin(cuda_device, H, n_tail):
    g = torch.Generator().manual_seed(H + n_tail)
    r0 = torch.empty(H).uniform_(-6, 0, generator=g)
    r1 = torch.empty(H).uniform_(-6, 0, generator=g)
    d2 = torch.empty(H).uniform_(-0.5, 0.5, generator=g)
    d2[::128] = torch.empty(H // 128).uniform_(-4, 0, generator=g)
    n_hit = H - 128 + n_tail
    args = [t.to(cuda_device) for t in (r0, r1, d2)]
    want = lcs.seg_weights_plain(*args, n_hit)
    before = lcs.seg_weights.launches
    got = lcs.seg_weights(*args, n_hit)
    torch.cuda.synchronize()
    assert lcs.seg_weights.launches == before + 1
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.cpu().numpy(), w.cpu().numpy(),
                                   rtol=TOL["cf"])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [None, "slab"])
def test_cuda_session_matches_cpu(cuda_device, kernel):
    model, samples = _corpus(600, seed=2)
    kernels = ((lcf.fused_forward_chunk, lcf.fused_backward_chunk)
               if kernel is None else
               (lc.forward_scan, lc.backward_betas_scan))
    kernels += (lcs.seg_weights_gather, lcs.seg_sums)
    before = [k.launches for k in kernels]
    sess = DeviceTrainSession(model, samples, 1024, kernel=kernel,
                              device=cuda_device)
    got = [sess.e_step(model, 0.0, 0) for _ in range(2)]
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert np.array_equal(got[0], got[1])  # the steady state repeats
    cpu = DeviceTrainSession(model, samples, 1024, kernel=kernel,
                             device="cpu")
    _assert_counts_close(got[0], cpu.e_step(model, 0.0, 0), model, samples)
    np.testing.assert_array_equal(sess.count_frequencies(model),
                                  cpu.count_frequencies(model))


def _walk_case(dev, width, fused, seed=3, max_len=11, gaps=False):
    """A packed batch of whole samples (tokens up to max_len bytes), its
    tables and Viterbi outputs on the card, and its walk index, with every
    fifth span marked unreachable; `gaps` leaves every third span out, so
    a row's spans have holes between them."""
    model, samples = _corpus(3000 if not fused else 600, seed=seed,
                             max_len=max_len)
    rng = random.Random(seed)
    if width > 8192:
        samples = samples + [b" ".join(rng.choice(samples)
                                       for _ in range(90))[:width - 7]]
    tbl = lat.DeviceTables.from_table(
        TokenTable.build(model.vocab, min_bits=None if fused else 16), dev)
    assert lat.has_vscan(tbl) == fused and tbl.max_len == max_len
    packed = pack_samples(samples, width=width)
    batch = lat.prepare_batch(packed, tbl.max_len, dev)
    dp, best_l = lat.viterbi(tbl, batch, backend="fused" if fused else "slab")
    spans = [sp for k, sp in enumerate(packed.spans) if not gaps or k % 3]
    index = lat.walk_index(spans, *best_l.shape, dev)
    ok = torch.ones(index.n, dtype=torch.bool, device=dev)
    ok[::5] = False
    return tbl, batch, dp, best_l, index, ok


@pytest.mark.cuda
@pytest.mark.parametrize("width,fused,layout,max_len,gaps,segment", [
    (2048, False, "int32", 11, False, 256),
    (2048, True, "uint8", 11, False, 256),
    (2048, False, "strided", 11, False, 256),
    (32768, False, "uint8", 11, False, 256),
    (8192, False, "uint8", 16, True, 256),
    (8192, False, "strided", 16, False, 32),
    (8192, True, "uint8", 24, True, 48),
    (8192, False, "strided", 24, True, 256),
    (32768, False, "strided", 16, True, 256),
    (32768, False, "uint8", 24, False, 256)])
def test_cuda_viterbi_walk_matches_twin(cuda_device, width, fused, layout,
                                        max_len, gaps, segment, monkeypatch):
    tbl, batch, dp, best_l, index, ok = _walk_case(
        cuda_device, width, fused, max_len=max_len, gaps=gaps)
    bl = {"int32": best_l.contiguous(),
          "uint8": best_l.to(torch.uint8).contiguous(),
          "strided": best_l}[layout]
    assert (layout == "strided") == (not bl.is_contiguous())
    monkeypatch.setattr(lat, "WALK_SEGMENT", segment)
    copy = int(layout == "strided")  # the tiled copy to (B, W) bytes
    args, kw = lat._walk_tables(tbl, batch)
    for use_ok in (torch.ones_like(ok), ok):
        want = lat.viterbi_walk_plain(bl, *args, index, ok=use_ok, **kw)
        before = (lat.viterbi_walk.launches, lat.viterbi_walk.calls)
        got = lat.viterbi_walk(bl, *args, index, ok=use_ok, **kw)
        torch.cuda.synchronize()
        assert (lat.viterbi_walk.launches, lat.viterbi_walk.calls) == (
            before[0] + copy + 1, before[1] + 1)
        assert torch.equal(got, want) and int(got[-1]) == 0
        wflat, wn, wincl = lat.viterbi_walk_plain(bl, *args, index,
                                                  ok=use_ok, ids=True, **kw)
        before = (lat.viterbi_walk.launches, lat.viterbi_walk.calls)
        gflat, gn, gincl = lat.viterbi_walk(bl, *args, index, ok=use_ok,
                                            ids=True, **kw)
        torch.cuda.synchronize()
        assert (lat.viterbi_walk.launches, lat.viterbi_walk.calls) == (
            before[0] + copy + 2, before[1] + 1)
        assert torch.equal(gn, wn) and torch.equal(gincl, wincl)
        total = int(wn.sum())
        assert gflat.shape == (index.cap,)
        assert torch.equal(gflat[:total], wflat[:total])
        assert int(got[:-1].sum()) == total


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_encode_walks_on_the_card(cuda_device, fused, monkeypatch):
    model, samples = _corpus(3000 if not fused else 600, seed=5)
    texts = samples[:200] + [b"", samples[7]]
    hints = None if fused else (16, None)

    def no_host_walk(*a, **k):
        raise AssertionError("a host backtrack ran")

    want = ed.encode_corpus_device(model, texts, table_hints=hints,
                                   device="cpu")
    monkeypatch.setattr(lat, "backtrack", no_host_walk)
    before = lat.viterbi_walk.calls
    got = ed.encode_corpus_device(model, texts, table_hints=hints,
                                  device=cuda_device)
    assert got == want
    assert lat.viterbi_walk.calls == before + 1
    counts = ed.count_frequencies_device(model, texts, table_hints=hints,
                                         device=cuda_device)
    np.testing.assert_array_equal(counts, np.bincount(
        np.concatenate([np.asarray(r, np.int64) for r in want if r]),
        minlength=model.vocab_size()))


@pytest.mark.cuda
def test_cuda_viterbi_walk_clamps_spans(cuda_device):
    """On the card the walk clamps span bounds into [0, W] instead of
    checking them (a check would sync): out-of-range spans walk as their
    clamped selves and touch no memory outside the row."""
    tbl, batch, dp, best_l, index, _ = _walk_case(cuda_device, 2048, False)
    # One span a row: clamped, two spans of a row would overlap.
    rows = index.rows.cpu().numpy()
    first = np.unique(rows, return_index=True)[1]
    rows = rows[first]
    B, W = best_l.shape
    wild = [(r, s - 3000, e + 3000) for r, s, e in zip(
        rows, index.starts.cpu().numpy()[first],
        index.ends.cpu().numpy()[first])]
    clamped = [(r, 0, W) for r in rows]
    args, kw = lat._walk_tables(tbl, batch)
    kw["ok"] = torch.ones(len(rows), dtype=torch.bool, device=cuda_device)
    wild_index = lat.walk_index(wild, B, W, cuda_device)
    assert wild_index.cap == len(rows) * W
    got = lat.viterbi_walk(best_l, *args, wild_index, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, lat.viterbi_walk_plain(
        best_l, *args, lat.walk_index(clamped, B, W, cuda_device), **kw))


def _feed_samples(seed=0):
    """Seeded code-like text with multi-byte chars, samples of 0 bytes,
    one byte and one of 9 KB."""
    rng = np.random.default_rng(seed)
    pieces = ["def ", "return", " x", "(a, b)", "é", "中文", "😀", "  ", "\n",
              "value_1", "0x1F", "# note", "ab ab", "'s'", "=="]
    texts = ["".join(pieces[int(i)] for i in
                     rng.integers(0, len(pieces), int(rng.integers(0, 40))))
             for _ in range(60)]
    long = "".join(pieces[int(i)] for i in rng.integers(0, len(pieces), 4000))
    texts += ["", "a", long.encode()[:9216].decode("utf-8", "ignore")]
    return [t.encode() for t in texts]


_ALL_PATTERNS = None


def _all_patterns_dfa():
    global _ALL_PATTERNS
    if _ALL_PATTERNS is None:
        _ALL_PATTERNS = compile_dfa(build_allow_regex(
            load_patterns([p[0] for p in PATTERNS])))
    return _ALL_PATTERNS


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "global", "none"])
@pytest.mark.parametrize("p", [1.0, 0.3, 0.01])
@pytest.mark.parametrize("L", [16, 24])
def test_cuda_dfa_mask_matches_twin(cuda_device, route, p, L):
    samples = _feed_samples()
    W8, B = dd.group_shape(samples, 1 << 23)
    assert W8 == 16384 and B == 64
    arr, lens = dd.pack_group(samples, B, W8)
    rows = torch.from_numpy(arr).to(cuda_device)
    lens = torch.from_numpy(lens).to(cuda_device)
    ddfa = None if route == "none" else dd._device_dfa_for(
        _all_patterns_dfa(), cuda_device)
    table = None if route == "none" else route
    want = dd.packed_candidate_mask_plain(ddfa, rows, lens, L, p, 17, 1000)
    before = dd.packed_candidate_mask.launches
    got = dd.packed_candidate_mask(ddfa, rows, lens, L, p, 17, 1000,
                                   table=table)
    torch.cuda.synchronize()
    assert dd.packed_candidate_mask.launches == before + 1
    assert got.shape == (B, L, W8 // 8) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    assert bool(got.any())


def _ragged_rows(samples, W8, dev):
    """(B, W8) rows of the samples cut to W8 bytes, and their lengths."""
    cut = [s[:W8] for s in samples]
    arr, lens = dd.pack_group(cut, len(cut), W8)
    return (torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("p", [1.0, 0.01])
@pytest.mark.parametrize("L", [16, 24])
@pytest.mark.parametrize("W8", [512, 1056, 3104])
def test_cuda_dfa_mask_ragged_last_tile(cuda_device, route, p, L, W8):
    """Rows whose width is not a multiple of the kernel's 1,024-position
    tile: the row's last tile is shorter, its halo past the row."""
    rows, lens = _ragged_rows(_feed_samples(2), W8, cuda_device)
    ddfa = dd._device_dfa_for(_all_patterns_dfa(), cuda_device)
    want = dd.packed_candidate_mask_plain(ddfa, rows, lens, L, p, 5, 77)
    got = dd.packed_candidate_mask(ddfa, rows, lens, L, p, 5, 77,
                                   table=route)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("p", [1.0, 0.01])
def test_cuda_dfa_mask_uint16_entries(cuda_device, route, p):
    """A DFA of over 256 states takes the uint16 class table."""
    from tokengeex_tpu_torch.core.redfa import ByteDFA

    # As tests/test_torch_generate.py `_random_dfa` (this file runs
    # without JAX, so it keeps its own copy).
    rng = np.random.default_rng(9)
    group = rng.permutation(np.arange(256) % 40)
    cols = rng.integers(1, 300, (300, 40))
    cols[rng.random((300, 40)) < 0.3] = 0
    cols[0] = 0
    accept = rng.random(300) < 0.4
    accept[0] = False
    dfa = ByteDFA(np.ascontiguousarray(cols[:, group]).astype(np.int32),
                  accept, 1)
    ddfa = dd.DeviceDFA.from_byte_dfa(dfa, cuda_device)
    assert ddfa.entry_bytes == 2 and dd.pick_route(ddfa) == "shared"
    samples = _feed_samples(3)
    W8, B = dd.group_shape(samples, 1 << 23)
    arr, lens = dd.pack_group(samples, B, W8)
    rows = torch.from_numpy(arr).to(cuda_device)
    lens = torch.from_numpy(lens).to(cuda_device)
    want = dd.packed_candidate_mask_plain(ddfa, rows, lens, 16, p, 3, 0)
    got = dd.packed_candidate_mask(ddfa, rows, lens, 16, p, 3, 0,
                                   table=route)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool(got.any())


@pytest.mark.cuda
def test_cuda_feed_counts_match_cpu(cuda_device):
    """Same coins and exact keys: the card's counts equal the CPU's, and
    small groups (several launches) change nothing."""
    samples = _feed_samples(1)
    dfa = _all_patterns_dfa()
    want = dd.feed_counts(dfa, samples, 16, 0.3, seed=8, device="cpu")
    before = dd.packed_candidate_mask.launches
    got = dd.feed_counts(dfa, samples, 16, 0.3, seed=8, group_bytes=1 << 16,
                         device=cuda_device)
    assert dd.packed_candidate_mask.launches == before + 16
    assert got == want and sum(got.values()) > 0
    gen = {}
    for dev in ("cpu", cuda_device):
        g = VocabularyGenerator(max_token_length=16, insert_probability=0.3,
                                allow=build_allow_regex(load_patterns(
                                    [p[0] for p in PATTERNS])),
                                added_tokens=["def "], seed=3, device=dev)
        g.feed([s.decode() for s in samples])
        gen[str(dev)] = [(t.value, t.score, t.keep) for t in g.generate(2000)]
    assert gen["cpu"] == gen[str(cuda_device)]


@pytest.mark.cuda
def test_cuda_fused_probe_rejects_a_t2_slot_collision(cuda_device):
    """The fused kernels check the mixed word: a substring sharing a T2
    token's fp2 (and so its slot) is no match on the card either (the CPU
    case: tests/test_torch_prep.py)."""
    from tokengeex_tpu_torch.ops import hashing as H

    token, other = b"fiqsqmg", b"ceot\nsn"
    vocab = [ScoredToken(bytes([b]), -10.0)
             for b in sorted(set(token + other + b"x"))]
    vocab.append(ScoredToken(token, -0.5))
    pt = TokenTable.build(vocab)
    r1 = int(np.nonzero(pt.t1[:, 3] == len(vocab) - 1)[0][0])
    i2 = int(H.host_table_index(
        np.array([H.host_fingerprints(token)[1]]), np.array([len(token)]),
        H.IDX_A2, H.IDX_M2, pt.bits)[0])
    pt.t2[i2] = pt.t1[r1]
    pt.t1[r1] = np.array([0, 0, 0, 0xFFFFFFFF], dtype=np.uint32)
    model = Model(vocab)
    samples = [b"x" + other + b"x", token, b"x" + token + other]
    before = lcf.fused_forward_chunk.launches
    got = ed.encode_corpus_device(
        model, samples, table=lat.DeviceTables.from_table(pt, cuda_device),
        device=cuda_device)
    assert lcf.fused_forward_chunk.launches == before + 1
    assert got == [model.oracle.encode(s.decode()) for s in samples]


def _f64_scan_inputs(L, dropout, dev):
    """`_scan_inputs`' batch in float64: the exact probe's f64 cache, the
    forward's and the marginal scan's streams, both chain bounds."""
    model, samples = _corpus(600, max_len=L)
    tbl = lat.DeviceTables.from_table(
        TokenTable.build(model.vocab, min_bits=16), dev, torch.float64)
    batch = lat.prepare_batch(pack_samples(samples, width=1024), L, dev)
    W = batch.width
    cache = lat.match_cache(tbl, batch, C=512, dtype=torch.float64)
    assert cache[0].dtype == torch.float64 and bool((cache[1] >= 0).any())
    fwd, bwd = lat.chain_bounds(batch, 64)
    du, kw = None, {"pad": batch.pad}
    if dropout:
        gen = torch.Generator(device=dev).manual_seed(L)
        du = torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                           generator=gen, dtype=torch.int32, device=dev)
        kw.update(du=du.t().contiguous(), dropout=dropout)
    starts = batch.is_start[:, 1:].t().double().contiguous()
    hist = lat._hist0(batch, L, None, torch.float64).clamp(
        min=lc.NEG).t().contiguous()
    A = lat.forward(tbl, batch, cache, drop_u=du, dropout=dropout)
    assert A.dtype == torch.float64
    marg = (cache[0], *lat._marginal_inputs(batch, A, L), bwd)
    assert all(t.dtype == torch.float64 for t in marg[:5])
    return (cache[0], starts, hist, fwd), marg, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("L", [8, 16, 32])
def test_cuda_f64_scans_match_twins(cuda_device, L, dropout):
    """The double instantiations of viterbi_scan (bit for bit),
    forward_scan and backward_marginal_scan (rtol 1e-12: the card's
    double exp / log against torch's) equal their f64 twins on the card,
    each counted apart from the f32 launches."""
    fwd_args, marg_args, kw = _f64_scan_inputs(L, dropout, cuda_device)
    before = (lc.viterbi_scan.launches, lc.viterbi_scan.launches_f64,
              lc.forward_scan.launches_f64,
              lc.backward_marginal_scan.launches_f64)
    want = lc.viterbi_scan_plain(*fwd_args, **kw)
    got = lc.viterbi_scan(*fwd_args, **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float64 and bool((want[1] > 1).any())
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    _assert_close(lc.forward_scan(*fwd_args, **kw),
                  lc.forward_scan_plain(*fwd_args, **kw), 1e-12)
    got = lc.backward_marginal_scan(*marg_args, **kw)
    want = lc.backward_marginal_scan_plain(*marg_args, **kw)
    torch.cuda.synchronize()
    assert float(want[0].max()) > 0.5
    for g_, w in zip(got, want):
        _assert_close(g_, w, 1e-12)
    assert (lc.viterbi_scan.launches, lc.viterbi_scan.launches_f64,
            lc.forward_scan.launches_f64,
            lc.backward_marginal_scan.launches_f64) == \
        (before[0], before[1] + 1, before[2] + 1, before[3] + 1)


@pytest.mark.cuda
def test_cuda_f64_encode_and_estep_match_cpu(cuda_device):
    """Encode at f64 (a chained sample included) gives the CPU's ids; the
    f64 E-step and session give the CPU's counts at rtol 1e-8; all
    through the double kernels."""
    model, samples = _corpus(600, seed=1)
    mixed = samples[:80] + [b" ".join(samples)[:3000]]
    f64 = torch.float64
    before = (lc.viterbi_scan.launches_f64, lc.forward_scan.launches_f64,
              lc.backward_marginal_scan.launches_f64)
    got = ed.encode_corpus_device(model, mixed, dtype=f64, max_width=1024,
                                  device=cuda_device)
    assert got == ed.encode_corpus_device(model, mixed, dtype=f64,
                                          max_width=1024, device="cpu")
    assert got == [model.oracle.encode(s) for s in mixed]
    est = ed.run_e_step_device(model, samples[:80], 0.0, 81920, dtype=f64,
                               device=cuda_device)
    want = ed.run_e_step_device(model, samples[:80], 0.0, 81920, dtype=f64,
                                device="cpu")
    np.testing.assert_allclose(est, want, rtol=1e-8, atol=1e-9)
    sess = DeviceTrainSession(model, samples[:80], 81920, dtype=f64,
                              device=cuda_device)
    np.testing.assert_allclose(sess.e_step(model, 0.0, 0), want, rtol=1e-8,
                               atol=1e-9)
    after = (lc.viterbi_scan.launches_f64, lc.forward_scan.launches_f64,
             lc.backward_marginal_scan.launches_f64)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.cuda
def test_cuda_prune_alternatives_match_cpu(cuda_device):
    """The prune round's alternatives on the card (one masked f64 Viterbi
    pass: viterbi_scan's double instantiation and the walk's ids mode)
    equal the plain route's on the CPU, and the oracle's nbest(2) keep
    flags."""
    from tokengeex_tpu_torch.train.prune import VocabularyPruner

    model, _ = _corpus(2000, seed=3, max_len=16)
    before = (lc.viterbi_scan.launches_f64, lat.viterbi_walk.launches)
    got = ed.prune_alternatives_device(model, device=cuda_device)
    assert (lc.viterbi_scan.launches_f64, lat.viterbi_walk.launches) == \
        (before[0] + 1, before[1] + 3)
    want = ed.prune_alternatives_device(model, device="cpu")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    oracle = VocabularyPruner(10, backend="oracle")._alternatives(model)
    assert np.array_equal(got[0], oracle[0])
    assert int((~got[0]).sum()) > 0 and sum(map(bool, got[1])) > 1000
