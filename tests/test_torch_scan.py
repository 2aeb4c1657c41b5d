"""The port's whole-width scans against the JAX package's, on the CPU.

`forward_scan` and `backward_betas_scan` (csrc/forward_chunk.cu,
csrc/backward_chunk.cu) read a start-indexed score cache over the whole
row width, draw the dropout coins themselves and cut each row into chains
at sample boundaries and padding (`lattice.chain_bounds`). Their twins are
held against `lattice_jax.forward(cache=)` and `backward_betas(cache=)` on
the same packed batch, tables and numpy dropout words; the chain-split
twins against the one-chain-per-row twins bit for bit, on rows that pack
several samples with padding gaps, rows that begin in padding and samples
longer than a segment; and the wrappers' argument checks.
tests/test_torch_cuda.py holds the CUDA kernels against the twins on a GPU.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokengeex_tpu import ScoredToken as JScoredToken
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
from tokengeex_tpu.utils.packing import PackedBatch as JPackedBatch

from tokengeex_tpu_torch import Model, ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
from tokengeex_tpu_torch.utils.packing import PackedBatch

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

W = 256
ROWS = 24
ALPHABET = b"abcde fgh()"


def _rows(seed):
    """Per row, (offset, sample) placements: a leading gap on every
    third row (the row begins in padding), gaps of 0-5 bytes between
    samples, samples of 1-150 bytes (longer than a 16- or 64-position
    segment), the last row left empty."""
    rng = random.Random(seed)
    rows = []
    for r in range(ROWS - 1):
        pos = rng.randint(1, 20) if r % 3 == 0 else 0
        placed = []
        while True:
            n = rng.randint(1, 150)
            if pos + n > W:
                break
            placed.append((pos, bytes(rng.choice(ALPHABET) for _ in range(n))))
            pos += n + rng.choice([0, 0, 1, 5])
        rows.append(placed)
    rows.append([])
    return rows


def _packed(rows, cls):
    bytes_arr = np.zeros((len(rows), W), np.uint8)
    sample_id = np.full((len(rows), W), -1, np.int32)
    is_start = np.zeros((len(rows), W + 1), bool)
    end_index = np.zeros((len(rows), W), np.int32)
    spans = []
    for r, placed in enumerate(rows):
        for off, data in placed:
            n = len(data)
            bytes_arr[r, off : off + n] = np.frombuffer(data, np.uint8)
            sample_id[r, off : off + n] = len(spans)
            is_start[r, off] = True
            end_index[r, off : off + n] = off + n
            spans.append((r, off, off + n, len(spans), 0))
    return cls(bytes_arr, sample_id, is_start, end_index, spans)


def _vocab(rows, L, seed):
    """All alphabet bytes plus random substrings of the samples up to L
    bytes, one of them exactly L long."""
    rng = random.Random(seed + 100)
    samples = [d for placed in rows for _, d in placed if len(d) >= L]
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in sorted(ALPHABET)]
    seen = {v for v, _ in vocab}
    first = samples[0][:L]
    vocab.append((first, -3.0))
    seen.add(first)
    while len(vocab) < 300:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, L)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    return vocab


_CASES = {}


def _case(seed, L):
    """One batch, its tables in both packages, the port's dropout-free
    cache, and numpy dropout words."""
    key = (seed, L)
    if key not in _CASES:
        rows = _rows(seed)
        vocab = _vocab(rows, L, seed)
        pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab],
                              min_bits=16)
        assert pt.max_token_len == L
        tbl = lat.DeviceTables.from_table(pt, "cpu")
        pb = lat.prepare_batch(_packed(rows, PackedBatch), L, "cpu")
        rng = np.random.default_rng(seed)
        du = rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                          dtype=np.int64).astype(np.int32)
        _CASES[key] = {"rows": rows, "vocab": vocab, "tbl": tbl, "pb": pb,
                       "cache": lat.match_cache(tbl, pb, C=W)[0], "du": du}
    return _CASES[key]


def _scan_args(case, dropout):
    pb = case["pb"]
    L = case["tbl"].max_len
    kw = {"pad": pb.pad}
    if dropout:
        kw.update(du=torch.as_tensor(case["du"]).t().contiguous(),
                  dropout=dropout)
    fwd = (case["cache"],
           pb.is_start[:, 1:].t().to(torch.float32).contiguous(),
           lat._hist0(pb, L, None).clamp(min=lc.NEG).t().contiguous())
    bwd = (case["cache"], pb.is_end[:, :W].t().to(torch.float32).contiguous(),
           lat.lcf.betas_hist0(pb.is_end[:, W], L))
    return fwd, bwd, kw


def _assert_close_masked(got, want):
    """f32 forward/backward values within tests/test_pallas.py's
    tolerance (rtol 2e-5, atol 1e-5), -inf where the reference has it."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-5)


# -- the batches hold what the chain split must survive --


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_bounds_follow_their_definition(seed):
    pb = _case(seed, 8)["pb"]
    outside = (pb.sid[:, pb.pad : pb.pad + W] < 0).numpy()
    starts = pb.is_start[:, :W].numpy()
    ends = pb.is_end[:, :W].numpy()
    # The rows pack several samples, with gaps, some rows begin in
    # padding, and some samples are longer than a 64-position segment.
    spans = [sp for placed in _rows(seed) for sp in placed]
    assert max(len(d) for _, d in spans) > 64
    assert (starts.sum(axis=1) >= 2).any() and not starts[:, 0].all()
    assert (outside & (np.arange(W) < W - 160)).any()
    for S in (16, 64, 1024):
        fwd, bwd = lat.chain_bounds(pb, S)
        K = -(-W // S)
        assert fwd.shape == bwd.shape == (K + 1, ROWS)
        assert fwd.dtype == torch.int32 and fwd.is_contiguous()
        for bounds, flag in ((fwd, starts | outside), (bwd, ends | outside)):
            want = np.zeros((K + 1, ROWS), np.int64)
            want[K] = W
            for k in range(1, K):
                for r in range(ROWS):
                    hits = np.nonzero(flag[r, k * S :])[0]
                    want[k, r] = k * S + hits[0] if hits.size else W
            np.testing.assert_array_equal(bounds.numpy(), want)


# -- the whole-width twins against lattice_jax over a cache --


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("seed", [0, 1])
def test_scans_match_jax(seed, dropout):
    case = _case(seed, 16)
    rows, vocab = case["rows"], case["vocab"]
    jt = JTokenTable.build([JScoredToken(v, s) for v, s in vocab],
                           min_bits=16)
    dt = lj.DeviceTables.from_table(jt, dtype=jnp.float32)
    assert not lj.has_vscan(dt) and not lat.has_vscan(case["tbl"])
    jb = lj.prepare_batch(_packed(rows, JPackedBatch), dt.max_len)
    jdu = jnp.asarray(case["du"]) if dropout else None
    pdu = torch.as_tensor(case["du"]) if dropout else None
    # JAX's cache holds the dropout; the port's is dropout-free and the
    # scans draw the coins in the kernel.
    jcache = lj.match_cache(dt, jb, C=W, drop_u=jdu, dropout=dropout)
    cache = (case["cache"], None)
    pb, tbl = case["pb"], case["tbl"]
    counts = (lc.forward_scan.launches, lc.backward_betas_scan.launches)
    A = lat.forward(tbl, pb, cache, drop_u=pdu, dropout=dropout)
    _assert_close_masked(A, lj.forward(dt, jb, C=W, drop_u=jdu,
                                       dropout=dropout, cache=jcache))
    Bt = lat.backward_betas(tbl, pb, cache, drop_u=pdu, dropout=dropout)
    _assert_close_masked(Bt, lj.backward_betas(dt, jb, C=W, drop_u=jdu,
                                               dropout=dropout, cache=jcache))
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert counts == (lc.forward_scan.launches,
                      lc.backward_betas_scan.launches)


# -- chains cut at sample boundaries give the per-row DP bit for bit --


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("L", [8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_split_equals_one_chain_per_row(seed, L, S, dropout):
    case = _case(seed, L)
    fwd, bwd, kw = _scan_args(case, dropout)
    seg_f, seg_b = lat.chain_bounds(case["pb"], S)
    # Inner chains exist, and some run past their segment (a sample
    # longer than S) or leave the next one empty.
    inner = (seg_f[1:-1] < W).sum()
    assert inner > ROWS and (seg_f[2:] - seg_f[1:-1] > S).any()
    a_split = lc.forward_scan_plain(*fwd, seg_f, **kw)
    a_row = lc.forward_scan_plain(*fwd, None, **kw)
    assert torch.equal(a_split, a_row)
    assert (a_row > lc.NEG * 0.5).any() and (a_row <= lc.NEG * 0.5).any()
    b_split = lc.backward_betas_scan_plain(*bwd, seg_b, **kw)
    b_row = lc.backward_betas_scan_plain(*bwd, None, **kw)
    assert torch.equal(b_split, b_row)
    assert (b_row == 0).any() and (b_row <= lc.NEG * 0.5).any()


def test_forward_scan_equals_chunked_views():
    """The whole-width scan over the start-indexed cache equals the chunk
    API walked over end-indexed views of it, chunk by chunk with the
    carried history."""
    case = _case(0, 16)
    pb = case["pb"]
    (cache, starts, hist), _, _ = _scan_args(case, 0.0)
    want = lc.forward_scan_plain(cache, starts, hist)
    # Row j at step q is the token starting at q - j (NEG before 0).
    padded = torch.cat([cache.new_full((16, 16, ROWS), lc.NEG),
                        cache.clamp(min=lc.NEG)])
    end = torch.stack([padded[16 - j : 16 - j + W, j] for j in range(16)],
                      dim=1)
    parts = []
    for cs in range(0, W, 64):
        view = end[cs : cs + 64].contiguous()
        a, hist = lc.forward_chunk(view, starts[cs : cs + 64].contiguous(),
                                   hist)
        parts.append(a)
    assert torch.equal(torch.cat(parts), want)
    assert pb.width == W


# -- the session caches each group's bounds --


def test_session_caches_chain_bounds(monkeypatch):
    case = _case(0, 8)
    samples = [d for placed in case["rows"] for _, d in placed]
    model = Model([ScoredToken(v, s) for v, s in case["vocab"]])
    # The slab route on this small table: the has_vscan threshold lowered.
    monkeypatch.setattr(lat, "VSCAN_MAX_BITS", -1)
    sess = DeviceTrainSession(model, samples, 256, device="cpu")
    assert not sess._fused()
    first = sess.e_step(model, 0.0, 0)
    groups = sess._groups()
    assert set(sess.chain_cache) == set(range(len(groups)))
    cached = {gi: tuple(t.clone() for t in c)
              for gi, c in sess.chain_cache.items()}
    assert np.array_equal(sess.e_step(model, 0.0, 0), first)
    for gi, (fwd, bwd) in sess.chain_cache.items():
        assert torch.equal(fwd, cached[gi][0])
        assert torch.equal(bwd, cached[gi][1])
    sess.close()
    assert not sess.chain_cache


# -- argument checks --


def _bad_bound_values(seg):
    """Chain bounds of the right shape, type and layout whose values are
    out of range or out of order: a first row not 0, a last row short of
    or past the width, a negative bound, a row below the one before."""
    W = int(seg[-1, 0])
    out = []
    for row, value in ((0, 1), (-1, W - 1), (-1, W + 1), (1, -1)):
        s = seg.clone()
        s[row, 3] = value
        out.append(s)
    s = seg.clone()
    s[1, 5], s[2, 5] = W, 0
    out.append(s)
    return out


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_scan_wrappers_reject_bad_input(direction):
    case = _case(0, 8)
    fwd, bwd, _ = _scan_args(case, 0.0)
    fn = lc.forward_scan if direction == "forward" else lc.backward_betas_scan
    cache, flags, hist = fwd if direction == "forward" else bwd
    seg = lat.chain_bounds(case["pb"], 64)[0 if direction == "forward" else 1]
    du = torch.as_tensor(case["du"]).t().contiguous()
    pad = case["pb"].pad
    fn(cache, flags, hist, seg, du, dropout=0.1, pad=pad)  # accepted
    bad = [
        # device
        ((cache, flags.to("meta"), hist, seg), {}),
        ((cache.to("meta"), flags.to("meta"), hist.to("meta")), {}),
        # type
        ((cache.double(), flags, hist), {}),
        ((cache, flags.int(), hist), {}),
        ((cache, flags, hist, seg.long()), {}),
        ((cache, flags, hist, seg, du.float()), {"dropout": 0.1, "pad": pad}),
        # shape
        ((cache[:, :, 0], flags, hist), {}),
        ((cache, flags[:-1], hist), {}),
        ((cache, flags, hist[:-1]), {}),
        ((cache, flags, hist, seg[:1]), {}),
        ((cache, flags, hist, seg[:, :-1]), {}),
        ((cache, flags, hist, seg, du[: pad + W - 1]),
         {"dropout": 0.1, "pad": pad}),
        ((cache, flags, hist, seg, du), {"dropout": 0.1, "pad": 1}),
        ((cache, flags, hist, seg), {"dropout": 0.1, "pad": pad}),
        # contiguity
        ((cache.transpose(0, 1).contiguous().transpose(0, 1), flags, hist),
         {}),
        ((cache, flags.t().contiguous().t(), hist), {}),
        ((cache, flags, hist, seg.t().contiguous().t()), {}),
    ]
    # values: out of range or out of order
    bad += [((cache, flags, hist, s), {}) for s in _bad_bound_values(seg)]
    for args, kw in bad:
        with pytest.raises(ValueError):
            fn(*args, **kw)
