"""The port's Viterbi scans against the JAX package's, on the CPU.

`viterbi_scan` (csrc/viterbi_chunk.cu, encode's slab route and the cached
frequency pass) and `fused_forward_chunk(kind="viterbi")`
(csrc/fused_forward.cu, encode's fused route) are chained, lane-parallel
max-plus scans over the whole row width: rows cut into chains at sample
boundaries and padding (`lattice.chain_bounds`), the dropout coins drawn
in the kernel. Their plain twins are held:

  - with chains against one chain per row, bit for bit (dp and best_l),
    on rows that pack several samples with padding gaps, rows that begin
    in padding, empty rows and samples longer than a segment, with
    half-integer scores (ties are common), NEG holes and a step with no
    candidate;
  - fed the chains through `lattice.viterbi` against the JAX package's
    slab route (`lattice_pallas.viterbi_chunk` in interpret mode) and its
    fused route (`lattice_pallas_fused.fused_forward_chunk(kind=
    "viterbi")` in interpret mode), on the same batch, tables and numpy
    dropout words, including chained long-sample windows with a carried
    history: best_l exact, dp equal;
  - the chunk API `viterbi_chunk` against the Pallas kernel in interpret
    mode, and the whole-width scan against it walked chunk by chunk;
  - the session's frequency pass, its chain bounds made once per group,
    against the JAX session's counts;
  - and the wrappers' argument checks.

tests/test_torch_cuda.py holds the CUDA kernels against the twins on a GPU.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokengeex_tpu import ScoredToken as JScoredToken
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops import lattice_pallas as lp
from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
from tokengeex_tpu.train.device_session import (
    DeviceTrainSession as JDeviceTrainSession)
from tokengeex_tpu.utils.packing import PackedBatch as JPackedBatch

from tokengeex_tpu_torch import ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
from tokengeex_tpu_torch.utils.packing import PackedBatch

from test_torch_session import (  # noqa: F401
    ROUTES, _models, corpus, one_jax_device, use_route)

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

W = 256
ROWS = 128  # the Pallas kernels' lane width
FILLED = 48  # rows holding samples; the rest are empty padding
ALPHABET = b"abcde fgh()"


def _rows(seed):
    """Per row, (offset, sample) placements: a leading gap on every
    third row (the row begins in padding), gaps of 0-5 bytes between
    samples, samples of 1-150 bytes (longer than a 16- or 64-position
    segment), every fourth row filled up to the width; rows past FILLED
    are empty."""
    rng = random.Random(seed)
    rows = []

    def sample(n):
        return bytes(rng.choice(ALPHABET) for _ in range(n))

    for r in range(FILLED):
        pos = rng.randint(1, 20) if r % 3 == 0 else 0
        placed = []
        while True:
            n = rng.randint(1, 150)
            if pos + n > W:
                break
            placed.append((pos, sample(n)))
            pos += n + rng.choice([0, 0, 1, 5])
        if r % 4 == 1 and pos < W:
            placed.append((pos, sample(W - pos)))
        rows.append(placed)
    return rows + [[] for _ in range(ROWS - FILLED)]


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
    bytes, one of them exactly L long, every score a multiple of 0.5 so
    that equal candidates are common."""
    rng = random.Random(seed + 100)
    samples = [d for placed in rows for _, d in placed if len(d) >= L]
    vocab = [(bytes([b]), rng.choice([-10.0, -10.5, -11.0]))
             for b in sorted(ALPHABET)]
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
            vocab.append((w, rng.randint(-18, -2) / 2))
    return vocab


_CASES = {}


def _case(seed, L, fused=False):
    """One batch, its tables (the slab route's, bits 16, or the fused
    route's), the JAX package's, and numpy dropout words."""
    key = (seed, L, fused)
    if key not in _CASES:
        rows = _rows(seed)
        vocab = _vocab(rows, L, seed)
        bits = None if fused else 16
        pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab],
                              min_bits=bits)
        tbl = lat.DeviceTables.from_table(pt, "cpu")
        assert tbl.max_len == L and lat.has_vscan(tbl) == fused
        jt = JTokenTable.build([JScoredToken(v, s) for v, s in vocab],
                               min_bits=bits)
        assert jt.bits == pt.bits
        pb = lat.prepare_batch(_packed(rows, PackedBatch), L, "cpu")
        rng = np.random.default_rng(seed)
        du = rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                          dtype=np.int64).astype(np.int32)
        _CASES[key] = {"rows": rows, "tbl": tbl, "pb": pb, "du": du,
                       "dt": lj.DeviceTables.from_table(jt, dtype=jnp.float32)}
    return _CASES[key]


def _holed_cache(case, seed):
    """The case's start-indexed score cache with 30 % of its entries set
    to NEG and every token ending at dp index 101 removed (a step with no
    candidate). Removing tokens keeps every chain bound a bound."""
    cache = lat.match_cache(case["tbl"], case["pb"], C=W, slots=False)[0]
    g = torch.Generator().manual_seed(seed)
    cache = torch.where(torch.rand(cache.shape, generator=g) < 0.3,
                        lc.NEG, cache)
    L = cache.shape[1]
    for j in range(L):
        cache[100 - j, j] = lc.NEG
    return cache


def _scan_args(case, dropout, cache=None):
    pb = case["pb"]
    L = case["tbl"].max_len
    kw = {"pad": pb.pad}
    if dropout:
        kw.update(du=torch.as_tensor(case["du"]).t().contiguous(),
                  dropout=dropout)
    if cache is None:
        cache = lat.match_cache(case["tbl"], pb, C=W, slots=False)[0]
    return (cache, pb.is_start[:, 1:].t().to(torch.float32).contiguous(),
            lat._hist0(pb, L, None).clamp(min=lc.NEG).t().contiguous()), kw


def _ties(dp, starts, hist0, score):
    """Steps (of rows that reach them) where two or more valid lengths
    hold the max: the recurrence's history rebuilt from dp."""
    n, L, B = score.shape
    carry = torch.where(starts > 0.5, 0.0, dp)
    full = torch.cat([hist0.flip(0), carry])  # full[L + p] = carry at p
    hist = torch.stack([full[L - 1 - j : L - 1 - j + n] for j in range(L)],
                       dim=1)
    s = score.clamp(min=lc.NEG)
    cand = hist + s
    ok = s > lc.NEG
    m = torch.where(ok, cand, -np.inf).max(dim=1, keepdim=True).values
    return int(((cand == m) & ok).sum(dim=1).gt(1).sum())


# -- chains cut at sample boundaries give the per-row DP bit for bit --


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("S", [16, 64, W])
@pytest.mark.parametrize("L", [8, 16, 32])
def test_viterbi_chain_split_equals_one_chain_per_row(L, S, dropout):
    case = _case(0, L)
    args, kw = _scan_args(case, dropout, _holed_cache(case, L))
    seg = lat.chain_bounds(case["pb"], S)[0]
    assert seg.shape[0] == -(-W // S) + 1
    if S < W:  # inner chains exist, and some run past their segment
        assert (seg[1:-1] < W).sum() > FILLED
        assert (seg[2:] - seg[1:-1] > S).any()
    dp_split, bl_split = lc.viterbi_scan_plain(*args, seg, **kw)
    dp_row, bl_row = lc.viterbi_scan_plain(*args, None, **kw)
    assert torch.equal(dp_split, dp_row) and torch.equal(bl_split, bl_row)
    assert (dp_row > lc.NEG * 0.5).any() and (dp_row <= lc.NEG * 0.5).any()
    assert (bl_row > 1).any()
    assert (dp_row[100, :FILLED] <= lc.NEG * 0.5).all()  # no candidate
    # Equal candidates are common: the tie rule decides many steps.
    end = lc._end_view(lc._scan_cache(args[0], kw.get("du"), dropout,
                                      kw["pad"]), W)
    assert _ties(dp_row, args[1], args[2], end) > 100


def test_viterbi_scan_equals_chunked_views():
    """The whole-width scan over the start-indexed cache equals the chunk
    API (`viterbi_chunk`) walked over end-indexed views of it, chunk by
    chunk with the carried history."""
    case = _case(1, 16)
    (cache, starts, hist), kw = _scan_args(case, 0.0)
    dp, bl = lc.viterbi_scan(cache, starts, hist, **kw)
    # Row j at step q is the token starting at q - j (NEG before 0).
    padded = torch.cat([cache.new_full((16, 16, ROWS), lc.NEG),
                        cache.clamp(min=lc.NEG)])
    end = torch.stack([padded[16 - j : 16 - j + W, j] for j in range(16)],
                      dim=1)
    parts, hist0 = [], hist
    for cs in range(0, W, 64):
        d, b, hist = lc.viterbi_chunk(end[cs : cs + 64].contiguous(),
                                      starts[cs : cs + 64].contiguous(), hist)
        parts.append((d, b))
    assert torch.equal(torch.cat([p[0] for p in parts]), dp)
    assert torch.equal(torch.cat([p[1] for p in parts]), bl)
    # The recurrence's history after the last step is the one the fused
    # kinds rebuild from dp.
    is_start = case["pb"].is_start.t()
    assert torch.equal(lcf._hist_from_values(dp, is_start, hist0), hist)


@pytest.mark.parametrize("L", [8, 32])
@pytest.mark.parametrize("seed", [2, 3])
def test_viterbi_chunk_matches_pallas_at_more_lengths(seed, L):
    """The chunk API against the Pallas kernel in interpret mode at L = 8
    and 32 (tests/test_torch_kernels.py holds L = 12), half-integer
    scores, NEG holes, a step with no candidate and sample starts."""
    rng = np.random.default_rng(seed)
    G, C = 1, 64
    s = np.round(rng.uniform(-12.0, -1.0, (G, C, L, 128)) * 2) / 2
    s[rng.random(s.shape) < 0.4] = lp.NEG
    s[:, 9] = lp.NEG
    starts = (rng.random((G, C, 1, 128)) < 0.05).astype(np.float32)
    hist0 = np.round(rng.uniform(-30.0, 0.0, (G, L, 128)) * 2) / 2
    hist0[rng.random(hist0.shape) < 0.2] = lp.NEG
    s, hist0 = s.astype(np.float32), hist0.astype(np.float32)
    dp_j, bl_j, h_j = (np.asarray(a) for a in lp.viterbi_chunk(
        jnp.asarray(s), jnp.asarray(starts), jnp.asarray(hist0),
        interpret=True))
    dp, bl, h = lc.viterbi_chunk(torch.as_tensor(s[0]),
                                 torch.as_tensor(starts[0, :, 0]),
                                 torch.as_tensor(hist0[0]))
    np.testing.assert_array_equal(dp.numpy(), dp_j[0, :, 0])
    np.testing.assert_array_equal(bl.numpy(), bl_j[0, :, 0])
    np.testing.assert_array_equal(h.numpy(), h_j[0])
    assert (bl.numpy() > 1).any() and (dp.numpy() <= lp.NEG * 0.5).any()


# -- the chained twins against the JAX package's routes --


def _assert_viterbi_equal(got, want):
    """best_l exact; dp equal, -inf where the reference has it."""
    dp_j, bl_j = (np.asarray(a) for a in want)
    dp_p, bl_p = (a.numpy() for a in got)
    fin = np.isfinite(dp_j)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(dp_p) == fin).all()
    np.testing.assert_array_equal(dp_p[fin], dp_j[fin])
    np.testing.assert_array_equal(bl_p, bl_j)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("backend", ["slab", "fused"])
def test_chained_viterbi_matches_jax(backend, dropout):
    fused = backend == "fused"
    case = _case(0, 16, fused=fused)
    jb = lj.prepare_batch(_packed(case["rows"], JPackedBatch), 16)
    jdu = jnp.asarray(case["du"]) if dropout else None
    pdu = torch.as_tensor(case["du"]) if dropout else None
    chains = lat.chain_bounds(case["pb"], 64)
    assert (chains[0][1:-1] < W).any()
    want = lj.viterbi(case["dt"], jb, C=128, drop_u=jdu, dropout=dropout,
                      backend="fused" if fused else "pallas")
    before = (lc.viterbi_scan.launches, lcf.fused_forward_chunk.launches)
    got = lat.viterbi(case["tbl"], case["pb"], C=128, drop_u=pdu,
                      dropout=dropout, backend=backend, chains=chains)
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert before == (lc.viterbi_scan.launches,
                      lcf.fused_forward_chunk.launches)
    _assert_viterbi_equal(got, want)


@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_fused_viterbi_chain_split_equals_one_chain_per_row(dropout, S):
    case = _case(1, 16, fused=True)
    du = torch.as_tensor(case["du"]) if dropout else None
    args = lat.fused_inputs(case["tbl"], case["pb"], du, dropout)
    kw = dict(L=16, bits=case["tbl"].bits, pad=case["pb"].pad,
              dropout=dropout)
    seg = lat.chain_bounds(case["pb"], S)[0]
    assert (seg[1:-1] < W).sum() > FILLED and (seg[2:] == seg[1:-1]).any()
    split = lcf.fused_forward_chunk_plain("viterbi", *args, **kw, seg=seg)
    row = lcf.fused_forward_chunk_plain("viterbi", *args, **kw)
    for i in range(4):  # dp, best_l, hist, rl
        assert torch.equal(split[i], row[i])
    assert (row[1] > 1).any() and (row[3] > 0).any()


def _chained_batches(L, seed):
    """Chained long-sample windows in both packages: 128 rows of [tail |
    body], bodies full, partial or empty, tails real or not, and a
    carried history (half-integers, some -inf) on about half the rows."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(ALPHABET, np.uint8)
    rows = alphabet[rng.integers(0, len(alphabet), (ROWS, L + W))]
    n_valid = rng.choice([0, W, 100, 37], ROWS).astype(np.int32)
    has_tail = (rng.random(ROWS) < 0.7) & (n_valid > 0)
    for r in range(ROWS):
        rows[r, L + n_valid[r] :] = 0
        if not has_tail[r]:
            rows[r, :L] = 0
    mask = has_tail & (rng.random(ROWS) < 0.8)
    hist = np.round(rng.uniform(-60.0, -1.0, (ROWS, L)) * 2) / 2
    hist[rng.random(hist.shape) < 0.2] = -np.inf
    hist = hist.astype(np.float32)
    pb = lat.prepare_chained_batch(rows, n_valid, has_tail, L, W, "cpu")
    jb = lj.prepare_chained_batch(rows, n_valid, has_tail, L, W)
    return (pb, (torch.as_tensor(mask), torch.as_tensor(hist)),
            jb, (jnp.asarray(mask), jnp.asarray(hist)))


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("backend", ["slab", "fused"])
def test_carried_windows_match_jax(backend, dropout):
    """A window's chain 0 starts from the carried history, and the tokens
    starting in the carried tail reach into the body: the slab route's
    cache then holds L columns before position 0."""
    fused = backend == "fused"
    case = _case(0, 16, fused=fused)
    pb, carry, jb, jcarry = _chained_batches(16, 5)
    rng = np.random.default_rng(6)
    du = rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                      dtype=np.int64).astype(np.int32)
    want = lj.viterbi(case["dt"], jb, C=128,
                      drop_u=jnp.asarray(du) if dropout else None,
                      dropout=dropout, carry=jcarry,
                      backend="fused" if fused else "pallas")
    got = lat.viterbi(case["tbl"], pb, C=128,
                      drop_u=torch.as_tensor(du) if dropout else None,
                      dropout=dropout, carry=carry, backend=backend)
    _assert_viterbi_equal(got, want)
    if not fused:  # the carried tail's tokens are in the cache
        cache = lat.match_cache(case["tbl"], pb, C=128, lead=16,
                                slots=False)[0]
        assert cache.shape[0] == 16 + W
        assert (cache[:16] > lc.NEG * 0.5).any()


# -- the session's frequency pass makes each group's bounds once --


@pytest.mark.parametrize("route,jkernel", ROUTES)
def test_session_frequencies_make_chains_once(corpus, one_jax_device,
                                              monkeypatch, route, jkernel):
    vocab, vocab2, samples = corpus
    rng = random.Random(9)
    extra = "".join(rng.choice("abcdef ()") for _ in range(1500)).encode()
    built = []
    chain_bounds = lat.chain_bounds

    def counted(*args, **kwargs):
        built.append(1)
        return chain_bounds(*args, **kwargs)

    monkeypatch.setattr(lat, "chain_bounds", counted)
    jm, m = _models(vocab2)
    use_route(monkeypatch, route)
    # Samples longer than the 256-byte snippet: the frequency pass packs
    # again at the encode width, under keys of its own.
    sess = DeviceTrainSession(_models(vocab)[1], samples + [extra], 256,
                              device="cpu")
    assert sess._fused() == (route == "fused")
    first = sess.count_frequencies(m)
    keys = {("freq", gi) for gi, _ in sess._freq_groups()}
    assert not sess._freq_shared and set(sess.chain_cache) == keys
    assert len(built) == len(keys)
    assert np.array_equal(sess.count_frequencies(m), first)
    assert len(built) == len(keys)
    jsess = JDeviceTrainSession(_models(vocab)[0], samples + [extra],
                                max_snippet=256, kernel=jkernel)
    np.testing.assert_array_equal(first, jsess.count_frequencies(jm))
    # Where the packings agree, the E-step's bounds serve the frequencies.
    short = [s[:256] for s in samples]
    sess = DeviceTrainSession(_models(vocab)[1], short, 256, device="cpu")
    sess.e_step(m, 0.0, 0)
    made = len(built)
    sess.count_frequencies(m)
    assert sess._freq_shared and len(built) == made
    assert set(sess.chain_cache) == set(range(len(sess._groups())))


# -- argument checks --


def _bad_bound_values(seg):
    """Chain bounds of the right shape, type and layout whose values are
    out of range or out of order."""
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


def test_viterbi_scan_rejects_bad_input():
    case = _case(0, 8)
    (cache, starts, hist), kw = _scan_args(case, 0.0)
    seg = lat.chain_bounds(case["pb"], 64)[0]
    du = torch.as_tensor(case["du"]).t().contiguous()
    pad = kw["pad"]
    lc.viterbi_scan(cache, starts, hist, seg, du, dropout=0.1, pad=pad)
    lead = torch.cat([cache[:8], cache])
    lc.viterbi_scan(lead, starts, hist, seg, du, dropout=0.1, pad=pad,
                    lead=8)  # accepted
    bad = [
        ((cache, starts.to("meta"), hist, seg), {}),
        ((cache, starts, hist, seg.long()), {}),
        ((cache.double(), starts, hist), {}),
        ((cache, starts, hist, seg[:1]), {}),
        ((cache, starts, hist, seg[:, :-1]), {}),
        ((cache, starts, hist, seg.t().contiguous().t()), {}),
        ((cache, starts[:-1], hist), {}),
        ((cache, starts, hist[:-1]), {}),
        ((cache, starts, hist, seg, du), {"dropout": 0.1, "pad": 1}),
        ((cache, starts, hist, seg), {"dropout": 0.1, "pad": pad}),
        # lead: negative, past L, or not matching the cache's extra rows
        ((cache, starts, hist), {"lead": -1}),
        ((torch.cat([cache[:9], cache]), starts, hist), {"lead": 9}),
        ((lead, starts, hist), {"lead": 4}),
    ]
    bad += [((cache, starts, hist, s), {}) for s in _bad_bound_values(seg)]
    for args, kwargs in bad:
        with pytest.raises(ValueError):
            lc.viterbi_scan(*args, **kwargs)
    with pytest.raises(ValueError):
        lat.match_cache(case["tbl"], case["pb"], C=W, lead=9)
