"""The port's backpointer walk against the JAX package's, on the CPU.

`viterbi_walk` (csrc/viterbi_walk.cu) walks every span's Viterbi
backpointers on the device and resolves each token's id with the exact
tables; its plain twin, `viterbi_walk_plain`, is held here:

  - the exact tables `t1_exact` / `t2_exact` bit-equal to the JAX
    package's `DeviceTables.from_table`, before and after a session's
    rebind to a rescored, shrunk vocabulary;
  - count mode against `lattice_jax.viterbi_freq` on the same batch, dp
    and best_l (the JAX package's), on the slab and the fused route, with
    arbitrary and with half-integer scores (ties are common);
  - ids mode (`walk_ids`) against the host `backtrack` and the JAX
    package's `backtrack`, at dropout 0 and 0.1 (shared dropout words),
    split through the encode's `_place_ids`, with unreachable spans (-1
    tokens, and NoPath from the split);
  - the port's encode against the JAX package's with shared dropout words,
    empty samples, back-to-back samples in one row, NoPath, and a sample
    over 32 KiB (the chained path, walked across its windows on the
    device: tests/test_torch_chained_walk.py);
  - the session's frequency pass walks on the device, not on the host;
  - and the wrapper's argument checks.

tests/test_torch_cuda.py holds the CUDA kernel against the twin on a GPU.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tokengeex_tpu as jtg
from tokengeex_tpu import ScoredToken as JScoredToken
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
from tokengeex_tpu.train import estep_device as jed
from tokengeex_tpu.utils.packing import PackedBatch as JPackedBatch

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch import ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
from tokengeex_tpu_torch.utils.packing import PackedBatch

from test_torch_session import _models, corpus, one_jax_device  # noqa: F401
from test_torch_viterbi_scan import W, _packed, _rows

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

L = 8


def _vocab(rows, scores, seed):
    """All alphabet bytes plus random substrings of the samples up to L
    bytes; scores arbitrary ("exact") or multiples of 0.5 ("int")."""
    rng = random.Random(seed + 200)
    samples = [d for placed in rows for _, d in placed if len(d) >= L]
    score = ((lambda: rng.uniform(-9.0, -1.0)) if scores == "exact"
             else (lambda: rng.randint(-18, -2) / 2))
    vocab = [(bytes([b]), score() - 4.0) for b in sorted(b"abcde fgh()")]
    seen = {v for v, _ in vocab}
    while len(vocab) < 300:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, L)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, score()))
    return vocab


_CASES = {}


def _case(route, scores, seed=0):
    """One batch (several samples back to back in a row, gaps, empty
    rows), its tables in both packages, the JAX package's dp and best_l
    at dropout 0 and 0.1 (shared words), and the spans."""
    key = (route, scores, seed)
    if key not in _CASES:
        rows = _rows(seed)
        vocab = _vocab(rows, scores, seed)
        bits = None if route == "fused" else 16
        pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab],
                              min_bits=bits)
        jt = JTokenTable.build([JScoredToken(v, s) for v, s in vocab],
                               min_bits=bits)
        tbl = lat.DeviceTables.from_table(pt, "cpu")
        dt = lj.DeviceTables.from_table(jt, dtype=jnp.float32)
        assert lat.has_vscan(tbl) == (route == "fused") and tbl.max_len == L
        packed = _packed(rows, PackedBatch)
        jpacked = _packed(rows, JPackedBatch)
        pb = lat.prepare_batch(packed, L, "cpu")
        jb = lj.prepare_batch(jpacked, L)
        rng = np.random.default_rng(seed)
        du = rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                          dtype=np.int64).astype(np.int32)
        outs = {}
        for dropout in (0.0, 0.1):
            extra = ({"drop_u": jnp.asarray(du), "dropout": dropout}
                     if dropout else {})
            dp, bl = lj.viterbi(dt, jb, C=W, dtype=jnp.float32,
                                backend="fused" if route == "fused"
                                else "xla", **extra)
            outs[dropout] = (np.array(dp), np.array(bl, np.int32))
        _CASES[key] = {"tbl": tbl, "dt": dt, "pb": pb, "jb": jb,
                       "packed": packed, "jpacked": jpacked, "du": du,
                       "outs": outs, "vocab": vocab}
    return _CASES[key]


def _ends_mask(spans, B):
    ends = np.zeros((B, W + 1), bool)
    for r, s, e, _, _ in spans:
        if e > s:
            ends[r, e] = True
    return ends


def test_exact_tables_match_jax_before_and_after_rebind(corpus):
    vocab, vocab2, samples = corpus
    jt = JTokenTable.build([JScoredToken(v, s) for v, s in vocab])
    pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab])
    kept = vocab2[:60]
    jm, m = _models(kept)
    sess = DeviceTrainSession(_models(vocab)[1], samples, 256, device="cpu")
    pairs = [(lat.DeviceTables.from_table(pt, "cpu"),
              lj.DeviceTables.from_table(jt, dtype=jnp.float32))]
    sess._rebind(m)
    pairs.append((sess.dt, lj.DeviceTables.from_table(jt.rebind(jm.vocab),
                                                      dtype=jnp.float32)))
    for got, want in pairs:
        for name in ("t1_exact", "t2_exact"):
            g = getattr(got, name)
            assert g.dtype == torch.int32 and g.shape[1] == 4
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(want, name)))
    # The rebind renumbered the ids: the tables changed with them.
    assert not torch.equal(pairs[0][0].t1_exact, pairs[1][0].t1_exact)
    assert sess.dt.vocab_size == len(kept)


@pytest.mark.parametrize("scores", ["exact", "int"])
@pytest.mark.parametrize("route", ["slab", "fused"])
def test_walk_counts_match_viterbi_freq(route, scores):
    case = _case(route, scores)
    tbl, pb = case["tbl"], case["pb"]
    V = tbl.vocab_size
    spans = case["packed"].spans
    dp, bl = case["outs"][0.0]
    want = np.asarray(lj.viterbi_freq(
        case["dt"], case["jb"], jnp.asarray(dp), jnp.asarray(bl),
        jnp.asarray(_ends_mask(spans, dp.shape[0])), vpad=V, C=W))
    # The port's own Viterbi gives the same backpointers inside samples.
    got_dp, got_bl = lat.viterbi(tbl, pb, backend=route)
    inside = case["packed"].sample_id >= 0
    np.testing.assert_array_equal(got_bl.numpy()[inside], bl[inside])
    index = lat.walk_index(spans, *bl.shape, "cpu")
    ok = torch.isfinite(index.dp_ends(torch.as_tensor(dp)))
    assert bool(ok.all())
    before = lat.viterbi_walk.launches
    for best_l in (torch.as_tensor(bl), got_bl,
                   torch.as_tensor(bl).to(torch.uint8)):
        got = lat.walk_counts(tbl, pb, best_l, index, ok)
        assert got.dtype == torch.int32 and got.shape == (V + 1,)
        assert int(got[V]) == 0
        np.testing.assert_array_equal(got[:V].numpy(), want)
    assert want.sum() > 1000 and (want > 0).sum() > 50
    # CPU tensors take the plain twin: no kernel launch is counted.
    assert lat.viterbi_walk.launches == before


def _place(tbl, spans, walked):
    """walk_ids' flat ids and tokens per span, split a span through the
    encode's own _place_ids: it raises NoPath for the first dead span."""
    flat, ntok = walked
    samples = [bytes(e - s) for _, s, e, _, _ in spans]
    out = [None] * len(spans)
    ed._place_ids(out, samples, [np.arange(len(spans))], [ntok], [flat],
                  tbl.vocab_size, gather=False)
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("route", ["slab", "fused"])
def test_walk_ids_match_backtrack(route, dropout):
    case = _case(route, "int")
    tbl, pb = case["tbl"], case["pb"]
    dp, bl = case["outs"][dropout]
    extra = ({"drop_u": torch.as_tensor(case["du"]), "dropout": dropout}
             if dropout else {})
    got_dp, got_bl = lat.viterbi(tbl, pb, backend=route, **extra)
    inside = case["packed"].sample_id >= 0
    np.testing.assert_array_equal(got_bl.numpy()[inside], bl[inside])
    token_to_id = {v: i for i, (v, _) in enumerate(case["vocab"])}
    spans = case["packed"].spans
    want = lat.backtrack(case["packed"], dp, bl, token_to_id)
    jwant = lj.backtrack(case["jpacked"], dp, bl, token_to_id)
    got = _place(tbl, spans, lat.walk_ids(
        tbl, pb, torch.as_tensor(dp), torch.as_tensor(bl),
        lat.walk_index(spans, *bl.shape, "cpu")))
    assert got == want == jwant
    assert sum(map(len, got)) > 1000


@pytest.mark.parametrize("route", ["slab", "fused"])
def test_walk_ids_no_path(route):
    """Unreachable span ends are not walked: they count -1 tokens, as the
    host backtrack's None with raise_no_path=False, and the split raises
    NoPath(len, len)."""
    case = _case(route, "exact")
    tbl, pb = case["tbl"], case["pb"]
    dp, bl = case["outs"][0.0]
    dp = dp.copy()
    spans = case["packed"].spans
    dead = [3, 17, len(spans) - 1]
    for k in dead:
        r, s, e, _, _ = spans[k]
        dp[r, e - 1] = -np.inf
    token_to_id = {v: i for i, (v, _) in enumerate(case["vocab"])}
    want = lat.backtrack(case["packed"], dp, bl, token_to_id,
                         raise_no_path=False)
    index = lat.walk_index(spans, *bl.shape, "cpu")
    flat, ntok = lat.walk_ids(tbl, pb, torch.as_tensor(dp),
                              torch.as_tensor(bl), index)
    parts = np.split(flat.astype(np.int64),
                     np.cumsum(np.maximum(ntok, 0))[:-1])
    got = [None if c < 0 else p.tolist() for c, p in zip(ntok, parts)]
    assert got == want
    assert [k for k, ids in enumerate(got) if ids is None] == dead
    n = spans[dead[0]][2] - spans[dead[0]][1]
    with pytest.raises(tg.NoPathError) as err:
        _place(tbl, spans, (flat, ntok))
    assert (err.value.args, str(err.value)) == (
        tg.NoPathError(n, n).args, str(tg.NoPathError(n, n)))
    # Dead spans walk nothing in count mode either.
    ok = torch.isfinite(index.dp_ends(torch.as_tensor(dp)))
    counts = lat.walk_counts(tbl, pb, torch.as_tensor(bl), index, ok=ok)
    live = [ids for ids in got if ids]
    np.testing.assert_array_equal(
        counts[:-1].numpy(),
        np.bincount(np.concatenate(live), minlength=tbl.vocab_size))


@pytest.fixture(scope="module")
def enc_corpus():
    """Short and long samples over a small alphabet: several pack back to
    back in one row of the encode width."""
    rng = random.Random(31)
    alphabet = b"abcdef ()"
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < 120:
        w = bytes(rng.choice(alphabet) for _ in range(rng.randint(2, 8)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    samples = [bytes(rng.choice(alphabet) for _ in range(rng.randint(1, n)))
               for n in [40] * 24 + [700] * 6]
    return vocab, samples


def _jax_words(seed):
    """The JAX encode's dropout words, group after group."""
    key = jax.random.PRNGKey(seed)
    while True:
        key, sub = jax.random.split(key)
        yield sub


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("route,hints", [("fused", None),
                                         ("slab", (16, None))])
def test_encode_matches_jax_with_shared_words(enc_corpus, one_jax_device,
                                              monkeypatch, route, hints,
                                              dropout):
    vocab, samples = enc_corpus
    jm, m = _models(vocab)
    mixed = samples + [b"", samples[2], b""]
    want = jed.encode_corpus_device(jm, mixed, dtype=jnp.float32,
                                    kernel="xla", dropout=dropout, seed=4,
                                    table_hints=hints)
    # The JAX package pads no rows here (one device, the XLA kernels); the
    # port's groups carry its rows first, then empty padding rows.
    keys = _jax_words(4)

    def words(gen, rows, cols, device):
        packed = ed.pack_samples(mixed, width=ed._pick_width(mixed, None))
        jrows = packed.rows
        du = np.asarray(jax.random.randint(
            next(keys), (jrows, cols), minval=-(2**31), maxval=2**31 - 1,
            dtype=jnp.int32))
        return torch.as_tensor(np.concatenate(
            [du, np.zeros((rows - jrows, cols), np.int32)]), device=device)

    monkeypatch.setattr(ed, "_drop_words", words)

    def no_host_walk(*a, **k):
        raise AssertionError("encode walked on the host")

    monkeypatch.setattr(lat, "backtrack", no_host_walk)
    got = ed.encode_corpus_device(m, mixed, table_hints=hints, device="cpu",
                                  dropout=dropout, seed=4)
    assert got == want
    assert got[-1] == got[-3] == [] and got[-2] == got[2]
    if dropout:
        assert got != ed.encode_corpus_device(m, mixed, table_hints=hints,
                                              device="cpu")


def test_encode_no_path_and_long_sample(enc_corpus, one_jax_device):
    """A byte missing from the vocabulary raises NoPath on both packages;
    a sample over 32 KiB takes the chained path (its walk across the
    windows) and equals the JAX package's ids."""
    vocab, samples = enc_corpus
    jm, m = _models(vocab)
    bad = samples[:5] + [samples[5] + b"z"]
    with pytest.raises(jtg.NoPathError) as jerr:
        jed.encode_corpus_device(jm, bad, dtype=jnp.float32, kernel="xla")
    with pytest.raises(tg.NoPathError) as err:
        ed.encode_corpus_device(m, bad, device="cpu")
    assert err.value.args == jerr.value.args
    rng = random.Random(5)
    long_sample = bytes(rng.choice(b"abcdef ()")
                        for _ in range(ed.MAX_ENCODE_WIDTH + 300))
    mixed = samples[:8] + [long_sample]
    want = jed.encode_corpus_device(jm, mixed, dtype=jnp.float32,
                                    kernel="xla")
    got = ed.encode_corpus_device(m, mixed, device="cpu")
    assert got == want and len(got[-1]) > 5000


@pytest.mark.parametrize("kernel,jkernel", [(None, "pallas"),
                                            ("slab", "xla")])
def test_session_frequencies_walk_on_the_device(corpus, one_jax_device,
                                                monkeypatch, kernel,
                                                jkernel):
    """Every frequency group walks once, in count mode; no host backtrack
    runs; the counts equal the JAX session's device counts."""
    vocab, vocab2, samples = corpus
    jm, m = _models(vocab2)
    sess = DeviceTrainSession(_models(vocab)[1], samples, 256, kernel=kernel,
                              device="cpu")
    calls = []
    walk = lat.walk_counts

    def spy(*a, **k):
        calls.append(k.get("ok") is not None)
        return walk(*a, **k)

    def no_host_walk(*a, **k):
        raise AssertionError("the frequency pass walked on the host")

    monkeypatch.setattr(lat, "walk_counts", spy)
    monkeypatch.setattr(lat, "backtrack", no_host_walk)
    got = sess.count_frequencies(m)
    groups = [g for g, sub in sess._freq_groups()
              if sess._freq_info(g, sub)["countable"]]
    assert calls == [True] * len(groups) and groups
    jsess = jtg.train.device_session.DeviceTrainSession(
        _models(vocab)[0], samples, max_snippet=256, kernel=jkernel)
    np.testing.assert_array_equal(got, jsess.count_frequencies(jm))
    # The spans' device arrays are made once per group.
    made = dict(sess.walk_spans)
    np.testing.assert_array_equal(sess.count_frequencies(m), got)
    assert all(sess.walk_spans[k] is v for k, v in made.items())


def _segment_rows(L, S, seed, B=7):
    """Seeded (B, W) backpointers in [0, L] (a 0 steps by 1) and a span
    layout per row: one span over the whole row; spans cut exactly on
    segment boundaries; runs of 1-byte and short spans; spans with gaps and
    empty spans, cut at a boundary and one byte either side of it; random
    cuts; an empty row. The spans come in a shuffled order, a sixth of them
    with ok = 0."""
    rng = np.random.default_rng(seed)
    W = 4 * S + 37  # not a multiple of S: the last segment is short
    # Mostly short steps, so a segment holds long chains; a third reach up
    # to L, so the exits spread over the table.
    bl = np.where(rng.random((B, W)) < 0.7, rng.integers(0, 4, (B, W)),
                  rng.integers(0, L + 1, (B, W)))
    bounds = [g * S + d for g in range(1, W // S + 1) for d in (-1, 0, 1)]
    spans = [(0, 0, W)]
    cuts = [0] + [g * S for g in range(1, W // S + 1)] + [W]
    spans += [(1, a, b) for a, b in zip(cuts, cuts[1:])]
    p = 0
    while p < W:
        n = int(rng.choice([1, 1, 2, 3, 7]))
        spans.append((2, p, min(p + n, W)))
        p += n + int(rng.integers(0, 2))
    cuts = sorted({0, W, *bounds, *rng.integers(0, W, 6).tolist()})
    for a, b in zip(cuts, cuts[1:]):
        if rng.random() < 0.25:
            continue  # a gap
        spans.append((3, a, b))
        if rng.random() < 0.3:
            spans.append((3, b, b))  # an empty span at a cut
    cuts = sorted({0, W, *rng.integers(0, W, 12).tolist()})
    spans += [(4, a, b) for a, b in zip(cuts, cuts[1:])]
    spans += [(5, S - 1, 2 * S + 1), (5, 2 * S + 1, 2 * S + 2),
              (5, 3 * S, 3 * S)]
    order = rng.permutation(len(spans))
    spans = [spans[k] for k in order]
    ok = rng.random(len(spans)) > 1 / 6
    return bl, spans, ok


@pytest.mark.parametrize("layout", ["uint8", "int32_strided"])
@pytest.mark.parametrize("seg", ["2L", 256])
@pytest.mark.parametrize("L", [16, 24, 64])
def test_walk_segmented_matches_plain(L, seg, layout):
    """The kernel's decomposition (exit tables, composition, emit), as a
    plain emulation, walks every span to the same tokens as the
    step-by-step twin, bit for bit."""
    S = 2 * L if seg == "2L" else seg
    bl, spans, ok = _segment_rows(L, S, seed=L + S)
    best_l = (torch.as_tensor(bl.astype(np.uint8)) if layout == "uint8"
              else torch.as_tensor(bl.T.astype(np.int32).copy()).T)
    assert best_l.is_contiguous() == (layout == "uint8")
    index = lat.walk_index(spans, *bl.shape, "cpu")
    ok = torch.as_tensor(ok)
    want_pos, want_n = lat.walk_positions_plain(best_l, index, ok)
    got_pos, got_n = lat.walk_positions_segmented(best_l, index, ok, L, S)
    assert torch.equal(got_n, want_n) and torch.equal(got_pos, want_pos)
    # Dead and empty spans walk nothing; live ones tile their span.
    nt = want_n.numpy()
    for k, (r, s, e) in enumerate(spans):
        assert nt[k] == 0 if not ok[k] or e == s else 1 <= nt[k] <= e - s
    assert want_pos.numel() == nt.sum() > bl.shape[1] // 2
    assert nt.sum() <= index.cap


def test_walk_segmented_beyond_reach():
    """Backpointers longer than the tables' reach (out of contract, but
    possible off the path) leave the table for a step-by-step walk: still
    the twin's tokens."""
    bl, spans, ok = _segment_rows(40, 64, seed=9)
    best_l = torch.as_tensor(bl.astype(np.uint8))
    index = lat.walk_index(spans, *bl.shape, "cpu")
    ok = torch.as_tensor(ok)
    want = lat.walk_positions_plain(best_l, index, ok)
    got = lat.walk_positions_segmented(best_l, index, ok, 16, 64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("S", [16, 256])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("route", ["slab", "fused"])
def test_walk_segmented_matches_jax_backpointers(route, dropout, S):
    """On the JAX package's Viterbi backpointers and packed spans, the
    decomposition's emulation gives the twin's flat ids, which equal the
    host backtrack's."""
    case = _case(route, "int")
    tbl, pb = case["tbl"], case["pb"]
    dp, bl = case["outs"][dropout]
    spans = case["packed"].spans
    index = lat.walk_index(spans, *bl.shape, "cpu")
    best_l = torch.as_tensor(bl)
    ok = torch.isfinite(index.dp_ends(torch.as_tensor(dp)))
    args, kw = lat._walk_tables(tbl, pb)
    flat, ntok, incl = lat.viterbi_walk(best_l, *args, index, ok=ok,
                                        ids=True, **kw)
    pos, n = lat.walk_positions_segmented(best_l, index, ok, kw["max_len"],
                                          S)
    assert torch.equal(n, ntok) and flat.shape == (index.cap,)
    assert torch.equal(incl, torch.cumsum(n, 0).to(torch.int32))
    ids = lat._walk_probe(best_l.long(), *args, pos, kw["bits"], kw["pad"],
                          kw["vocab_size"])
    assert torch.equal(ids.to(torch.int32), flat[: ids.numel()])
    token_to_id = {v: i for i, (v, _) in enumerate(case["vocab"])}
    want = lat.backtrack(case["packed"], dp, bl, token_to_id)
    parts = np.split(ids.numpy(), np.cumsum(n.numpy())[:-1])
    assert [p.tolist() for p in parts] == want


def test_walk_rejects_bad_input():
    case = _case("slab", "exact")
    tbl, pb = case["tbl"], case["pb"]
    dp, bl = case["outs"][0.0]
    bl = torch.as_tensor(bl)
    args, kw = lat._walk_tables(tbl, pb)
    index = lat.walk_index(case["packed"].spans, *bl.shape, "cpu")
    ok = torch.ones(index.n, dtype=torch.bool)
    kw["ok"] = ok
    with pytest.raises(ValueError, match="best_l must be"):
        lat.viterbi_walk(bl.float(), *args, index, **kw)
    with pytest.raises(ValueError, match="rows must be int32"):
        lat.viterbi_walk(bl, *args, dataclasses.replace(
            index, rows=index.rows.long()), **kw)
    with pytest.raises(ValueError, match="outside the"):
        lat.viterbi_walk(bl, *args, dataclasses.replace(
            index, ends=index.ends + W), **kw)
    with pytest.raises(ValueError, match="exact tables"):
        lat.viterbi_walk(bl, *args, index, **{**kw, "bits": kw["bits"] - 1})
    with pytest.raises(ValueError, match="ok must be"):
        lat.viterbi_walk(bl, *args, index, **{**kw, "ok": ok[1:]})
    with pytest.raises(ValueError, match="walk index is of a"):
        lat.viterbi_walk(bl[:-1], *args, index, **kw)
    with pytest.raises(ValueError, match="max_len 65 outside"):
        lat.viterbi_walk(bl, *args, index, **{**kw, "max_len": 65})
    with pytest.raises(ValueError, match="no exact rows"):
        lat._walk_tables(lat.DeviceTables.from_numpy(
            {"t1_fast": tbl.t1_fast.numpy(), "t2_fast": tbl.t2_fast.numpy(),
             "scores": tbl.scores.numpy()},
            (tbl.bits, tbl.max_len, tbl.vocab_size, 0, 0), "cpu"), pb)
