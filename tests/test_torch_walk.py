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
    with unreachable spans (raising, and None with raise_no_path=False);
  - the port's encode against the JAX package's with shared dropout words,
    empty samples, back-to-back samples in one row, NoPath, and a sample
    over 32 KiB (the chained path, walked on the host);
  - the session's frequency pass walks on the device, not on the host;
  - and the wrapper's argument checks.

tests/test_torch_cuda.py holds the CUDA kernel against the twin on a GPU.
"""

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
    r, s, e = lat.span_arrays(spans, "cpu")
    ok = torch.isfinite(torch.as_tensor(dp)[r.long(), e.long() - 1])
    assert bool(ok.all())
    before = lat.viterbi_walk.launches
    for best_l in (torch.as_tensor(bl), got_bl,
                   torch.as_tensor(bl).to(torch.uint8)):
        got = lat.walk_counts(tbl, pb, best_l, (r, s, e), ok)
        assert got.dtype == torch.int32 and got.shape == (V + 1,)
        assert int(got[V]) == 0
        np.testing.assert_array_equal(got[:V].numpy(), want)
    assert want.sum() > 1000 and (want > 0).sum() > 50
    # CPU tensors take the plain twin: no kernel launch is counted.
    assert lat.viterbi_walk.launches == before


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
    got = lat.walk_ids(tbl, pb, torch.as_tensor(dp), torch.as_tensor(bl),
                       spans)
    assert got == want == jwant
    assert sum(map(len, got)) > 1000


@pytest.mark.parametrize("route", ["slab", "fused"])
def test_walk_ids_no_path(route):
    """Unreachable span ends are not walked: they raise NoPath(len, len),
    or give None with raise_no_path=False, as the host backtrack does."""
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
    got = lat.walk_ids(tbl, pb, torch.as_tensor(dp), torch.as_tensor(bl),
                       spans, raise_no_path=False)
    assert got == want
    assert [k for k, ids in enumerate(got) if ids is None] == dead
    n = spans[dead[0]][2] - spans[dead[0]][1]
    with pytest.raises(tg.NoPathError) as err:
        lat.walk_ids(tbl, pb, torch.as_tensor(dp), torch.as_tensor(bl), spans)
    assert (err.value.args, str(err.value)) == (
        tg.NoPathError(n, n).args, str(tg.NoPathError(n, n)))
    # Dead spans walk nothing in count mode either.
    r, s, e = lat.span_arrays(spans, "cpu")
    ok = torch.isfinite(torch.as_tensor(dp)[r.long(), e.long() - 1])
    counts = lat.walk_counts(tbl, pb, torch.as_tensor(bl), (r, s, e), ok=ok)
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
    a sample over 32 KiB takes the chained path (its host walk) and
    equals the JAX package's ids."""
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


def test_walk_rejects_bad_input():
    case = _case("slab", "exact")
    tbl, pb = case["tbl"], case["pb"]
    dp, bl = case["outs"][0.0]
    bl = torch.as_tensor(bl)
    args, kw = lat._walk_tables(tbl, pb)
    spans = lat.span_arrays(case["packed"].spans, "cpu")
    ok = torch.ones(spans[0].shape, dtype=torch.bool)
    kw["ok"] = ok
    with pytest.raises(ValueError, match="best_l must be"):
        lat.viterbi_walk(bl.float(), *args, *spans, **kw)
    with pytest.raises(ValueError, match="rows must be int32"):
        lat.viterbi_walk(bl, *args, spans[0].long(), *spans[1:], **kw)
    with pytest.raises(ValueError, match="outside the"):
        lat.viterbi_walk(bl, *args, spans[0], spans[1], spans[2] + W, **kw)
    with pytest.raises(ValueError, match="exact tables"):
        lat.viterbi_walk(bl, *args, *spans, **{**kw, "bits": kw["bits"] - 1})
    with pytest.raises(ValueError, match="ok must be"):
        lat.viterbi_walk(bl, *args, *spans, **{**kw, "ok": ok[1:]})
    with pytest.raises(ValueError, match="no exact rows"):
        lat._walk_tables(lat.DeviceTables.from_numpy(
            {"t1_fast": tbl.t1_fast.numpy(), "t2_fast": tbl.t2_fast.numpy(),
             "scores": tbl.scores.numpy()},
            (tbl.bits, tbl.max_len, tbl.vocab_size, 0, 0), "cpu"), pb)
