"""The port's DeviceTrainSession against the JAX package's, on the CPU.

The port's session on the CPU (the kernels' plain versions), on the
fused route (the fused probe kernels, which small tables take) and on the
slab route (cached ranks, probed slabs; the tests lower the has_vscan
threshold, lattice.VSCAN_MAX_BITS, below the small tables' bits), is held
against the JAX session on one device with kernel="pallas" (interpret
mode) and kernel="xla": the first pass, a pass after a rescored and
shrunk rebind, the over-budget route, the frequency pass, dropout
seeding, rare tokens beside large-weight neighbours, the f64 and the
default route against the JAX E-step, and the pruner's use of the
session.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tokengeex_tpu as jtg
from tokengeex_tpu.train import estep_device as jed
from tokengeex_tpu.train.device_session import (
    DeviceTrainSession as JDeviceTrainSession)

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train import prune
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession

from test_torch_prune import KW, _corpus as _prune_corpus, _model

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

# The port's route -> the JAX session's kernel mode of the same route.
ROUTES = [("fused", "pallas"), ("slab", "xla")]


def use_route(monkeypatch, route):
    """Route "slab" keeps the small tables off the fused kernels: the
    has_vscan threshold lowered below every table's bits."""
    if route == "slab":
        monkeypatch.setattr(lat, "VSCAN_MAX_BITS", -1)


@pytest.fixture(scope="module")
def corpus():
    """The tests/test_device_session.py corpus, with a rescored and shrunk
    second vocabulary, as (value, score) pairs."""
    rng = random.Random(77)
    alphabet = b"abcdef ()"
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < 90:
        w = bytes(rng.choice(alphabet) for _ in range(rng.randint(2, 8)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    samples = [
        "".join(rng.choice("abcdef ()") for _ in range(rng.randint(1, 700))
                ).encode() for _ in range(24)
    ]
    rng = random.Random(3)
    vocab2 = [(v, s - rng.random()) for i, (v, s) in enumerate(vocab)
              if len(v) == 1 or i % 5 != 0]
    return vocab, vocab2, samples


def _models(vocab):
    return (jtg.Model([jtg.ScoredToken(v, s) for v, s in vocab]),
            tg.Model([tg.ScoredToken(v, s) for v, s in vocab]))


@pytest.fixture
def one_jax_device(monkeypatch):
    """The JAX session's single-device routes (the fused Pallas E-step,
    the device frequency counts) need one device; tests/conftest.py gives
    eight."""
    dev0 = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: dev0)


def _close(got, want):
    assert got.dtype == np.float64 and got.shape == want.shape
    assert got.sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route,jkernel", ROUTES)
def test_session_passes_match_jax(corpus, one_jax_device, monkeypatch,
                                  route, jkernel):
    vocab, vocab2, samples = corpus
    (jm1, m1), (jm2, m2) = _models(vocab), _models(vocab2)
    jsess = JDeviceTrainSession(jm1, samples, max_snippet=256,
                                kernel=jkernel)
    use_route(monkeypatch, route)
    sess = DeviceTrainSession(m1, samples, 256, device="cpu")
    assert sess._fused() == (route == "fused") == jsess._fused()
    launches = (lcf.fused_forward_chunk.launches,
                lcf.fused_backward_chunk.launches,
                lc.backward_betas_chunk.launches, lcs.seg_weights.launches)
    e1 = sess.e_step(m1, 0.0, 0)
    _close(e1, jsess.e_step(jm1, 0.0, 0))
    # The first pass built one SegStruct per group; the fused route keeps
    # no slots once its SegStruct exists, the cached route keeps them.
    groups = len(sess._groups())
    assert len(sess.seg_cache) == groups
    assert len(sess.slot_cache) == (0 if route == "fused" else groups)
    # The steady state repeats the first pass exactly.
    assert np.array_equal(sess.e_step(m1, 0.0, 0), e1)
    # A rescored, shrunk vocabulary rebinds onto the cached structures.
    _close(sess.e_step(m2, 0.0, 0), jsess.e_step(jm2, 0.0, 0))
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert launches == (lcf.fused_forward_chunk.launches,
                        lcf.fused_backward_chunk.launches,
                        lc.backward_betas_chunk.launches,
                        lcs.seg_weights.launches)


@pytest.mark.parametrize("route,jkernel", ROUTES)
def test_session_over_budget_matches_jax(corpus, one_jax_device, monkeypatch,
                                         route, jkernel):
    vocab, _, samples = corpus
    jm, m = _models(vocab)
    want = JDeviceTrainSession(jm, samples, max_snippet=256,
                               kernel=jkernel).e_step(jm, 0.0, 0)
    use_route(monkeypatch, route)
    sess = DeviceTrainSession(m, samples, 256, cache_budget=0, device="cpu")
    assert sess._fused() == (route == "fused")
    _close(sess.e_step(m, 0.0, 0), want)
    _close(sess.e_step(m, 0.0, 0), want)
    assert not sess.slot_cache and sess.cache_used == 0
    assert all(seg is None for seg in sess.seg_cache.values())


@pytest.mark.parametrize("route,jkernel", ROUTES)
def test_session_over_budget_dropout_matches_jax(corpus, one_jax_device,
                                                 monkeypatch, route,
                                                 jkernel):
    """The over-budget route at dropout 0.05 (the marginal scan draws the
    coins itself) against the JAX session's budgeted route, both fed the
    JAX session's dropout words: its single-device ops expand group g's
    key, the g-th split of PRNGKey(seed), into (rows, width) words."""
    vocab, _, samples = corpus
    jm, m = _models(vocab)
    seed = 4
    want = JDeviceTrainSession(jm, samples, max_snippet=256,
                               kernel=jkernel).e_step(jm, 0.05, seed)

    def jax_words():
        key = jax.random.PRNGKey(seed)
        while True:
            key, sub = jax.random.split(key)
            yield sub

    keys = jax_words()

    def words(gen, rows, cols, device):
        return torch.as_tensor(np.array(jax.random.randint(
            next(keys), (rows, cols), minval=-(2**31), maxval=2**31 - 1,
            dtype=jax.numpy.int32)), device=device)

    monkeypatch.setattr(ed, "_drop_words", words)
    use_route(monkeypatch, route)
    sess = DeviceTrainSession(m, samples, 256, cache_budget=0, device="cpu")
    assert sess._fused() == (route == "fused")
    before = lc.backward_marginal_scan.launches
    _close(sess.e_step(m, 0.05, seed), want)
    assert not sess.slot_cache
    # CPU tensors take the plain twin: no kernel launch is counted.
    assert lc.backward_marginal_scan.launches == before


@pytest.mark.parametrize("route,jkernel", ROUTES)
def test_session_count_frequencies_match(corpus, one_jax_device, route,
                                         jkernel, monkeypatch):
    vocab, vocab2, samples = corpus
    # The frequency pass walks the backpointers on the device (the walk's
    # count mode), never on the host.
    walks = []
    walk_counts = lat.walk_counts

    def spy(*args, **kwargs):
        walks.append(1)
        return walk_counts(*args, **kwargs)

    def no_host_walk(*args, **kwargs):
        raise AssertionError("the frequency pass walked on the host")

    monkeypatch.setattr(lat, "walk_counts", spy)
    monkeypatch.setattr(lat, "backtrack", no_host_walk)
    # Samples that fit one EM snippet count over the EM groups (and, on the
    # slab route, their cached ranks); samples longer than the snippet make
    # the frequency pass pack again at the encode width.
    rng = random.Random(9)
    extra = "".join(rng.choice("abcdef ()") for _ in range(1500)).encode()
    use_route(monkeypatch, route)
    for smp, shared in (([s[:256] for s in samples], True),
                        (samples + [extra], False)):
        jm, m = _models(vocab2)
        sess = DeviceTrainSession(_models(vocab)[1], smp, 256, device="cpu")
        assert sess._fused() == (route == "fused")
        sess.e_step(m, 0.0, 0)  # warms the slot cache
        before = len(walks)
        got = sess.count_frequencies(m)
        assert len(walks) - before == len(sess._freq_groups())
        assert got.dtype == np.int64 and got.sum() > 0
        assert sess._freq_shared == shared
        # The encode route's ids, counted on the host.
        ids = ed.encode_corpus_device(m, smp, device="cpu")
        np.testing.assert_array_equal(got, np.bincount(
            np.concatenate([np.asarray(r, np.int64) for r in ids if r]),
            minlength=m.vocab_size()))
        jsess = JDeviceTrainSession(_models(vocab)[0], smp, max_snippet=256,
                                    kernel=jkernel)
        np.testing.assert_array_equal(got, jsess.count_frequencies(jm))


def test_session_dropout_is_seeded(corpus):
    vocab, _, samples = corpus
    _, m = _models(vocab)
    sess = DeviceTrainSession(m, samples, 256, device="cpu")
    e1 = sess.e_step(m, 0.3, 7)
    assert np.array_equal(e1, sess.e_step(m, 0.3, 7))
    assert not np.array_equal(e1, sess.e_step(m, 0.3, 8))
    e0 = sess.e_step(m, 0.0, 7)
    assert not np.allclose(e1, e0)
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 0.5


def _wide_scores_case(seed=11, n_tokens=20_000):
    """tests/test_scale_vocab.py's wide-scores case: a vocabulary past the
    fused route's table size, most scores in [-12, -1] and a rare tail
    near -15 whose tokens recur in the corpus beside frequent ones."""
    rng = random.Random(seed)
    alphabet = b"abcdef ()"
    vocab = [tg.ScoredToken(bytes([b]), rng.uniform(-11.0, -9.0))
             for b in alphabet]
    seen = {t.value for t in vocab}
    rare = []
    while len(vocab) < n_tokens:
        w = bytes(rng.choice(alphabet) for _ in range(rng.randint(2, 8)))
        if w in seen:
            continue
        seen.add(w)
        if rng.random() < 0.002:
            vocab.append(tg.ScoredToken(w, rng.uniform(-16.0, -13.0)))
            rare.append(w)
        else:
            vocab.append(tg.ScoredToken(w, rng.uniform(-12.0, -1.0)))
    pool = [t.value for t in vocab[len(alphabet):]]
    samples = []
    for _ in range(48):
        parts, size, target = [], 0, rng.randint(64, 500)
        while size < target:
            p = rng.choice(pool) if rng.random() < 0.6 else \
                bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 5)))
            parts.append(p)
            size += len(p)
        samples.append(b"".join(parts)[:target])
    for w in rare[:8]:
        samples.extend([b"ab" + w + b"ba" + w + b"cd"] * 5)
    return tg.Model(vocab), samples, rare


def test_session_wide_scores_keep_rare_tokens():
    """Rare tokens sharing SEG_BLK blocks with marginal-1 neighbours keep
    their counts through the segsum (the true marginal is summed, not
    exp(score) factored out), against the f64 oracle."""
    model, samples, rare = _wide_scores_case()
    sess = DeviceTrainSession(model, samples, 512, device="cpu")
    assert not sess._fused()
    e = sess.e_step(model, 0.0, 0)
    assert sess.seg_cache
    want = [0.0] * model.vocab_size()
    for s in samples:
        lattice = tg.Lattice(s)
        model.oracle.populate_nodes(lattice, 0.0)
        lattice.populate_marginal(want)
    ids = model.oracle.token_to_ids
    checked = 0
    for w in rare:
        i = ids[w]
        if want[i] > 1e-4:
            checked += 1
            assert e[i] > 0.0, (w, want[i], e[i])
            np.testing.assert_allclose(e[i], want[i], rtol=0.1, atol=5e-5)
    assert checked >= 4


def test_pruner_uses_session_and_releases_it(monkeypatch):
    vocab, samples = _prune_corpus()
    seen = []
    orig = DeviceTrainSession.e_step

    def spy(self, *a, **k):
        seen.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(DeviceTrainSession, "e_step", spy)
    pruner = prune.VocabularyPruner(backend="device", device="cpu", **KW)
    got = pruner.prune(_model(tg, vocab), samples)
    # One session served every E-step and was released on the way out.
    assert len(seen) >= 2 and all(s is seen[0] for s in seen)
    assert pruner._session is None
    assert not seen[0].slot_cache and not seen[0].seg_cache
    assert not seen[0].input_cache and seen[0].dt is None
    oracle = prune.VocabularyPruner(backend="oracle", **KW).prune(
        _model(tg, vocab), samples)
    assert sorted(t.value for t in got.vocab) == \
        sorted(t.value for t in oracle.vocab)


def test_session_needs_a_device_without_cuda(corpus, monkeypatch):
    vocab, _, samples = corpus
    _, m = _models(vocab)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceTrainSession(m, samples, 256)


@pytest.mark.parametrize("kw,exc", [
    ({"local_shard": True}, NotImplementedError),
    ({"probe": "fast"}, TypeError),
    ({"kernel": "pallas"}, TypeError),
])
def test_session_unported_options_raise(corpus, kw, exc):
    """Probe and kernel overrides are no options of the session (the
    table's size picks the route, the dtype the exact mode): they raise
    TypeError. local_shard, refused until multi-GPU was ported, is the
    plain session at world size 1 (the shard is the corpus): the same
    counts and frequencies (tests/test_torch_multigpu.py runs shards on
    four ranks)."""
    vocab, _, samples = corpus
    _, m = _models(vocab)
    if "local_shard" not in kw:
        with pytest.raises(exc):
            DeviceTrainSession(m, samples, 256, device="cpu", **kw)
        return
    got = DeviceTrainSession(m, samples, 256, device="cpu", **kw)
    want = DeviceTrainSession(m, samples, 256, device="cpu")
    assert not got.local_shard
    np.testing.assert_array_equal(got.e_step(m, 0.05, 1),
                                  want.e_step(m, 0.05, 1))
    np.testing.assert_array_equal(got.count_frequencies(m),
                                  want.count_frequencies(m))


@pytest.mark.parametrize("kw", [{"dtype": torch.float64}, {}])
def test_session_f64_and_exact_probe_run(corpus, kw):
    """dtype=float64, refused until the f64 / exact mode was ported, takes
    the session's conformance mode (the exact probe); the default f32
    route (the fused kernels on this table) is the pruner's. Each pass's
    counts at dropout 0 equal the JAX package's E-step at the same type,
    at the type's tolerance (rtol 1e-8 at f64, 1e-4 at f32)."""
    vocab, _, samples = corpus
    jm, m = _models(vocab)
    f64 = kw.get("dtype") == torch.float64
    sess = DeviceTrainSession(m, samples, 256, device="cpu", **kw)
    assert sess.exact == f64 and sess._fused() == (not f64)
    got = sess.e_step(m, 0.0, 0)
    want = jed.run_e_step_device(jm, samples, dropout=0.0, max_snippet=256,
                                 dtype=jnp.float64 if f64 else jnp.float32)
    rtol = 1e-8 if f64 else 1e-4
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    assert got.sum() > 100 and (not f64 or not sess.slot_cache)
