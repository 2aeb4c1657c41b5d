"""The port's VocabularyPruner against the JAX package's, on the CPU.

The oracle backends of both packages are pure f64 Python over the same
host code, so they must agree bit for bit; the port's device backend
(run on the CPU through the kernels' plain versions) must keep the same
tokens with scores within f32 error.
"""

import random

import numpy as np
import pytest
import torch

import tokengeex_tpu as jtg
from tokengeex_tpu.train import prune as jprune

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.train import prune

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)


def _corpus(seed=0):
    rng = random.Random(seed)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "mi", "value",
             "def", "return", "data", "self", "print"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 30))
                        ).encode() for _ in range(60)]
    alphabet = sorted(set(b"".join(samples)))
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < 150:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, 8)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    return vocab, samples


def _model(pkg, vocab):
    # Single bytes are kept, so the M-step cannot drop a byte the corpus
    # needs (the frequency pass would then find no path).
    return pkg.Model([pkg.ScoredToken(v, s, len(v) == 1) for v, s in vocab])


KW = dict(vocab_size=80, shrink_factor=0.7, em_subiters=2, dropout=0.0)


@pytest.fixture(scope="module")
def oracle_pruned():
    vocab, samples = _corpus()
    return prune.VocabularyPruner(backend="oracle", **KW).prune(
        _model(tg, vocab), samples)


def test_oracle_pruner_matches_jax_exactly(oracle_pruned, monkeypatch):
    vocab, samples = _corpus()
    # The JAX pruner's pure-Python route (no native library).
    monkeypatch.setattr(jtg.Model, "native", lambda self: None)
    want = jprune.VocabularyPruner(backend="oracle", **KW).prune(
        _model(jtg, vocab), samples)
    assert len(want.vocab) == 80
    assert [(t.value, t.score, t.keep) for t in oracle_pruned.vocab] == \
        [(t.value, t.score, t.keep) for t in want.vocab]


def test_digamma_and_m_step_match_jax():
    x = np.concatenate([[0.5, 0.75, 1.0, 6.9, 7.0, 7.5], np.geomspace(
        0.5, 1e6, 200)])
    assert np.array_equal(prune.digamma_np(x), jprune.digamma_np(x))
    assert [prune.digamma(v) for v in x] == [jprune.digamma(v) for v in x]
    vocab, _ = _corpus(1)
    rng = np.random.default_rng(1)
    expected = rng.exponential(3.0, len(vocab))
    expected[::7] = 0.1  # below the 0.5 threshold: dropped unless kept
    got = prune.VocabularyPruner(80, backend="oracle").run_m_step(
        _model(tg, vocab), expected)
    want = jprune.VocabularyPruner(80, backend="oracle").run_m_step(
        _model(jtg, vocab), expected)
    assert [(t.value, t.score, t.keep) for t in got] == \
        [(t.value, t.score, t.keep) for t in want]


def test_device_pruner_on_cpu_matches_oracle(oracle_pruned):
    """Seed 0 was checked to leave every decision (Viterbi paths, the
    M-step's 0.5 threshold, the loss ranking) outside f32 error: both
    prunes keep the same 80 tokens, scores agree to ~5e-6 relative."""
    vocab, samples = _corpus()
    launches = (lc.forward_chunk.launches, lc.backward_chunk.launches,
                lc.viterbi_chunk.launches, lc.viterbi_scan.launches)
    got = prune.VocabularyPruner(backend="device", device="cpu", **KW).prune(
        _model(tg, vocab), samples)
    assert launches == (lc.forward_chunk.launches, lc.backward_chunk.launches,
                        lc.viterbi_chunk.launches, lc.viterbi_scan.launches)
    want = {t.value: t.score for t in oracle_pruned.vocab}
    assert sorted(t.value for t in got.vocab) == sorted(want)
    np.testing.assert_allclose([t.score for t in got.vocab],
                               [want[t.value] for t in got.vocab], rtol=1e-4)


@pytest.mark.parametrize("kw", [
    {"backend": "auto"}, {"backend": "native"}, {"corpus_sharded": True},
])
def test_unported_options_raise(kw):
    """The native and auto backends are not part of the port;
    corpus_sharded, refused until multi-GPU was ported, prunes in one
    process (world size 1: the shard is the corpus) to the unsharded
    pruner's vocabulary (tests/test_torch_multigpu.py prunes two ranks'
    shards)."""
    if not kw.get("corpus_sharded"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prune.VocabularyPruner(80, **kw)
        return
    vocab, samples = _corpus()
    got, want = (prune.VocabularyPruner(backend="device", device="cpu",
                                        corpus_sharded=sharded, **KW).prune(
        _model(tg, vocab), samples) for sharded in (True, False))
    assert [(t.value, t.score, t.keep) for t in got.vocab] == \
        [(t.value, t.score, t.keep) for t in want.vocab]
    with pytest.raises(ValueError, match="device backend"):
        prune.VocabularyPruner(80, backend="oracle", **kw)


def test_device_dtype_f64_runs(oracle_pruned):
    """device_dtype=float64, refused until the f64 / exact mode was
    ported, prunes through the session's f64 mode to the f64 oracle's
    vocabulary and scores (tests/test_torch_f64.py holds it against the
    JAX package's f64 pruner); other types raise."""
    vocab, samples = _corpus()
    got = prune.VocabularyPruner(backend="device", device="cpu",
                                 device_dtype=torch.float64, **KW).prune(
        _model(tg, vocab), samples)
    want = {t.value: t.score for t in oracle_pruned.vocab}
    assert sorted(t.value for t in got.vocab) == sorted(want)
    np.testing.assert_allclose([t.score for t in got.vocab],
                               [want[t.value] for t in got.vocab], rtol=1e-8)
    with pytest.raises(ValueError, match="device_dtype"):
        prune.VocabularyPruner(80, device_dtype=torch.float16)


def test_device_pruner_needs_a_device_without_cuda(monkeypatch):
    vocab, samples = _corpus()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prune.VocabularyPruner(backend="device", **KW).prune(
            _model(tg, vocab), samples)
