"""The port's merge and filter against the JAX package's, on the CPU.

`count_pairs_arrays` (the device encode over a DeviceCorpus packed once,
its ids walked on the device and their pairs counted there), in order as
the merger reads it, against the JAX package's `count_pairs_device`, as a
dict and in order; `VocabularyMerger` on the device
backend (the kernels' plain versions) and on the oracle backend against
the JAX package's merger on the same samples and allow pattern;
`VocabularyFilter`, the allow-DFA and the pattern helpers against their
JAX package originals (the port's copies).
"""

import random

import numpy as np
import pytest
import torch

from tokengeex_tpu.core import redfa as jredfa
from tokengeex_tpu.train import estep_device as jed
from tokengeex_tpu.train import patterns as jpatterns
from tokengeex_tpu.train.filter import VocabularyFilter as JVocabularyFilter
from tokengeex_tpu.train.merge import VocabularyMerger as JVocabularyMerger

from tokengeex_tpu_torch.core import redfa
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train import patterns
from tokengeex_tpu_torch.train.filter import VocabularyFilter
from tokengeex_tpu_torch.train.merge import VocabularyMerger

from test_torch_pairs import pair_list
from test_torch_session import _models, one_jax_device  # noqa: F401

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

# An anchored identifier / punctuation class the allow-DFA compiles.
ALLOW = r"^(?: ?[a-z]+|[[:punct:]]+)$"


@pytest.fixture(scope="module")
def merge_corpus():
    """Code-like samples over a small alphabet, and a vocabulary of all
    their bytes plus a few words, most of them short."""
    rng = random.Random(41)
    words = [b"def", b"ab", b"cab", b"fed", b"bead", b"(a)", b"()", b"ca"]
    samples = [b" ".join(rng.choice(words) for _ in range(rng.randint(1, 40)))
               + rng.choice([b"", b"(", b" )"]) for _ in range(60)]
    alphabet = sorted(set(b"".join(samples)))
    vocab = [(bytes([b]), rng.uniform(-7.0, -5.0)) for b in alphabet]
    vocab += [(w, rng.uniform(-6.0, -3.0)) for w in (b" d", b"ef", b"ab")]
    return vocab, samples


def _as_tuples(model):
    return [(t.value, t.score, t.keep) for t in model.vocab]


@pytest.mark.parametrize("hints", [None, (16, 24)])
def test_count_pairs_match_jax(merge_corpus, one_jax_device, hints):
    vocab, samples = merge_corpus
    jm, m = _models(vocab)
    want = jed.count_pairs_device(jm, samples, table_hints=hints)
    got = pair_list(m, samples, table_hints=hints, device="cpu")
    assert got == want  # in order: descending counts, ties by key
    assert dict(got) == dict(want) and len(got) > 20
    assert any(c > 10 for _, c in got)


def test_device_corpus_reuse_and_mismatch(merge_corpus, monkeypatch):
    """A corpus packed once serves every model; one packed from other
    samples is not trusted. Its groups re-encode through the walk."""
    vocab, samples = merge_corpus
    _, m = _models(vocab)
    _, m2 = _models(vocab[:-2])
    corpus = ed.DeviceCorpus(samples, device="cpu")
    calls = []
    walk = lat.walk_ids

    def spy(*a, **k):
        calls.append(1)
        return walk(*a, **k)

    monkeypatch.setattr(lat, "walk_ids", spy)
    for model in (m, m2, m):
        want = ed.encode_corpus_device(model, samples, device="cpu")
        assert ed.encode_corpus_device(model, samples, device="cpu",
                                       corpus=corpus) == want
    assert len(calls) == 6 * len(corpus.groups)
    assert corpus.used > 0 and len(corpus._inputs) == len(corpus.groups)
    assert set(corpus._chains) == set(corpus._inputs)
    other = samples[10:20]
    assert ed.encode_corpus_device(m, other, device="cpu", corpus=corpus) \
        == ed.encode_corpus_device(m, other, device="cpu")
    pairs = pair_list(m, samples, corpus=corpus)
    assert pairs == pair_list(m, samples, device="cpu")


def test_device_corpus_is_single_process(merge_corpus, tmp_path):
    """A DeviceCorpus under a process group, refused until multi-GPU was
    ported: at world size 1 it keeps every row, and its pair counts and
    merges equal the run without a group (tests/test_torch_multigpu.py
    merges through two ranks)."""
    from tokengeex_tpu_torch.parallel import mesh

    vocab, samples = merge_corpus
    _, m = _models(vocab)
    want = pair_list(m, samples, device="cpu")
    merger = dict(allow=ALLOW, num_merges=6, step=3, device="cpu")
    merged = VocabularyMerger(**merger).merge(_models(vocab)[1], samples)
    mesh.distributed_initialize("cpu", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0, timeout=60)
    try:
        corpus = ed.DeviceCorpus(samples, device="cpu")
        assert [sub.rows for _, sub in corpus.groups] == \
            [rows for rows, lo in corpus.blocks.values()]
        assert pair_list(m, samples, corpus=corpus) == want
        got = VocabularyMerger(**merger).merge(_models(vocab)[1], samples)
    finally:
        mesh.shutdown()
    assert _as_tuples(got) == _as_tuples(merged)


@pytest.mark.parametrize("backend", ["device", "oracle"])
def test_merger_matches_jax(merge_corpus, one_jax_device, monkeypatch,
                            backend):
    vocab, samples = merge_corpus
    jm, m = _models(vocab)
    # The JAX package's oracle backend counts through its native runtime
    # when that is built; the port has none, so both count on the oracle.
    monkeypatch.setattr(jm, "native", lambda: None)
    kw = dict(allow=ALLOW, num_merges=12, step=4, max_token_length=12)
    want = JVocabularyMerger(backend=backend, **kw).merge(jm, samples)
    extra = {"device": "cpu"} if backend == "device" else {}
    merger = VocabularyMerger(backend=backend, **kw, **extra)
    got = merger.merge(m, samples)
    assert _as_tuples(got) == _as_tuples(want)
    assert got.vocab_size() == len(vocab) + 12
    if backend == "device":
        # One corpus for the whole merge run.
        assert merger._corpus is not None and merger._corpus.samples \
            is samples


def test_device_and_oracle_pairs_agree(merge_corpus):
    """Both backends count the same pairs; they order equal counts
    differently (by key on the device, by first occurrence on the oracle,
    as in the JAX package)."""
    vocab, samples = merge_corpus
    _, m = _models(vocab)
    merger = VocabularyMerger(allow=ALLOW, backend="oracle")
    task = ed.Task("pairs", len(samples))
    want = merger._count_pairs(m, samples, task)
    got = pair_list(m, samples, device="cpu")
    assert dict(got) == dict(want)
    assert [c for _, c in got] == [c for _, c in want]


def test_merger_backends():
    for backend in ("auto", "native"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            VocabularyMerger(allow=ALLOW, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        VocabularyMerger(allow=ALLOW, backend="tpu")


@pytest.mark.parametrize("vocab_size,min_score,force", [
    (20, None, False), (25, -5.0, False), (10, -4.0, True), (100, None, True)])
def test_filter_matches_jax(merge_corpus, vocab_size, min_score, force):
    vocab, _ = merge_corpus
    vocab = vocab + [(b"keep", -9.0)]
    jm, m = _models(vocab)
    m.vocab[-1].keep = jm.vocab[-1].keep = True
    want = JVocabularyFilter(vocab_size, min_score, force).filter(jm)
    got = VocabularyFilter(vocab_size, min_score, force).filter(m)
    assert _as_tuples(got) == _as_tuples(want)


@pytest.mark.parametrize("pattern", [
    ALLOW, r"^ ?[a-z]+$|^.$", r"^[ -~]+$", r"^(?:[[:punct:]]+\n)$",
    r"[a-c]{2,3}d?"])
def test_allow_dfa_and_patterns_match_jax(pattern):
    dfa = redfa.compile_is_match_dfa(pattern)
    jdfa = jredfa.compile_is_match_dfa(pattern)
    for name in ("next", "accept"):
        np.testing.assert_array_equal(getattr(dfa, name), getattr(jdfa, name))
    for text in (b"abc", b" def", b"();", b"a b", b"", b"\xe4\xb8\x80"):
        assert dfa.fullmatch_bytes(text) == jdfa.fullmatch_bytes(text)
    assert patterns.rust_to_python(pattern) == \
        jpatterns.rust_to_python(pattern)
