"""The prune round's nbest(2) alternatives on the device route against the
reference, on the CPU.

`estep_device.prune_alternatives_device` runs one masked f64 Viterbi pass
over the vocabulary's own bytes (the kernels' plain versions here); the
JAX package computes the same `(always_keep, alternatives)` in its native
runtime (`NativeModel.prune_alternatives`) or, without it, with a Python
`Lattice.nbest(2)` per token, as the port's oracle backend does. The card
against the plain route is in tests/test_torch_cuda.py.
"""

import random

import numpy as np
import pytest
import torch

import tokengeex_tpu as jtg
from tokengeex_tpu.train import prune as jprune

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.models import oracle
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train import prune
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession

torch.set_num_threads(1)

ALPHABET = b"abcdefg"
MAX_LEN = 12
# Tokens of bytes outside ALPHABET, each byte in one token only: their
# lattices hold the whole token alone.
LONE = [b"\x01\x02", b"\x03\x04\x05\x06"]


def _square_free(w: bytes) -> bool:
    """No substring zz. A token holding none has no two adjacent tokens
    that commute (XY == YX needs X, Y powers of one word z), so no two
    of its paths are one path's tokens reordered into an equal f64 sum."""
    return not any(w[i : i + k] == w[i + k : i + 2 * k]
                   for k in range(1, len(w) // 2 + 1)
                   for i in range(len(w) - 2 * k + 1))


def _vocab(seed, n, ints=False, squares=False):
    """(value, score) pairs: every byte of ALPHABET, the LONE tokens,
    tokens of 2 to MAX_LEN bytes over ALPHABET (square-free unless
    `squares`), several at MAX_LEN, and two values twice (the later
    duplicate wins, as in the oracle's trie). Integer scores tie often."""
    rng = random.Random(seed)

    def score(lo, hi):
        return float(rng.randint(lo, hi)) if ints else rng.uniform(lo, hi)

    vocab = [(bytes([b]), score(-11, -9)) for b in ALPHABET]
    vocab += [(w, score(-9, -1)) for w in LONE]
    seen = {v for v, _ in vocab}
    while len(vocab) < n:
        k = MAX_LEN if len(vocab) % 50 == 0 else rng.randint(2, MAX_LEN - 1)
        w = bytes(rng.choice(ALPHABET) for _ in range(k))
        if w not in seen and (squares or _square_free(w)):
            seen.add(w)
            vocab.append((w, score(-9, -1)))
    for i in (20, 77):
        vocab.append((vocab[i][0], score(-9, -1)))
    return vocab


def _model(pkg, vocab):
    return pkg.Model([pkg.ScoredToken(v, s) for v, s in vocab])


def _jax_alternatives(vocab, monkeypatch, native: bool):
    model = _model(jtg, vocab)
    if native:
        assert model.native() is not None, "the native runtime did not build"
    else:
        monkeypatch.setattr(jtg.Model, "native", lambda self: None)
    return jprune.VocabularyPruner(10, backend="oracle")._alternatives(model)


ALTERNATIVES = prune.VocabularyPruner._alternatives


def _oracle_alternatives(model):
    """The port's oracle route: a Python Lattice.nbest(2) per token."""
    return ALTERNATIVES(prune.VocabularyPruner(10, backend="oracle"), model)


def _cases(vocab, got):
    """The rule's three cases on this vocabulary: tokens with no M, with
    M's ids, and not kept."""
    keep, alts = got
    return (int((keep & ~np.asarray([bool(a) for a in alts])).sum()),
            sum(bool(a) for a in alts), int((~keep).sum()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("route", ["native", "python"])
def test_device_alternatives_match_jax(seed, route, monkeypatch):
    """Continuous scores: keep flags and lists bit for bit equal to the
    JAX package's `_alternatives`, native and pure Python, and to the
    port's oracle route; every case of the rule occurs."""
    vocab = _vocab(seed, 700)
    got = ed.prune_alternatives_device(_model(tg, vocab), device="cpu")
    no_m, with_m, dropped = _cases(vocab, got)
    assert no_m >= len(ALPHABET) - 1 and with_m > 100 and dropped > 0
    for want in (_jax_alternatives(vocab, monkeypatch, route == "native"),
                 _oracle_alternatives(_model(tg, vocab))):
        assert np.array_equal(got[0], want[0])
        assert got[1] == want[1]


def _forward_sum(scores, ids):
    total = 0.0
    for i in ids:
        total += scores[i]
    return total


def tie_kind(scores, a, b) -> str:
    """How two segmentations of one token, a and b, tie: "exact" when
    their f64 sums in the forward order are equal, "reordered" when they
    are the same tokens in another order (equal in exact arithmetic) and
    their f64 sums at most 2 ulps apart; "" otherwise."""
    sa, sb = _forward_sum(scores, a), _forward_sum(scores, b)
    if sa == sb:
        return "exact"
    if sorted(a) == sorted(b) and abs(sa - sb) <= 2 * np.spacing(abs(sa)):
        return "reordered"
    return ""


@pytest.mark.parametrize("kw,kinds", [
    ({"seed": 2, "ints": True}, ["exact", "exact"]),
    ({"seed": 3, "squares": True}, ["reordered"]),
])
def test_tied_paths_keep_flags_equal_lists_tie(kw, kinds):
    """Where two multi-token paths tie for the best path without the whole
    token, the A* (which orders by a forward prefix plus a backward suffix
    sum) and the scan (forward sums, ties to the longest token) may pick
    different ones, the documented deviation: integer scores, and
    continuous scores over tokens holding squares (the same tokens
    reordered). Keep flags equal the oracle route's; the differing lists
    are pinned at these seeds, each a segmentation of its token tying
    with the oracle's."""
    vocab = _vocab(n=1500, **kw)
    model = _model(tg, vocab)
    got = ed.prune_alternatives_device(model, device="cpu")
    want = _oracle_alternatives(model)
    assert np.array_equal(got[0], want[0])
    scores = [s for _, s in vocab]
    differ = [t for t, (a, b) in enumerate(zip(got[1], want[1])) if a != b]
    assert [tie_kind(scores, got[1][t], want[1][t]) for t in differ] == kinds
    for t in differ:
        assert b"".join(vocab[i][0] for i in got[1][t]) == vocab[t][0]


def test_model_builds_no_trie_until_a_host_method_needs_one():
    vocab = [tg.ScoredToken(v, s) for v, s in _vocab(4, 200)]
    model = tg.Model(vocab)
    extra = tg.ScoredToken(b"gfedcba", -3.0)
    assert model.vocab_size() == len(vocab) and model.vocab == vocab
    assert model.token_to_ids[vocab[20].value] == len(vocab) - 2
    model.add_tokens([extra])
    assert model.token_to_ids[extra.value] == len(vocab)
    assert model.decode([0, len(vocab)]) == "a" + extra.value.decode()
    assert model._oracle is None
    ids = model.encode("abcgfedcba")
    assert model._oracle is not None
    assert ids == oracle.OracleModel(vocab + [extra]).encode("abcgfedcba")
    model.add_tokens([tg.ScoredToken(b"gg", -1.0)])
    assert model.vocab_size() == len(vocab) + 2
    assert model.token_to_ids[b"gg"] == model.token_to_id(b"gg") == \
        len(vocab) + 1


def _prune_corpus():
    rng = random.Random(5)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "value", "return"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 20))
                        ).encode() for _ in range(40)]
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0))
             for b in sorted(set(b"".join(samples)))]
    seen = {v for v, _ in vocab}
    while len(vocab) < 120:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, 8)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    model = tg.Model([tg.ScoredToken(v, s, len(v) == 1) for v, s in vocab])
    return model, samples


def test_device_pruner_runs_no_nbest_and_builds_no_trie(monkeypatch):
    """The device pruner computes its alternatives through the masked
    pass over the session's table (no Lattice.nbest, no trie, no kernel
    launch on the CPU) and prunes to the vocabulary it prunes to with the
    oracle route's alternatives."""
    model, samples = _prune_corpus()
    kw = dict(vocab_size=60, shrink_factor=0.7, dropout=0.0, device="cpu")
    monkeypatch.setattr(prune.VocabularyPruner, "_alternatives",
                        lambda self, m: _oracle_alternatives(m))
    want = prune.VocabularyPruner(**kw).prune(model, samples)
    monkeypatch.undo()

    def refuse(*args, **kwargs):
        raise AssertionError("the device route built a trie or a lattice")

    monkeypatch.setattr(oracle.Lattice, "nbest", refuse)
    monkeypatch.setattr(oracle.OracleModel, "__init__", refuse)
    # The frequency pass after the alternatives finds the session bound to
    # its model: the table is bound once a model.
    bound = []
    count = DeviceTrainSession.count_frequencies

    def counted(self, m, *args, **kwargs):
        bound.append(self._model is m)
        return count(self, m, *args, **kwargs)

    monkeypatch.setattr(DeviceTrainSession, "count_frequencies", counted)
    launches = (lc.viterbi_scan.launches, lc.viterbi_scan.launches_f64)
    got = prune.VocabularyPruner(**kw).prune(
        tg.Model(list(model.vocab)), samples)
    assert (lc.viterbi_scan.launches, lc.viterbi_scan.launches_f64) == \
        launches
    assert bound and all(bound)
    assert [(t.value, t.score) for t in got.vocab] == \
        [(t.value, t.score) for t in want.vocab]
