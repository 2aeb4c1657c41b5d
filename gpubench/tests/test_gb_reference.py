"""The plain reference on hand-worked lattices, and the roofline work
counts on hand-made shapes."""

import math

import numpy as np
import pytest
import torch

from gpubench import kernels_work as kw
from gpubench.reference import lattice as rl
from gpubench.reference import prune as rp

CPU = torch.device("cpu")
# Text "abc": a|b|c -4.0, ab|c -3.5, a|bc -3.2, abc -4.0.
VOCAB = [(b"a", -1.0, True), (b"b", -1.0, True), (b"c", -2.0, True),
         (b"ab", -1.5, False), (b"bc", -2.2, False), (b"abc", -4.0, False)]


def _scores(v):
    return torch.tensor([t[1] for t in v], dtype=torch.float64)


def test_viterbi_best_path_and_ties():
    lookup = rl.Lookup([t[0] for t in VOCAB], CPU)
    best, ids = rl.encode([b"abc", b"ab", b"c", b""], lookup,
                          _scores(VOCAB))
    assert np.allclose(best, [-3.2, -1.5, -2.0, 0.0])
    assert ids == [[0, 4], [3], [2], []]
    # a|b and ab tie at -2: the longest token wins, as upstream.
    tie = [(b"a", -1.0, True), (b"b", -1.0, True), (b"ab", -2.0, False)]
    _, ids = rl.encode([b"ab", b"abab"], rl.Lookup([t[0] for t in tie], CPU),
                       _scores(tie))
    assert ids == [[2], [2, 2]]


def test_e_step_marginals():
    gen = torch.Generator().manual_seed(0)
    counts, hits = rp.e_step(VOCAB, [b"abc"], 0.0, gen, CPU)
    paths = {"a|b|c": -4.0, "ab|c": -3.5, "a|bc": -3.2, "abc": -4.0}
    z = sum(math.exp(v) for v in paths.values())
    p = {k: math.exp(v) / z for k, v in paths.items()}
    want = [p["a|b|c"] + p["a|bc"], p["a|b|c"], p["a|b|c"] + p["ab|c"],
            p["ab|c"], p["a|bc"], p["abc"]]
    assert np.allclose(counts, want, rtol=1e-12)
    assert hits.tolist() == [1, 1, 1, 1, 1, 1]


def test_e_step_dropout_keeps_single_bytes():
    gen = torch.Generator().manual_seed(1)
    counts, _ = rp.e_step(VOCAB, [b"abc"] * 200, 1.0, gen, CPU)
    assert np.allclose(counts, [200, 200, 200, 0, 0, 0])


def test_alternatives_rule():
    keep, alts, s_w, s_m = rp.alternatives(VOCAB, CPU)
    # abc: a|bc scores -3.2 > -4.0: neither kept nor alternatives.
    # ab: a|b -2.0 < -1.5: kept with a|b; bc: b|c -3.0 < -2.2: kept.
    assert keep.tolist() == [True, True, True, True, True, False]
    assert alts == [[], [], [], [0, 1], [1, 2], []]
    assert np.allclose(s_m[3:], [-2.0, -3.0, -3.2])
    assert np.isinf(s_m[:3]).all()


def test_m_step_and_select():
    v = [(b"a", -1.0, False), (b"b", -1.0, False), (b"c", -1.0, True)]
    out = rp.m_step(v, np.array([3.0, 0.2, 5.0]))
    dg = {3: 0.9227843350984671, 5: 1.5061176684318003,
          8: 2.0156414779556098}
    assert [t[0] for t in out] == [b"a", b"c"]
    assert np.allclose([t[1] for t in out], [dg[3] - dg[8], dg[5] - dg[8]])
    # The loss ranks "ab" (whose alternative a|b is frequent) last: cut.
    v = [(b"a", -1.0, True), (b"b", -1.0, True), (b"ab", -2.0, False),
         (b"ba", -2.5, False)]
    kept = rp.select(v, np.array([10, 10, 5, 1]), np.ones(4, bool),
                     [[], [], [0, 1], [1, 0]], 4, 3, 0.75)
    assert [t[0] for t in kept] == [b"a", b"b", b"ab"]


def test_roofline_counts():
    # match_probe: 1,000 positions, L = 16, 100 tokens, 2 calls: 88,000
    # bytes and 224,000 operations: bound by the bytes.
    assert kw.match_probe(1000, 16, 100, 2) == pytest.approx(88_000 / 3.35e12)
    assert kw.viterbi_scan(1000, 16) == pytest.approx(76_000 / 3.35e12)
    assert kw.forward_scan(1000, 16, True) == pytest.approx(76_000 / 3.35e12)
    assert kw.forward_scan(1000, 16, False) == pytest.approx(72_000 / 3.35e12)
    # seg_weights_gather: 12,800 entries (100 blocks), 1,000 positions, 50
    # tokens: 102,400 + 1,200 + 17,000 + 400 bytes; 300,400 operations.
    assert kw.seg_weights_gather(1000, 12800, 50, True) == pytest.approx(
        max(121_000 / 3.35e12, 300_400 / 67e12))
    assert kw.bound_s(0, 67e12) == pytest.approx(1.0)



def test_select_sums_alternatives_left_to_right():
    """Two candidates of equal frequency whose alternatives hold the same
    frequencies in another order: summed left to right, as upstream and
    the program sum them, the second's loss comes out an ulp above the
    first's and only it is kept; Python's compensated sum() ties them, and
    the tie keeps the first."""
    rng = np.random.default_rng(3)
    freq, V = 1.0, 5

    def alt(f, order):
        logsum = math.log(float(f.sum() + 2) + freq * (V - 1))
        terms = [math.log(float(f[a]) + freq) - logsum for a in order]
        total = 0.0
        for t in terms:
            total += t
        return total, sum(terms)

    while True:
        f = rng.integers(1, 10**6, 3)
        (a_fwd, a_comp), (b_fwd, b_comp) = alt(f, [0, 1, 2]), alt(f, [2, 1, 0])
        if b_fwd < a_fwd and a_comp == b_comp:
            break
    # Tokens 0-2: the alternatives, kept (no alternatives of their own);
    # 3 and 4: the candidates, one of them kept.
    vocab = [(bytes([65 + i]), -5.0, False) for i in range(3)] + \
        [(b"xy", -9.0, False), (b"yx", -9.0, False)]
    freqs = np.array(list(f) + [1, 1], np.int64)
    alts = [[], [], [], [0, 1, 2], [2, 1, 0]]
    keep = np.zeros(V, bool)
    got = rp.select(vocab, freqs, keep, alts, 10, 4, 0.8)
    assert [t[0] for t in got][-1] == b"yx"
    from tokengeex_tpu_torch import Model, ScoredToken
    from tokengeex_tpu_torch.train.prune import VocabularyPruner

    p = VocabularyPruner(vocab_size=4, shrink_factor=0.8, device="cpu")
    p._n_samples = 10
    p._alternatives = lambda model: (keep, alts)
    p._count_frequencies = lambda model, samples, task: freqs
    want = p.prune_vocab(Model([ScoredToken(*t) for t in vocab]), [])
    assert got == [(t.value, t.score, t.keep) for t in want]
