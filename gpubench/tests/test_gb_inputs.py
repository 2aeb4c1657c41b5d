"""The seeded corpus and the vocabulary rules."""

import numpy as np

from gpubench import corpus, inputs, vocab

PARAMS = {"pool_size": 12000, "zipf": 0.7, "file_median_bytes": 3000,
          "file_sigma": 1.0, "file_min_bytes": 16, "file_max_bytes": 262144,
          "sizes_seed": 20}


def test_same_seed_same_bytes():
    a = corpus.build_corpus(300_000, 2**40 + 3, PARAMS)
    b = corpus.build_corpus(300_000, 2**40 + 3, PARAMS)
    c = corpus.build_corpus(300_000, 2**40 + 4, PARAMS)
    assert a == b
    assert a != c
    assert sum(map(len, a)) >= 300_000
    # Every seed gets the same sizes, in another order.
    assert sorted(map(len, a)) == sorted(map(len, c))
    assert list(map(len, a)) != list(map(len, c))


def test_file_lengths_follow_the_distribution():
    rng = np.random.default_rng(5)
    sizes = corpus.file_lengths(rng, 60_000_000, 3000, 1.0, 16, 262144)
    assert sizes.sum() >= 60_000_000
    assert sizes.min() >= 16 and sizes.max() <= 262144
    q = np.quantile(sizes, [0.25, 0.5, 0.75])
    # lognormal(log 3000, 1): quartiles at 3000 e^-0.674, 3000, 3000 e^0.674
    assert np.allclose(q, [3000 * np.exp(-0.6745), 3000,
                           3000 * np.exp(0.6745)], rtol=0.05)
    big = sizes[sizes > 32768].sum() / sizes.sum()
    assert 0.05 < big < 0.12  # about 8 % of the bytes take the chained path


def test_text_is_code_like_lines():
    files = corpus.build_corpus(100_000, 11, PARAMS)
    text = b"".join(files)
    assert text.count(b"\n") > 1000
    assert set(text) <= set(b"abcdefghijklmnopqrstuvwxyz ()=,._:[]0{}+'%;\n12")


def _check_vocab(v, size, files):
    text = b"\x00".join(files)
    assert len(v) == size
    assert len({t for t, _, _ in v}) == size
    assert [t for t, _, _ in v[:0]] == []
    byte_tokens = {t for t, _, k in v if len(t) == 1 and k}
    assert byte_tokens == {bytes([b]) for b in range(255)}
    for t, s, k in v:
        assert np.isfinite(s) and s < 0
        if len(t) > 1:
            assert not k and 2 <= len(t) <= 16
            assert t in text, t


def test_words_vocab():
    files = corpus.build_corpus(400_000, 3, PARAMS)
    for prefixes in (False, True):
        v = vocab.words_vocab(files, 3000, 16, prefixes)
        _check_vocab(v, 3000, files)
        assert max(len(t) for t, _, _ in v) == 16


def test_sampled_vocab():
    files = corpus.build_corpus(400_000, 3, PARAMS)
    v = vocab.sampled_vocab(files, 3000, 16, 0.05, 9)
    _check_vocab(v, 3000, files)
    assert v == vocab.sampled_vocab(files, 3000, 16, 0.05, 9)
    # Scores are log probabilities of frequency x length, summing to 1.
    assert np.isclose(sum(np.exp(s) for _, s, _ in v), 1.0)


def test_recipe_sizes():
    config = {"init_vocab_size": 500000, "vocab_size": 32768,
              "prune": {"shrink_factor": 0.8}}
    sizes = inputs.recipe_sizes(config)
    assert sizes[:2] == [500000, 400000]
    assert sizes[-3:] == [42948, 34358, 32768]
    assert inputs.prune_sizes(config, {"rounds": "first", "n_rounds": 1}) \
        == (500000, 400000)
    assert inputs.prune_sizes(config, {"rounds": "last", "n_rounds": 2}) \
        == (42948, 32768)
