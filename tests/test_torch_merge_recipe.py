"""The recipe's merge stage (upstream docs/RECIPES.md exact-32k-merged:
merge --step 100 --max-token-length 20 --allow data/fine.regex) on the
device route, against the benchmark's plain reference
(gpubench/reference/merge.py, which shares no code with the port).

On the CPU: `VocabularyMerger(backend="device", device="cpu")` at
max_token_length 20 with the fine pattern set, step 10, three passes, on
seeded files and a seeded ~300-token vocabulary, on the fused route (the
default small table) and on the slab route at table bits 16 (the
benchmark cell's); each pass's pair counts equal the reference's on the
same model, and the merged vocabulary equals the one the reference's own
passes make. The reference runs its Viterbi in float32 there, the
program's precision: a merge makes exact ties (a + b and b + a score
alike, so " ==" + " " and " " + "== " spell " == " at one score), which
each precision breaks by its own rounding. The first pass, whose scores
tie nowhere, equals the float64 reference's too. Also the merge's spans
and counters.

Marked `cuda`: `viterbi_scan` (its LMAX 32 instantiation), `match_probe`
and `viterbi_walk` at 20 lengths against their plain twins on a GPU:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_merge_recipe.py -q -m cuda
"""

import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tokengeex_tpu_torch import Model, ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train import merge as mg
from tokengeex_tpu_torch.train.patterns import (build_allow_regex,
                                                load_patterns)
from tokengeex_tpu_torch.utils import trace
from tokengeex_tpu_torch.utils.packing import pack_samples

from test_torch_cuda import _scan_inputs, cuda_device  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gpubench.reference import merge as rm  # noqa: E402

FINE = ["any-char", "space-lowercase-word", "space-uppercase-word",
        "space-capitalized-word", "english-contraction", "chinese-word",
        "indent", "space-operator-space", "space-punct-space"]
L = 20
STEP, MERGES = 10, 30
WORDS = ["value", "return", "data", "self", "index", "count", "Total",
         "ITEMS", "def", "for", "in", "range", "it's", "print", "none",
         "initialization", "representation", "internationalization"]
SEPS = [" ", " = ", "(", ") ", ", ", ".", " += ", "\n    ", "[0]", " == "]


def _recipe_corpus(seed=11, n=80):
    """Seeded code-like samples of 20-200 bytes and a vocabulary of their
    bytes (kept) and ~300 of their substrings of 2-12 bytes, scores drawn
    apart so that no two paths tie."""
    rng = random.Random(seed)
    samples = []
    for _ in range(n):
        parts = []
        while sum(map(len, parts)) < rng.randint(20, 200):
            parts.append(rng.choice(WORDS))
            parts.append(rng.choice(SEPS))
        samples.append("".join(parts).encode())
    vocab = [ScoredToken(bytes([b]), rng.uniform(-12.0, -10.0), True)
             for b in sorted(set(b"".join(samples)))]
    seen = {t.value for t in vocab}
    while len(vocab) < 300:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, 12)]
        if len(w) > 1 and w not in seen:
            seen.add(w)
            vocab.append(ScoredToken(w, rng.uniform(-9.5, -5.0)))
    return vocab, samples


def _reference_merge(vocab, samples, dtype):
    """The reference's own passes: pair counts of its Viterbi in `dtype`,
    upstream's selection."""
    cur = [(t.value, t.score) for t in vocab]
    allow = rm.allow_fn(FINE)
    refused, passes = set(), []
    while len(cur) < len(vocab) + MERGES:
        r = rm.pair_counts([cur], samples, "cpu", dtype)[0]
        passes.append((len(cur), r))
        new = rm.select(cur, r["keys"], r["counts"],
                        min(STEP, len(vocab) + MERGES - len(cur)), L, 0.9,
                        allow, refused)
        if not new:
            break
        cur = cur + new
    return cur, passes


@pytest.fixture(scope="module")
def recipe():
    vocab, samples = _recipe_corpus()
    want, ref_passes = _reference_merge(vocab, samples, torch.float32)
    assert len(ref_passes) >= 3 and len(want) == len(vocab) + MERGES
    assert max(len(v) for v, _ in want) > 12  # merges past the vocabulary's
    first = rm.pair_counts([[(t.value, t.score) for t in vocab]], samples,
                           "cpu")[0]
    return vocab, samples, want, ref_passes, first


@pytest.mark.parametrize("bits", [None, 16], ids=["fused", "slab-bits16"])
def test_device_merge_equals_reference(recipe, bits, monkeypatch):
    """Each pass's pair counts equal the reference's on the same model,
    and the merged vocabulary (bytes, scores, keep) equals the
    reference's."""
    vocab, samples, want, ref_passes, first = recipe
    if bits:
        monkeypatch.setattr(mg, "merge_table_hints",
                            lambda v, n, l: (bits, l))
    count, passes = ed.count_pairs_arrays, []

    def recorded(model, *args, **kwargs):
        keys, counts = count(model, *args, **kwargs)
        passes.append((model.vocab_size(), keys, counts))
        return keys, counts

    monkeypatch.setattr(ed, "count_pairs_arrays", recorded)
    merger = mg.VocabularyMerger(build_allow_regex(load_patterns(FINE)),
                                 num_merges=MERGES, step=STEP,
                                 scale_factor=0.9, max_token_length=L,
                                 backend="device", device="cpu")
    with trace.recording() as rec:
        got = merger.merge(Model(vocab), samples)
    assert [(t.value, t.score) for t in got.vocab] == want
    assert all(not t.keep for t in got.vocab[len(vocab):])
    assert len(passes) == len(ref_passes)
    for (n, keys, counts), (n_ref, r) in zip(passes, ref_passes):
        assert n == n_ref
        np.testing.assert_array_equal(np.sort(keys), r["keys"])
        order = np.argsort(keys)
        np.testing.assert_array_equal(counts[order], r["counts"])
    np.testing.assert_array_equal(ref_passes[0][1]["keys"], first["keys"])
    np.testing.assert_array_equal(ref_passes[0][1]["counts"],
                                  first["counts"])
    # The spans and counters the benchmark's *.merge readers read.
    assert rec.calls("merge") == 1
    assert rec.calls("merge.count") == len(passes)
    assert rec.calls("merge.select") == len(passes)
    assert rec.calls("merge.count.tables") == len(passes)
    assert rec.counter("merge.merged", "merge.select") == MERGES
    assert rec.counter("merge.refused", "merge.select") > 0
    assert rec.counter("pairs.distinct", "merge.count") == \
        sum(len(k) for _, k, _ in passes)
    assert rec.counter("probe.redone") is None
    assert rec.seconds("merge.count") + rec.seconds("merge.select") <= \
        rec.seconds("merge")


def test_reference_lookup_finds_tokens_past_16_bytes():
    """The reference's lookup holds tokens of 17-24 bytes, the last of
    equal tokens winning, and none past a sample's end."""
    tokens = [b"a", b"b", b"ab" * 9, b"a" * 24, b"ab" * 9]
    lk = rm.Lookup(tokens, "cpu")
    text = b"ab" * 9 + b"a" * 24
    rows = torch.as_tensor(np.frombuffer(text, np.uint8)[None].copy())
    room = torch.as_tensor(np.arange(len(text), 0, -1)[None])
    ids = lk.match(rows, room)
    assert ids.shape == (1, len(text), 24)
    assert int(ids[0, 0, 17]) == 4 and int(ids[0, 18, 23]) == 3
    assert int(ids[0, 19, 23]) == -1 and int(ids[0, 1, 0]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("chained", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_cuda_viterbi_scan_at_20_lengths(cuda_device, dropout, chained):
    """The LMAX 32 instantiation at 20 lengths equals its twin."""
    args, kw = _scan_inputs(L, dropout, cuda_device, "forward")
    seg = args[3] if chained else None
    want = lc.viterbi_scan_plain(*args[:3], seg, **kw)
    before = lc.viterbi_scan.launches
    got = lc.viterbi_scan(*args[:3], seg, **kw)
    torch.cuda.synchronize()
    assert lc.viterbi_scan.launches == before + 1
    assert bool((want[1] > 16).any())
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


def _l20_case(dev):
    """Tables of the recipe vocabulary at bits 16 with 20 lengths, the
    corpus packed on `dev`."""
    vocab, samples = _recipe_corpus(seed=5, n=400)
    vocab += [ScoredToken(s[:L], -4.0) for s in samples[:40] if len(s) >= L]
    pt = TokenTable.build(vocab, min_bits=16, min_len=L)
    assert pt.max_token_len == L
    batch = lat.prepare_batch(pack_samples(samples, width=1024), L, dev)
    return pt, batch, samples


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bucket", "fast", "exact"])
def test_cuda_match_probe_at_20_lengths(cuda_device, mode):
    """The probe at 20 lengths, bits 16 (the filtered branch in bucket
    mode), scores and slots, equals its twin."""
    pt, batch, _ = _l20_case(cuda_device)
    dt = lat.DeviceTables.from_table(pt, cuda_device)
    want = lat.match_cache_plain(dt, batch, 512, mode)
    got = lat.match_cache(dt, batch, C=512, probe=mode)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(torch.isfinite(want[0][:, L - 1]).any())


@pytest.mark.cuda
def test_cuda_viterbi_walk_at_20_lengths(cuda_device):
    """The walk over 20-length backpointers, ids and counts, equals its
    twin, and encode's ids equal the CPU route's."""
    pt, batch, samples = _l20_case(cuda_device)
    dt = lat.DeviceTables.from_table(pt, cuda_device)
    dp, best_l = lat.viterbi(dt, batch, C=512, backend="slab")
    assert int(best_l.max()) > 16
    packed = pack_samples(samples, width=1024)
    index = lat.walk_index(packed.spans, *best_l.shape, cuda_device)
    ok = torch.isfinite(index.dp_ends(dp)) & index.nonempty
    args, kw = lat._walk_tables(dt, batch)
    for ids in (True, False):
        want = lat.viterbi_walk_plain(best_l, *args, index, ok=ok, ids=ids,
                                      **kw)
        got = lat.viterbi_walk(best_l, *args, index, ok=ok, ids=ids, **kw)
        torch.cuda.synchronize()
        if ids:
            n = int(want[1].sum())
            assert torch.equal(got[0][:n], want[0][:n])
            assert torch.equal(got[1], want[1])
        else:
            assert torch.equal(got, want)
    model = Model([ScoredToken(v, float(s)) for v, s in
                   zip(pt.token_bytes, pt.scores_f64)])
    assert ed.encode_corpus_device(model, samples, table_hints=(16, L),
                                   device=cuda_device) == \
        ed.encode_corpus_device(model, samples, table_hints=(16, L),
                                device="cpu")
