"""A probe's false match, planted, and the exact redo of the samples it
hits.

The bucket probe matches a span on its row's 32-bit check word (fp2)
alone, the fast probe on one 32-bit check word a cuckoo slot, so a span
that is no token can score as an entry. The walk resolves ids with the
exact tables and finds no token there (id V). Encode
(`estep_device.encode_corpus_device`), merge's pair count
(`count_pairs_arrays`) and the session's frequency pass
(`DeviceTrainSession.count_frequencies`) redo the samples whose paths
took such a span with the exact probe, so their ids, pair counts and
frequencies equal the exact route's.

Each test plants an entry for a span of the corpus that is no token, at
a high score, into the bucket rows (table bits 16: the slab route) or
the fast rows (the default small table: the fused route), leaving the
exact rows alone. Before the fallback every one of them raised. The
`cuda` cases run the same on a GPU (the kernels have no CPU mode):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_false_match.py -q -m cuda
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from tokengeex_tpu_torch import Model, ScoredToken
from tokengeex_tpu_torch.ops import hashing as H
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
from tokengeex_tpu_torch.ops.match_table import _NEG_SCORE_BITS
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
from tokengeex_tpu_torch.utils import trace

WORDS = ["an", "er", "ti", "on", "ra", "lo", "de", "mi", "value", "def",
         "return", "data", "self", "print"]
L = 12
# The planted span: in the corpus (in every fifth sample), no token.
FALSE = b"value return"
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
ROUTES = ["bucket", "fast"]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device(request.param)


def _corpus(seed=3, n=60, long_words=0):
    """Samples of WORDS, every fifth holding FALSE, and a vocabulary of
    its bytes and ~120 substrings of 2-L bytes (FALSE not among them);
    with long_words, two more samples of that many words."""
    rng = random.Random(seed)
    samples = []
    for i in range(n + (2 if long_words else 0)):
        k = long_words if i >= n else rng.randint(2, 30)
        words = [rng.choice(WORDS) for _ in range(k)]
        if i % 5 == 0:
            words.insert(rng.randint(0, len(words)), FALSE.decode())
        samples.append(" ".join(words).encode())
    vocab = [ScoredToken(bytes([b]), rng.uniform(-11.0, -9.0))
             for b in sorted(set(b"".join(samples)))]
    seen = {t.value for t in vocab} | {FALSE}
    while len(vocab) < 120:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, L)]
        if w not in seen and len(w) > 1:
            seen.add(w)
            vocab.append(ScoredToken(w, rng.uniform(-9.0, -4.0)))
    return Model(vocab), samples


def plant(dt: lat.DeviceTables, route: str, text: bytes = FALSE,
          score: float = -0.5) -> lat.DeviceTables:
    """`dt` with an entry for `text` (no token) in a free slot of its
    bucket row ("bucket") or of its fast T1 or T2 slot ("fast"), scored
    `score`; the exact rows unchanged."""
    fp1, fp2 = H.host_fingerprints(text)
    n = np.array([len(text)], np.uint32)
    word = int(np.array([score], np.float32).view(np.int32)[0])
    if route == "bucket":
        tb = dt.t_bucket.clone()
        row = int(H.host_bucket_index(np.array([fp1]), n, dt.bk_salt,
                                      dt.bk_bits)[0])
        free = [k for k in range(8)
                if int(tb[row, 2 * k + 1]) == _NEG_SCORE_BITS]
        tb[row, 2 * free[0]] = int(np.array([fp2]).astype(np.uint32)
                                   .view(np.int32)[0])
        tb[row, 2 * free[0] + 1] = word
        return dataclasses.replace(
            dt, t_bucket=tb,
            bk_filter=(lcp.BucketFilter.of(tb) if lcp.has_filter(dt.bk_bits)
                       else None))
    check = int(np.array(H.host_check(fp1, fp2), np.uint32)
                .view(np.int32))
    tables = {"t1_fast": (fp1, H.IDX_A1, H.IDX_M1),
              "t2_fast": (fp2, H.IDX_A2, H.IDX_M2)}
    for name, (fp, a, m) in tables.items():
        t = getattr(dt, name)
        slot = int(H.host_table_index(np.array([fp], np.uint32), n, a, m,
                                      dt.bits)[0])
        if int(t[slot, 1]) == _NEG_SCORE_BITS:
            t = t.clone()
            t[slot, 0], t[slot, 1] = check, word
            return dataclasses.replace(dt, **{name: t})
    raise AssertionError("both fast slots of the planted span are taken")


@pytest.fixture
def planted(monkeypatch):
    """Plants into every table a pass builds for itself (`_tables_on`
    without a table), as `planted(route)`; returns the record of the
    spans and counters."""
    real = ed._tables_on

    def arm(route):
        def tables_on(model, table, dev, dtype, hints=None):
            dt = real(model, table, dev, dtype, hints)
            return dt if table is not None else plant(dt, route)

        monkeypatch.setattr(ed, "_tables_on", tables_on)

    return arm


def _hints(route):
    """Table bits 16 take the slab route and its bucket probe; the small
    default table takes the fused route and its fast probe."""
    return (16, L) if route == "bucket" else None


def _redone(rec, samples) -> None:
    """Some samples were redone, each one holding the planted span."""
    assert rec.counter("probe.redone_bytes") > 0
    assert 0 < rec.counter("probe.redone") <= sum(FALSE in s
                                                 for s in samples)


def _pairs(encoded):
    keys = ed._chained_pair_keys(encoded)
    uniq, counts = np.unique(keys, return_counts=True)
    return dict(zip(uniq.tolist(), counts.tolist()))


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("route", ROUTES)
def test_encode_redoes_false_matches_exactly(device, route, planted):
    """Encode's ids with a planted false match, short and chained
    samples alike, equal the exact route's."""
    model, samples = _corpus(long_words=200)
    hints = _hints(route)
    want = ed.encode_corpus_device(model, samples, table_hints=hints,
                                   probe="exact", max_width=512,
                                   device=device)
    planted(route)
    with trace.recording() as rec:
        got = ed.encode_corpus_device(model, samples, table_hints=hints,
                                      max_width=512, device=device)
    assert got == want
    _redone(rec, samples)
    assert rec.calls("redo") == 1


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("route", ROUTES)
def test_pair_count_redoes_false_matches_exactly(device, route, planted):
    """Merge's pair count with a planted false match equals the pairs of
    the exact route's ids: the hit samples' pairs are left out of their
    group's insert and inserted from the exact redo; the samples past the
    pack width take the chained encode and are redone alike."""
    model, samples = _corpus(long_words=200)
    hints = _hints(route)
    want = _pairs(ed.encode_corpus_device(model, samples, table_hints=hints,
                                          probe="exact", device=device))
    planted(route)
    corpus = ed.DeviceCorpus(samples, max_width=512, device=device)
    with trace.recording() as rec:
        keys, counts = ed.count_pairs_arrays(model, samples,
                                             table_hints=hints,
                                             corpus=corpus)
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    _redone(rec, samples)
    assert rec.calls("count.redo") == 2  # the short, then the chained
    assert rec.calls("count.chained") == 1
    assert rec.counter("pairs.distinct") == len(want)
    order = np.lexsort((keys, -counts))
    assert (order == np.arange(keys.size)).all()


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("route", ROUTES)
def test_frequency_pass_redoes_false_matches_exactly(device, route,
                                                     monkeypatch):
    """The session's frequency pass with a planted false match in its
    bound tables counts what the exact route counts."""
    model, samples = _corpus()
    ids = ed.encode_corpus_device(model, samples, probe="exact",
                                  device=device)
    want = np.bincount(np.concatenate([np.asarray(r) for r in ids]),
                       minlength=model.vocab_size())
    if route == "bucket":
        # The slab route on this small table: the has_vscan threshold
        # lowered.
        monkeypatch.setattr(lat, "VSCAN_MAX_BITS", -1)
    sess = DeviceTrainSession(model, samples, max_snippet=None,
                              device=device)
    assert sess._fused() == (route == "fast")
    sess.dt = plant(sess.dt, route)
    with trace.recording() as rec:
        got = sess.count_frequencies(model)
    np.testing.assert_array_equal(got, want)
    _redone(rec, samples)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_exact_route_still_raises_on_a_table_mismatch(device, monkeypatch):
    """Walk tables with no rows resolve every token to V, on the exact
    route too: a model/table mismatch, which the redo does not hide."""
    model, samples = _corpus(n=10)
    tables = lat._walk_tables

    def emptied(tbl, batch):
        args, kw = tables(tbl, batch)
        return args[:4] + (torch.zeros_like(args[4]),
                           torch.zeros_like(args[5])), kw

    monkeypatch.setattr(lat, "_walk_tables", emptied)
    with pytest.raises(KeyError, match="not a vocabulary token"):
        ed.encode_corpus_device(model, samples, device=device)
    with pytest.raises(KeyError, match="not a vocabulary token"):
        ed.count_pairs_arrays(model, samples, device=device)
    sess = DeviceTrainSession(model, samples, max_snippet=None,
                              device=device)
    with pytest.raises(RuntimeError, match="not vocabulary tokens"):
        sess.count_frequencies(model)
