"""Merge's pair count on the device route against the JAX package's.

`count_pairs_device` / `count_pairs_arrays` keep each row group's walked
ids on the device (`lattice.walk_ids_device`) and count their adjacent
pairs in a hash table (ops/pair_count.py `PairTable`, csrc/pair_count.cu;
on the CPU the kernels' plain twin, `pair_count_plain`). Held here on the
CPU:

  - the pair list against the JAX package's `count_pairs_device`, list
    for list in order (descending count, ties by key), on a code-like
    corpus and on one with many tied counts, and against its native
    `count_pairs` as a dict where that runtime builds;
  - samples past the pack cap (chained windows, their pairs inserted as
    rows) against the route through per-sample lists;
  - empty and one-token samples, NoPath (the JAX package's length) and a
    model/table mismatch (KeyError);
  - the route never splits ids into lists (`_place_ids`, `walk_ids`);
  - `pair_count_plain` against a Counter, and the CPU table's weighted
    rows.

The tests marked `cuda` hold the kernel against its twin on a GPU (the
kernels have no CPU mode); the file imports the JAX package only inside
the tests that compare with it, so on a machine without JAX

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_pairs.py -q -m cuda

runs them.
"""

import importlib
import random
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import pair_count as pc
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train.merge import VocabularyMerger

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture
def jax_pkg(monkeypatch):
    """The JAX package's modules, its encode on one device (tests/
    conftest.py gives eight)."""
    jax = importlib.import_module("jax")
    dev0 = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: dev0)
    return SimpleNamespace(
        tg=importlib.import_module("tokengeex_tpu"),
        ed=importlib.import_module("tokengeex_tpu.train.estep_device"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _corpus(kind: str):
    """(vocab, samples): `code`, code-like samples over a small alphabet
    (tests/test_torch_merge.py's); `ties`, short strings of 16 letters, so
    most counts are shared by many pairs."""
    rng = random.Random(41 if kind == "code" else 5)
    if kind == "code":
        words = [b"def", b"ab", b"cab", b"fed", b"bead", b"(a)", b"()", b"ca"]
        samples = [b" ".join(rng.choice(words)
                             for _ in range(rng.randint(1, 40)))
                   + rng.choice([b"", b"(", b" )"]) for _ in range(60)]
        extra = [b" d", b"ef", b"ab"]
    else:
        letters = b"abcdefghijklmnop"
        samples = [bytes(rng.choice(letters)
                         for _ in range(rng.randint(2, 9)))
                   for _ in range(80)]
        extra = [b"ab", b"cd"]
    alphabet = sorted(set(b"".join(samples)))
    vocab = [(bytes([b]), rng.uniform(-7.0, -5.0)) for b in alphabet]
    vocab += [(w, rng.uniform(-6.0, -3.0)) for w in extra]
    return vocab, samples


def _model(vocab):
    return tg.Model([tg.ScoredToken(v, s) for v, s in vocab])


def _jmodel(jax_pkg, vocab):
    return jax_pkg.tg.Model([jax_pkg.tg.ScoredToken(v, s) for v, s in vocab])


def _via_lists(encoded):
    """The pair count through per-sample lists: np.unique over the keys of
    every sample's adjacent ids, by descending count (stable)."""
    keys = ed._chained_pair_keys(encoded)
    uniq, cnt = np.unique(keys, return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    return [((int(k) >> 32, int(k) & 0xFFFFFFFF), int(c))
            for k, c in zip(uniq[order], cnt[order])]


def _as_list(keys, counts):
    return [((int(k) >> 32, int(k) & 0xFFFFFFFF), int(c))
            for k, c in zip(keys, counts)]


@pytest.mark.parametrize("kind", ["code", "ties"])
@pytest.mark.parametrize("hints", [None, (16, 24)])
def test_count_pairs_match_jax(jax_pkg, kind, hints):
    vocab, samples = _corpus(kind)
    want = jax_pkg.ed.count_pairs_device(_jmodel(jax_pkg, vocab), samples,
                                         table_hints=hints)
    got = ed.count_pairs_device(_model(vocab), samples, table_hints=hints,
                                device="cpu")
    assert got == want  # in order: descending counts, ties by key
    counts = [c for _, c in got]
    if kind == "ties":
        assert len(got) > 100 and len(set(counts)) < len(counts) // 10
    else:
        assert len(got) > 20 and counts[0] > 100
    keys, cnt = ed.count_pairs_arrays(_model(vocab), samples,
                                      table_hints=hints, device="cpu")
    assert keys.dtype == cnt.dtype == np.int64
    assert _as_list(keys, cnt) == want


def test_count_pairs_match_native(jax_pkg):
    vocab, samples = _corpus("code")
    native = _jmodel(jax_pkg, vocab).native()
    if native is None:
        pytest.skip("the JAX package's native runtime is not built here")
    want = {(a, b): n for a, b, n in native.count_pairs(samples)}
    got = ed.count_pairs_device(_model(vocab), samples, device="cpu")
    assert dict(got) == want


def test_chained_samples_counted():
    """Samples over the pack cap (a 512-byte cap) encode through chained
    windows; their pairs go into the table as rows and the result equals
    the count through per-sample lists."""
    vocab, samples = _corpus("code")
    rng = random.Random(3)
    longs = [b" ".join(rng.choice(samples) for _ in range(30))
             for _ in range(2)]
    assert all(len(s) > 600 for s in longs)
    mixed = samples[:20] + [longs[0], b""] + samples[20:30] + [longs[1]]
    m = _model(vocab)
    corpus = ed.DeviceCorpus(mixed, max_width=512, device="cpu")
    assert corpus.long_idx == [20, 32]
    want = _via_lists(ed.encode_corpus_device(m, mixed, max_width=512,
                                              device="cpu"))
    got = ed.count_pairs_device(m, mixed, corpus=corpus)
    assert got == want
    # The long samples' pairs are in it.
    short = dict(ed.count_pairs_device(m, samples[:30], device="cpu"))
    assert sum(c for _, c in got) > sum(short.values()) + 400


def test_empty_and_one_token_samples(jax_pkg):
    vocab, samples = _corpus("code")
    mixed = [b"", samples[0], b"a", b"", b"(", samples[1], b"d"]
    want = jax_pkg.ed.count_pairs_device(_jmodel(jax_pkg, vocab), mixed)
    assert ed.count_pairs_device(_model(vocab), mixed, device="cpu") == want
    for only in ([b"a", b"", b"("], [b""], []):
        keys, counts = ed.count_pairs_arrays(_model(vocab), only,
                                             device="cpu")
        assert keys.shape == counts.shape == (0,)
        assert ed.count_pairs_device(_model(vocab), only, device="cpu") == []


@pytest.mark.parametrize("where", ["first", "last"])
def test_no_path_raises_like_jax(jax_pkg, where):
    vocab, samples = _corpus("code")
    bad = b"ab" * 7 + b"\x01" + b"cab"  # byte 1 is not in the vocabulary
    mixed = ([bad] + samples[:20] if where == "first"
             else samples[:20] + [bad, b"ab\x01"])
    with pytest.raises(jax_pkg.tg.NoPathError) as want:
        jax_pkg.ed.count_pairs_device(_jmodel(jax_pkg, vocab), mixed)
    with pytest.raises(tg.NoPathError) as got:
        ed.count_pairs_device(_model(vocab), mixed, device="cpu")
    assert (got.value.pos, got.value.length) == \
        (want.value.pos, want.value.length)
    assert want.value.length in (len(bad), 3)


def test_table_mismatch_raises_key_error(monkeypatch):
    """Exact tables with no rows: every walked token resolves to V, the
    walk's mismatch value."""
    vocab, samples = _corpus("code")
    tables = lat._walk_tables

    def emptied(tbl, batch):
        args, kw = tables(tbl, batch)
        return args[:4] + (torch.zeros_like(args[4]),
                           torch.zeros_like(args[5])), kw

    monkeypatch.setattr(lat, "_walk_tables", emptied)
    with pytest.raises(KeyError, match="mismatch"):
        ed.count_pairs_device(_model(vocab), samples, device="cpu")


def test_pair_route_builds_no_lists(monkeypatch):
    """The route splits no ids into per-sample lists: `_place_ids` and
    `walk_ids` raise here, and the merger's device backend still merges."""
    vocab, samples = _corpus("code")
    m = _model(vocab)
    want = ed.count_pairs_device(m, samples, device="cpu")
    merged = VocabularyMerger(allow=".*", num_merges=4, step=2,
                              device="cpu").merge(_model(vocab), samples)

    def refuse(*a, **k):
        raise AssertionError("the pair route split ids into lists")

    monkeypatch.setattr(ed, "_place_ids", refuse)
    monkeypatch.setattr(lat, "walk_ids", refuse)
    assert ed.count_pairs_device(m, samples, device="cpu") == want
    got = VocabularyMerger(allow=".*", num_merges=4, step=2,
                           device="cpu").merge(_model(vocab), samples)
    assert [(t.value, t.score) for t in got.vocab] == \
        [(t.value, t.score) for t in merged.vocab]
    with pytest.raises(AssertionError, match="lists"):
        ed.encode_corpus_device(m, samples, device="cpu")


def _spans(seed: int, n: int, top: int):
    """Seeded flat ids and inclusive offsets: n spans of 0-40 tokens (empty
    and one-token spans among them), ids below `top` drawn from a few
    values (heavy duplicates) and from the four below `top`, a tail of
    junk after the last span."""
    rng = np.random.default_rng(seed)
    ntok = rng.integers(0, 41, n)
    ntok[:: 7] = 1
    ntok[3:: 11] = 0
    total = int(ntok.sum())
    common = rng.integers(0, 6, total)
    rare = top - rng.integers(1, 5, total)
    ids = np.where(rng.random(total) < 0.8, common, rare)
    flat = np.concatenate([ids, rng.integers(0, top, 9)]).astype(np.int32)
    return (torch.from_numpy(flat),
            torch.from_numpy(np.cumsum(ntok).astype(np.int32)), ntok)


def _counter(flat, ntok):
    want, at = Counter(), 0
    for k in ntok.tolist():
        ids = flat[at : at + k].tolist()
        want.update(((a << 32) | b for a, b in zip(ids, ids[1:])))
        at += k
    return want


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_count_plain_matches_counter(seed):
    top = 2**31
    flat, incl, ntok = _spans(seed, 300, top)
    keys, counts, bad = pc.pair_count_plain(flat, incl, top)
    want = _counter(flat, ntok)
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    assert torch.equal(keys, torch.sort(keys)[0]) and not bool(bad)
    assert max(counts.tolist()) > 50 and (keys >> 32).max() == top - 1
    # An id at or over V is flagged.
    assert bool(pc.pair_count_plain(flat, incl, top - 1)[2])


def test_cpu_table_sums_rows():
    flat, incl, ntok = _spans(2, 100, 1000)
    table = pc.PairTable("cpu")
    half = 50
    table.insert_ids(flat, incl[:half], 1000)
    rest = flat[int(incl[half - 1]):].contiguous()
    table.insert_ids(rest, incl[half:] - incl[half - 1], 1000)
    extra = torch.tensor([pc.EMPTY, 7, 7, (3 << 32) | 4], dtype=torch.int64)
    table.insert_weighted(extra, torch.tensor([9, 1, 2, 5]))
    keys, counts = table.compact()
    want = _counter(flat, ntok)
    want.update({7: 3, (3 << 32) | 4: 5})
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    assert table.read()[1:] == [0, 0]  # no overflow, no mismatch
    with pytest.raises(ValueError, match="int32"):
        table.insert_ids(flat.long(), incl, 1000)


def _pair_count(flat, incl, vocab_size):
    """One group's count through a PairTable on the card, as
    `pair_count_plain` gives it: (keys ascending, counts, mismatch)."""
    table = pc.PairTable(flat.device)
    table.reserve(flat.numel())
    table.insert_ids(flat, incl, vocab_size)
    keys, counts = table.compact()
    keys, order = torch.sort(keys)
    return keys, counts[order], table.state[2] != 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_plain(cuda_device, seed):
    top = 2**31
    flat, incl, _ = _spans(seed, 2000, top)
    before = pc.PairTable.launches
    got = _pair_count(flat.to(cuda_device), incl.to(cuda_device), top)
    torch.cuda.synchronize()
    assert pc.PairTable.launches == before + 2  # the insert, the compaction
    want = pc.pair_count_plain(flat, incl, top)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(_pair_count(flat.to(cuda_device), incl.to(cuda_device),
                            top - 1)[2])


@pytest.mark.cuda
def test_table_grows_by_rehash(cuda_device, monkeypatch):
    flat, incl, ntok = _spans(4, 600, 5000)
    monkeypatch.setattr(pc, "MIN_SLOTS", 16)
    table = pc.PairTable(cuda_device)
    cuts = [0, 100, 300, 600]
    for a, b in zip(cuts, cuts[1:]):
        lo = int(incl[a - 1]) if a else 0
        part = flat[lo : int(incl[b - 1])].contiguous().to(cuda_device)
        off = (incl[a:b] - lo).contiguous().to(cuda_device)
        distinct = table.read()[0]
        table.reserve(int(ntok[a:b].sum()), distinct)
        table.insert_ids(part, off, 5000)
    assert table.slots > 1024
    keys, counts = table.compact()
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == _counter(flat, ntok) and table.read()[0] == len(got)


@pytest.mark.cuda
def test_weighted_entry(cuda_device):
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 400, 5000) << 32 | rng.integers(0, 7, 5000)
    keys[::13] = pc.EMPTY
    counts = rng.integers(1, 1000, 5000)
    k, c = (torch.from_numpy(a.astype(np.int64)) for a in (keys, counts))
    cpu = pc.PairTable("cpu")
    cpu.insert_weighted(k, c)
    table = pc.PairTable(cuda_device)
    table.reserve(k.numel())
    table.insert_weighted(k.to(cuda_device), c.to(cuda_device))
    got, want = table.compact(), cpu.compact()
    order = torch.argsort(got[0])
    assert torch.equal(got[0][order].cpu(), want[0])
    assert torch.equal(got[1][order].cpu(), want[1])


@pytest.mark.cuda
def test_overflow_raises(cuda_device, monkeypatch):
    flat, incl, _ = _spans(7, 200, 5000)
    monkeypatch.setattr(pc, "MIN_SLOTS", 16)
    table = pc.PairTable(cuda_device)  # not reserved
    table.insert_ids(flat.to(cuda_device), incl.to(cuda_device), 5000)
    assert table.read()[1] == 1
    with pytest.raises(RuntimeError, match="overflow"):
        table.compact()


@pytest.mark.cuda
def test_count_pairs_on_card_match_cpu(cuda_device):
    vocab, samples = _corpus("code")
    before = pc.PairTable.launches
    got = ed.count_pairs_device(_model(vocab), samples, device=cuda_device)
    assert pc.PairTable.launches > before
    assert got == ed.count_pairs_device(_model(vocab), samples, device="cpu")
