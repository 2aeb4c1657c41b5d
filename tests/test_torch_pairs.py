"""Merge's pair count on the device route against the JAX package's.

`count_pairs_arrays` keeps each row group's walked ids on the device
(`lattice.walk_ids_device`) and counts their adjacent pairs in a hash
table (ops/pair_count.py `PairTable`, csrc/pair_count.cu; on the CPU the
kernels' plain twin, `pair_count_plain`). Held here on the CPU:

  - the pair list (the arrays in order, as the merger reads them:
    `pair_list`) against the JAX package's `count_pairs_device`, list for
    list in order (descending count, ties by key), on a code-like
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
from tokengeex_tpu_torch.train.merge import VocabularyMerger, _pairs_in_order

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
    most counts are shared by many pairs; `zipf`, Zipf-weighted code words
    (rank r drawn with weight r^-1.3), so a few pairs (runs of indent
    spaces, ");" and newlines) take most of the counts, as in a code
    corpus."""
    rng = random.Random({"code": 41, "ties": 5, "zipf": 13}[kind])
    if kind == "zipf":
        words = [b"    ", b");", b"\n", b"x", b"(", b"ab", b"def", b"ca",
                 b"fed", b"bead", b" = ", b"cab"]
        weights = [(r + 1) ** -1.3 for r in range(len(words))]
        samples = [b"".join(rng.choices(words, weights,
                                        k=rng.randint(5, 60)))
                   for _ in range(60)]
        extra = [b"  ", b");", b"ab"]
    elif kind == "code":
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


def pair_list(*args, **kwargs):
    """`count_pairs_arrays` as the merger reads it: ((a, b), count) by
    descending count, equal counts in ascending key order."""
    return list(_pairs_in_order(*ed.count_pairs_arrays(*args, **kwargs)))


def _as_list(keys, counts):
    return [((int(k) >> 32, int(k) & 0xFFFFFFFF), int(c))
            for k, c in zip(keys, counts)]


@pytest.mark.parametrize("kind", ["code", "ties", "zipf"])
@pytest.mark.parametrize("hints", [None, (16, 24)])
def test_count_pairs_match_jax(jax_pkg, kind, hints):
    vocab, samples = _corpus(kind)
    want = jax_pkg.ed.count_pairs_device(_jmodel(jax_pkg, vocab), samples,
                                         table_hints=hints)
    got = pair_list(_model(vocab), samples, table_hints=hints,
                                device="cpu")
    assert got == want  # in order: descending counts, ties by key
    counts = [c for _, c in got]
    if kind == "ties":
        assert len(got) > 100 and len(set(counts)) < len(counts) // 10
    elif kind == "zipf":
        assert len(got) > 20 and counts[0] > sum(counts) // 5
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
    got = pair_list(_model(vocab), samples, device="cpu")
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
    got = pair_list(m, mixed, corpus=corpus)
    assert got == want
    # The long samples' pairs are in it.
    short = dict(pair_list(m, samples[:30], device="cpu"))
    assert sum(c for _, c in got) > sum(short.values()) + 400


def test_empty_and_one_token_samples(jax_pkg):
    vocab, samples = _corpus("code")
    mixed = [b"", samples[0], b"a", b"", b"(", samples[1], b"d"]
    want = jax_pkg.ed.count_pairs_device(_jmodel(jax_pkg, vocab), mixed)
    assert pair_list(_model(vocab), mixed, device="cpu") == want
    for only in ([b"a", b"", b"("], [b""], []):
        keys, counts = ed.count_pairs_arrays(_model(vocab), only,
                                             device="cpu")
        assert keys.shape == counts.shape == (0,)
        assert pair_list(_model(vocab), only, device="cpu") == []


@pytest.mark.parametrize("where", ["first", "last"])
def test_no_path_raises_like_jax(jax_pkg, where):
    vocab, samples = _corpus("code")
    bad = b"ab" * 7 + b"\x01" + b"cab"  # byte 1 is not in the vocabulary
    mixed = ([bad] + samples[:20] if where == "first"
             else samples[:20] + [bad, b"ab\x01"])
    with pytest.raises(jax_pkg.tg.NoPathError) as want:
        jax_pkg.ed.count_pairs_device(_jmodel(jax_pkg, vocab), mixed)
    with pytest.raises(tg.NoPathError) as got:
        pair_list(_model(vocab), mixed, device="cpu")
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
        pair_list(_model(vocab), samples, device="cpu")


def test_pair_route_builds_no_lists(monkeypatch):
    """The route splits no ids into per-sample lists: `_place_ids` and
    `walk_ids` raise here, and the merger's device backend still merges."""
    vocab, samples = _corpus("code")
    m = _model(vocab)
    want = pair_list(m, samples, device="cpu")
    merged = VocabularyMerger(allow=".*", num_merges=4, step=2,
                              device="cpu").merge(_model(vocab), samples)

    def refuse(*a, **k):
        raise AssertionError("the pair route split ids into lists")

    monkeypatch.setattr(ed, "_place_ids", refuse)
    monkeypatch.setattr(lat, "walk_ids", refuse)
    assert pair_list(m, samples, device="cpu") == want
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
    assert table.read()[1:3] == [0, 0]  # no overflow, no mismatch
    with pytest.raises(ValueError, match="int32"):
        table.insert_ids(flat.long(), incl, 1000)


@pytest.mark.parametrize("held,hint,spilled", [
    (0, 0, 0), (0, 1, 0), (5000, 0, 0), (0, 231_052, 0), (100, 231_052, 7),
    (183_234, 48_000, 0), ((1 << 20) - 1, 1, 0)])
def test_table_slots(held, hint, spilled):
    """The sizing rule: the least power of two at least twice the distinct
    keys held, the hint and the spilled rows, and at least MIN_SLOTS."""
    slots = pc.table_slots(held, hint, spilled)
    bound = held + hint + spilled
    assert slots & (slots - 1) == 0
    assert slots >= max(pc.MIN_SLOTS, 2 * bound)
    assert slots == pc.MIN_SLOTS or slots < 4 * bound
    if (held, spilled) == (0, 0) and hint == 231_052:
        # A merge pass at chip_smoke.py's shape, hinted with the last
        # pass's distinct pairs: 8 MB, not 2^22 slots sized from the pairs.
        assert slots == 1 << 19


def test_pass_hint_carried():
    """count_pairs_arrays leaves the distinct keys it held on the corpus,
    and the next pass sized from that hint counts the same pairs."""
    vocab, samples = _corpus("zipf")
    m = _model(vocab)
    corpus = ed.DeviceCorpus(samples, device="cpu")
    assert corpus.pair_hint is None
    first = ed.count_pairs_arrays(m, samples, corpus=corpus)
    hint = corpus.pair_hint
    assert hint >= first[0].size > 0
    again = ed.count_pairs_arrays(m, samples, corpus=corpus)
    assert corpus.pair_hint == hint
    for a, b in zip(first, again):
        assert np.array_equal(a, b)


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
    """A table grown before each insert (reserve, after a readback, for
    the part's pairs) keeps every count through the rehash."""
    flat, incl, ntok = _spans(4, 600, 5000)
    monkeypatch.setattr(pc, "MIN_SLOTS", 16)
    table = pc.PairTable(cuda_device)
    assert table.slots == 16
    cuts = [0, 100, 300, 600]
    for a, b in zip(cuts, cuts[1:]):
        lo = int(incl[a - 1]) if a else 0
        part = flat[lo : int(incl[b - 1])].contiguous().to(cuda_device)
        off = (incl[a:b] - lo).contiguous().to(cuda_device)
        state = table.read()
        table.reserve(int(ntok[a:b].sum()), state[pc.DISTINCT],
                      state[pc.SPILLED])
        table.insert_ids(part, off, 5000)
    assert table.slots > 1024
    keys, counts = table.compact()
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == _counter(flat, ntok) and table.read()[0] == len(got)
    assert table.read()[pc.SPILLED] == 0


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
    """A table that cannot grow (the sizing rule pinned at 16 slots) takes
    the rows that found no slot into its spill buffer; draining them into
    the full table overflows, and the compaction raises."""
    flat, incl, ntok = _spans(7, 200, 5000)
    assert len(_counter(flat, ntok)) > 16
    monkeypatch.setattr(pc, "table_slots", lambda *a: 16)
    table = pc.PairTable(cuda_device)
    table.insert_ids(flat.to(cuda_device), incl.to(cuda_device), 5000)
    assert table.read()[pc.SPILLED] > 0 and table.read()[pc.OVERFLOW] == 0
    with pytest.raises(RuntimeError, match="overflow"):
        table.compact()
    assert table.slots == 16 and table.read()[pc.OVERFLOW] == 1


def _hot_spans(seed: int, n: int, top: int):
    """Seeded spans of 1-3,000 tokens whose ids are 7 with probability 0.8:
    the key (7, 7) takes about 64 % of the pairs."""
    rng = np.random.default_rng(seed)
    ntok = rng.integers(1, 3001, n)
    total = int(ntok.sum())
    ids = np.where(rng.random(total) < 0.8, 7, rng.integers(0, top, total))
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(np.cumsum(ntok).astype(np.int32)), ntok)


def _random_spans(seed: int, n: int, lo: int, hi: int):
    """Seeded spans of lo..hi tokens of random 31-bit ids: nearly every
    pair its own key."""
    rng = np.random.default_rng(seed)
    ntok = rng.integers(lo, hi, n)
    flat = rng.integers(0, 2**31, int(ntok.sum())).astype(np.int32)
    return (torch.from_numpy(flat),
            torch.from_numpy(np.cumsum(ntok).astype(np.int32)))


def _on_card(table, flat, incl, top, cuda_device):
    """Inserts the spans into `table` and returns (its rows sorted by key,
    the state just after the insert, the plain twin's (keys, counts))."""
    table.insert_ids(flat.to(cuda_device), incl.to(cuda_device), top)
    state = table.read()
    keys, counts = table.compact()
    order = torch.argsort(keys)
    want = pc.pair_count_plain(flat, incl, top)
    return (keys[order].cpu(), counts[order].cpu()), state, want[:2]


@pytest.mark.cuda
def test_hot_key(cuda_device):
    """One key takes over half of the pairs: the block's fold in shared
    memory sends it once a flush, and its count is exact."""
    flat, incl, _ = _hot_spans(8, 600, 5000)
    table = pc.PairTable(cuda_device, flat.numel())
    got, state, want = _on_card(table, flat, incl, 5000, cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    pairs, hot = int(want[1].sum()), int(want[1].max())
    assert hot * 2 > pairs
    # Every other key is sent at most once an occurrence; the hot key once
    # a block's flush, not once a pair.
    assert state[pc.SENT] <= pairs - hot + 4096
    assert state[pc.SPILLED] == 0


@pytest.mark.cuda
def test_shared_table_spill(cuda_device):
    """More distinct keys than a block's shared table holds (random 31-bit
    ids, every pair its own key, ~4 M tokens: over 8,192 a block): the
    block flushes between tiles and sends the pairs that find its table
    full straight to the global table; every key counted once."""
    flat, incl = _random_spans(9, 1000, 2000, 6000)
    table = pc.PairTable(cuda_device, flat.numel())
    got, state, want = _on_card(table, flat, incl, 2**31, cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert state[pc.DISTINCT] == want[0].numel() and state[pc.SPILLED] == 0
    assert state[pc.SENT] >= want[0].numel()


@pytest.mark.cuda
def test_global_spill_regrows(cuda_device):
    """A hint far too small: the table's 4,096 slots fill, the rest of the
    rows spill, and the compaction grows the table, drains them and
    counts each pair once."""
    flat, incl = _random_spans(10, 300, 0, 1500)
    table = pc.PairTable(cuda_device, 1)
    assert table.slots == pc.MIN_SLOTS
    got, state, want = _on_card(table, flat, incl, 2**31, cuda_device)
    assert want[0].numel() > 4 * pc.MIN_SLOTS
    assert state[pc.SPILLED] > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    after = table.read()
    assert after[pc.SPILLED] == 0 and after[pc.DISTINCT] == want[0].numel()
    assert table.slots >= 2 * want[0].numel()


@pytest.mark.cuda
def test_table_reused(cuda_device):
    """One table through two inserts, each followed by a compaction: the
    second compaction holds both inserts' pairs."""
    flat, incl, ntok = _spans(11, 800, 5000)
    half = 400
    lo = int(incl[half - 1])
    parts = [(flat[:lo].contiguous(), incl[:half].contiguous()),
             (flat[lo:].contiguous(), (incl[half:] - lo).contiguous())]
    table = pc.PairTable(cuda_device, flat.numel())
    want = Counter()
    for k, (f, i) in enumerate(parts):
        table.insert_ids(f.to(cuda_device), i.to(cuda_device), 5000)
        want += _counter(f, ntok[: half] if k == 0 else ntok[half:])
        keys, counts = table.compact()
        assert dict(zip(keys.tolist(), counts.tolist())) == want
    assert table.read()[pc.DISTINCT] == len(want)


@pytest.mark.cuda
def test_count_pairs_on_card_match_cpu(cuda_device):
    vocab, samples = _corpus("code")
    before = pc.PairTable.launches
    got = pair_list(_model(vocab), samples, device=cuda_device)
    assert pc.PairTable.launches > before
    assert got == pair_list(_model(vocab), samples, device="cpu")
