"""The chained windows' walk on the device, against the host walk it
replaced.

Samples longer than the encode width are scanned in windows of W bytes
with a carried dp tail (`estep_device._encode_chained`); every window's
backpointers stay on the device and `lattice.chained_walk`
(csrc/viterbi_walk.cu `tgx_chained_walk`; on the CPU its twin
`chained_walk_plain`) walks each sample across its windows and resolves
its ids from the windows' bytes. Held here:

  - the walk alone, on backpointers whose path is known, against that
    path walked over the whole sample at once: W = 32 KiB, samples of 32
    KiB + 1, 2 W, 2 W + 1, 94 KiB and 256 KiB bytes, L = 16 and 20,
    tokens across and ending on the windows' boundaries, a token that is
    no vocabulary token (its sample flagged), a sample not walked;
  - the chained encode against the host backtrack it replaced (kept here
    as the oracle: the encode's own windows' backpointers read back and
    walked token by token in Python), at the same lengths in windows
    of 512 bytes on the CPU (32 KiB on the card), L = 16 and 20, f32 (the
    fused and the slab route) and f64, dropout 0 and 0.05;
  - a planted false match in a chained sample (redone, equal to the exact
    probe's ids), NoPath in the last window, and the counters;
  - one long sample among short ones: the windows kept are the samples'
    own, batches are cut by a window budget, and on the card the long
    sample's peak memory is its own windows'.

The `cuda` cases run the kernel on a GPU:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_chained_walk.py -q -m cuda
"""

import itertools
import random

import numpy as np
import pytest
import torch

from tokengeex_tpu_torch import Model, NoPathError, ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.utils import trace

from test_torch_false_match import (  # noqa: F401
    FALSE, _corpus, _hints, plant, planted)

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

KB = 1 << 10
# Sample lengths at W = 32 KiB, and the same in windows of w bytes.
LENGTHS = {"W+1": lambda w: w + 1, "2W": lambda w: 2 * w,
           "2W+1": lambda w: 2 * w + 1, "94K": lambda w: 94 * w // 32,
           "256K": lambda w: 8 * w}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device(request.param)


# -- the walk alone, on a known path --


def _path_sample(rng, n: int, L: int, W: int, cross: bool, bad_at=None):
    """(bytes, best_l, path) of an n-byte sample over b"ab": its path
    (token ends and lengths, in order) fixed first, from the end: lengths
    1-6, and L on a run of L b"a"s, where every window boundary is crossed
    by an L-byte token (`cross`) or is a token's end; best_l (n + 1,)
    holds the path's lengths at its ends and random ones (at most 6, none
    before the sample's start) elsewhere. bad_at puts a 7-byte b"b"
    token, no vocabulary token, on the path at or below there."""
    data = bytearray(rng.choice(b"ab") for _ in range(n))
    bl = np.array([0] + [rng.randint(1, min(6, p)) for p in range(1, n + 1)],
                  np.int64)
    path, p = [], n
    while p > 0:
        below = (p - 1) // W * W  # the window boundary below p
        if bad_at is not None and 7 <= p <= bad_at:
            l, bad_at = 7, None
            data[p - 7 : p] = b"b" * 7
        elif below and p - below <= 6:
            l = L if cross else p - below
        elif p >= L and rng.random() < 0.02:
            l = L
        else:
            l = rng.randint(1, min(6, p))
        if l == L:
            data[p - L : p] = b"a" * L
        bl[p] = l
        path.append((p, l))
        p -= l
    return bytes(data), bl, path[::-1]


def _walk_inputs(samples, bls, L, W, dev):
    """The walk's inputs for samples (with their (n + 1,) best_l) in
    windows of W, the windows of sample after sample: bl (NW, W), rows
    (NW, L + W), nwin, last_n."""
    lens = np.array([len(s) for s in samples])
    nwin = -(-lens // W)
    bl, rows = [], []
    for r, (s, b) in enumerate(zip(samples, bls)):
        body = np.zeros(nwin[r] * W, np.uint8)
        body[: len(s)] = np.frombuffer(s, np.uint8)
        cells = np.zeros(nwin[r] * W, np.uint8)
        cells[: len(s)] = b[1:]  # cell j of window k: dp index k W + j + 1
        for k in range(nwin[r]):
            bl.append(cells[k * W : (k + 1) * W])
            row = np.zeros(L + W, np.uint8)
            row[L:] = body[k * W : (k + 1) * W]
            if k:
                row[:L] = body[k * W - L : k * W]
            rows.append(row)
    up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (up(np.stack(bl)), up(np.stack(rows)), up(nwin.astype(np.int32)),
            up((lens - (nwin - 1) * W).astype(np.int32)))


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("L", [16, 20])
@pytest.mark.parametrize("length", sorted(LENGTHS))
def test_chained_walk_matches_the_whole_path(device, length, L):
    W = 32 * KB
    n = LENGTHS[length](W)
    rng = random.Random(n + L)
    made = [_path_sample(rng, n, L, W, cross=False),
            _path_sample(rng, rng.randint(W + 1, n + 1), L, W, cross=True),
            _path_sample(rng, W + 7, L, W, cross=False, bad_at=W + 3),
            _path_sample(rng, n, L, W, cross=True)]
    samples = [m[0] for m in made]
    vocab = [ScoredToken(bytes(t), -float(len(t))) for k in range(1, 7)
             for t in itertools.product(b"ab", repeat=k)]
    vocab.append(ScoredToken(b"a" * L, -1.0))
    model = Model(vocab)
    dt = lat.DeviceTables.from_table(TokenTable.build(model.vocab), device)
    V = dt.vocab_size
    bl, rows, nwin, last_n = _walk_inputs(samples, [m[1] for m in made], L,
                                          W, device)
    ok = torch.tensor([True, True, True, False], device=device)
    flat, ntok, bad = lat.chained_walk(
        bl, rows, nwin, last_n, ok, dt.t1_exact, dt.t2_exact, bits=dt.bits,
        vocab_size=V, cap=sum(map(len, samples)))
    # Each sample's windows' token counts, in the flat window list.
    nw = nwin.cpu().numpy()
    ntok = np.split(ntok.cpu().numpy(), np.cumsum(nw)[:-1])
    assert ntok[3].sum() == 0  # not walked
    ids = flat.cpu().numpy().tolist()
    at = 0
    for r, (s, _, path) in enumerate(made[:3]):
        want = [model.token_to_ids.get(s[p - l : p], V) for p, l in path]
        assert ntok[r].sum() == len(path)
        # The tokens ending in each window, the boundary's own included.
        ends = np.array([p for p, _ in path])
        assert ntok[r].tolist() == [
            int(((ends > k * W) & (ends <= (k + 1) * W)).sum())
            for k in range(nw[r])]
        assert ids[at : at + len(path)] == want
        at += len(path)
    assert (V in ids[:at]) and bad.cpu().tolist() == [False, False, True,
                                                      False]
    assert not any(ids[at:])
    # Sample 0's path ends a token on every boundary, sample 1's crosses
    # each with an L-byte token.
    for k in range(1, -(-n // W)):
        assert k * W in dict(made[0][2])
    assert any(p - l < W < p and l == L for p, l in made[1][2])


def test_chained_walk_checks():
    bl = torch.zeros((6, 512), dtype=torch.uint8)
    rows = torch.zeros((6, 16 + 512), dtype=torch.uint8)
    i3 = torch.full((3,), 2, dtype=torch.int32)
    t = torch.zeros((16, 4), dtype=torch.int32)
    ok = torch.ones(3, dtype=torch.bool)
    kw = dict(bits=4, vocab_size=5, cap=10)
    with pytest.raises(ValueError, match="bl must be"):
        lat.chained_walk(bl.int(), rows, i3, i3, ok, t, t, **kw)
    with pytest.raises(ValueError, match="rows must be"):
        lat.chained_walk(bl, rows[:5], i3, i3, ok, t, t, **kw)
    with pytest.raises(ValueError, match="must be int32"):
        lat.chained_walk(bl, rows, i3.long(), i3, ok, t, t, **kw)
    with pytest.raises(ValueError, match="must be \\(R,\\)"):
        lat.chained_walk(bl, rows, i3[:2], i3, ok, t, t, **kw)
    with pytest.raises(ValueError, match="exact tables"):
        lat.chained_walk(bl, rows, i3, i3, ok, t[:8], t[:8], **kw)
    with pytest.raises(ValueError, match="sum to 6 windows"):
        lat.chained_walk(bl, rows, i3 - 1, i3, ok, t, t, **kw)


# -- the chained encode against the host backtrack it replaced --


def _host_backtrack(long_samples, token_to_id, W, windows):
    """The host walk the chained encode had (the oracle): each window's
    backpointers read back (`windows`, the (dp, best_l) of its scans, in
    order), then every sample walked token by token from its end,
    positions <= 0 jumping into the window before. None for a sample
    holding a span that is no token."""
    R = len(long_samples)
    best_l_store = [dict() for _ in range(R)]
    end_info = [(0, 0, 0.0)] * R
    for k, (dp, best_l) in enumerate(windows):
        active = [(r, min(len(s) - k * W, W))
                  for r, s in enumerate(long_samples) if k * W < len(s)]
        best_l_host = best_l.to(torch.int8).cpu().numpy()
        dp_last = dp[[r for r, _ in active],
                     [n - 1 for _, n in active]].cpu().numpy()
        for i, (r, n) in enumerate(active):
            best_l_store[r][k] = best_l_host[r].copy()
            end_info[r] = (k, n, float(dp_last[i]))
    out = []
    for r, s in enumerate(long_samples):
        k, n, dp_e = end_info[r]
        if not np.isfinite(dp_e):
            raise NoPathError(len(s), len(s))
        ids_rev, pos = [], n
        while True:
            bl, base = best_l_store[r][k], k * W
            while pos > 0:
                length = int(bl[pos - 1])
                a = base + pos
                ids_rev.append(token_to_id.get(s[a - length : a], -1))
                pos -= length
            if k == 0:
                break
            pos += W
            k -= 1
        ids_rev.reverse()
        out.append(None if -1 in ids_rev else ids_rev)
    return out


def _encode_model(L: int, seed: int):
    """A code-like vocabulary of tokens up to L bytes, two planted L-byte
    tokens scored high, and its sampler of text (the planted tokens
    included)."""
    rng = random.Random(seed)
    words = ["def", "return", "self", "value", "data", "print", "lo", "mi",
             "(", ")", ":", " ", "  ", "\n"]
    long_tokens = [b"Q" * L, b"Z" * (L - 1) + b"!"]

    def text(n):
        out = bytearray()
        while len(out) < n:
            out += (rng.choice(long_tokens) if rng.random() < 0.01
                    else rng.choice(words).encode())
        return bytes(out[:n])

    sample = text(4000)
    vocab = {bytes([b]): rng.uniform(-11.0, -9.0)
             for b in sorted(set(sample) | set(b"".join(long_tokens)))}
    while len(vocab) < 400:
        a = rng.randrange(len(sample))
        w = sample[a : a + rng.randint(2, L)]
        vocab.setdefault(w, rng.uniform(-9.0, -2.0))
    for t in long_tokens:
        vocab[t] = -0.01
    return Model([ScoredToken(v, s) for v, s in vocab.items()]), text


ROUTES = {"f32-fused": (torch.float32, None),
          "f32-slab": (torch.float32, (16, None)),
          "f64": (torch.float64, None)}


def _chained_case(device, length, L, route, dropout):
    W = 32 * KB if device.type == "cuda" else 512
    n = LENGTHS[length](W)
    model, text = _encode_model(L, n + L)
    rng = random.Random(n)
    samples = [text(n), text(rng.randint(W + 1, n + 1)), text(n)]
    # A planted token across the first boundary, one ending on the second
    # (on the first where the sample has one window's bytes more).
    a = min(W - 5, n - L)
    samples[0] = samples[0][:a] + b"Q" * L + samples[0][a + L :]
    end = 2 * W if n >= 2 * W else W
    samples[2] = (samples[2][: end - L] + b"Z" * (L - 1) + b"!"
                  + samples[2][end:])[:n]
    dtype, hints = ROUTES[route]
    dt = lat.DeviceTables.from_table(
        TokenTable.build(model.vocab, min_bits=(hints or (None,))[0]),
        device, dtype)
    probe = "exact" if dtype == torch.float64 else None
    backend = ed._eff_backend(dt, probe, dtype)
    assert dt.max_len == L
    assert backend == ("fused" if route == "f32-fused" else "slab")
    return model, dt, samples, W, backend, probe, dtype


@pytest.mark.parametrize("dropout", [0.0, 0.05])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("L", [16, 20])
@pytest.mark.parametrize("length", sorted(LENGTHS))
@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_chained_encode_matches_host_backtrack(device, monkeypatch, length,
                                               L, route, dropout):
    model, dt, samples, W, backend, probe, dtype = _chained_case(
        device, length, L, route, dropout)
    windows = []
    scan = lat.viterbi

    def spy(*a, **k):
        windows.append(scan(*a, **k))
        return windows[-1]

    monkeypatch.setattr(lat, "viterbi", spy)
    launches = lat.chained_walk.launches
    with trace.recording() as rec:
        got = ed._encode_chained(
            dt, list(enumerate(samples)), W, backend=backend,
            dropout=dropout, seed=77, probe=probe, device=device,
            dtype=dtype)
    # On the card: each window's backpointers copied to bytes, then the
    # walk's two launches; on the CPU none.
    assert lat.chained_walk.launches - launches == (
        len(windows) + 2 if device.type == "cuda" else 0)
    # The host walk over the same windows' backpointers.
    want = _host_backtrack(samples, model.token_to_ids, W, windows)
    if route == "f64" and dropout == 0.0 and device.type == "cpu":
        # The windows' scans and carries, end to end: the exact route is
        # the reference's unchunked encode.
        assert want == [model.oracle.encode(s) for s in samples]
    assert got.false == [] and got.lists() == want
    assert rec.counter("chained.samples") == 3
    assert rec.counter("chained.windows") == sum(-(-len(s) // W)
                                                 for s in samples)
    assert rec.counter("chained.false") == 0
    if dropout == 0.0:
        # The planted tokens are on the path: across the first boundary
        # and ending on a later one.
        def starts(ids):
            return np.cumsum([0] + [len(model.vocab[i].value) for i in ids])

        q = model.token_to_ids[b"Q" * L]
        assert any(a < W < a + L
                   for a, i in zip(starts(want[0]), want[0]) if i == q)
        assert (2 * W if len(samples[2]) >= 2 * W else W) in starts(want[2])


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_chained_memory_follows_the_windows(device, monkeypatch):
    """One long sample among many short ones: the walk keeps each
    sample's own windows (a flat list), not every sample padded to the
    longest's; a batch holds at most its window budget (16 groups' bytes),
    a sample past it alone; the ids are the same however the samples are
    cut. On the card the long sample's windows cost their own bytes: the
    rows padded to its window count would add about 128 x its bytes."""
    model, text = _encode_model(16, 5)
    W = 32 * KB if device.type == "cuda" else 512
    rng = random.Random(5)
    short = [text(rng.randint(W + 1, 2 * W)) for _ in range(40)]
    long = text(16 * W)
    samples = list(enumerate(short[:25] + [long] + short[25:]))
    dt = lat.DeviceTables.from_table(TokenTable.build(model.vocab), device)
    kw = dict(backend=ed._eff_backend(dt, None, torch.float32), dropout=0.0,
              seed=0, probe=None, device=device)
    calls = []
    walk = lat.chained_walk

    def spy(bl, rows, nwin, *a, **k):
        calls.append((bl.shape[0], rows.shape[0], nwin.tolist()))
        return spy.walk(bl, rows, nwin, *a, **k)

    spy.walk, spy.launches = walk, 0
    monkeypatch.setattr(lat, "chained_walk", spy)

    def encode(chain):
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        out = ed._encode_chained(dt, chain, W, **kw).lists()
        peak = (torch.cuda.max_memory_allocated(device) - base
                if device.type == "cuda" else 0)
        return out, peak

    whole, peak = encode(samples)
    nwin = [-(-len(s) // W) for _, s in samples]
    assert calls == [(sum(nwin), sum(nwin), nwin)]
    if device.type == "cuda":
        # The same batch with a short sample in the long one's place.
        _, peak_short = encode(samples[:25] + [(25, short[0])]
                               + samples[26:])
        assert peak - peak_short < 15 * (3 * W + 16 * KB) + (16 << 20)
    # A budget of 16 windows a batch.
    monkeypatch.setattr(ed, "GROUP_BYTES", W)
    calls.clear()
    cut, _ = encode(samples)
    assert cut == whole
    assert [w for _, _, n in calls for w in n] == nwin
    assert all(sum(n) <= 16 or len(n) == 1 for _, _, n in calls)
    assert [16] in [n for _, _, n in calls] and len(calls) >= 4


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_chained_encode_no_path_in_the_last_window(device):
    model, dt, samples, W, backend, probe, dtype = _chained_case(
        device, "94K", 16, "f32-slab", 0.0)
    bad = samples[1][:-10] + b"\xff" + samples[1][-9:]  # no such token
    with pytest.raises(NoPathError) as err:
        ed._encode_chained(dt, [(0, samples[0]), (1, bad)], W,
                           backend=backend, dropout=0.0, seed=0, probe=None,
                           device=device)
    assert err.value.args == NoPathError(len(bad), len(bad)).args
    with pytest.raises(NoPathError) as err:
        ed.encode_corpus_device(model, [samples[0], bad], max_width=W,
                                table_hints=(16, None), device=device)
    assert err.value.args == NoPathError(len(bad), len(bad)).args


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("route", ["bucket", "fast"])
def test_chained_false_match_is_redone(device, route, planted):  # noqa: F811
    """A planted false match in a chained sample: the walk flags it
    (`false`, counter `chained.false`), and the encode redoes it to the
    exact probe's ids."""
    model, samples = _corpus(long_words=200)
    hints = _hints(route)
    long_idx = [i for i, s in enumerate(samples) if len(s) > 512]
    holding = [j for j, i in enumerate(long_idx) if FALSE in samples[i]]
    assert len(long_idx) == 2 and holding
    dt = lat.DeviceTables.from_table(
        TokenTable.build(model.vocab, min_bits=(hints or (None,))[0]),
        device)
    kw = dict(backend=ed._eff_backend(dt, None, torch.float32), dropout=0.0,
              seed=0, probe=None, device=device)
    want = ed.encode_corpus_device(model, samples, table_hints=hints,
                                   probe="exact", max_width=512,
                                   device=device)
    with trace.recording() as rec:
        got = ed._encode_chained(plant(dt, route),
                                 [(i, samples[i]) for i in long_idx], 512,
                                 **kw)
    assert got.false == holding
    assert rec.counter("chained.false") == len(holding)
    assert got.lists() == [None if j in holding else want[i]
                           for j, i in enumerate(long_idx)]
    planted(route)
    with trace.recording() as rec:
        assert ed.encode_corpus_device(model, samples, table_hints=hints,
                                       max_width=512, device=device) == want
    assert rec.counter("chained.false") == len(holding)
    assert rec.counter("probe.redone") >= len(holding)
