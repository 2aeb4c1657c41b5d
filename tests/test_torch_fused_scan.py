"""The port's fused log-sum-exp scans against the JAX package's, on the CPU.

`fused_forward_chunk(kind="logsumexp")` and `fused_backward_chunk`
(csrc/fused_forward.cu, csrc/fused_backward.cu) probe the vocabulary
inside the DP and cut each row into chains at sample boundaries and
padding (`lattice.chain_bounds`). Their plain twins are held:

  - with chains against one chain per row, bit for bit (forward values,
    history and run length; betas), on hand-packed rows with padding gaps,
    rows that begin in padding, empty rows and samples longer than a
    segment;
  - fed the chains through `lattice.forward` / `backward_betas`
    (backend "fused") against the JAX package's fused route in Pallas
    interpret mode, on the same batch, tables and numpy dropout words;
  - in the session, whose fused branch passes each group's cached bounds;
  - and the wrappers' checks of the chain bounds.

tests/test_torch_cuda.py holds the CUDA kernels against the twins on a GPU.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokengeex_tpu import ScoredToken as JScoredToken
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
from tokengeex_tpu.utils.packing import PackedBatch as JPackedBatch

from tokengeex_tpu_torch import Model, ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
from tokengeex_tpu_torch.utils.packing import PackedBatch

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

W = 256
ROWS = 128  # the Pallas kernels' lane width
FILLED = 40  # rows holding samples; the rest are empty padding
ALPHABET = b"abcde fgh()"


def _rows(seed):
    """Per row, (offset, sample) placements: a leading gap on every
    third row (the row begins in padding), gaps of 0-5 bytes between
    samples, samples of 1-150 bytes (longer than a 16- or 64-position
    segment), every fourth row filled up to the width (a run and an end
    at W); rows past FILLED are empty."""
    rng = random.Random(seed)
    rows = []

    def sample(n):
        return bytes(rng.choice(ALPHABET) for _ in range(n))

    for r in range(FILLED):
        pos = rng.randint(1, 20) if r % 3 == 0 else 0
        placed = []
        while True:
            n = rng.randint(1, 150)
            if pos + n > W:
                break
            placed.append((pos, sample(n)))
            pos += n + rng.choice([0, 0, 1, 5])
        if r % 4 == 1 and pos < W:
            placed.append((pos, sample(W - pos)))
        rows.append(placed)
    return rows + [[] for _ in range(ROWS - FILLED)]


def _packed(rows, cls):
    bytes_arr = np.zeros((len(rows), W), np.uint8)
    sample_id = np.full((len(rows), W), -1, np.int32)
    is_start = np.zeros((len(rows), W + 1), bool)
    end_index = np.zeros((len(rows), W), np.int32)
    spans = []
    for r, placed in enumerate(rows):
        for off, data in placed:
            n = len(data)
            bytes_arr[r, off : off + n] = np.frombuffer(data, np.uint8)
            sample_id[r, off : off + n] = len(spans)
            is_start[r, off] = True
            end_index[r, off : off + n] = off + n
            spans.append((r, off, off + n, len(spans), 0))
    return cls(bytes_arr, sample_id, is_start, end_index, spans)


def _vocab(rows, L, seed):
    """All alphabet bytes plus random substrings of the samples up to L
    bytes, one of them exactly L long."""
    rng = random.Random(seed + 100)
    samples = [d for placed in rows for _, d in placed if len(d) >= L]
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in sorted(ALPHABET)]
    seen = {v for v, _ in vocab}
    first = samples[0][:L]
    vocab.append((first, -3.0))
    seen.add(first)
    while len(vocab) < 300:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, L)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    return vocab


_CASES = {}


def _case(seed, L):
    """One batch, its fused-route tables and numpy dropout words."""
    key = (seed, L)
    if key not in _CASES:
        rows = _rows(seed)
        vocab = _vocab(rows, L, seed)
        pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab])
        tbl = lat.DeviceTables.from_table(pt, "cpu")
        assert lat.has_vscan(tbl) and tbl.max_len == L
        pb = lat.prepare_batch(_packed(rows, PackedBatch), L, "cpu")
        rng = np.random.default_rng(seed)
        du = rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                          dtype=np.int64).astype(np.int32)
        _CASES[key] = {"rows": rows, "vocab": vocab, "tbl": tbl, "pb": pb,
                       "du": du}
    return _CASES[key]


def _twin_args(case, dropout):
    """The fused kernels' positional arguments and keywords for a case."""
    tbl, pb = case["tbl"], case["pb"]
    du = torch.as_tensor(case["du"]) if dropout else None
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=pb.pad, dropout=dropout)
    return (lat.fused_inputs(tbl, pb, du, dropout),
            lat.fused_bwd_inputs(tbl, pb, du, dropout), kw)


# -- chains cut at sample boundaries give the per-row DP bit for bit --


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("L", [8, 16])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_fused_chain_split_equals_one_chain_per_row(direction, seed, L, S,
                                                    dropout):
    case = _case(seed, L)
    fwd, bwd, kw = _twin_args(case, dropout)
    seg_f, seg_b = lat.chain_bounds(case["pb"], S)
    seg = seg_f if direction == "forward" else seg_b
    # Inner chains exist, and some run past their segment (a sample
    # longer than S) or leave the next one empty.
    assert (seg[1:-1] < W).sum() > FILLED
    assert (seg[2:] - seg[1:-1] > S).any() and (seg[2:] == seg[1:-1]).any()
    if direction == "forward":
        split = lcf.fused_forward_chunk_plain("logsumexp", *fwd, **kw,
                                              seg=seg)
        row = lcf.fused_forward_chunk_plain("logsumexp", *fwd, **kw)
        assert split[1] is None and row[1] is None
        for i in (0, 2, 3):  # a, hist, rl
            assert torch.equal(split[i], row[i])
        a = row[0]
        assert (a > lc.NEG * 0.5).any() and (a <= lc.NEG * 0.5).any()
        assert (row[3] > 0).any()
    else:
        split = lcf.fused_backward_chunk_plain(*bwd, **kw, seg=seg)
        row = lcf.fused_backward_chunk_plain(*bwd, **kw)
        assert torch.equal(split, row)
        assert (row == 0).any() and (row <= lc.NEG * 0.5).any()


def test_fused_restarts_rebuild_the_run_lengths():
    """A chain's first byte is a sample start or padding, so the run
    lengths restarted there equal the carried ones: the forward's ending
    at each byte, the backward's starting at each byte."""
    pb = _case(0, 8)["pb"]
    seg_f, seg_b = lat.chain_bounds(pb, 16)
    inb = pb.sid[:, pb.pad : pb.pad + W].t() >= 0
    stb = pb.is_start[:, :W].t()
    rl0 = torch.zeros(ROWS, dtype=torch.int32)
    fwd = lc._inner_bounds(seg_f, W)
    bwd = lc._inner_bounds(seg_b, W)
    assert fwd[:W].any() and bwd[1:].any()
    assert torch.equal(lcf.run_lengths(inb, stb, rl0, fwd[:W]),
                       lcf.run_lengths(inb, stb, rl0))
    nxt = pb.is_start[:, 1:].t()
    assert torch.equal(lcf.start_run_lengths(inb, nxt, bwd[1:]),
                       lcf.start_run_lengths(inb, nxt))


# -- the chained twins against the JAX package's fused route --


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_chained_fused_twins_match_jax(direction, dropout):
    case = _case(0, 16)
    jt = JTokenTable.build([JScoredToken(v, s) for v, s in case["vocab"]])
    dt = lj.DeviceTables.from_table(jt, dtype=jnp.float32)
    assert lj.has_vscan(dt) and jt.bits == case["tbl"].bits
    jb = lj.prepare_batch(_packed(case["rows"], JPackedBatch), dt.max_len)
    jdu = jnp.asarray(case["du"]) if dropout else None
    pdu = torch.as_tensor(case["du"]) if dropout else None
    chains = lat.chain_bounds(case["pb"], 64)
    assert (chains[0][1:-1] < W).any() and (chains[1][1:-1] < W).any()
    fn = {"forward": (lj.forward, lat.forward),
          "backward": (lj.backward_betas, lat.backward_betas)}[direction]
    want = fn[0](dt, jb, C=128, drop_u=jdu, dropout=dropout, backend="fused")
    before = (lcf.fused_forward_chunk.launches,
              lcf.fused_backward_chunk.launches)
    got = fn[1](case["tbl"], case["pb"], drop_u=pdu, dropout=dropout,
                backend="fused", chains=chains)
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert before == (lcf.fused_forward_chunk.launches,
                      lcf.fused_backward_chunk.launches)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(got) == fin).all()
    # tests/test_pallas_fused.py's tolerance for forward values and betas.
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=2e-5)


# -- the session's fused branch passes its cached bounds --


def test_session_fused_branch_reuses_chain_bounds(monkeypatch):
    case = _case(1, 8)
    samples = [d for placed in case["rows"] for _, d in placed]
    model = Model([ScoredToken(v, s) for v, s in case["vocab"]])
    built, passed = [], []
    chain_bounds, estep_fused = lat.chain_bounds, lat.estep_fused

    def counted_bounds(*args, **kwargs):
        built.append(chain_bounds(*args, **kwargs))
        return built[-1]

    def recorded_estep(*args, chains=None, **kwargs):
        passed.append(chains)
        return estep_fused(*args, chains=chains, **kwargs)

    monkeypatch.setattr(lat, "chain_bounds", counted_bounds)
    monkeypatch.setattr(lat, "estep_fused", recorded_estep)
    sess = DeviceTrainSession(model, samples, 256, device="cpu")
    assert sess._fused()
    first = sess.e_step(model, 0.0, 0)
    groups = len(sess._groups())
    assert np.array_equal(sess.e_step(model, 0.0, 0), first)
    # Two passes, every group through the fused branch, its bounds built
    # once and handed over both times.
    assert len(passed) == 2 * groups and len(built) == groups
    assert all(any(c is b for b in built) for c in passed)
    assert [id(c) for c in passed[:groups]] == \
        [id(c) for c in passed[groups:]]
    assert set(sess.chain_cache) == set(range(groups))
    sess.close()


# -- argument checks --


def _bad_bound_values(seg):
    """Chain bounds of the right shape, type and layout whose values are
    out of range or out of order: a first row not 0, a last row short of
    or past the width, a negative bound, a row below the one before."""
    W = int(seg[-1, 0])
    out = []
    for row, value in ((0, 1), (-1, W - 1), (-1, W + 1), (1, -1)):
        s = seg.clone()
        s[row, 3] = value
        out.append(s)
    s = seg.clone()
    s[1, 5], s[2, 5] = W, 0
    out.append(s)
    return out


@pytest.mark.parametrize("direction", ["forward", "backward", "viterbi"])
def test_fused_wrappers_reject_bad_chains(direction):
    case = _case(0, 8)
    fwd, bwd, kw = _twin_args(case, 0.0)
    seg = lat.chain_bounds(case["pb"], 64)[1 if direction == "backward"
                                           else 0]
    if direction == "backward":
        def call(s):
            return lcf.fused_backward_chunk(*bwd, **kw, seg=s)
    else:
        kind = "logsumexp" if direction == "forward" else "viterbi"

        def call(s):
            return lcf.fused_forward_chunk(kind, *fwd, **kw, seg=s)
    call(seg)  # accepted
    bad = [seg.to("meta"),                        # device
           seg.long(), seg.float(),               # type
           seg[:1], seg[:, :-1], seg[0],          # shape
           seg.t().contiguous().t()]              # contiguity
    bad += _bad_bound_values(seg)                 # values
    for s in bad:
        with pytest.raises(ValueError):
            call(s)
