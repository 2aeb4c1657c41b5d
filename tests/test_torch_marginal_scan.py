"""The marginal scan and `backward_expected` over it against the JAX
package's, on the CPU.

`backward_marginal_scan` (csrc/backward_chunk.cu) walks the backward
log-sum-exp DP over the whole width of a start-indexed score cache, rows
cut into chains at sample ends and padding (`lattice.chain_bounds`),
drawing the dropout coins itself, and writes every token's marginal and
the betas. Its twin is held against the Pallas `backward_chunk` in
interpret mode chunk by chunk (the history carried from chunk to chunk);
the chained twin against one chain per row bit for bit, on rows that pack
several samples with padding gaps and samples longer than a segment; the
chunk API walked over the width against the whole-width scan; and
`backward_expected` with chains, folded through the session's rank
space, against `lattice_jax.backward_expected`, with
`_dropout_keep_window` off its path. tests/test_torch_cuda.py holds
the kernel against the twin on a GPU.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops import lattice_pallas as lp

from tokengeex_tpu_torch import ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.utils.packing import pack_samples

from test_torch_estep import estep_setup  # noqa: F401 (a fixture)
from test_torch_estep import rank_fold
from test_torch_kernels import _drop_u, _hist_from_groups, _slab_to_port
from test_torch_scan import W as SCAN_W, _case as _scan_case

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)


def _marginal_args(tbl, pb, cache, du, dropout):
    """The marginal scan's arguments after the cache: forward values of
    the same cache and dropout words, a / z / ends / history, and the
    dropout keywords in the scans' (position, row) layout."""
    pdu = torch.as_tensor(du) if dropout else None
    A = lat.forward(tbl, pb, (cache, None), drop_u=pdu, dropout=dropout)
    kw = {"pad": pb.pad}
    if dropout:
        kw.update(du=pdu.t().contiguous(), dropout=dropout)
    return lat._marginal_inputs(pb, A, tbl.max_len), kw


# -- the twin against the Pallas kernel, chunk by chunk --


def _pallas_case(L, seed=0):
    """128 rows of width 256 (the Pallas kernel's 128-row lane group):
    samples of 1-150 bytes, and a vocabulary of random substrings up to L
    bytes, one of them exactly L long."""
    rng = random.Random(seed + L)
    alphabet = b"abcdefgh ()"
    samples = [bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 150)))
               for _ in range(230)]
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    first = next(s for s in samples if len(s) >= L)[:L]
    vocab.append((first, -3.0))
    seen.add(first)
    while len(vocab) < 300:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, L)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab], min_bits=16)
    assert pt.max_token_len == L
    tbl = lat.DeviceTables.from_table(pt, "cpu")
    pb = lat.prepare_batch(pack_samples(samples, width=256, row_multiple=128),
                           L, "cpu")
    assert pb.p1.shape[0] == 128
    return tbl, pb


def _to_groups(x):
    """Port (n, B) rows -> JAX (G, n, 1, 128) lane groups."""
    n, B = x.shape
    return jnp.asarray(np.ascontiguousarray(
        x.numpy().reshape(n, B // 128, 128).transpose(1, 0, 2)[:, :, None]))


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("L", [8, 16])
def test_marginal_scan_twin_matches_pallas(L, dropout):
    tbl, pb = _pallas_case(L)
    W = pb.width
    B = pb.p1.shape[0]
    du = _drop_u(pb, 3)
    cache = lat.match_cache(tbl, pb, C=W)[0]
    (a, z, ends, hist0), kw = _marginal_args(tbl, pb, cache, du, dropout)
    chains = lat.chain_bounds(pb, 64)
    assert (chains[1][1:-1] < W).any()  # inner chains
    marg, betas = lc.backward_marginal_scan(cache, a, z, ends, hist0,
                                            chains[1], **kw)

    # The JAX package's kernel reads the cache with its dropout applied
    # (its own keep-mask), one chain per row, chunk by chunk.
    score = cache.permute(2, 1, 0).numpy()  # (B, L, W)
    if dropout:
        keep = np.asarray(lj._dropout_keep_window(
            jnp.asarray(du), dropout, L, pb.pad, 0, W))
        score = np.where(keep, score, -np.inf)
    score_g = jnp.asarray(np.ascontiguousarray(np.maximum(
        score, lp.NEG).reshape(B // 128, 128, L, W).transpose(0, 3, 2, 1)))
    a_g, z_g, e_g = (_to_groups(x) for x in (a, z, ends))
    h_g = jnp.asarray(np.ascontiguousarray(
        hist0.numpy().reshape(L, B // 128, 128).transpose(1, 0, 2)))
    C = 64
    for q0 in range(W - C, -1, -C):
        part = slice(q0, q0 + C)
        m_g, h_g = lp.backward_chunk(score_g[:, part], a_g[:, part],
                                     z_g[:, part], e_g[:, part], h_g,
                                     interpret=True)
        m_ref = _slab_to_port(np.array(m_g)).numpy()
        got = marg[part].numpy()
        assert (m_ref > 1e-3).any()
        # atol covers f32 subnormals, which XLA's CPU code may flush.
        np.testing.assert_allclose(got, m_ref, rtol=1e-5, atol=1e-37)
        # The carried history holds the betas of the chunk's first L
        # positions.
        h_ref = _hist_from_groups(np.array(h_g))
        n = min(L, W - q0)
        got_b = betas[q0 : q0 + n].numpy()
        fin = h_ref[:n] > lp.NEG * 0.5
        assert ((got_b > lc.NEG * 0.5) == fin).all()
        np.testing.assert_allclose(got_b[fin], h_ref[:n][fin], rtol=2e-5,
                                   atol=1e-5)


# -- chains cut at sample ends give the per-row DP bit for bit --


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("L", [8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_marginal_chains_equal_one_chain_per_row(seed, L, S, dropout):
    case = _scan_case(seed, L)
    pb, tbl, cache = case["pb"], case["tbl"], case["cache"]
    (a, z, ends, hist0), kw = _marginal_args(tbl, pb, cache, case["du"],
                                             dropout)
    seg = lat.chain_bounds(pb, S)[1]
    assert (seg[1:-1] < SCAN_W).sum() > pb.p1.shape[0]
    m_split, b_split = lc.backward_marginal_scan_plain(
        cache, a, z, ends, hist0, seg, **kw)
    m_row, b_row = lc.backward_marginal_scan_plain(
        cache, a, z, ends, hist0, None, **kw)
    assert torch.equal(m_split, m_row) and torch.equal(b_split, b_row)
    assert float(m_row.max()) > 0.5 and bool((m_row == 0).any())
    # The betas are the betas scan's.
    assert torch.equal(b_row, lc.backward_betas_scan_plain(
        cache, ends, hist0, seg, **kw))


def test_chunk_api_equals_whole_width_scan():
    """`backward_chunk` walked over the width, the history carried from
    chunk to chunk, equals the whole-width scan: the marginals, and the
    history after the first chunk holds the first L betas."""
    case = _scan_case(0, 16)
    pb, tbl, cache = case["pb"], case["tbl"], case["cache"]
    (a, z, ends, hist), _ = _marginal_args(tbl, pb, cache, None, 0.0)
    marg, betas = lc.backward_marginal_scan_plain(cache, a, z, ends, hist)
    parts = []
    for cs in range(SCAN_W - 64, -1, -64):
        view = slice(cs, cs + 64)
        m, hist = lc.backward_chunk(cache[view].clamp(min=lc.NEG),
                                    a[view].contiguous(),
                                    z[view].contiguous(),
                                    ends[view].contiguous(), hist)
        parts.insert(0, m)
    assert torch.equal(torch.cat(parts), marg)
    assert torch.equal(hist, betas[:16])


# -- backward_expected with chains against lattice_jax --


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_backward_expected_with_chains_matches_jax(estep_setup, monkeypatch,
                                                   dropout):
    dt, tbl, jb, pb = estep_setup
    du = _drop_u(pb, 7) if dropout else None
    jdu = jnp.asarray(du) if dropout else None
    pdu = torch.as_tensor(du) if dropout else None
    C = 256
    jcache = lj.match_cache(dt, jb, C=C, drop_u=jdu, dropout=dropout)
    A_j = lj.forward(dt, jb, C=C, drop_u=jdu, dropout=dropout,
                     backend="pallas", cache=jcache)
    e_j = lj.fold_expected(dt, lj.backward_expected(
        dt, jb, A_j, C=C, drop_u=jdu, dropout=dropout, backend="pallas",
        cache=jcache))

    # The marginal scan draws the coins itself: no keep-mask is built.
    def no_mask(*args, **kwargs):
        raise AssertionError("backward_expected built a keep-mask")

    monkeypatch.setattr(lat, "_dropout_keep_window", no_mask)
    cache = lat.match_cache(tbl, pb, C=C)
    A = lat.forward(tbl, pb, cache, C=C, drop_u=pdu, dropout=dropout)
    chains = lat.chain_bounds(pb, 64)
    assert (chains[1][1:-1] < pb.width).any()
    # Folded as the session folds: the bucket slots remapped to ranks.
    lut, rank_ids, n_pad = rank_fold(tbl.bk_slot_to_id)
    ranked = (cache[0], lat.remap_slots(lut, cache[1]))
    before = (lc.backward_marginal_scan.launches, lc.backward_chunk.launches)
    acc = lat.backward_expected(tbl, pb, A, ranked, C=C, drop_u=pdu,
                                dropout=dropout, nbins=n_pad, chains=chains)
    # CPU tensors take the plain twin: no kernel launch is counted.
    assert before == (lc.backward_marginal_scan.launches,
                      lc.backward_chunk.launches)
    e = lat.fold_expected_rank(acc, rank_ids, tbl.vocab_size)
    assert e.sum() > 100
    np.testing.assert_allclose(e, e_j, rtol=1e-4, atol=1e-4)
    # The chains change no count.
    whole = lat.backward_expected(tbl, pb, A, ranked, C=C, drop_u=pdu,
                                  dropout=dropout, nbins=n_pad)
    assert torch.equal(whole, acc)


def test_marginal_scan_rejects_bad_input():
    case = _scan_case(0, 8)
    pb, tbl, cache = case["pb"], case["tbl"], case["cache"]
    (a, z, ends, hist), _ = _marginal_args(tbl, pb, cache, None, 0.0)
    seg = lat.chain_bounds(pb, 64)[1]
    lc.backward_marginal_scan(cache, a, z, ends, hist, seg)  # accepted
    bad = [
        (cache, a[:-1], z, ends, hist, seg),
        (cache, a, z.double(), ends, hist, seg),
        (cache, a, z, ends, hist[:-1], seg),
        (cache, a.t().contiguous().t(), z, ends, hist, seg),
        (cache, a, z.to("meta"), ends, hist, seg),
        (cache, a, z, ends, hist, seg[:, :-1]),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            lc.backward_marginal_scan(*args)
