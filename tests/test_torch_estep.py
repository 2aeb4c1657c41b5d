"""The port's EM E-step against the JAX package's, on the CPU.

The plain twins of `forward_chunk` and `backward_chunk` are held against
the Pallas kernels in interpret mode; `forward` and `backward_expected`,
folded as the session folds (slots remapped to a dense rank space,
`fold_expected_rank`), against `lattice_jax` on the same batch, tables
and dropout words; the port's E-step, `DeviceTrainSession.e_step` on
device="cpu" on the fused and the slab route, and its frequency pass
against the JAX E-step and frequency counts on the
tests/test_estep_device.py corpus. tests/test_torch_cuda.py holds the
CUDA kernels against the twins on a GPU.
"""

import random
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tokengeex_tpu as jtg
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops import lattice_pallas as lp
from tokengeex_tpu.train import estep_device as jed

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train.device_session import DeviceTrainSession

from test_torch_kernels import (_drop_u, _hist_from_groups, _random_slab,
                                _rows_from_groups, _setup, _slab_to_port)

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _assert_close_masked(got, want, rtol, atol=0.0):
    fin = want > lp.NEG * 0.5
    assert fin.any()
    assert ((got > lc.NEG * 0.5) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


# -- the plain twins against the Pallas kernels (interpret mode) --


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_chunk_twin_matches_pallas(seed):
    s, starts, hist0 = _random_slab(seed)
    a_j, h_j = (np.asarray(x) for x in lp.forward_chunk(
        jnp.asarray(s), jnp.asarray(starts), jnp.asarray(hist0),
        interpret=True))
    a, h = lc.forward_chunk(_slab_to_port(s), _t(_rows_from_groups(starts)),
                            _t(_hist_from_groups(hist0)))
    a_ref = _rows_from_groups(a_j)
    assert (a_ref <= lp.NEG * 0.5).any()  # the step with no candidate
    _assert_close_masked(a.numpy(), a_ref, 2e-5, 1e-5)
    _assert_close_masked(h.numpy(), _hist_from_groups(h_j), 2e-5, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_chunk_twin_matches_pallas(seed):
    s, ends, hist0 = _random_slab(seed)
    rng = np.random.default_rng(seed + 10)
    G, C = s.shape[:2]
    # Forward values and normalisers that keep the marginals near [0, 1].
    a = rng.uniform(-1.0, 0.0, (G, C, 1, 128)).astype(np.float32)
    z = rng.uniform(0.0, 1.0, (G, C, 1, 128)).astype(np.float32)
    m_j, h_j = (np.asarray(x) for x in lp.backward_chunk(
        *(jnp.asarray(x) for x in (s, a, z, ends, hist0)), interpret=True))
    m, h = lc.backward_chunk(
        _slab_to_port(s), *(_t(_rows_from_groups(x)) for x in (a, z, ends)),
        _t(_hist_from_groups(hist0)))
    m_ref = _slab_to_port(m_j).numpy()
    assert (np.isfinite(m.numpy()) == np.isfinite(m_ref)).all()
    assert (m_ref > 1e-3).any()
    # atol covers f32 subnormals, which XLA's CPU code may flush to zero.
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=1e-5, atol=1e-37)
    _assert_close_masked(h.numpy(), _hist_from_groups(h_j), 2e-5, 1e-5)


def test_chunk_wrappers_reject_bad_input():
    s = torch.zeros((4, 3, 128))
    row = torch.zeros((4, 128))
    with pytest.raises(ValueError):
        lc.forward_chunk(s, torch.zeros((4, 64)), torch.zeros((3, 128)))
    with pytest.raises(ValueError):
        lc.backward_chunk(s, row, row.double(), row, torch.zeros((3, 128)))


def e_step(model, samples, max_snippet, dropout=0.0, seed=0, **kw):
    """The port's E-step: one pass of a DeviceTrainSession on the CPU,
    closed after use."""
    sess = DeviceTrainSession(model, samples, max_snippet, device="cpu",
                              **kw)
    try:
        return sess.e_step(model, dropout, seed)
    finally:
        sess.close()


def rank_fold(slot_to_id):
    """The session's fold over a probe's slot map: (lut, rank_ids, n_pad)
    of `lattice.build_rank_space` over it (the lut maps each slot, and the
    miss past the last, to its rank; `remap_slots` applies it), with
    `rank_to_ids`' map of each rank to its token. build_rank_space reads a
    table's bucket layout, 8 slots a bucket; a cuckoo slot map (2^(bits +
    1) slots) fits it as well."""
    bk_bits = int(slot_to_id.size // 8).bit_length() - 1
    assert 8 << bk_bits == slot_to_id.size
    host = types.SimpleNamespace(bk=True, bk_bits=bk_bits, bk_ids=slot_to_id)
    rank = lat.build_rank_space(host)
    return (torch.as_tensor(rank.lut), lat.rank_to_ids(rank, host),
            rank.n_pad)


# -- forward / backward_expected against lattice_jax on one batch --


@pytest.fixture(scope="module")
def estep_setup():
    """One batch and the JAX tables, carried into the port with their
    slot maps, so that both packages fold through the same maps."""
    dt, ptbl, jb, pb = _setup(400, 16, seed=2)
    tbl = lat.DeviceTables.from_numpy(
        {"t1_fast": ptbl.t1_fast.numpy(), "t2_fast": ptbl.t2_fast.numpy(),
         "t_bucket": np.asarray(dt.t_bucket), "scores": np.asarray(dt.scores),
         "slot_to_id": dt.slot_to_id, "slot_len": dt.slot_len,
         "bk_slot_to_id": dt.bk_slot_to_id, "bk_slot_len": dt.bk_slot_len},
        (dt.bits, dt.max_len, dt.vocab_size, dt.bk_bits, dt.bk_salt), "cpu")
    assert tbl.t_bucket is not None and tbl.bk_slot_to_id is not None
    return dt, tbl, jb, pb


@pytest.mark.parametrize("probe", ["bucket", "fast"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_estep_ops_match_jax(estep_setup, probe, dropout):
    dt, tbl, jb, pb = estep_setup
    du = _drop_u(pb, 5) if dropout else None
    jdu = jnp.asarray(du) if dropout else None
    pdu = torch.as_tensor(du) if dropout else None
    C = 256

    jcache = lj.match_cache(dt, jb, C=C, drop_u=jdu, dropout=dropout,
                            probe=probe)
    A_j = lj.forward(dt, jb, C=C, drop_u=jdu, dropout=dropout,
                     backend="pallas", probe=probe, cache=jcache)
    e_j = lj.fold_expected(dt, lj.backward_expected(
        dt, jb, A_j, C=C, drop_u=jdu, dropout=dropout, backend="pallas",
        probe=probe, cache=jcache))

    # The port keeps the cache in its (W, L, B) slab layout and without
    # dropout; JAX's E-step probes with the dropout words. The keep-mask
    # over the whole width gives JAX's cache back.
    cache = lat.match_cache(tbl, pb, C=C, probe=probe)
    keep = (lat._dropout_keep_window(pdu, dropout, tbl.max_len, pb.pad, 0,
                                     pb.width) if dropout
            else torch.tensor(True))
    miss = tbl.bk_num_slots if probe == "bucket" else tbl.num_slots
    want_s, want_a = (torch.as_tensor(np.array(x)).permute(2, 1, 0)
                      for x in jcache)
    assert torch.equal(torch.where(keep, cache[0], lat.NEG_INF), want_s)
    assert torch.equal(torch.where(keep, cache[1], miss), want_a)
    A = lat.forward(tbl, pb, cache, C=C, drop_u=pdu, dropout=dropout)
    A_j = np.asarray(A_j)
    fin = np.isfinite(A_j)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(A.numpy()) == fin).all()
    np.testing.assert_allclose(A.numpy()[fin], A_j[fin], rtol=2e-5, atol=1e-5)

    # Folded as the session folds: the slots remapped to dense ranks, the
    # marginals added into rank bins, the ranks folded to token ids.
    lut, rank_ids, n_pad = rank_fold(
        tbl.bk_slot_to_id if probe == "bucket" else tbl.slot_to_id)
    assert lut.shape[0] == miss + 1
    acc = lat.backward_expected(tbl, pb, A,
                                (cache[0], lat.remap_slots(lut, cache[1])),
                                C=C, drop_u=pdu, dropout=dropout,
                                probe=probe, nbins=n_pad)
    assert acc.shape[0] == n_pad
    e = lat.fold_expected_rank(acc, rank_ids, tbl.vocab_size)
    assert e.sum() > 100
    np.testing.assert_allclose(e, e_j, rtol=1e-4, atol=1e-4)


# -- the session's E-step and frequency pass against the JAX package's --


@pytest.fixture(scope="module")
def corpus():
    """The tests/test_estep_device.py corpus, for both packages."""
    rng = random.Random(21)
    alphabet = b"abcdef ()"
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < 80:
        w = bytes(rng.choice(alphabet) for _ in range(rng.randint(2, 8)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    samples = [
        "".join(rng.choice("abcdef ()") for _ in range(rng.randint(1, 700))
                ).encode() for _ in range(30)
    ]
    jmodel = jtg.Model([jtg.ScoredToken(v, s) for v, s in vocab])
    model = tg.Model([tg.ScoredToken(v, s) for v, s in vocab])
    return jmodel, model, samples


@pytest.mark.parametrize("route,probe", [("fused", None), ("slab", "fast")])
def test_run_e_step_matches_jax(corpus, monkeypatch, route, probe):
    """The session's first pass on each route (the small table takes the
    fused kernels unless the has_vscan threshold is lowered below it)
    against the JAX E-step (its probe: the default, or the fast one)."""
    jmodel, model, samples = corpus
    # Force several row groups on both sides.
    monkeypatch.setattr(jed, "GROUP_BYTES", 1 << 13)
    monkeypatch.setattr(ed, "GROUP_BYTES", 1 << 13)
    if route == "slab":
        monkeypatch.setattr(lat, "VSCAN_MAX_BITS", -1)
    want = jed.run_e_step_device(jmodel, samples, dropout=0.0,
                                 max_snippet=256, dtype=jnp.float32,
                                 probe=probe)
    counts = (lcf.fused_forward_chunk.launches,
              lcf.fused_backward_chunk.launches, lc.forward_scan.launches,
              lc.backward_betas_scan.launches)
    sess = DeviceTrainSession(model, samples, 256, device="cpu")
    assert sess._fused() == (route == "fused")
    assert len(sess._groups()) > 1
    got = sess.e_step(model, 0.0, 0)
    sess.close()
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert counts == (lcf.fused_forward_chunk.launches,
                      lcf.fused_backward_chunk.launches,
                      lc.forward_scan.launches,
                      lc.backward_betas_scan.launches)
    assert got.dtype == np.float64 and got.shape == (model.vocab_size(),)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_run_e_step_dropout_is_seeded(corpus):
    _, model, samples = corpus
    a = e_step(model, samples[:8], 256, dropout=0.3, seed=7)
    assert np.array_equal(a, e_step(model, samples[:8], 256, dropout=0.3,
                                    seed=7))
    e0 = e_step(model, samples[:8], 256)
    assert not np.array_equal(a, e0)
    assert abs(a.sum() - e0.sum()) / e0.sum() < 0.5


def test_run_e_step_snippet_cap(corpus):
    """max_snippet above DEVICE_EM_SNIPPET packs at the f32 cap."""
    _, model, samples = corpus
    long = b"".join(samples)[: ed.DEVICE_EM_SNIPPET * 2 + 100]
    sess = DeviceTrainSession(model, [long], 81920, device="cpu")
    assert sess.max_snippet == ed.DEVICE_EM_SNIPPET
    got = sess.e_step(model, 0.0, 0)
    sess.close()
    want = [0.0] * model.vocab_size()
    for off in range(0, len(long), ed.DEVICE_EM_SNIPPET):
        lattice = tg.Lattice(long[off : off + ed.DEVICE_EM_SNIPPET])
        model.oracle.populate_nodes(lattice, 0.0)
        lattice.populate_marginal(want)
    # f32 forward/backward values over 1 KB snippets: ~1e-3 relative.
    np.testing.assert_allclose(got.sum(), sum(want), rtol=2e-3)


def test_run_e_step_no_path_raises(corpus):
    _, model, samples = corpus
    bad = samples[0][:100] + b"zzz" + samples[1][:50]  # 'z' not in vocab
    with pytest.raises(ValueError, match="normalization constant is not "
                                         "finite"):
        e_step(model, [samples[2], bad], 256)


def test_run_e_step_needs_a_device_without_cuda(corpus, monkeypatch):
    """Without a GPU and without `device`, the session (the E-step and
    the frequency pass) and encode (the pair count's and the
    alternatives') raise."""
    _, model, samples = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceTrainSession(model, samples[:2], 256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ed.encode_corpus_device(model, samples[:2])


def test_count_frequencies_matches_jax(corpus):
    jmodel, model, samples = corpus
    want = jed.count_frequencies_device(jmodel, samples)
    sess = DeviceTrainSession(model, samples, 256, device="cpu")
    got = sess.count_frequencies(model)
    sess.close()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
