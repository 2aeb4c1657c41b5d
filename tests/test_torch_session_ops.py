"""The port's session ops against the JAX package's, on the CPU.

The dense rank space, the score columns, `score_from_slots` and
`SegStruct` must equal the JAX package's bit for bit; the plain twins of
`seg_weights`, `fused_forward_chunk(kind="logsumexp")`,
`fused_backward_chunk` and the betas mode of `backward_chunk` are held
against the Pallas kernels in interpret mode and the XLA scans; the
segsum counts and the composite E-step ops against `lattice_jax` on the
same batch, tables and dropout words. tests/test_torch_cuda.py holds the
CUDA kernels against the twins on a GPU.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokengeex_tpu import ScoredToken as JScoredToken
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops import lattice_pallas_fused as lpf
from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
from tokengeex_tpu.utils.packing import pack_samples as jpack

from tokengeex_tpu_torch import ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.utils.packing import pack_samples

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

C = 256  # two chunks of the 512-wide rows


def _case(min_bits, seed):
    """One packed batch (W = 512, 128 rows) and one vocabulary, as host
    tables, device tables, rank spaces and rank-remapped probe slots of
    both packages."""
    rng = random.Random(seed)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "mi", "value",
             "def", "return", "data", "self", "print"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 30))
                        ).encode() for _ in range(150)]
    alphabet = sorted(set(b"".join(samples)))
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < 400:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, 11)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    jt = JTokenTable.build([JScoredToken(v, s) for v, s in vocab],
                           min_bits=min_bits)
    pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab],
                          min_bits=min_bits)
    assert np.array_equal(jt.bk, pt.bk) and jt.bits == pt.bits
    dt = lj.DeviceTables.from_table(jt, dtype=jnp.float32)
    tbl = lat.DeviceTables.from_table(pt, "cpu")
    jb = lj.prepare_batch(jpack(samples, width=512, row_multiple=128),
                          dt.max_len)
    pb = lat.prepare_batch(pack_samples(samples, width=512, row_multiple=128),
                           tbl.max_len, "cpu")
    jrank = lj.build_rank_space(jt)
    rank = lat.build_rank_space(pt)
    _, jraw = lj.match_cache(dt, jb, C=C)
    _, raw = lat.match_cache(tbl, pb, C=C)
    return {"jt": jt, "pt": pt, "dt": dt, "tbl": tbl, "jb": jb, "pb": pb,
            "jrank": jrank, "rank": rank, "jraw": jraw, "raw": raw,
            "jslots": lj.remap_slots(jnp.asarray(jrank.lut), jraw),
            "slots": lat.remap_slots(torch.as_tensor(rank.lut), raw),
            "jrows": jnp.asarray(lj.rank_score_rows(jrank, jt)),
            "rows": lat.rank_score_rows(rank, tbl)}


@pytest.fixture(scope="module")
def fused_case():
    case = _case(None, 0)
    assert lj.has_vscan(case["dt"]) and lat.has_vscan(case["tbl"])
    return case


@pytest.fixture(scope="module")
def slab_case():
    case = _case(16, 1)
    assert not lat.has_vscan(case["tbl"])
    return case


def _case_for(request, name):
    return request.getfixturevalue(f"{name}_case")


def _to_port(x):
    """JAX (B, L, W) -> port (W, L, B)."""
    return torch.as_tensor(np.ascontiguousarray(
        np.transpose(np.asarray(x), (2, 1, 0))))


def _drop_u(pb, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                        dtype=np.int64).astype(np.int32)


def _drops(case, dropout, seed):
    if not dropout:
        return None, None
    du = _drop_u(case["pb"], seed)
    return jnp.asarray(du), torch.as_tensor(du)


def _assert_close_masked(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


# -- bit-equal host and index structures --


@pytest.mark.parametrize("name", ["fused", "slab"])
def test_rank_space_matches_jax(request, name):
    case = _case_for(request, name)
    jrank, rank = case["jrank"], case["rank"]
    assert rank.n_pad == jrank.n_pad
    assert np.array_equal(rank.lut, jrank.lut)
    assert np.array_equal(rank.occ, jrank.occ)
    assert np.array_equal(lat.rank_to_ids(rank, case["pt"]),
                          lj.rank_to_ids(jrank, case["jt"]))
    assert torch.equal(case["slots"], _to_port(case["jslots"]))
    assert int(case["slots"].max()) == rank.n_pad  # the misses
    rng = np.random.default_rng(3)
    acc = rng.exponential(2.0, rank.n_pad).astype(np.float32)
    ids = lat.rank_to_ids(rank, case["pt"])
    V = case["pt"].vocab_size
    assert np.array_equal(
        lat.fold_expected_rank(torch.as_tensor(acc), ids, V),
        lj.fold_expected_rank(jnp.asarray(acc), ids, V))


@pytest.mark.parametrize("name", ["fused", "slab"])
def test_score_rows_and_regather_match_jax(request, name):
    case = _case_for(request, name)
    # Per-slot and per-rank score bits; the JAX rows carry them in column 0.
    want_slot = np.asarray(lj.slot_score_rows(case["dt"]))[:, 0]
    assert np.array_equal(lat.slot_score_rows(case["tbl"]).numpy(), want_slot)
    assert np.array_equal(case["rows"].numpy(), np.asarray(case["jrows"])[:, 0])
    assert lat.rows_nbins(case["rows"]) == lj.rows_nbins(case["jrows"])
    got = lat.score_from_slots(case["rows"], case["slots"])
    want = _to_port(lj.score_from_slots(case["jrows"], case["jslots"]))
    assert torch.equal(got, want) and torch.isfinite(got).any()
    got = lat.score_from_slots(lat.slot_score_rows(case["tbl"]), case["raw"])
    want = _to_port(lj.score_from_slots(lj.slot_score_rows(case["dt"]),
                                        case["jraw"]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["fused", "slab"])
def test_seg_struct_matches_jax(request, name):
    """Every field equal: an order mismatch would put counts into the
    wrong bins with the right total."""
    case = _case_for(request, name)
    nbins = case["rank"].n_pad
    seg = lat.build_seg_struct(case["slots"], nbins)
    jseg = lj.build_seg_struct(case["jslots"], nbins)
    assert len(seg.perm) == len(jseg.perm) == case["tbl"].max_len
    for field in ("perm", "blk_slot"):
        for got, want in zip(getattr(seg, field), getattr(jseg, field)):
            assert np.array_equal(got.numpy(), np.asarray(want)), field
    for field in ("pre_pos", "end_pos", "occ_slot"):
        assert np.array_equal(getattr(seg, field).numpy(),
                              np.asarray(getattr(jseg, field))), field
    assert np.array_equal(np.asarray(seg.n_hit), np.asarray(jseg.n_hit))
    # The port's struct adds blk_occ and nxt for its kernels.
    extra = 4 * (seg.blk_occ.numel() + seg.nxt.numel())
    assert sum(seg.n_hit) > 0 and seg.nbytes() == jseg.nbytes() + extra


@pytest.mark.parametrize("n_tail", [1, 77])
def test_seg_weights_plain_matches_pallas(n_tail):
    rng = np.random.default_rng(n_tail)
    shape = (2, 64, 128)  # H = 16384
    r0 = rng.uniform(-6.0, 0.0, shape).astype(np.float32)
    r1 = rng.uniform(-6.0, 0.0, shape).astype(np.float32)
    d2 = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    d2[:, :, 0] = rng.uniform(-4.0, 0.0, shape[:2])  # the block anchors
    n_hit = r0.size - 128 + n_tail  # inside the last block
    cf_j, t_j = lpf.seg_weights(jnp.asarray(r0), jnp.asarray(r1),
                                jnp.asarray(d2), jnp.int32(n_hit),
                                interpret=True)
    cf, t = lcs.seg_weights(*(torch.as_tensor(x.reshape(-1))
                              for x in (r0, r1, d2)), n_hit)
    assert cf.shape == (r0.size,) and t.shape == (r0.size // 128,)
    np.testing.assert_allclose(cf.numpy(), np.asarray(cf_j).reshape(-1),
                               rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j).reshape(-1),
                               rtol=1e-6)


def test_seg_weights_rejects_bad_input():
    x = torch.zeros(200)
    with pytest.raises(ValueError):
        lcs.seg_weights(x, x, x, 10)
    y = torch.zeros(256)
    with pytest.raises(ValueError):
        lcs.seg_weights(y, y.double(), y, 10)


# -- the fused forward, fused backward and betas-mode scans --


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_fused_forward_logsumexp_matches_jax(fused_case, dropout):
    case = fused_case
    jdu, pdu = _drops(case, dropout, 5)
    want = lj.forward(case["dt"], case["jb"], C=C, drop_u=jdu,
                      dropout=dropout, backend="fused")
    got = lat.forward(case["tbl"], case["pb"], drop_u=pdu, dropout=dropout,
                      backend="fused")
    assert got.shape == want.shape
    _assert_close_masked(got.numpy(), want, 2e-5, 2e-5)


@pytest.mark.parametrize("backend", ["fused", "slab"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_backward_betas_match_jax(request, backend, dropout):
    case = _case_for(request, backend)
    jdu, pdu = _drops(case, dropout, 6)
    if backend == "fused":
        want = lj.backward_betas(case["dt"], case["jb"], C=C, drop_u=jdu,
                                 dropout=dropout, backend="fused")
        got = lat.backward_betas(case["tbl"], case["pb"], drop_u=pdu,
                                 dropout=dropout, backend="fused")
    else:
        jcache = lj.match_cache(case["dt"], case["jb"], C=C)
        want = lj.backward_betas(case["dt"], case["jb"], C=C, drop_u=jdu,
                                 dropout=dropout, cache=jcache)
        before = lc.backward_betas_chunk.launches
        got = lat.backward_betas(case["tbl"], case["pb"],
                                 lat.match_cache(case["tbl"], case["pb"], C=C),
                                 C=C, drop_u=pdu, dropout=dropout)
        # CPU tensors take the plain twin: no kernel launch is counted.
        assert lc.backward_betas_chunk.launches == before
    assert got.shape == want.shape
    _assert_close_masked(got.numpy(), want, 2e-5, 2e-5)


def test_fused_backward_and_betas_twins_agree(fused_case):
    """The fused backward's start-indexed probe and run-length validity
    give the scores of the start-indexed match_cache probe: both routes'
    betas agree exactly."""
    case = fused_case
    fused = lat.backward_betas(case["tbl"], case["pb"], backend="fused")
    slab = lat.backward_betas(case["tbl"], case["pb"],
                              lat.match_cache(case["tbl"], case["pb"], C=C),
                              C=C)
    assert torch.equal(fused, slab)


# -- segsum and the composite E-step ops --


def _fold(case, acc):
    ids = lat.rank_to_ids(case["rank"], case["pt"])
    return lat.fold_expected_rank(acc, ids, case["pt"].vocab_size)


@pytest.mark.parametrize("name", ["fused", "slab"])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_segsum_and_estep_ops_match_jax(request, name, dropout):
    case = _case_for(request, name)
    dt, tbl, jb, pb = case["dt"], case["tbl"], case["jb"], case["pb"]
    jdu, pdu = _drops(case, dropout, 9)
    nbins = case["rank"].n_pad
    jseg = lj.build_seg_struct(case["jslots"], nbins)
    seg = lat.build_seg_struct(case["slots"], nbins)
    if name == "fused":
        jA, jexp = lj.estep_fused(dt, jb, jseg, case["jrows"], drop_u=jdu,
                                  dropout=dropout, C=C)
        A, exp = lat.estep_fused(tbl, pb, seg, case["rows"], pdu, dropout)
    else:
        jA, jexp = lj.estep_cached(dt, jb, case["jslots"], case["jrows"],
                                   seg=jseg, drop_u=jdu, dropout=dropout, C=C)
        A, exp = lat.estep_cached(tbl, pb, case["slots"], case["rows"], seg,
                                  C, pdu, dropout)
    _assert_close_masked(A.numpy(), jA, 2e-5, 2e-5)
    assert exp.shape == (nbins,)
    np.testing.assert_allclose(exp.numpy(), np.asarray(jexp), rtol=1e-4,
                               atol=1e-4)
    e = _fold(case, exp)
    assert e.sum() > 100
    np.testing.assert_allclose(e, _fold(case, np.asarray(jexp)), rtol=1e-4,
                               atol=1e-4)

    # segsum alone, on the JAX package's own A and betas.
    jcache = (lj.score_from_slots(case["jrows"], case["jslots"]),
              case["jslots"])
    jBt = lj.backward_betas(dt, jb, C=C, drop_u=jdu, dropout=dropout,
                            cache=jcache)
    want = lj.segsum_expected(dt, jb, jA, jBt, jseg, case["jrows"],
                              drop_u=jdu, dropout=dropout)
    got = lat.segsum_expected(tbl, pb, torch.as_tensor(np.array(jA)),
                              torch.as_tensor(np.array(jBt)), seg,
                              case["rows"], pdu, dropout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    # Without a SegStruct the cached op scatters marginals into rank bins.
    _, scat = lat.estep_cached(tbl, pb, case["slots"], case["rows"], None, C,
                               pdu, dropout)
    np.testing.assert_allclose(scat.numpy(), exp.numpy(), rtol=1e-4,
                               atol=1e-4)
