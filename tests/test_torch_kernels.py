"""The port's two kernels vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch twins, which are
held against the Pallas kernels in interpret mode on the same inputs.
tests/test_torch_cuda.py holds the CUDA kernels against those twins.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokengeex_tpu import ScoredToken as JScoredToken
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops import lattice_pallas as lp
from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
from tokengeex_tpu.utils.packing import pack_samples as jpack

from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.utils.packing import pack_samples

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)


# -- layout adapters: JAX (G, C, L, 128) lane groups <-> port (C, L, B) --


def _slab_to_port(x):
    G, C, L, lanes = x.shape
    return torch.as_tensor(
        np.ascontiguousarray(np.transpose(x, (1, 2, 0, 3)).reshape(
            C, L, G * lanes)))


def _rows_from_groups(x):
    """(G, C, 1, 128) -> (C, B)."""
    G, C, _, lanes = x.shape
    return np.transpose(x[:, :, 0, :], (1, 0, 2)).reshape(C, G * lanes)


def _hist_from_groups(x):
    """(G, L, 128) -> (L, B)."""
    G, L, lanes = x.shape
    return np.transpose(x, (1, 0, 2)).reshape(L, G * lanes)


def _random_slab(seed, G=2, C=96, L=12):
    rng = np.random.default_rng(seed)
    # Half-integer scores make exact ties common; 40% NEG holes.
    s = np.round(rng.uniform(-12.0, -1.0, (G, C, L, 128)) * 2) / 2
    s[rng.random(s.shape) < 0.4] = lp.NEG
    s[:, 5] = lp.NEG  # a whole step with no candidate
    starts = (rng.random((G, C, 1, 128)) < 0.05).astype(np.float32)
    hist0 = np.round(rng.uniform(-30.0, 0.0, (G, L, 128)) * 2) / 2
    hist0[rng.random(hist0.shape) < 0.2] = lp.NEG
    return (s.astype(np.float32), starts, hist0.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_chunk_twin_matches_pallas(seed):
    s, starts, hist0 = _random_slab(seed)
    dp_j, bl_j, h_j = (np.asarray(a) for a in lp.viterbi_chunk(
        jnp.asarray(s), jnp.asarray(starts), jnp.asarray(hist0),
        interpret=True))
    dp, bl, h = lc.viterbi_chunk(
        _slab_to_port(s), torch.as_tensor(_rows_from_groups(starts)),
        torch.as_tensor(np.ascontiguousarray(_hist_from_groups(hist0))))
    dp_ref = _rows_from_groups(dp_j)
    fin = dp_ref > lp.NEG * 0.5
    assert fin.any() and (~fin).any()
    assert ((dp.numpy() > lc.NEG * 0.5) == fin).all()
    np.testing.assert_allclose(dp.numpy(), dp_ref, rtol=1e-6)
    np.testing.assert_array_equal(bl.numpy(), _rows_from_groups(bl_j))
    np.testing.assert_array_equal(h.numpy(), _hist_from_groups(h_j))


def test_viterbi_chunk_rejects_bad_input():
    s = torch.zeros((4, 3, 128))
    with pytest.raises(ValueError):
        lc.viterbi_chunk(s, torch.zeros((4, 64)), torch.zeros((3, 128)))
    with pytest.raises(ValueError):
        lc.viterbi_chunk(s.double(), torch.zeros((4, 128)),
                         torch.zeros((3, 128)))


# -- both routes against lj.viterbi on a packed batch --


def _setup(n_vocab, min_bits, seed=0, max_len=11):
    rng = random.Random(seed)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "mi", "value",
             "def", "return", "data", "self", "print"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 30))
                        ).encode() for _ in range(150)]
    alphabet = sorted(set(b"".join(samples)))
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < n_vocab:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, max_len)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    jt = JTokenTable.build([JScoredToken(v, s) for v, s in vocab],
                           min_bits=min_bits)
    dt = lj.DeviceTables.from_table(jt, dtype=jnp.float32)
    tbl = lat.DeviceTables.from_numpy(
        {"t1_fast": np.asarray(dt.t1_fast), "t2_fast": np.asarray(dt.t2_fast),
         "t_bucket": np.asarray(dt.t_bucket), "scores": np.asarray(dt.scores)},
        (dt.bits, dt.max_len, dt.vocab_size, dt.bk_bits, dt.bk_salt), "cpu")
    jb = lj.prepare_batch(jpack(samples, width=512, row_multiple=128),
                          dt.max_len)
    pb = lat.prepare_batch(pack_samples(samples, width=512, row_multiple=128),
                           dt.max_len, "cpu")
    return dt, tbl, jb, pb


@pytest.fixture(scope="module")
def fused_setup():
    dt, tbl, jb, pb = _setup(400, None)
    assert lj.has_vscan(dt) and lat.has_vscan(tbl)
    return dt, tbl, jb, pb


@pytest.fixture(scope="module")
def slab_setup():
    dt, tbl, jb, pb = _setup(400, 16, seed=1)
    assert not lat.has_vscan(tbl) and tbl.t_bucket is not None
    return dt, tbl, jb, pb


def _drop_u(pb, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                        dtype=np.int64).astype(np.int32)


def _assert_viterbi_equal(j, p):
    dp_j, bl_j = (np.asarray(a) for a in j)
    dp_p, bl_p = (a.numpy() for a in p)
    fin = np.isfinite(dp_j)
    assert fin.any()
    assert (fin == np.isfinite(dp_p)).all()
    np.testing.assert_allclose(dp_p[fin], dp_j[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(bl_p, bl_j)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_fused_twin_matches_pallas_fused(fused_setup, dropout):
    dt, tbl, jb, pb = fused_setup
    du = _drop_u(pb, 3) if dropout else None
    j = lj.viterbi(dt, jb, C=256, drop_u=jnp.asarray(du) if dropout else None,
                   dropout=dropout, backend="fused")
    p = lat.viterbi(tbl, pb, drop_u=torch.as_tensor(du) if dropout else None,
                    dropout=dropout, backend="fused")
    _assert_viterbi_equal(j, p)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_slab_route_matches_pallas(slab_setup, dropout):
    dt, tbl, jb, pb = slab_setup
    du = _drop_u(pb, 4) if dropout else None
    j = lj.viterbi(dt, jb, C=256, drop_u=jnp.asarray(du) if dropout else None,
                   dropout=dropout, backend="pallas")
    p = lat.viterbi(tbl, pb, C=256,
                    drop_u=torch.as_tensor(du) if dropout else None,
                    dropout=dropout, backend="slab")
    _assert_viterbi_equal(j, p)


def test_fused_probe_matches_match_slab(fused_setup):
    """The fused probe's scores (run-length validity, T1-first direct
    gathers) equal the end-indexed fast probe's on every position."""
    _, tbl, _, pb = fused_setup
    args = lat.fused_inputs(tbl, pb)
    score, _ = lcf.fused_probe_plain(*args[:9], args[10], L=tbl.max_len,
                                     bits=tbl.bits, pad=pb.pad)
    ref, _ = lat._match_slab(tbl, pb, 0, pb.width, tbl.max_len,
                             mode="fast", end_indexed=True)
    ref = ref.clamp(min=lc.NEG).permute(2, 1, 0)
    assert torch.equal(score, ref)


def test_fused_forward_chunk_logsumexp_not_ported(fused_setup):
    _, tbl, _, pb = fused_setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lcf.fused_forward_chunk("logsumexp", *lat.fused_inputs(tbl, pb),
                                L=tbl.max_len, bits=tbl.bits, pad=pb.pad)
