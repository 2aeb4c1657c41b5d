"""PyTorch port vs the JAX package: host copies, tables, batch prep and
the vocabulary probe, all bit-equal on the same inputs (CPU)."""

import pathlib
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokengeex_tpu import ScoredToken as JScoredToken
from tokengeex_tpu.ops import lattice_jax as lj
from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
from tokengeex_tpu.utils.packing import pack_samples as jpack

from tokengeex_tpu_torch import ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.utils.packing import pack_samples

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

ALPHABET = b"abcdef ()"
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("rel", [
    "core/types.py", "core/processors.py", "core/splitter.py",
    "models/oracle.py", "ops/match_table.py", "utils/packing.py"])
def test_host_modules_are_verbatim_copies(rel):
    port = (REPO / "tokengeex_tpu_torch" / rel).read_text()
    assert port == (REPO / "tokengeex_tpu" / rel).read_text()


def test_hashing_is_the_reference_plus_torch_helpers():
    port = (REPO / "tokengeex_tpu_torch/ops/hashing.py").read_text()
    ref = (REPO / "tokengeex_tpu/ops/hashing.py").read_text()
    assert port.replace("import torch\n", "", 1).startswith(ref)


def _vocab(seed, n, alphabet=ALPHABET, max_len=8):
    rng = random.Random(seed)
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < n:
        w = bytes(rng.choice(alphabet) for _ in range(rng.randint(2, max_len)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    return vocab


def _samples(seed, n, max_len, alphabet="abcdef ()"):
    rng = random.Random(seed)
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, max_len))
                    ).encode() for _ in range(n)]


def _both(vocab, min_bits=None):
    jt = JTokenTable.build([JScoredToken(v, s) for v, s in vocab],
                           min_bits=min_bits)
    pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab],
                          min_bits=min_bits)
    return jt, pt


@pytest.mark.parametrize("n,min_bits", [(40, None), (300, None), (200, 16)])
def test_token_table_bit_equal(n, min_bits):
    jt, pt = _both(_vocab(n, n), min_bits)
    assert pt.bits == jt.bits and pt.bk_bits == jt.bk_bits
    assert pt.bk_salt == jt.bk_salt
    assert pt.max_token_len == jt.max_token_len
    for name in ("t1", "t2", "bk", "bk_ids", "bk_lens", "scores"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name))
    if min_bits:
        assert pt.bits >= 16


def _jax_tables(jt):
    return lj.DeviceTables.from_table(jt, dtype=jnp.float32)


def _port_from_jax(dt):
    arrays = {"t1_fast": np.asarray(dt.t1_fast),
              "t2_fast": np.asarray(dt.t2_fast),
              "t_bucket": (np.asarray(dt.t_bucket)
                           if dt.t_bucket is not None else None),
              "scores": np.asarray(dt.scores)}
    meta = (dt.bits, dt.max_len, dt.vocab_size, dt.bk_bits, dt.bk_salt)
    return lat.DeviceTables.from_numpy(arrays, meta, "cpu")


@pytest.mark.parametrize("min_bits", [None, 16])
def test_device_tables_from_numpy_round_trip(min_bits):
    jt, pt = _both(_vocab(3, 120), min_bits)
    dt = _jax_tables(jt)
    via_numpy = _port_from_jax(dt)
    own = lat.DeviceTables.from_table(pt, "cpu")
    for name in ("t1_fast", "t2_fast", "t_bucket", "scores"):
        a, b = getattr(via_numpy, name), getattr(own, name)
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(dt, name)))
    assert lat.has_vscan(own) == lj.has_vscan(dt) == (min_bits is None)
    assert (own.bits, own.max_len, own.bk_bits, own.bk_salt) == \
        (dt.bits, dt.max_len, dt.bk_bits, dt.bk_salt)


BATCH_FIELDS = ("p1", "p2", "sid", "is_start", "is_end", "end_index",
                "rinv1", "rinv2")


@pytest.fixture(scope="module")
def packed_pair():
    samples = _samples(5, 60, 300) + [b"", b"a" * 700]
    return (jpack(samples, width=1024, row_multiple=128),
            pack_samples(samples, width=1024, row_multiple=128))


def _assert_batch_equal(jb, pb):
    assert pb.width == jb.width and pb.pad == jb.pad
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)


def test_prepare_batch_bit_equal(packed_pair):
    jp, pp = packed_pair
    assert pp.spans == jp.spans
    L = 9
    jb = lj.prepare_batch(jp, L)
    pb = lat.prepare_batch(pp, L, "cpu")
    # Prefix hashes wrap mod 2^32 at this width.
    assert (pb.p1.numpy() < 0).any()
    _assert_batch_equal(jb, pb)


def test_prepare_chained_batch_bit_equal():
    rng = np.random.default_rng(7)
    L, W, B = 8, 512, 128
    rows = rng.integers(0, 256, (B, L + W), dtype=np.uint8)
    n_valid = rng.integers(0, W + 1, B).astype(np.int32)
    n_valid[:5] = 0
    has_tail = rng.random(B) < 0.5
    jb = lj.prepare_chained_batch(rows, n_valid, has_tail, L, W)
    pb = lat.prepare_chained_batch(rows, n_valid, has_tail, L, W, "cpu")
    _assert_batch_equal(jb, pb)


@pytest.fixture(scope="module")
def probe_setup(packed_pair):
    jp, pp = packed_pair
    jt, _ = _both(_vocab(11, 150))
    dt = _jax_tables(jt)
    tbl = _port_from_jax(dt)
    L = dt.max_len
    jb = lj.prepare_batch(jp, L)
    pb = lat.prepare_batch(pp, L, "cpu")
    rng = np.random.default_rng(3)
    du = rng.integers(-(2**31), 2**31 - 1, tuple(pb.sid.shape),
                      dtype=np.int64).astype(np.int32)
    return dt, tbl, jb, pb, du


@pytest.mark.parametrize("mode", ["bucket", "fast", "em"])
@pytest.mark.parametrize("end_indexed", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.4])
def test_match_slab_equal(probe_setup, mode, end_indexed, dropout):
    dt, tbl, jb, pb, du = probe_setup
    L = dt.max_len
    for start, n in ((0, 256), (512, 512)):
        js, jslot = lj._match_slab(
            dt, jb, start, n, L, jnp.asarray(du) if dropout else None,
            dropout, jnp.float32, mode=mode, end_indexed=end_indexed)
        ps, pslot = lat._match_slab(
            tbl, pb, start, n, L, torch.as_tensor(du) if dropout else None,
            dropout, mode=mode, end_indexed=end_indexed)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pslot.numpy(), np.asarray(jslot))
        assert np.isfinite(ps.numpy()).any()
