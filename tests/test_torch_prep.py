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
from tokengeex_tpu_torch.ops import hashing as H
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.utils.packing import pack_samples

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

ALPHABET = b"abcdef ()"
REPO = pathlib.Path(__file__).resolve().parents[1]


# Parts of a host module that the port rewrites: its shadow check follows
# the port's probe check word (ops/hashing.py `host_check`), so
# match_table.py differs from the reference in its docstring and the two
# functions that emulate the fast probe.
PORT_REWRITES = {"ops/match_table.py": ('"""', "def _shadowed_entries",
                                        "def _build_cuckoo_vectorized")}


def _outside_rewrites(text: str, marks) -> str:
    """The text with the module docstring and the span between the two
    function marks cut out."""
    doc, a, b = marks
    head = text.index(doc, text.index(doc) + len(doc)) + len(doc)
    return text[head : text.index(a)] + text[text.index(b):]


@pytest.mark.parametrize("rel", [
    "core/types.py", "core/processors.py", "core/splitter.py",
    "models/oracle.py", "ops/match_table.py", "utils/packing.py"])
def test_host_modules_are_verbatim_copies(rel):
    port = (REPO / "tokengeex_tpu_torch" / rel).read_text()
    ref = (REPO / "tokengeex_tpu" / rel).read_text()
    if rel in PORT_REWRITES:
        port = _outside_rewrites(port, PORT_REWRITES[rel])
        ref = _outside_rewrites(ref, PORT_REWRITES[rel])
    assert port == ref


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


def _port_fast(dt, jt):
    """The JAX package's fast rows with the port's check word: the port
    checks fp2 ^ rotl(fp1, 16) where the JAX package checks fp2 alone
    (ops/hashing.py `host_check`); scores and empty rows are the same."""
    out = {}
    for name, rows in (("t1_fast", jt.t1), ("t2_fast", jt.t2)):
        fast = np.asarray(getattr(dt, name)).copy()
        rows = rows.astype(np.uint32)
        empty = rows[:, 3] == np.uint32(0xFFFFFFFF)
        np.testing.assert_array_equal(fast[:, 0].view(np.uint32),
                                      np.where(empty, 0, rows[:, 1]))
        fast[:, 0] = np.where(empty, np.uint32(0), H.host_check(
            rows[:, 0], rows[:, 1])).view(np.int32)
        out[name] = fast
    return out


def _port_from_jax(dt, jt):
    arrays = {**_port_fast(dt, jt),
              "t_bucket": (np.asarray(dt.t_bucket)
                           if dt.t_bucket is not None else None),
              "scores": np.asarray(dt.scores)}
    meta = (dt.bits, dt.max_len, dt.vocab_size, dt.bk_bits, dt.bk_salt)
    return lat.DeviceTables.from_numpy(arrays, meta, "cpu")


@pytest.mark.parametrize("min_bits", [None, 16])
def test_device_tables_from_numpy_round_trip(min_bits):
    jt, pt = _both(_vocab(3, 120), min_bits)
    dt = _jax_tables(jt)
    via_numpy = _port_from_jax(dt, jt)
    own = lat.DeviceTables.from_table(pt, "cpu")
    fast = _port_fast(dt, jt)
    for name in ("t1_fast", "t2_fast", "t_bucket", "scores"):
        a, b = getattr(via_numpy, name), getattr(own, name)
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(
            a.numpy(), fast[name] if name in fast
            else np.asarray(getattr(dt, name)))
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
    tbl = _port_from_jax(dt, jt)
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


def test_fast_probe_rejects_a_t2_slot_collision():
    """A substring with a T2 token's fp2, at its length, lands in that
    token's T2 slot (the slot is a function of fp2): a check of fp2 alone,
    the JAX package's, takes it for the token. The port's check word mixes
    in fp1. This pair was met in a generate -> prune run, where the false
    token won a Viterbi path that the walk then refused."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.train import estep_device as ed

    token, other = b"fiqsqmg", b"ceot\nsn"
    (f1t, f2t), (f1o, f2o) = (H.host_fingerprints(token),
                              H.host_fingerprints(other))
    assert f2t == f2o and f1t != f1o
    vocab = [ScoredToken(bytes([b]), -10.0)
             for b in sorted(set(token + other + b"x"))]
    vocab.append(ScoredToken(token, -0.5))
    pt = TokenTable.build(vocab)
    # Move the token into its T2 slot, where a crowded table puts it.
    tid = len(vocab) - 1
    r1 = int(np.nonzero(pt.t1[:, 3] == tid)[0][0])
    i2 = int(H.host_table_index(np.array([f2t]), np.array([len(token)]),
                                H.IDX_A2, H.IDX_M2, pt.bits)[0])
    assert pt.t2[i2, 3] == np.uint32(0xFFFFFFFF)
    pt.t2[i2] = pt.t1[r1]
    pt.t1[r1] = np.array([0, 0, 0, 0xFFFFFFFF], dtype=np.uint32)
    tbl = lat.DeviceTables.from_table(pt, "cpu")
    assert lat.has_vscan(tbl)
    samples = [b"x" + other + b"x", token, b"x" + token + other]
    pb = lat.prepare_batch(pack_samples(samples, width=512), len(token),
                           "cpu")
    for mode in ("fast", "bucket"):
        score, _ = lat._match_slab(tbl, pb, 0, 512, len(token), mode=mode)
        # Length 7 matches only where the token itself starts.
        assert int(torch.isfinite(score[:, len(token) - 1]).sum()) == 2
    # The fused route's probe (the table is small): the Viterbi paths.
    model = Model(vocab)
    assert ed.encode_corpus_device(model, samples, table=pt, device="cpu") \
        == [model.oracle.encode(s.decode()) for s in samples]


def test_shadow_check_pins_a_check_word_collision(monkeypatch):
    """The table build's shadow check follows the probe's check word:
    with the word cut to 3 bits, tokens in T2 meet T1 occupants that share
    it but not fp2 (a check keyed on fp2 misses them); the build pins each such
    cluster into T2, and every token probed alone resolves to its own
    slot through the port's fast probe."""
    from tokengeex_tpu_torch.ops import match_table as mt

    real, real_i32 = H.host_check, H.check_i32
    monkeypatch.setattr(H, "host_check",
                        lambda a, b: real(a, b) & np.uint32(7))
    monkeypatch.setattr(H, "check_i32", lambda a, b: real_i32(a, b) & 7)
    vocab = [ScoredToken(v, s) for v, s in _vocab(11, 400)]
    by = {t.value: i for i, t in enumerate(vocab)}
    L = max(map(len, by))
    ents = mt._entry_arrays(by, L)
    bits = int(np.ceil(np.log2(len(by)))) + 1
    t1, t2 = mt._build_cuckoo_vectorized(by, bits, L, entries=ents)
    bad = mt._shadowed_entries(ents, t1, t2, bits)
    assert bad.size > 0
    fp1, fp2, lens, _ = ents
    occ = t1[H.host_table_index(fp1[bad], lens[bad], H.IDX_A1, H.IDX_M1,
                                bits)]
    assert (occ[:, 1] != fp2[bad]).all()  # unseen by a check of fp2

    pt = TokenTable.build(vocab)
    assert pt.bits == bits
    assert mt._shadowed_entries(ents, pt.t1, pt.t2, bits).size == 0
    ids = np.asarray([by[t] for t in by], np.uint32)
    pinned = ids[np.isin(np.arange(len(ids)), bad)]
    assert np.isin(pinned, pt.t2[:, 3]).all()
    tbl = lat.DeviceTables.from_table(pt, "cpu")
    toks = list(by)
    packed = pack_samples(toks, width=512)
    batch = lat.prepare_batch(packed, L, "cpu")
    _, slot = lat.match_cache(tbl, batch, probe="fast")
    for r, s, e, si, _ in packed.spans:
        got = tbl.slot_to_id[int(slot[s, e - s - 1, r])]
        assert got == by[toks[si]], toks[si]
