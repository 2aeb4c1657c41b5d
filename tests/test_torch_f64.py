"""The port's f64 / exact conformance mode against the reference, on the CPU.

The same inputs go through the port (the kernels' plain versions in
float64) and through the reference: the pure-Python f64 `OracleModel`
id for id, and the JAX package's f64 device route
(`encode_corpus_device(dtype=jnp.float64)`, `run_e_step_device(dtype=
jnp.float64)`, `VocabularyPruner(device_dtype=jnp.float64)`), at the
tolerance of tests/test_estep_device.py (rtol 1e-8, atol 1e-9); the
port's E-step is the f64 session's (`DeviceTrainSession(dtype=
torch.float64).e_step`). The
double kernels are held against their f64 twins on the card in
tests/test_torch_cuda.py.
"""

import math
import random

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

import tokengeex_tpu as jtg  # noqa: E402
from tokengeex_tpu.train import estep_device as jed  # noqa: E402
from tokengeex_tpu.train import prune as jprune  # noqa: E402

import tokengeex_tpu_torch as tg  # noqa: E402
from tokengeex_tpu_torch.core.types import NoPathError  # noqa: E402
from tokengeex_tpu_torch.ops import lattice as lat  # noqa: E402
from tokengeex_tpu_torch.ops import lattice_cuda as lc  # noqa: E402
from tokengeex_tpu_torch.train import estep_device as ed  # noqa: E402
from tokengeex_tpu_torch.train import prune  # noqa: E402
from tokengeex_tpu_torch.train.device_session import (  # noqa: E402
    DeviceTrainSession)

from test_fuzz_differential import _fuzz_case  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-8, 1e-9  # tests/test_estep_device.py:50
F64 = torch.float64


def _port_vocab(vocab):
    return [tg.ScoredToken(t.value, t.score, t.keep) for t in vocab]


@pytest.mark.parametrize("seed", [7, 1234, 2, 3])
def test_f64_encode_matches_oracle_and_jax(seed):
    """tests/test_fuzz_differential.py's seeded full-byte fuzz (binary
    vocabularies with exact score ties): the port's f64 encode equals
    the oracle and the JAX package's f64 encode id for id."""
    vocab, samples = _fuzz_case(seed)
    want = [tg.OracleModel(_port_vocab(vocab)).encode(s) for s in samples]
    got = ed.encode_corpus_device(tg.Model(_port_vocab(vocab)), samples,
                                  dtype=F64, device="cpu")
    assert got == want
    assert jed.encode_corpus_device(jtg.Model(vocab), samples,
                                    dtype=jnp.float64) == want


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_f64_encode_matches_oracle(seed):
    vocab, samples = _fuzz_case(seed)
    want = [tg.OracleModel(_port_vocab(vocab)).encode(s) for s in samples]
    assert ed.encode_corpus_device(tg.Model(_port_vocab(vocab)), samples,
                                   dtype=F64, device="cpu") == want


def test_f64_no_path_detection():
    """Byte 0x00 missing from the vocabulary: NoPath as in the oracle and
    the JAX package's f64 encode (tests/test_fuzz_differential.py)."""
    rng = random.Random(99)
    vocab = [tg.ScoredToken(bytes([b]), math.log(1 / 256))
             for b in range(1, 256)]
    ok = bytes(rng.randrange(1, 256) for _ in range(40))
    bad = ok[:20] + b"\x00" + ok[20:]
    oracle = tg.OracleModel(vocab)
    with pytest.raises(NoPathError):
        oracle.encode(bad)
    model = tg.Model(vocab)
    assert ed.encode_corpus_device(model, [ok], dtype=F64, device="cpu") \
        == [oracle.encode(ok)]
    with pytest.raises(NoPathError):
        ed.encode_corpus_device(model, [bad], dtype=F64, device="cpu")
    with pytest.raises(NoPathError):  # the chained route
        ed.encode_corpus_device(model, [ok * 40 + bad], dtype=F64,
                                max_width=512, device="cpu")


def test_f64_chained_encode_matches_oracle():
    """Samples longer than the pack width chain windows with the dp tail
    carried in f64; tokens straddle the window boundaries."""
    rng = random.Random(17)
    vocab = [tg.ScoredToken(bytes([b]), math.log(1 / 256))
             for b in range(256)]
    seen = {t.value for t in vocab}
    ties = [rng.uniform(-6.0, -1.0) for _ in range(4)]
    while len(vocab) < 256 + 80:
        w = bytes(rng.choice(b"abcdef \n\x00\xff")
                  for _ in range(rng.randint(2, 12)))
        if w not in seen:
            seen.add(w)
            vocab.append(tg.ScoredToken(w, rng.choice(ties)))
    pool = [t.value for t in vocab[256:]]
    samples = []
    for _ in range(3):
        n = rng.randint(1500, 3000)
        parts, size = [], 0
        while size < n:
            p = rng.choice(pool) if rng.random() < 0.7 else \
                bytes(rng.choice(b"abcdef \n") for _ in range(rng.randint(1, 9)))
            parts.append(p)
            size += len(p)
        samples.append(b"".join(parts)[:n])
    samples.append(b"abcabc")
    oracle = tg.OracleModel(vocab)
    got = ed.encode_corpus_device(tg.Model(vocab), samples, dtype=F64,
                                  max_width=512, device="cpu")
    assert got == [oracle.encode(s) for s in samples]


def test_exact_probe_at_f32_matches_jax():
    """probe="exact" at f32, as the JAX package accepts it: scores
    gathered by id at f32, the same encode."""
    vocab, samples = _fuzz_case(11)
    want = jed.encode_corpus_device(jtg.Model(vocab), samples,
                                    probe="exact")
    got = ed.encode_corpus_device(tg.Model(_port_vocab(vocab)), samples,
                                  probe="exact", device="cpu")
    assert got == want


def test_exact_probe_slab_matches_jax():
    """`_match_slab`'s exact mode: ids and f64 scores equal the JAX
    package's, start- and end-indexed, with dropout."""
    from tokengeex_tpu.ops import lattice_jax as lj
    from tokengeex_tpu.ops.match_table import TokenTable as JTokenTable
    from tokengeex_tpu.utils.packing import pack_samples as jpack

    from tokengeex_tpu_torch.ops.match_table import TokenTable
    from tokengeex_tpu_torch.utils.packing import pack_samples

    vocab, samples = _fuzz_case(3)
    jt = JTokenTable.build(vocab)
    pt = TokenTable.build(_port_vocab(vocab))
    jdt = lj.DeviceTables.from_table(jt, jnp.float64)
    pdt = lat.DeviceTables.from_table(pt, "cpu", F64)
    assert pdt.scores.dtype == F64
    L = pt.max_token_len
    jb = lj.prepare_batch(jpack(samples, width=512), L)
    pb = lat.prepare_batch(pack_samples(samples, width=512), L, "cpu")
    du = np.random.default_rng(5).integers(
        -(2**31), 2**31 - 1, (jb.p1.shape[0], jb.sid.shape[1])).astype(
        np.int32)
    for end_indexed in (False, True):
        for dropout in (0.0, 0.3):
            js, jid = lj._match_slab(jdt, jb, 0, 512, L, jnp.asarray(du),
                                     dropout, jnp.float64, mode="exact",
                                     end_indexed=end_indexed)
            ps, pid = lat._match_slab(pdt, pb, 0, 512, L,
                                      torch.from_numpy(du), dropout,
                                      mode="exact", end_indexed=end_indexed,
                                      dtype=F64)
            assert ps.dtype == F64
            np.testing.assert_array_equal(pid.numpy(), np.asarray(jid))
            np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
            assert (pid.numpy() >= 0).any()


def _estep_setup():
    """tests/test_estep_device.py's corpus."""
    rng = random.Random(21)
    alphabet = b"abcdef ()"
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < 80:
        w = bytes(rng.choice(alphabet) for _ in range(rng.randint(2, 8)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    samples = ["".join(rng.choice("abcdef ()")
                       for _ in range(rng.randint(1, 700))).encode()
               for _ in range(30)]
    return vocab, samples


@pytest.mark.parametrize("bound", [False, True])
def test_f64_estep_matches_jax(monkeypatch, bound):
    """dropout 0 and the JAX test's CHUNK and GROUP_BYTES (the port's
    groups smaller, so that the session has several), the f64 session's
    E-step against the JAX package's f64 E-step: a session made from the
    model, and one made from a larger vocabulary (other ids) with the
    model bound to it."""
    vocab, samples = _estep_setup()
    for mod in (ed, jed):
        monkeypatch.setattr(mod, "CHUNK", 128)
        monkeypatch.setattr(mod, "GROUP_BYTES", 1 << 14)
    monkeypatch.setattr(ed, "GROUP_BYTES", 1 << 12)
    want = jed.run_e_step_device(
        jtg.Model([jtg.ScoredToken(v, s) for v, s in vocab]), samples,
        dropout=0.0, max_snippet=256, dtype=jnp.float64)
    model = tg.Model([tg.ScoredToken(v, s) for v, s in vocab])
    extra = [tg.ScoredToken(v, -4.0) for v in (b"zz", b"abcabc", b"( )")]
    base = tg.Model(extra + model.vocab) if bound else model
    launches = lc.forward_scan.launches
    sess = DeviceTrainSession(base, samples, 256, dtype=F64, device="cpu")
    assert sess.exact and len(sess._groups()) > 1
    got = sess.e_step(model, 0.0, 0)
    sess.close()
    assert lc.forward_scan.launches == launches  # the CPU runs the twins
    assert got.dtype == np.float64 and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_f64_snippet_cap_keeps_the_callers():
    assert ed._em_snippet_cap(81920, F64) == 81920
    assert ed._em_snippet_cap(81920) == ed.DEVICE_EM_SNIPPET == 1024
    assert ed._em_snippet_cap(None, F64) is None


def test_f64_session_counts_match_the_per_pass_estep():
    """The f64 session probes afresh each pass (no rank space, no slot
    cache) and counts as the JAX package's f64 per-pass E-step does, also
    after a rebind; its frequency pass, walked on the device, equals the
    host backtrack's counts."""
    vocab, samples = _estep_setup()
    model = tg.Model([tg.ScoredToken(v, s) for v, s in vocab])
    sess = DeviceTrainSession(model, samples, 256, dtype=F64, device="cpu")
    assert sess.exact and sess.rank is None and sess.max_snippet == 256

    def jax_e_step(vocab_):
        return jed.run_e_step_device(
            jtg.Model([jtg.ScoredToken(v, s) for v, s in vocab_]), samples,
            dropout=0.0, max_snippet=256, dtype=jnp.float64)

    want = jax_e_step(vocab)
    got = sess.e_step(model, 0.0, 0)
    assert not sess.slot_cache and not sess.seg_cache
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # A rescored, shrunk model rebinds the tables.
    vocab2 = [(v, s - 0.5) for i, (v, s) in enumerate(vocab)
              if len(v) == 1 or i % 4]
    model2 = tg.Model([tg.ScoredToken(v, s) for v, s in vocab2])
    np.testing.assert_allclose(sess.e_step(model2, 0.0, 0),
                               jax_e_step(vocab2), rtol=RTOL, atol=ATOL)
    freqs = sess.count_frequencies(model2)
    want_f = np.zeros(model2.vocab_size(), np.int64)
    for s in samples:
        for i in model2.oracle.encode(s):
            want_f[i] += 1
    np.testing.assert_array_equal(freqs, want_f)


def test_f64_pruner_matches_jax():
    """VocabularyPruner(device_dtype=float64) keeps the JAX package's
    f64 pruner's tokens, scores within 1e-8 relative."""
    from test_torch_prune import KW, _corpus, _model

    vocab, samples = _corpus()
    want = jprune.VocabularyPruner(backend="device",
                                   device_dtype=jnp.float64, **KW).prune(
        _model(jtg, vocab), samples)
    got = prune.VocabularyPruner(backend="device", device_dtype=F64,
                                 device="cpu", **KW).prune(
        _model(tg, vocab), samples)
    assert [t.value for t in got.vocab] == [t.value for t in want.vocab]
    np.testing.assert_allclose([t.score for t in got.vocab],
                               [t.score for t in want.vocab], rtol=RTOL)
