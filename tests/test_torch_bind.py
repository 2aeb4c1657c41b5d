"""A training session's binding of a model to its resident table layout
(ops/lattice.py ResidentLayout, train/device_session.py `_rebind`): the
layout's id map against `TokenTable.rebind`'s ids, every word of a
binding against a fresh upload of the rebound table, and a prune over
bound tables against one that uploads a rebound table a model.

The file imports only the port, so its `cuda` test runs on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bind.py -q
"""

import random

import numpy as np
import pytest
import torch

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train import device_session as ds
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train import prune

# The suite runs in several worker processes at once.
torch.set_num_threads(1)

CPU = torch.device("cpu")
TENSORS = ("t1_fast", "t2_fast", "scores", "t_bucket", "t1_exact",
           "t2_exact")
NUMBERS = ("bits", "max_len", "vocab_size", "bk_bits", "bk_salt")
MAPS = ("slot_to_id", "slot_len", "bk_slot_to_id", "bk_slot_len")


def _corpus(seed=5, n_vocab=150):
    """A small code-like corpus, two samples past an encode width of 1,024
    bytes, and a vocabulary of its bytes (kept) and substrings, three of
    them twice (the later copy scored apart)."""
    rng = random.Random(seed)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "value", "return"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 20))
                        ).encode() for _ in range(40)]
    samples += [" ".join(rng.choice(words) for _ in range(n)).encode()
                for n in (300, 420)]
    vocab = [tg.ScoredToken(bytes([b]), rng.uniform(-11.0, -9.0), True)
             for b in sorted(set(b"".join(samples)))]
    seen = {t.value for t in vocab}
    while len(vocab) < n_vocab:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, 8)]
        if w not in seen:
            seen.add(w)
            vocab.append(tg.ScoredToken(w, rng.uniform(-9.0, -1.0)))
    vocab += [t.clone_with_score(t.score - 0.5) for t in vocab[-3:]]
    return vocab, samples


def _chain(vocab, seed=7):
    """(name, vocabulary) of a chain of bindings from `vocab`: M-step
    rescorings that drop tokens, a removal round, duplicated byte strings
    with an empty token and one longer than the table's L (which no table
    holds), and the kept bytes alone."""
    rng = random.Random(seed)
    L = max(len(t.value) for t in vocab)

    def rescore(v, drop):
        return [t.clone_with_score(t.score - rng.random()) for t in v
                if t.keep or rng.random() >= drop]

    m1 = rescore(vocab, 0.2)
    m2 = rescore(m1, 0.1)
    removal = [t for t in m2 if t.keep or rng.random() < 0.6]
    multi = [t for t in removal if not t.keep]
    dups = removal + [t.clone_with_score(t.score + 1.0) for t in multi[:4]] \
        + [tg.ScoredToken(b"", -3.0), tg.ScoredToken(b"q" * (L + 2), -4.0)]
    keep = [t for t in vocab if t.keep]
    return [("mstep", m1), ("mstep2", m2), ("removal", removal),
            ("duplicates", dups), ("keep", keep)]


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    elif t.dtype == torch.float64:
        t = t.view(torch.int64)
    return t.numpy()


def _slot_maps(sess, vocab) -> dict:
    """The host slot maps of the session's binding of `vocab`, through the
    layout's id map from the base table's: what `from_table` of the
    rebound table gives (no route of the session reads them, and its
    bindings carry none)."""
    base = sess.layout.base
    lut = sess.layout.id_map([t.value for t in vocab])

    def ids(slot_to_id):
        return np.where(slot_to_id >= 0, lut[np.maximum(slot_to_id, 0)], -1)

    slot_to_id = ids(base.slot_to_id)
    return {"slot_to_id": slot_to_id,
            "slot_len": np.where(slot_to_id >= 0, base.slot_len, 0),
            "bk_slot_to_id": ids(base.bk_slot_to_id),
            "bk_slot_len": base.bk_slot_len}


def _assert_same_tables(got: lat.DeviceTables, want: lat.DeviceTables,
                        maps=None):
    """Every tensor bit for bit, every number, the bucket filter's tags and
    that the filter belongs to `got`'s own buckets, and the slot maps:
    `got`'s, or where it carries none (a binding) `maps`."""
    for name in TENSORS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.device.type == w.device.type, name
            assert g.is_contiguous(), name
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    for name in NUMBERS:
        assert getattr(got, name) == getattr(want, name), name
    assert (got.bk_filter is None) == (want.bk_filter is None)
    if got.bk_filter is not None:
        assert got.bk_filter.belongs_to(got.t_bucket)
        assert torch.equal(got.bk_filter.tags.cpu(), want.bk_filter.tags.cpu())
    if maps is None:
        maps = {k: getattr(got, k) for k in MAPS}
    else:
        assert all(getattr(got, k) is None for k in MAPS)
    for name in MAPS:
        g, w = maps[name], getattr(want, name)
        assert g.dtype == np.int64, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", ["chain", "capped", "empty_and_long"])
def test_id_map_equals_rebind(case):
    """The layout's id map gives every slot the id `TokenTable.rebind`
    gives it, along the chain, on a table capped below its longest token
    (tokens past the cap map nothing), and for empty and over-long
    tokens; a token the table never held raises as rebind raises."""
    vocab, _ = _corpus()
    if case == "capped":
        tbl = TokenTable.build(vocab, max_probe_len=5)
        assert max(len(t.value) for t in vocab) > tbl.max_token_len
    else:
        tbl = TokenTable.build(vocab)
    chain = _chain(vocab)
    if case == "empty_and_long":
        chain = [(n, v + [tg.ScoredToken(b"", 0.0),
                          tg.ScoredToken(b"z" * 40, -1.0)])
                 for n, v in chain]
    layout = lat.ResidentLayout.of(tbl, CPU)
    empty = np.uint32(0xFFFFFFFF)
    for name, v in chain:
        lut = layout.id_map([t.value for t in v])
        assert lut.shape == (len(vocab) + 1,) and lut[-1] == -1
        want = tbl.rebind(v)
        occ = tbl.bk_ids >= 0
        np.testing.assert_array_equal(
            np.where(occ, lut[np.where(occ, tbl.bk_ids, 0)], -1),
            want.bk_ids, err_msg=name)
        for t, w in ((tbl.t1, want.t1), (tbl.t2, want.t2)):
            held = t[:, 3] != empty
            new = lut[np.where(held, t[:, 3], 0).astype(np.int64)]
            np.testing.assert_array_equal(
                np.where(held & (new >= 0), new.astype(np.uint32), empty),
                w[:, 3], err_msg=name)
    outside = chain[-1][1] + [tg.ScoredToken(b"\x00\x01", -1.0)]
    with pytest.raises(ValueError, match="not in the original table"):
        tbl.rebind(outside)
    with pytest.raises(ValueError, match="not in the original table"):
        layout.id_map([t.value for t in outside])


def _check_session_chain(device, dtype):
    vocab, samples = _corpus()
    sess = ds.DeviceTrainSession(tg.Model(vocab), samples, 256, dtype=dtype,
                                 device=device)
    base = sess.base_tbl
    assert sess.dt is sess.layout.base
    _assert_same_tables(sess.dt, lat.DeviceTables.from_table(
        base.rebind(vocab), device, dtype or torch.float32))
    held = None
    for name, v in _chain(vocab):
        model = tg.Model(v)
        prev = sess.dt
        prev_words = {k: getattr(prev, k).clone() for k in TENSORS}
        sess._rebind(model)
        tbl = base.rebind(v)
        want = lat.DeviceTables.from_table(tbl, device,
                                           dtype or torch.float32)
        _assert_same_tables(sess.dt, want, _slot_maps(sess, v))
        # Fresh tensors: the tables the previous binding handed out hold
        # what they held.
        for k, t in prev_words.items():
            assert torch.equal(getattr(prev, k), t), (name, k)
        if not sess.exact:
            np.testing.assert_array_equal(
                _bits(sess.slot_rows),
                _bits(lat.rank_score_rows(sess.rank, want)))
            np.testing.assert_array_equal(sess.rank_ids,
                                          lat.rank_to_ids(sess.rank, tbl))
        # The alternatives' float64 tables of this binding.
        want64 = lat.DeviceTables.from_table(tbl, device, torch.float64)
        _assert_same_tables(sess.tables_f64(model), want64,
                            _slot_maps(sess, v))
        if sess.dtype == torch.float64:
            assert sess.tables_f64(model) is sess.dt
        held = (model, sess.dt)
    # A token outside the base table raises and leaves the binding be.
    with pytest.raises(ValueError, match="not in the original table"):
        sess._rebind(tg.Model(held[0].vocab + [
            tg.ScoredToken(b"\x00\x01", -1.0)]))
    assert sess._model is held[0] and sess.dt is held[1]


@pytest.mark.parametrize("dtype", [None, torch.float64],
                         ids=["f32", "f64"])
def test_session_binding_equals_a_fresh_upload(dtype):
    """Along the chain, every field of the session's bound DeviceTables,
    its rank rows and rank ids, and its slot maps equal those of
    `DeviceTables.from_table(base_tbl.rebind(vocab))`, at f32 and at f64
    (the exact mode); the float64 tables of the alternatives too."""
    _check_session_chain(CPU, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.float64],
                         ids=["f32", "f64"])
def test_session_binding_equals_a_fresh_upload_on_the_card(dtype):
    """The same on the GPU, where the words are gathered by CUDA ops."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the session runs the CUDA kernels")
    _check_session_chain(torch.device("cuda"), dtype)


class _UploadingSession(ds.DeviceTrainSession):
    """A session that binds as before the resident layout: the rebound
    TokenTable on the host, uploaded whole a model, and the alternatives'
    float64 tables uploaded again."""

    def _rebind(self, model, timer=None):
        with lat.phase(timer, "rebind"):
            if model is self._model:
                return
            self._tbl = self.base_tbl.rebind(model.vocab)
            self.dt = lat.DeviceTables.from_table(self._tbl, self.dev,
                                                  self.dtype)
            if not self.exact:
                self.slot_rows = lat.rank_score_rows(self.rank, self.dt)
                self.rank_ids = lat.rank_to_ids(self.rank, self._tbl)
            self._model = model

    def tables_f64(self, model):
        self._rebind(model)
        tbl = getattr(self, "_tbl", self.base_tbl)
        return lat.DeviceTables.from_table(tbl, self.dev, torch.float64)


def _recorded_prune(monkeypatch, session_cls, dtype, device="cpu"):
    """A two-round prune's E-steps, frequencies, alternatives and final
    vocabulary on `device`, its sessions made by `session_cls`."""
    monkeypatch.setattr(ed, "MAX_ENCODE_WIDTH", 1024)
    monkeypatch.setattr(prune, "DeviceTrainSession", session_cls)
    out = {"e_step": [], "freq": [], "alternatives": []}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            got = fn(*args, **kwargs)
            out[key].append(got)
            return got
        return wrapped

    monkeypatch.setattr(ds.DeviceTrainSession, "e_step",
                        spy("e_step", ds.DeviceTrainSession.e_step))
    monkeypatch.setattr(ds.DeviceTrainSession, "count_frequencies",
                        spy("freq", ds.DeviceTrainSession.count_frequencies))
    monkeypatch.setattr(prune, "prune_alternatives_device",
                        spy("alternatives", prune.prune_alternatives_device))
    vocab, samples = _corpus(n_vocab=200)
    assert max(map(len, samples)) > 1024
    pruner = prune.VocabularyPruner(76, shrink_factor=0.8, em_subiters=2,
                                    dropout=0.05, device=device,
                                    device_dtype=dtype)
    model = pruner.prune(tg.Model(vocab), samples)
    out["vocab"] = [(t.value, t.score, t.keep) for t in model.vocab]
    return out


def _check_prune_against_uploads(dtype, device, rtol=0.0):
    """The prunes' passes equal; the E-step counts and the final scores
    to `rtol` (0: bit for bit)."""
    with pytest.MonkeyPatch.context() as mp:
        got = _recorded_prune(mp, ds.DeviceTrainSession, dtype, device)
    with pytest.MonkeyPatch.context() as mp:
        want = _recorded_prune(mp, _UploadingSession, dtype, device)
    assert len(got["e_step"]) == len(want["e_step"]) == 4
    assert len(got["freq"]) == len(want["freq"]) == 2
    for g, w in zip(got["e_step"], want["e_step"]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
    for g, w in zip(got["freq"], want["freq"]):
        np.testing.assert_array_equal(g, w)
    for (gk, ga), (wk, wa) in zip(got["alternatives"], want["alternatives"]):
        np.testing.assert_array_equal(gk, wk)
        assert ga == wa
    assert [(v, k) for v, _, k in got["vocab"]] \
        == [(v, k) for v, _, k in want["vocab"]]
    np.testing.assert_allclose([s for _, s, _ in got["vocab"]],
                               [s for _, s, _ in want["vocab"]],
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [None, torch.float64],
                         ids=["f32", "f64"])
def test_prune_over_bound_tables_equals_uploads(dtype):
    """A two-round prune whose session binds on the resident layout gives
    the E-steps, the frequency passes (their chained encode included),
    the alternatives and the final vocabulary of one whose session
    uploads each rebound table, exactly."""
    _check_prune_against_uploads(dtype, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.float64],
                         ids=["f32", "f64"])
def test_prune_on_a_bare_cuda_device_equals_uploads(dtype):
    """The same on the GPU named as a bare "cuda", the device the CLI's
    `--device cuda` gives: the alternatives and the frequency pass's
    chained encode take the session's binding, whose tensors name the
    card by its index. The f64 / exact mode adds its E-step marginals
    into token-id bins with atomics on the card, so two runs of it differ
    in the last bits, and the M-steps carry that on (seen: 4.4e-16 in a
    first E-step, 2.2e-12 in a later one; the f32 mode's equal); its
    tables are held bit for bit above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the session runs the CUDA kernels")
    _check_prune_against_uploads(
        dtype, "cuda", rtol=1e-9 if dtype == torch.float64 else 0.0)
