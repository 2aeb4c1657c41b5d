"""The slab route's vocabulary probe (`lattice.match_cache`) against the
JAX package's.

On a GPU `match_cache` launches csrc/match_probe.cu once a row group
(ops/lattice_cuda_probe.py `match_probe`); on the CPU it runs the
kernel's plain twin, `match_cache_plain`. Held here on the CPU, bit for
bit, against `lattice_jax.match_cache` (its (B, L, W) result permuted to
the port's (W, L, B)):

  - the bucket, fast and exact modes at float32, and exact at float64;
  - slots on and off;
  - tables on both sides of VSCAN_MAX_BITS (bits 13 and 17);
  - a batch of many short samples with empty rows, where validity
    matters, and a `prepare_chained_batch` window with lead = L, whose
    first L columns are the JAX package's `_match_slab` from -L;
  - the dispatch takes the twin on the CPU and counts no launch; the
    checks refuse a bad lead, an unknown mode and missing tables.

The bucket mode's miss filter and one-sector gathers are held on the CPU
in tests/test_torch_probe_filter.py; the `cuda` cases here run the kernel
on both of its branches (bits 13 and 17 filtered, 18 the gather branch),
on that file's overflow table (rows of 5-8 entries, some dead), and
refuse a filter made for another table.

The fast rows carry the port's check word (tests/test_torch_prep.py
`_port_fast`). The tests marked `cuda` hold the kernel against its twin
on a GPU (the kernel has no CPU mode); the file imports the JAX package
only inside the tests that compare with it, so on a machine without JAX

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_probe.py -q -m cuda

runs them.
"""

import dataclasses
import functools
import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tokengeex_tpu_torch import ScoredToken
from tokengeex_tpu_torch.ops import hashing as H
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.utils.packing import pack_samples

from test_torch_probe_filter import overflow_table

torch.set_num_threads(1)

ALPHABET = b"abcdef ()"
W, C = 512, 256
MODES = [("bucket", torch.float32), ("fast", torch.float32),
         ("exact", torch.float32), ("exact", torch.float64)]


def _vocab(seed, n, max_len=8):
    rng = random.Random(seed)
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in ALPHABET]
    seen = {v for v, _ in vocab}
    while len(vocab) < n:
        w = bytes(rng.choice(ALPHABET) for _ in range(rng.randint(2, max_len)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    return vocab


def _samples(seed):
    """Many short samples (1-40 bytes) and empty ones: most points cross
    a sample boundary."""
    rng = random.Random(seed)
    out = ["".join(rng.choice("abcdef ()") for _ in range(rng.randint(1, 40))
                   ).encode() for _ in range(60)]
    return out + [b"", b"", b"a" * 300]


def _chained_rows(seed, L, B=16):
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.frombuffer(ALPHABET, np.uint8), (B, L + W))
    n_valid = rng.integers(0, W + 1, B).astype(np.int32)
    n_valid[:2] = 0  # inactive rows
    n_valid[2] = W
    has_tail = rng.random(B) < 0.6
    return rows, n_valid, has_tail


def _port_tables(pt, dtype, fast=None):
    """The port's tables of `pt` at `dtype`, the fast rows replaced by
    `fast` (the JAX package's rows with the port's check word)."""
    dt = lat.DeviceTables.from_table(pt, "cpu", dtype)
    if fast is not None:
        dt = dataclasses.replace(
            dt, **{k: torch.from_numpy(v) for k, v in fast.items()})
    return dt


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's modules, float64 enabled (its exact mode gives
    float64 scores only so)."""
    jax = importlib.import_module("jax")
    jax.config.update("jax_enable_x64", True)
    prep = importlib.import_module("test_torch_prep")
    return SimpleNamespace(
        jnp=importlib.import_module("jax.numpy"),
        lj=importlib.import_module("tokengeex_tpu.ops.lattice_jax"),
        JScoredToken=importlib.import_module("tokengeex_tpu").ScoredToken,
        JTokenTable=importlib.import_module(
            "tokengeex_tpu.ops.match_table").TokenTable,
        jpack=importlib.import_module(
            "tokengeex_tpu.utils.packing").pack_samples,
        port_fast=prep._port_fast)


@pytest.fixture(scope="module")
def tables(jax_side):
    """Per bits (13, 17): the JAX package's and the port's token tables
    of one vocabulary."""
    out = {}
    for bits in (13, 17):
        vocab = _vocab(bits, 300)
        jt = jax_side.JTokenTable.build(
            [jax_side.JScoredToken(v, s) for v, s in vocab], min_bits=bits)
        pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab],
                              min_bits=bits)
        assert pt.bits == jt.bits == bits
        out[bits] = (jt, pt)
    return out


def _jax_cache(js, jt, mode, dtype, jb, lead):
    """The JAX package's start-indexed cache of `jb` as (lead + W, L, B)
    numpy arrays: `_match_slab` from -lead for the first lead columns,
    then `match_cache`."""
    jdtype = js.jnp.float64 if dtype == torch.float64 else js.jnp.float32
    dt = js.lj.DeviceTables.from_table(jt, dtype=jdtype)
    s, a = js.lj.match_cache(dt, jb, C=C, dtype=jdtype, probe=mode)
    parts = [(np.asarray(s), np.asarray(a))]
    if lead:
        ls, la = js.lj._match_slab(dt, jb, -lead, lead, dt.max_len,
                                   dtype=jdtype, mode=mode)
        parts.insert(0, (np.asarray(ls), np.asarray(la)))
    score = np.concatenate([p[0] for p in parts], axis=2).transpose(2, 1, 0)
    slot = np.concatenate([p[1] for p in parts], axis=2).transpose(2, 1, 0)
    return score, slot, dt


@pytest.mark.parametrize("batch_kind", ["packed", "chained"])
@pytest.mark.parametrize("mode,dtype", MODES,
                         ids=["bucket", "fast", "exact", "exact64"])
@pytest.mark.parametrize("bits", [13, 17])
def test_match_cache_equals_jax(jax_side, tables, bits, mode, dtype,
                                batch_kind):
    js = jax_side
    jt, pt = tables[bits]
    L = pt.max_token_len
    if batch_kind == "packed":
        samples = _samples(bits)
        jb = js.lj.prepare_batch(js.jpack(samples, width=W, row_multiple=8),
                                 L)
        pb = lat.prepare_batch(pack_samples(samples, width=W,
                                            row_multiple=8), L, "cpu")
        lead = 0
        # Rows past the samples: nothing but padding.
        assert (pb.sid[-1] < 0).all()
    else:
        rows, n_valid, has_tail = _chained_rows(bits, L)
        jb = js.lj.prepare_chained_batch(rows, n_valid, has_tail, L, W)
        pb = lat.prepare_chained_batch(rows, n_valid, has_tail, L, W, "cpu")
        lead = L
    want_s, want_a, jdt = _jax_cache(js, jt, mode, dtype, jb, lead)
    fast = js.port_fast(jdt, jt) if mode == "fast" else None
    dt = _port_tables(pt, dtype, fast)
    before = (lcp.match_probe.launches, lcp.match_probe.launches_f64)
    score, slot = lat.match_cache(dt, pb, C=C, probe=mode, lead=lead,
                                  dtype=dtype)
    assert score.dtype == dtype and score.shape == (lead + W, L,
                                                    pb.p1.shape[0])
    np.testing.assert_array_equal(score.numpy(), want_s)
    np.testing.assert_array_equal(slot.numpy(), want_a)
    only, none = lat.match_cache(dt, pb, C=C, probe=mode, lead=lead,
                                 slots=False, dtype=dtype)
    assert none is None and torch.equal(only, score)
    assert (lcp.match_probe.launches, lcp.match_probe.launches_f64) == before
    hits = np.isfinite(want_s)
    assert hits.any() and not hits.all()
    if mode == "exact":
        assert ((want_a >= 0) == hits).all()


def _small():
    pt = TokenTable.build([ScoredToken(v, s) for v, s in _vocab(3, 80)])
    batch = lat.prepare_batch(pack_samples(_samples(3), width=W),
                              pt.max_token_len, "cpu")
    return pt, batch


def test_cpu_dispatch_takes_the_twin(monkeypatch):
    """On CPU tensors `match_cache` returns the twin's caches and never
    reaches the kernel's wrapper (no launch counted)."""
    pt, batch = _small()
    dt = lat.DeviceTables.from_table(pt, "cpu")

    wrapper = lcp.match_probe
    before = (wrapper.launches, wrapper.launches_f64)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(lcp, "match_probe", refuse)
    for probe in ("bucket", "fast", "em", "exact"):
        got = lat.match_cache(dt, batch, C=C, probe=probe, lead=3)
        want = lat.match_cache_plain(dt, batch, C, probe, 3)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (wrapper.launches, wrapper.launches_f64) == before
    # The default mode: bucket where the table has the buckets.
    assert torch.equal(lat.match_cache(dt, batch)[1],
                       lat.match_cache_plain(dt, batch, probe="bucket")[1])


@pytest.mark.parametrize("case", ["lead", "negative_lead", "mode",
                                  "no_exact_rows", "no_buckets", "dtype"])
def test_probe_checks_refuse(case):
    pt, batch = _small()
    dt = lat.DeviceTables.from_table(pt, "cpu")
    kw = {"C": C}
    if case == "lead":
        kw["lead"] = batch.pad + 1
    elif case == "negative_lead":
        kw["lead"] = -1
    elif case == "mode":
        kw["probe"] = "slow"
    elif case == "no_exact_rows":
        dt = dataclasses.replace(dt, t1_exact=None, t2_exact=None)
        kw["probe"] = "exact"
    elif case == "no_buckets":
        dt = dataclasses.replace(dt, t_bucket=None)
        kw["probe"] = "bucket"
    else:
        kw["dtype"] = torch.float16
    before = lcp.match_probe.launches
    with pytest.raises(ValueError):
        lat.match_cache(dt, batch, **kw)
    with pytest.raises(ValueError):
        lcp.match_probe(dt, batch, kw.get("probe", "fast"),
                        kw.get("lead", 0),
                        dtype=kw.get("dtype", torch.float32))
    assert lcp.match_probe.launches == before


def test_match_probe_refuses_cpu_tensors():
    pt, batch = _small()
    dt = lat.DeviceTables.from_table(pt, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        lcp.match_probe(dt, batch, "bucket")


# ---------------------------------------------------------------------------
# On the card: the kernel against its twin
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [True, False])
@pytest.mark.parametrize("lead", [0, "L", 5])
@pytest.mark.parametrize("mode,dtype", MODES + [("fast", torch.float64)],
                         ids=["bucket", "fast", "exact", "exact64",
                              "fast64"])
@pytest.mark.parametrize("bits", [13, 17, 18, "overflow"])
def test_cuda_match_probe_matches_twin(cuda_device, bits, mode, dtype, lead,
                                       slots):
    """Bits 13 and 17 take the kernel's filtered branch, 18 the gather
    branch; "overflow" is tests/test_torch_probe_filter.py's table of rows
    holding 5-8 entries (bk_bits 5, filtered, the second sector read)."""
    seed = 19 if bits == "overflow" else bits
    if bits == "overflow":
        tables = functools.partial(overflow_table, cuda_device)
        L = tables()[0].max_len
    else:
        vocab = _vocab(bits, 300, max_len=12)
        pt = TokenTable.build([ScoredToken(v, s) for v, s in vocab],
                              min_bits=bits)
        tables = functools.partial(lat.DeviceTables.from_table, pt,
                                   cuda_device)
        L = pt.max_token_len
    if lead == 0:
        batch = lat.prepare_batch(pack_samples(_samples(seed) * 8, width=W),
                                  L, cuda_device)
    else:
        rows, n_valid, has_tail = _chained_rows(seed, L, B=40)
        batch = lat.prepare_chained_batch(rows, n_valid, has_tail, L, W,
                                          cuda_device)
        lead = L if lead == "L" else lead
    for scores_dtype in {dtype, torch.float64 if mode == "exact" else dtype}:
        dt = tables(scores_dtype)
        if bits == "overflow":
            dt = dt[0]
        assert lcp.probe_branch(dt, mode) == (
            "filtered" if mode == "bucket" and bits != 18 else "gather")
        want = lat.match_cache_plain(dt, batch, C, mode, lead, slots, dtype)
        counter = "launches_f64" if dtype == torch.float64 else "launches"
        before = getattr(lcp.match_probe, counter)
        got = lat.match_cache(dt, batch, C=C, probe=mode, lead=lead,
                              slots=slots, dtype=dtype)
        torch.cuda.synchronize()
        assert getattr(lcp.match_probe, counter) == before + 1
        assert got[0].dtype == dtype
        assert torch.equal(got[0], want[0])
        if slots:
            assert torch.equal(got[1], want[1])
        else:
            assert got[1] is None
        assert bool(torch.isfinite(want[0]).any())


@pytest.mark.cuda
def test_cuda_probe_refuses_a_filter_of_another_table(cuda_device):
    """A table holding the filter of another t_bucket (same rows, another
    tensor), or whose t_bucket changed in place after its filter was made,
    launches nothing."""
    pt, _ = _small()
    batch = lat.prepare_batch(pack_samples(_samples(3), width=W),
                              pt.max_token_len, cuda_device)
    dt = lat.DeviceTables.from_table(pt, cuda_device)
    other = lat.DeviceTables.from_table(pt, cuda_device)
    changed = lat.DeviceTables.from_table(pt, cuda_device)
    changed.t_bucket[0, 1] = 0
    before = lcp.match_probe.launches
    for bad in (dataclasses.replace(dt, bk_filter=other.bk_filter), changed):
        with pytest.raises(ValueError, match="filter"):
            lat.match_cache(bad, batch, C=C, probe="bucket")
    assert lcp.match_probe.launches == before
    lat.match_cache(dt, batch, C=C, probe="bucket")
    torch.cuda.synchronize()
    assert lcp.match_probe.launches == before + 1


@pytest.mark.cuda
def test_cuda_fast_probe_rejects_a_t2_slot_collision(cuda_device):
    """tests/test_torch_prep.py's witness on the card: a substring with a
    T2 token's fp2, at its length, lands in that token's T2 slot; the
    kernel's check word, like the twin's, refuses it."""
    token, other = b"fiqsqmg", b"ceot\nsn"
    (f1t, f2t), (f1o, f2o) = (H.host_fingerprints(token),
                              H.host_fingerprints(other))
    assert f2t == f2o and f1t != f1o
    vocab = [ScoredToken(bytes([b]), -10.0)
             for b in sorted(set(token + other + b"x"))]
    vocab.append(ScoredToken(token, -0.5))
    pt = TokenTable.build(vocab)
    tid = len(vocab) - 1
    r1 = int(np.nonzero(pt.t1[:, 3] == tid)[0][0])
    i2 = int(H.host_table_index(np.array([f2t]), np.array([len(token)]),
                                H.IDX_A2, H.IDX_M2, pt.bits)[0])
    assert pt.t2[i2, 3] == np.uint32(0xFFFFFFFF)
    pt.t2[i2] = pt.t1[r1]
    pt.t1[r1] = np.array([0, 0, 0, 0xFFFFFFFF], dtype=np.uint32)
    tbl = lat.DeviceTables.from_table(pt, cuda_device)
    samples = [b"x" + other + b"x", token, b"x" + token + other]
    batch = lat.prepare_batch(pack_samples(samples, width=512), len(token),
                              cuda_device)
    for mode in ("fast", "bucket", "exact"):
        got = lat.match_cache(tbl, batch, probe=mode)
        want = lat.match_cache_plain(tbl, batch, probe=mode)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # Length 7 matches only where the token itself starts.
        assert int(torch.isfinite(got[0][:, len(token) - 1]).sum()) == 2
