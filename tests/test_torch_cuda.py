"""The port's CUDA kernels against their plain PyTorch twins, on a GPU.

Every test here is marked `cuda` and skips where no GPU is present (the
kernels have no CPU mode). The file imports only the port, so it runs on
a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import random

import pytest
import torch

from tokengeex_tpu_torch import Model, ScoredToken
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.utils.packing import pack_samples


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _corpus(n_vocab, seed=0, max_len=11):
    rng = random.Random(seed)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "mi", "value",
             "def", "return", "data", "self", "print"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 60))
                        ).encode() for _ in range(300)]
    vocab = [ScoredToken(bytes([b]), rng.uniform(-11.0, -9.0))
             for b in sorted(set(b"".join(samples)))]
    seen = {t.value for t in vocab}
    while len(vocab) < n_vocab:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, max_len)]
        if w not in seen:
            seen.add(w)
            vocab.append(ScoredToken(w, rng.uniform(-9.0, -1.0)))
    return Model(vocab), samples


@pytest.mark.cuda
@pytest.mark.parametrize("L", [5, 16, 40])
def test_cuda_viterbi_chunk_matches_twin(cuda_device, L):
    g = torch.Generator().manual_seed(L)
    C, B = 256, 300
    s = torch.round(torch.empty(C, L, B).uniform_(-12, -1, generator=g) * 2) / 2
    s[torch.rand(C, L, B, generator=g) < 0.4] = lc.NEG
    s[5] = lc.NEG
    starts = (torch.rand(C, B, generator=g) < 0.05).float()
    hist0 = torch.round(torch.empty(L, B).uniform_(-30, 0, generator=g) * 2) / 2
    args = (s, starts, hist0)
    want = lc.viterbi_chunk_plain(*args)
    before = lc.viterbi_chunk.launches
    got = lc.viterbi_chunk(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert lc.viterbi_chunk.launches == before + 1
    for g_, w in zip(got, want):
        assert torch.equal(g_.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout,max_len", [(0.0, 11), (0.3, 11), (0.3, 40)])
def test_cuda_fused_forward_matches_twin(cuda_device, dropout, max_len):
    model, samples = _corpus(600, max_len=max_len)
    tbl = lat.DeviceTables.from_table(TokenTable.build(model.vocab),
                                      cuda_device)
    assert lat.has_vscan(tbl)
    batch = lat.prepare_batch(pack_samples(samples, width=1024,
                                           row_multiple=128),
                              tbl.max_len, cuda_device)
    du = None
    if dropout:
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        du = torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                           generator=gen, dtype=torch.int32,
                           device=cuda_device)
    args = lat.fused_inputs(tbl, batch, du, dropout)
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    want = lcf.fused_forward_chunk_plain("viterbi", *args, **kw)
    got = lcf.fused_forward_chunk("viterbi", *args, **kw)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hints", [None, (16, None)])
def test_cuda_encode_matches_cpu(cuda_device, hints):
    model, samples = _corpus(600, seed=1)
    long = b" ".join(samples)[:3000]
    mixed = samples + [b"", long]
    counts = (lc.viterbi_chunk.launches, lcf.fused_forward_chunk.launches)
    got = ed.encode_corpus_device(model, mixed, table_hints=hints,
                                  max_width=1024, device=cuda_device)
    launched = (lc.viterbi_chunk.launches - counts[0],
                lcf.fused_forward_chunk.launches - counts[1])
    assert launched[1 if hints is None else 0] > 0
    want = ed.encode_corpus_device(model, mixed, table_hints=hints,
                                   max_width=1024, device="cpu")
    assert got == want
    assert all(model.decode_bytes(ids) == s for ids, s in zip(got, mixed))
