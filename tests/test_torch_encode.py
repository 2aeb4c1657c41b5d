"""The port's batched Viterbi encode, end to end on the CPU, against the
JAX package's device encode: equal ids on both kernel routes, empty
samples, NoPath and chained long samples; dropout by its properties;
the Tokenizer on a checkpoint saved by the JAX package; and the port's
isolation from JAX."""

import ast
import pathlib
import random
import subprocess
import sys

import pytest
import torch

import jax.numpy as jnp

import tokengeex_tpu as jtg
from tokengeex_tpu.train import estep_device as jed

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.ops import lattice_cuda as lc
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
from tokengeex_tpu_torch.train import estep_device as ed

# The suite runs in several worker processes at once; torch's default
# intra-op thread pool per worker would oversubscribe the cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
# Default tables take the fused route; bits = 16 forces the slab route.
ROUTES = {"fused": None, "slab": (16, None)}


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


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encode_matches_jax(corpus, route):
    jmodel, model, samples = corpus
    hints = ROUTES[route]
    mixed = samples + [b"", samples[3]]
    want = jed.encode_corpus_device(jmodel, mixed, dtype=jnp.float32,
                                    table_hints=hints)
    counts = (lc.viterbi_chunk.launches, lcf.fused_forward_chunk.launches)
    got = ed.encode_corpus_device(model, mixed, table_hints=hints,
                                  device="cpu")
    assert got == want
    assert got[-2] == []
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert counts == (lc.viterbi_chunk.launches,
                      lcf.fused_forward_chunk.launches)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encode_chained_matches_jax(corpus, route):
    jmodel, model, samples = corpus
    hints = ROUTES[route]
    rng = random.Random(31)
    long1 = "".join(rng.choice("abcdef ()") for _ in range(1500)).encode()
    long2 = "".join(rng.choice("abcdef ()") for _ in range(2131)).encode()
    mixed = [samples[0], long1, b"", long2, samples[1]]
    want = jed.encode_corpus_device(jmodel, mixed, dtype=jnp.float32,
                                    table_hints=hints, max_width=512)
    got = ed.encode_corpus_device(model, mixed, table_hints=hints,
                                  max_width=512, device="cpu")
    assert got == want
    assert got == [model.oracle.encode(s) for s in mixed]


@pytest.mark.parametrize("max_width", [None, 512])
def test_encode_no_path_raises(corpus, max_width):
    _, model, samples = corpus
    bad = samples[0][:100] + b"zzz" + b"abcdef" * 120  # 'z' not in vocab
    with pytest.raises(tg.NoPathError):
        ed.encode_corpus_device(model, [samples[1], bad],
                                max_width=max_width, device="cpu")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encode_dropout_properties(corpus, route):
    _, model, samples = corpus
    hints = ROUTES[route]
    sub = samples[:6] + ["ab" * 700]
    sub = [s if isinstance(s, bytes) else s.encode() for s in sub]
    kw = dict(table_hints=hints, max_width=512, device="cpu")
    # dropout=1.0 forbids every multi-byte token (src/model.rs:218-236).
    ones = ed.encode_corpus_device(model, sub, dropout=1.0, **kw)
    assert [len(ids) for ids in ones] == [len(s) for s in sub]
    a = ed.encode_corpus_device(model, sub, dropout=0.5, seed=3, **kw)
    b = ed.encode_corpus_device(model, sub, dropout=0.5, seed=3, **kw)
    assert a == b
    assert all(model.decode_bytes(ids) == s for ids, s in zip(a, sub))
    assert a != ed.encode_corpus_device(model, sub, **kw)


def test_f64_mode_not_ported(corpus):
    _, model, samples = corpus
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ed.encode_corpus_device(model, samples[:2], dtype=torch.float64,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ed.encode_corpus_device(model, samples[:2], probe="exact",
                                device="cpu")


def test_tokenizer_matches_jax_checkpoint(tmp_path):
    vocab = [jtg.ScoredToken(bytes([b]), -10.0) for b in range(256)]
    vocab += [jtg.ScoredToken(w, -3.0)
              for w in (b"def ", b"return", b" x", b"f()", b"\xe4\xbd")]
    jtok = jtg.Tokenizer(jtg.Model(vocab), jtg.load_processors(["crlf"]),
                         ["<|eos|>", "<|pad|>"])
    path = tmp_path / "tok.json"
    jtok.save(str(path))
    tok = tg.Tokenizer.from_file(str(path), device="cpu")
    assert tok.to_string() == jtok.to_string()
    texts = ["def f():<|eos|>return x", "return<|eos|>", "<|eos|>", "",
             "a\r\nb<|pad|>你 x"]
    got = tok.encode_batch(texts, backend="device")
    assert got == jtok.encode_batch(texts, backend="device")
    assert got == tok.encode_batch(texts, backend="oracle")
    got_ord = tok.encode_ordinary_batch(texts, backend="device")
    assert got_ord == jtok.encode_ordinary_batch(texts, backend="device")
    assert [tok.decode(ids, include_special_tokens=True) for ids in got] \
        == [jtok.decode(ids, include_special_tokens=True) for ids in got]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tok.encode_batch(texts, backend="auto")


def test_entry_points_need_a_device_without_cuda(corpus, monkeypatch):
    _, model, samples = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ed.encode_corpus_device(model, samples[:2])
    tok = tg.Tokenizer(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tok.encode_batch(["abc"])


def test_import_leaves_no_jax():
    code = ("import sys, tokengeex_tpu_torch, tokengeex_tpu_torch.train."
            "estep_device, tokengeex_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tokengeex_tpu' or "
            "m.startswith('tokengeex_tpu.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "tokengeex_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tokengeex_tpu"), (path, mod)
