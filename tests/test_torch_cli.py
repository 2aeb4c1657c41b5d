"""The port's CLI against the JAX package's, on the CPU.

Both CLIs run in-process over the corpus of tests/test_cli.py, the JAX
one on its pure-Python routes (its native runtime patched off, as the
port has none), the port's with `--device cpu` (the kernels' plain
PyTorch versions). Outputs that do not go through f32 arithmetic --
regex, generate at p = 1, filter, mine, encode and decode -- must equal
byte for byte; prune and merge keep the same tokens as the JAX CLI's f64
oracle backend, scores within rtol 1e-4.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import tokengeex_tpu as jtg
from tokengeex_tpu import cli as jcli
from tokengeex_tpu.utils import nativelib

from tokengeex_tpu_torch import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_cli.py's corpus (seed 5): checked to leave every prune
    and merge decision outside f32 error."""
    tmp = tmp_path_factory.mktemp("corpus")
    rng = random.Random(5)
    words = ["def", "return", "value", "data", "print", "import"]
    samples = [
        " ".join(rng.choice(words) for _ in range(rng.randint(3, 12)))
        for _ in range(80)
    ]
    path = tmp / "train.bin"
    path.write_bytes(b"\x00".join(s.encode() for s in samples))
    (tmp / "added.json").write_text(json.dumps(["<|tab|>", "def value"]))
    (tmp / "suggested.json").write_text(json.dumps(["print(", "data"]))
    (tmp / "split.regex").write_text(r"\s+|\S+")
    return tmp, str(path)


@pytest.fixture
def pure_python_jax(monkeypatch):
    """The JAX package without its native runtime."""
    monkeypatch.setattr(nativelib, "get_lib", lambda: None)
    monkeypatch.setattr(jtg.Model, "native", lambda self: None)


def run_port(*args):
    random.seed(0)  # the sample shuffle of prune, merge and mine
    cli.main([*args, "--device", "cpu"])


def run_jax(*args):
    random.seed(0)
    jcli.main(list(args))


def _both(tmp, name, *args):
    """Run one subcommand through both CLIs, `{out}` in `args` naming
    each one's output file; returns the two paths."""
    paths = []
    for tag, run in (("port", run_port), ("jax", run_jax)):
        out = str(tmp / f"{name}.{tag}")
        run(*(a.format(out=out) for a in args))
        paths.append(out)
    return paths


def _same_bytes(paths):
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b
    return a


def test_regex_file_and_list_match_jax(corpus, pure_python_jax, capsys):
    tmp, _ = corpus
    _same_bytes(_both(tmp, "allow", "regex", "-o", "{out}", "-p",
                      "space-lowercase-word", "-p", "any-char"))
    run_port("regex")
    port = capsys.readouterr().out
    run_jax("regex")
    assert port == capsys.readouterr().out and "lowercase-word" in port


def _allow(tmp):
    path = tmp / "space-word.regex"
    if not path.exists():
        run_port("regex", "-o", str(path), "-p", "space-lowercase-word")
    return str(path)


@pytest.mark.parametrize("split", [False, True])
def test_generate_matches_jax(corpus, pure_python_jax, split):
    tmp, train = corpus
    extra = ["--split", str(tmp / "split.regex")] if split else []
    text = _same_bytes(_both(
        tmp, f"v0-{split}", "generate", "-v", "400", "-o", "{out}",
        "--train", f"code:{train}", "--processor", "crlf",
        "--allow", _allow(tmp), "--insert-probability", "1.0",
        "--max-token-length", "8", "--special", "<|eos|>",
        "--added", str(tmp / "added.json"),
        "--suggested", str(tmp / "suggested.json"), *extra))
    obj = json.loads(text)
    assert obj["special_tokens"] == ["<|eos|>"]
    assert 300 < len(obj["vocab"]) <= 400


def _vocab0(tmp, train):
    path = tmp / "v0.json"
    if not path.exists():
        run_jax("generate", "-v", "400", "-o", str(path), "--train",
                f"code:{train}", "--processor", "crlf", "--allow",
                _allow(tmp), "--insert-probability", "1.0",
                "--max-token-length", "8", "--special", "<|eos|>")
    return str(path)


def test_filter_matches_jax(corpus, pure_python_jax):
    tmp, train = corpus
    text = _same_bytes(_both(tmp, "filtered", "filter", "-i",
                             _vocab0(tmp, train), "-o", "{out}", "-v", "290",
                             "--min-score", "-5.0"))
    assert len(json.loads(text)["vocab"]) < len(_tokens(_vocab0(tmp, train)))


def test_mine_matches_jax_re_route(corpus, pure_python_jax):
    tmp, train = corpus
    text = _same_bytes(_both(tmp, "idioms", "mine", "-n", "5", "-o", "{out}",
                             "--train", f"code:{train}", "-p", r"[a-z]+",
                             "-p", r" [a-z]+"))
    assert len(json.loads(text)) == 5


def test_encode_decode_match_jax(corpus, pure_python_jax, capsys):
    tmp, train = corpus
    vocab = _vocab0(tmp, train)
    text = "def return value<|eos|>print data\r\nimport"
    run_port("encode", "-v", vocab, "-i", text)
    port = capsys.readouterr().out
    run_jax("encode", "-v", vocab, "-i", text)
    assert port == capsys.readouterr().out
    ids = json.loads(port)
    assert len(ids) > 3
    for given in (json.dumps(ids), ",".join(map(str, ids))):
        run_port("decode", "-v", vocab, "-i", given)
        port = capsys.readouterr().out
        run_jax("decode", "-v", vocab, "-i", given)
        assert port == capsys.readouterr().out
    assert port.rstrip("\n") == text.replace("\r\n", "\n")


def _tokens(path):
    return [(t["value"], t["score"], t.get("keep", False))
            for t in json.load(open(path))["vocab"]]


def _same_tokens(port_path, jax_path, ordered=True):
    got, want = _tokens(port_path), _tokens(jax_path)
    if not ordered:
        got, want = sorted(got), sorted(want)
    assert [(v, k) for v, _, k in got] == [(v, k) for v, _, k in want]
    np.testing.assert_allclose([s for _, s, _ in got],
                               [s for _, s, _ in want], rtol=1e-4)
    return got


@pytest.fixture(scope="module")
def syllables(tmp_path_factory):
    """A corpus of words made of syllables, so that prune and merge have
    choices to make. Seed 3 was checked to leave every decision (Viterbi
    paths, the M-step's 0.5 threshold, the loss ranking, the pair counts)
    outside f32 error."""
    tmp = tmp_path_factory.mktemp("syllables")
    rng = random.Random(3)
    parts = ["an", "er", "ti", "on", "ra", "lo", "de", "mi", "ka", "su"]
    words = ["".join(rng.choice(parts) for _ in range(rng.randint(1, 3)))
             for _ in range(40)]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(3, 20)))
               for _ in range(80)]
    path = tmp / "train.bin"
    path.write_bytes(b"\x00".join(s.encode() for s in samples))
    vocab0 = str(tmp / "v0.json")
    run_jax("generate", "-v", "600", "-o", vocab0, "--train",
            f"code:{path}", "--insert-probability", "1.0",
            "--max-token-length", "6")
    return tmp, str(path), vocab0


def test_prune_and_merge_match_jax_oracle(syllables, pure_python_jax):
    tmp, train, vocab0 = syllables
    port = str(tmp / "v1.port")
    want = str(tmp / "v1.jax")
    run_port("prune", "-i", vocab0, "-o", port, "-v", "300", "--train",
             f"code:{train}", "--dropout", "0.0")
    run_jax("prune", "-i", vocab0, "-o", want, "-v", "300", "--train",
            f"code:{train}", "--dropout", "0.0", "--backend", "oracle")
    assert len(_same_tokens(port, want)) == 300
    # Every merge starts from the JAX prune's vocabulary. Equal pair
    # counts are ordered by key on the device and by first occurrence on
    # the oracle (as in the JAX package), so the device run adds the same
    # tokens in another order within a step; the port's oracle backend
    # adds them in the same order.
    merge = ["merge", "-i", want, "--train", f"code:{train}", "--allow",
             _allow(tmp), "--num-merges", "12", "--step", "4"]
    want = str(tmp / "v2.jax")
    run_jax(*merge, "-o", want, "--backend", "oracle")
    for backend, ordered in (("device", False), ("oracle", True)):
        port = str(tmp / f"v2.{backend}")
        run_port(*merge, "-o", port, "--backend", backend)
        assert len(_same_tokens(port, want, ordered)) == 312


@pytest.mark.parametrize("argv", [
    ["prune", "--backend", "auto"], ["prune", "--backend", "native"],
    ["merge", "--backend", "auto"], ["merge", "--backend", "native"],
    ["prune", "--corpus-sharded"], ["generate", "--corpus-sharded"],
])
def test_unported_options_raise(corpus, pure_python_jax, argv):
    """`--backend auto` / `native` raise (not part of the port);
    `--corpus-sharded`, refused until multi-GPU was ported, runs, and in
    one process (world size 1: the shard is the corpus) writes the
    unsharded run's output byte for byte (tests/test_torch_multigpu.py
    runs it in two ranks)."""
    tmp, train = corpus
    vocab0 = _vocab0(tmp, train)
    cmd, *rest = argv
    out = str(tmp / f"x-{cmd}.json")
    args = {
        "prune": ["-i", vocab0, "-o", out, "-v", "300", "--dropout", "0.0"],
        "merge": ["-i", vocab0, "-o", out, "--allow", _allow(tmp)],
        "generate": ["-v", "300", "-o", out, "--insert-probability", "1.0",
                     "--max-token-length", "8"],
    }[cmd]
    if "--corpus-sharded" not in rest:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_port(cmd, *args, "--train", f"code:{train}", *rest)
        return
    run_port(cmd, *args, "--train", f"code:{train}", *rest)
    sharded = open(out, "rb").read()
    run_port(cmd, *args, "--train", f"code:{train}")
    assert open(out, "rb").read() == sharded
    assert 256 < len(json.loads(sharded)["vocab"]) <= 300


def test_cli_exits_without_a_device(monkeypatch, capsys):
    """The subcommands that use the card exit non-zero without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["generate", "-v", "10", "-o", "x.json"],
                 ["encode", "-v", "x.json", "-i", "a"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code not in (0, None)
        assert "device='cpu'" in str(exc.value.code)


def test_cli_regex_needs_no_device(monkeypatch, capsys, tmp_path):
    """regex, filter, mine and decode resolve no device: regex runs with
    no GPU and no --device, creates no CUDA context, and in a process of
    its own imports no torch."""
    code = ("import sys; import tokengeex_tpu_torch.cli as c; "
            "c.main(['regex']); assert 'torch' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert "lowercase-word" in r.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_context(*a, **k):
        raise AssertionError("regex touched the CUDA device")

    monkeypatch.setattr(torch.cuda, "current_device", no_context)
    monkeypatch.setattr(torch.cuda, "init", no_context)
    cli.main(["regex"])
    assert "lowercase-word" in capsys.readouterr().out
    out = tmp_path / "allow.regex"
    cli.main(["regex", "-o", str(out), "-p", "space-lowercase-word"])
    assert out.read_text()


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "tokengeex_tpu_torch.cli", "regex",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "lowercase-word" in r.stdout
    if not torch.cuda.is_available():
        r = subprocess.run(
            [sys.executable, "-m", "tokengeex_tpu_torch.cli", "encode",
             "-v", "x.json", "-i", "a"],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        assert r.returncode != 0 and "device='cpu'" in r.stderr
