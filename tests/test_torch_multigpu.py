"""The port's multi-GPU path (parallel/mesh.py) on the CPU, under gloo.

Each test starts two or four ranks of tests/torch_multigpu_worker.py as
processes (`device="cpu"`, a file store under the test's tmp_path, so
that the suite's workers cannot collide on a port; a 60 s collective
timeout and a time limit on every process, so that a hang fails the test)
and holds what they return against the port at world size 1 and the JAX
package, both run in this process on the same seeded data with the same
small row groups (several a corpus, each split over the ranks):

  - the f64 session's E-step, replicated corpus, dropout 0 and 0.05 (2
    and 4 ranks):
    rtol 1e-12 per token against world 1 (only the summation order
    differs), and at dropout 0 rtol 1e-8 / atol 1e-9 against the JAX
    package's f64 E-step (tests/test_torch_f64.py's tolerance);
  - the f32 session on the cached and the fused route, dropout 0 and 0.05:
    counts within rtol 1e-4 / atol 1e-4 per token and 1e-5 on the total,
    frequencies exact;
  - encode (with a sample over MAX_ENCODE_WIDTH, and at dropout 0.3) and
    Tokenizer.encode_batch: ids exact, gathered on every rank;
  - a byte outside the vocabulary: NoPathError (encode) and the E-step's
    ValueError on every rank;
  - prune, replicated and with disjoint corpus shards, f64: tokens, order
    and keep flags exact, scores rtol 1e-12;
  - merge through the multi-process DeviceCorpus and generate on shards
    with allreduce_frequencies: exact;
  - four ranks with one empty shard: the same results, no hang;
  - the CLI's --corpus-sharded generate and prune, two hand-launched ranks
    (the CLI reads torchrun's variables, so that test alone meets on a
    free localhost port).
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from tokengeex_tpu.train import estep_device as jed  # noqa: E402

from tokengeex_tpu_torch import Tokenizer  # noqa: E402
from tokengeex_tpu_torch import cli  # noqa: E402
from tokengeex_tpu_torch.parallel import mesh  # noqa: E402
from tokengeex_tpu_torch.train import estep_device as ed  # noqa: E402
from tokengeex_tpu_torch.train import prune  # noqa: E402
from tokengeex_tpu_torch.train.device_session import (  # noqa: E402
    DeviceTrainSession)
from tokengeex_tpu_torch.train.generate import (  # noqa: E402
    VocabularyGenerator)
from tokengeex_tpu_torch.train.merge import VocabularyMerger  # noqa: E402

import torch_multigpu_worker as W  # noqa: E402
from test_torch_session import _models, one_jax_device  # noqa: E402,F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multigpu_worker.py")
LIMIT_S = 150  # per launch: every rank's whole run


def _run_ranks(cmds, env_of, cwd=None):
    """Start one process a rank, wait for all under LIMIT_S, kill any
    left; every rank must exit 0."""
    procs = [subprocess.Popen(cmd, env=env_of(r), cwd=cwd,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r, cmd in enumerate(cmds)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"


def _launch(tmp_path, mode, world):
    out = tmp_path / "out"
    out.mkdir()
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    _run_ranks([[sys.executable, WORKER, mode, str(r), str(world), str(store),
                 str(out)] for r in range(world)], lambda r: env)
    ranks = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture
def small_groups(monkeypatch):
    for k, v in W.small_groups().items():
        monkeypatch.setattr(ed, k, v)


@pytest.fixture
def world_one_group(tmp_path):
    """A gloo process group of one rank in this process."""
    mesh.distributed_initialize("cpu", init_method=f"file://{tmp_path}/one",
                                world_size=1, rank=0, timeout=60)
    try:
        yield
    finally:
        mesh.shutdown()


def _same_vocab(got, want, rtol):
    assert [t[0] for t in got] == [t[0] for t in want]
    assert [t[2] for t in got] == [t[2] for t in want]
    np.testing.assert_allclose([t[1] for t in got], [t[1] for t in want],
                               rtol=rtol, atol=0)


def _close_counts(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert abs(got.sum() - want.sum()) <= 1e-5 * want.sum()


def test_mesh_helpers_without_a_group():
    """World size 1 without a group: every helper is the identity."""
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    x = np.arange(5, dtype=np.int64)
    assert mesh.all_reduce_counts(x) is x
    np.testing.assert_array_equal(mesh.allgather_ints([7, -1]), [[7, -1]])
    assert mesh.allgather_fail(3, 2.5) == (3, 2.5)
    assert mesh.allgather_pickled({"a": 1}) == [{"a": 1}]
    assert [a.tolist() for a in mesh.allgather_ragged(x)] == [x.tolist()]


@pytest.mark.parametrize("world", [2, 4])
def test_estep_replicated_equals_one_process(tmp_path, small_groups,
                                             one_jax_device, world):
    ranks = _launch(tmp_path, "estep", world)
    vocab, samples = W.corpus()
    jm, m = _models(vocab)
    dropouts = (0.0, 0.05)
    for d, want in zip(dropouts, W.e_steps(vocab, samples, dropouts, 3,
                                           dtype=torch.float64)):
        assert want.sum() > 100
        for r in ranks:
            np.testing.assert_allclose(r[f"estep_{d}"], want, rtol=1e-12,
                                       atol=0)
            np.testing.assert_array_equal(r[f"estep_{d}"],
                                          ranks[0][f"estep_{d}"])
    jax_want = jed.run_e_step_device(jm, samples, 0.0, W.SNIPPET,
                                     dtype=jnp.float64)
    np.testing.assert_allclose(ranks[0]["estep_0.0"], jax_want, rtol=1e-8,
                               atol=1e-9)


def test_session_and_encode_replicated(tmp_path, small_groups):
    a, b = _launch(tmp_path, "session_encode", 2)
    vocab, samples = W.corpus()
    m = W.model(vocab)
    for route in ("slab", "fused"):
        with W.use_route(route):
            sess = DeviceTrainSession(m, samples, W.SNIPPET, device="cpu")
            want = [sess.e_step(m, 0.0, 0), sess.e_step(m, 0.0, 0),
                    sess.e_step(m, 0.05, 5), sess.count_frequencies(m)]
            rows = [sub.rows for _, sub in sess._groups()]
        assert not np.allclose(want[2], want[0], rtol=1e-3)
        assert len(rows) > 1
        for r in (a, b):
            assert r[f"fused_{route}"] == (route == "fused")
            assert r[f"rows_{route}"] == [n // 2 for n in rows]
            # Dropout 0.05 draws each group's coins whole, then slices
            # the rank's rows: the single-process coins.
            for got, w in zip(r[f"session_{route}"][:3], want[:3]):
                _close_counts(got, w)
            np.testing.assert_array_equal(r[f"session_{route}"][3],
                                          want[3])
    both = samples + [W.long_sample(samples)]
    assert len(both[-1]) > ed.MAX_ENCODE_WIDTH
    assert a["encode"] == b["encode"] == ed.encode_corpus_device(
        m, both, device="cpu")
    assert a["encode_dropout"] == b["encode_dropout"] == \
        ed.encode_corpus_device(m, both, dropout=0.3, seed=4, device="cpu")
    texts = [s.decode() for s in samples[:40]]
    assert a["encode_batch"] == b["encode_batch"] == \
        Tokenizer(m, device="cpu").encode_batch(texts)
    # The bad sample lies in one rank's rows; both raise.
    assert a["bad_owner"] != b["bad_owner"]
    for r in (a, b):
        assert r["nopath"].startswith("NoPathError")
        assert r["estep_fail"].startswith("ValueError") and \
            "not finite" in r["estep_fail"]


def test_prune_replicated_and_sharded(tmp_path, small_groups):
    """tests/test_multihost.py's prune settings (60 -> 45 tokens, shrink
    0.8, 2 sub-iterations), f64: one session per prune and rank, closed
    after; disjoint shards samples[r::2] with corpus_sharded."""
    ranks = _launch(tmp_path, "prune", 2)
    vocab, samples = W.corpus(48, seed=7)
    want = W.vocab_rows(prune.VocabularyPruner(**W.prune_kw()).prune(
        W.model(vocab), samples).vocab)
    assert len(want) < 60
    for r in ranks:
        for sharded in (False, True):
            _same_vocab(r[f"prune_{sharded}"], want, 1e-12)
            assert r[f"sessions_{sharded}"] == [(sharded, True)]


def test_merge_and_generate(tmp_path, small_groups):
    ranks = _launch(tmp_path, "merge_generate", 2)
    vocab, samples = W.corpus(48, seed=7)
    merger = VocabularyMerger(allow=".*", num_merges=6, step=3,
                              scale_factor=0.9, max_token_length=8,
                              device="cpu")
    merged = W.vocab_rows(merger.merge(W.model(vocab), samples).vocab)
    assert len(merged) == 66
    pairs = W.pairs(W.model(vocab), samples)
    g = VocabularyGenerator(max_token_length=6, insert_probability=1.0,
                            added_tokens=["absent"], seed=0, device="cpu")
    g.feed([s.decode() for s in samples])
    generated = W.vocab_rows(g.generate(300))
    assert any(t[0] == b"absent" for t in generated)
    rows = [sub.rows for _, sub in merger._corpus.groups]
    for r in ranks:
        assert r["merge"] == merged and r["pairs"] == pairs
        assert r["generate"] == generated
        assert r["corpus_rows"] == [n // 2 for n in rows]


def test_four_ranks_with_an_empty_shard(tmp_path, small_groups):
    ranks = _launch(tmp_path, "empty_shard", 4)
    vocab, samples = W.corpus(48, seed=7)
    m = W.model(vocab)
    sess = DeviceTrainSession(m, samples, W.SNIPPET, dtype=torch.float64,
                              device="cpu")
    estep, freqs = sess.e_step(m, 0.0, 0), sess.count_frequencies(m)
    want = W.vocab_rows(prune.VocabularyPruner(**W.prune_kw()).prune(
        W.model(vocab), samples).vocab)
    assert ranks[3]["n_local"] == 0
    assert sum(r["n_local"] for r in ranks) == len(samples)
    for r in ranks:
        assert r["local_shard"]
        np.testing.assert_allclose(r["estep"], estep, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(r["freqs"], freqs)
        _same_vocab(r["prune"], want, 1e-12)
        assert r["estep_fail"].startswith("ValueError")
        assert r["freq_fail"].startswith("NoPathError")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_corpus_sharded_two_ranks(tmp_path):
    """generate and prune --corpus-sharded, each rank launched by hand
    with its own --train shard and the variables torchrun would set:
    both exit 0, only rank 0 writes -o, and generate's output equals the
    one-process run over the union of the shards."""
    _, samples = W.corpus(48, seed=7)
    texts = [s.decode() for s in samples]
    shards = []
    for r in range(2):
        path = tmp_path / f"shard{r}.bin"
        path.write_bytes("\x00".join(texts[r::2]).encode())
        shards.append(str(path))
    union = tmp_path / "union.bin"
    union.write_bytes("\x00".join(texts).encode())
    gen = ["generate", "-v", "120", "--insert-probability", "1.0",
           "--max-token-length", "6", "--device", "cpu"]

    def ranks(args_of):
        port = str(_free_port())
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port)
        _run_ranks([[sys.executable, "-m", "tokengeex_tpu_torch.cli",
                     *args_of(r)] for r in range(2)],
                   lambda r: dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                   cwd=str(tmp_path))

    ranks(lambda r: [*gen, "-o", str(tmp_path / f"gen{r}.json"),
                     "--train", f"code:{shards[r]}", "--corpus-sharded"])
    assert not (tmp_path / "gen1.json").exists()
    cli.main([*gen, "-o", str(tmp_path / "one.json"), "--train",
              f"code:{union}"])
    assert (tmp_path / "gen0.json").read_bytes() == \
        (tmp_path / "one.json").read_bytes()
    ranks(lambda r: ["prune", "-i", str(tmp_path / "gen0.json"), "-o",
                     str(tmp_path / f"pruned{r}.json"), "-v", "90",
                     "--dropout", "0.0", "--train", f"code:{shards[r]}",
                     "--corpus-sharded", "--device", "cpu"])
    assert (tmp_path / "pruned0.json").exists()
    assert not (tmp_path / "pruned1.json").exists()


def test_world_one_group_is_the_plain_run(small_groups, world_one_group):
    """A process group of one rank: encode gathers its own ids and the
    E-step reduces its own counts, equal to the run without a group."""
    vocab, samples = W.corpus()
    m = W.model(vocab)
    assert mesh.process_count() == 1 and mesh.initialized()
    got = ed.encode_corpus_device(m, samples, device="cpu")
    est = W.e_steps(vocab, samples, [0.05], 1)[0]
    mesh.shutdown()
    assert got == ed.encode_corpus_device(m, samples, device="cpu")
    np.testing.assert_array_equal(est, W.e_steps(vocab, samples, [0.05],
                                                 1)[0])
