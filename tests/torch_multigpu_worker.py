"""One rank of tests/test_torch_multigpu.py: a gloo process on the CPU.

    python tests/torch_multigpu_worker.py MODE RANK WORLD STORE OUT

joins a process group of WORLD ranks through the file store STORE, runs
MODE's checks through the port's entry points and pickles a dict of
results to OUT/rank{RANK}.pkl. The test holds them against the port at
world size 1 (and the JAX package), computed in its own process from the
same seeded data (`corpus`, `small_groups`).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import random
import sys

import torch

# Small row groups (several a corpus, their rows split over the ranks)
# and a small pack cap (a 2 KB sample takes the chained route), set alike
# in the workers and in the test's world-1 runs.
GROUP_BYTES = 1 << 13
ROW_MULT = 8
MAX_ENCODE_WIDTH = 1 << 11
SNIPPET = 128
TIMEOUT_S = 60


def small_groups() -> dict:
    """The estep_device constants the workers and the world-1 references
    share (the test sets them with monkeypatch)."""
    return {"GROUP_BYTES": GROUP_BYTES, "ROW_MULT": ROW_MULT,
            "MAX_ENCODE_WIDTH": MAX_ENCODE_WIDTH}


def corpus(n: int = 160, seed: int = 99):
    """tests/test_multihost.py's vocabulary (60 tokens over b"abcdef ")
    and `n` samples of 5-120 bytes over the same alphabet."""
    rng = random.Random(seed)
    alphabet = b"abcdef "
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0)) for b in alphabet]
    seen = {v for v, _ in vocab}
    while len(vocab) < 60:
        w = bytes(rng.choice(alphabet) for _ in range(rng.randint(2, 6)))
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    samples = [bytes(rng.choice(alphabet) for _ in range(rng.randint(5, 120)))
               for _ in range(n)]
    return vocab, samples


def long_sample(samples) -> bytes:
    """One sample over the encode's pack cap (the chained route)."""
    from tokengeex_tpu_torch.train import estep_device as ed

    text = b"".join(samples)
    while len(text) <= ed.MAX_ENCODE_WIDTH:
        text += text
    return text[: ed.MAX_ENCODE_WIDTH + 777]


def model(vocab):
    from tokengeex_tpu_torch import Model, ScoredToken

    return Model([ScoredToken(v, s) for v, s in vocab])


def shard(samples, rank: int, world: int, empty_rank: int = -1):
    """Disjoint shards samples[r::N]; `empty_rank` holds none (its share
    goes to the next rank)."""
    if empty_rank < 0:
        return samples[rank::world]
    ranks = [r for r in range(world) if r != empty_rank]
    return [] if rank == empty_rank else samples[ranks.index(rank)::len(ranks)]


def prune_kw():
    return dict(vocab_size=45, shrink_factor=0.8, em_subiters=2,
                dropout=0.0, device="cpu", device_dtype=torch.float64)


def pairs(m, samples):
    """The pair count as the merger reads it: `count_pairs_arrays` in
    order, ((a, b), count) by descending count, ties by key."""
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.merge import _pairs_in_order

    return list(_pairs_in_order(*ed.count_pairs_arrays(m, samples,
                                                       device="cpu")))


def vocab_rows(tokens):
    return [(t.value, t.score, t.keep) for t in tokens]


def raises(fn, exc) -> str:
    """The message of `exc` raised by fn(); a collective that hung fails
    the run at the group's timeout instead."""
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError(f"{exc.__name__} not raised")


# -- Modes -------------------------------------------------------------------


def e_steps(vocab, samples, dropouts, seed, **kw):
    """One session's E-step at each dropout (`seed`), closed after."""
    from tokengeex_tpu_torch.train.device_session import DeviceTrainSession

    m = model(vocab)
    sess = DeviceTrainSession(m, samples, SNIPPET, device="cpu", **kw)
    try:
        return [sess.e_step(m, d, seed) for d in dropouts]
    finally:
        sess.close()


def run_estep(rank, world):
    vocab, samples = corpus()
    dropouts = (0.0, 0.05)
    return {f"estep_{d}": e for d, e in zip(dropouts, e_steps(
        vocab, samples, dropouts, 3, dtype=torch.float64))}


@contextlib.contextmanager
def use_route(route: str):
    """Route "slab" keeps the small tables off the fused kernels: the
    has_vscan threshold lowered below every table's bits while it runs."""
    from tokengeex_tpu_torch.ops import lattice as lat

    kept = lat.VSCAN_MAX_BITS
    if route == "slab":
        lat.VSCAN_MAX_BITS = -1
    try:
        yield
    finally:
        lat.VSCAN_MAX_BITS = kept


def run_session_encode(rank, world):
    from tokengeex_tpu_torch import NoPathError, Tokenizer
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.device_session import DeviceTrainSession

    vocab, samples = corpus()
    m = model(vocab)
    out = {}
    for route in ("slab", "fused"):
        with use_route(route):
            sess = DeviceTrainSession(m, samples, SNIPPET, device="cpu")
            out[f"session_{route}"] = [sess.e_step(m, 0.0, 0),
                                       sess.e_step(m, 0.0, 0),
                                       sess.e_step(m, 0.05, 5),
                                       sess.count_frequencies(m)]
            out[f"fused_{route}"] = sess._fused()
            out[f"rows_{route}"] = [sub.rows for _, sub in sess._groups()]
            sess.close()
    both = samples + [long_sample(samples)]
    out["encode"] = ed.encode_corpus_device(m, both, device="cpu")
    out["encode_dropout"] = ed.encode_corpus_device(m, both, dropout=0.3,
                                                    seed=4, device="cpu")
    texts = [s.decode() for s in samples[:40]]
    out["encode_batch"] = Tokenizer(m, device="cpu").encode_batch(texts)
    # A byte outside the vocabulary in one sample: every rank raises.
    bad = samples[:-1] + [samples[-1] + b"\x01"]
    corpus_ = ed.DeviceCorpus(bad, device="cpu", budget=0)
    out["bad_owner"] = any(sp[3] == len(bad) - 1
                           for _, sub in corpus_.groups for sp in sub.spans)
    out["nopath"] = raises(
        lambda: ed.encode_corpus_device(m, bad, device="cpu"), NoPathError)
    out["estep_fail"] = raises(lambda: e_steps(vocab, bad, [0.0], 0),
                               ValueError)
    return out


def run_prune(rank, world):
    from tokengeex_tpu_torch.train import prune
    from tokengeex_tpu_torch.train.device_session import DeviceTrainSession

    vocab, samples = corpus(48, seed=7)
    out = {}
    for sharded in (False, True):
        sessions = []
        orig = DeviceTrainSession.__init__

        def spy(self, *a, **k):
            sessions.append(self)
            orig(self, *a, **k)

        DeviceTrainSession.__init__ = spy
        try:
            pruner = prune.VocabularyPruner(corpus_sharded=sharded,
                                            **prune_kw())
            got = pruner.prune(
                model(vocab),
                shard(samples, rank, world) if sharded else samples)
        finally:
            DeviceTrainSession.__init__ = orig
        out[f"prune_{sharded}"] = vocab_rows(got.vocab)
        out[f"sessions_{sharded}"] = [(s.local_shard, s.dt is None)
                                      for s in sessions]
    return out


def run_merge_generate(rank, world):
    from tokengeex_tpu_torch.train.generate import VocabularyGenerator
    from tokengeex_tpu_torch.train.merge import VocabularyMerger

    vocab, samples = corpus(48, seed=7)
    merger = VocabularyMerger(allow=".*", num_merges=6, step=3,
                              scale_factor=0.9, max_token_length=8,
                              device="cpu")
    out = {"merge": vocab_rows(merger.merge(model(vocab), samples).vocab)}
    out["corpus_rows"] = [sub.rows for _, sub in merger._corpus.groups]
    out["pairs"] = pairs(model(vocab), samples)
    g = VocabularyGenerator(max_token_length=6, insert_probability=1.0,
                            added_tokens=["absent"], seed=0, device="cpu")
    g.feed([s.decode() for s in shard(samples, rank, world)])
    g.allreduce_frequencies()
    out["generate"] = vocab_rows(g.generate(300))
    return out


def run_empty_shard(rank, world):
    from tokengeex_tpu_torch import NoPathError
    from tokengeex_tpu_torch.train import prune
    from tokengeex_tpu_torch.train.device_session import DeviceTrainSession

    vocab, samples = corpus(48, seed=7)
    m = model(vocab)
    mine = shard(samples, rank, world, empty_rank=world - 1)
    sess = DeviceTrainSession(m, mine, SNIPPET, local_shard=True,
                              dtype=torch.float64, device="cpu")
    out = {"local_shard": sess.local_shard, "n_local": len(mine),
           "estep": sess.e_step(m, 0.0, 0),
           "freqs": sess.count_frequencies(m)}
    sess.close()
    out["prune"] = vocab_rows(prune.VocabularyPruner(
        corpus_sharded=True, **prune_kw()).prune(model(vocab), mine).vocab)
    # A byte outside the vocabulary on rank 0's shard alone.
    bad = mine + [b"ab\x01"] if rank == 0 else mine
    sess = DeviceTrainSession(m, bad, SNIPPET, local_shard=True,
                              device="cpu")
    out["estep_fail"] = raises(lambda: sess.e_step(m, 0.0, 0), ValueError)
    out["freq_fail"] = raises(lambda: sess.count_frequencies(m), NoPathError)
    return out


MODES = {"estep": run_estep, "session_encode": run_session_encode,
         "prune": run_prune, "merge_generate": run_merge_generate,
         "empty_shard": run_empty_shard}


def main() -> None:
    mode, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from tokengeex_tpu_torch.parallel import mesh
    from tokengeex_tpu_torch.train import estep_device as ed

    for k, v in small_groups().items():
        setattr(ed, k, v)
    mesh.distributed_initialize("cpu", init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=TIMEOUT_S)
    try:
        assert mesh.process_count() == world
        res = MODES[mode](rank, world)
    finally:
        mesh.shutdown()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
