"""Encode traffic: a closed loop of `Tokenizer.encode_batch` requests.

Each request hands the tokenizer the next `request_files` files of a
seeded pool as str texts (wrapping at the pool's end) and waits for the
ids; the window closes at the end of the last request begun within
`--seconds`. For the check, each request keeps its longest file and one
file drawn from the seed with their ids.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from gpubench import compare, harness, inputs, kernels_work


def build(config: dict, traffic: dict, seed: int) -> dict:
    files = inputs.build_files(traffic["pool_bytes"], traffic, seed)
    vocab = inputs.build_vocab(config, "encode", files,
                               int(config["vocab_size"]), seed)
    return {"files": files, "texts": [f.decode("utf-8") for f in files],
            "vocab": vocab}


def tokenizer(config: dict, vocab, device):
    from tokengeex_tpu_torch import (Model, ScoredToken, Tokenizer,
                                     load_processors)

    model = Model([ScoredToken(v, s, k) for v, s, k in vocab])
    return Tokenizer(model, load_processors(config["processors"]),
                     config["special_tokens"], device=device)


def requests(texts, n: int):
    """The k-th request's texts: files k n .. k n + n - 1 of the pool,
    wrapping."""
    k = 0
    while True:
        idx = [(k * n + i) % len(texts) for i in range(n)]
        yield idx
        k += 1


def phase_timer(dev):
    """The program's PhaseTimer, each phase also a profiler annotation
    (`phase.<name>`) for the trace's idle gaps."""
    from torch.profiler import record_function
    from tokengeex_tpu_torch.ops.lattice import PhaseTimer

    class Timer(PhaseTimer):
        @contextlib.contextmanager
        def __call__(self, name):
            with record_function("phase." + name), super().__call__(name):
                yield

    return Timer(dev)


def run(ctx: dict) -> dict:
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    dev, trace = ctx["device"], ctx["trace"]
    t = time.perf_counter()
    data = build(config, traffic, seed)
    texts, vocab = data["texts"], data["vocab"]
    tok = tokenizer(config, vocab, dev)
    ctx["log"](f"inputs in {time.perf_counter() - t:.3f} s: "
               f"{len(texts)} files, {len(vocab)} tokens")
    n = int(traffic["request_files"])
    dropout = float(traffic["dropout"])
    nbytes = np.array([len(f) for f in data["files"]], np.int64)
    # Warm-up: one request of the first files and the pool's longest,
    # so that the chained path for files past the pack cap runs too.
    warm = list(range(n - 1)) + [int(nbytes.argmax())]
    t = time.perf_counter()
    tok.encode_batch([texts[i] for i in warm], dropout=dropout,
                     backend="device")
    ctx["sync"]()
    ctx["log"](f"warm-up request in {time.perf_counter() - t:.3f} s")
    ctx["setup_done"]()

    rng = np.random.default_rng(inputs.subseed(seed, inputs.SAMPLE))
    times, done_bytes, kept = [], 0, []
    phases = {}
    attempted = failed = 0
    with harness.Trace(trace) as tr:
        w0 = time.perf_counter()
        for idx in requests(texts, n):
            if time.perf_counter() - w0 >= ctx["seconds"]:
                break
            batch = [texts[i] for i in idx]
            timer = phase_timer(dev) if trace else None
            attempted += 1
            t = time.perf_counter()
            try:
                with harness.annotate("gpubench.request", trace):
                    ids = tok.encode_batch(batch, dropout=dropout,
                                           backend="device", timer=timer)
            except Exception as err:  # the run reports it as failed
                failed += 1
                ctx["log"](f"request {attempted} failed: {err!r}")
                break
            times.append(time.perf_counter() - t)
            done_bytes += int(nbytes[idx].sum())
            longest = int(np.argmax(nbytes[idx]))
            pick = int(rng.integers(len(idx)))
            kept.append((idx[longest], ids[longest]))
            kept.append((idx[pick], ids[pick]))
            if timer is not None:
                for k, v in timer.seconds.items():
                    phases[k] = phases.get(k, 0.0) + v
        window = time.perf_counter() - w0
    ctx["window_closed"]()
    del tok
    out = {"attempted": attempted, "failed": failed,
           "end_to_end": {
               "encode_MBps": done_bytes / window / 1e6,
               "encode_p95_ms": (float(np.percentile(times, 95)) * 1e3
                                 if times else None)}}
    ctx["log"](f"{attempted} requests, {done_bytes} bytes in {window:.3f} s,"
               f" p50 {np.percentile(times, 50) * 1e3:.1f} ms"
               if times else "no request completed")
    # The check: the longest kept files and a seeded sample of the rest.
    chk = traffic["check"]
    order = sorted(range(len(kept)), key=lambda j: -nbytes[kept[j][0]])
    longest = order[: int(chk["longest_files"])]
    rest = [j for j in range(len(kept)) if j not in set(longest)]
    rest = rng.permutation(rest)[: int(chk["random_files"])].tolist()
    sample = [kept[j] for j in longest + rest]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = compare.encode(config, vocab, [texts[i] for i, _ in sample],
                            [ids for _, ids in sample], dev)
    ctx["log"](f"check of {len(sample)} files "
               f"({int(sum(nbytes[i] for i, _ in sample))} bytes) in "
               f"{time.perf_counter() - t:.1f} s")
    out["checks"] = compare.numbers(values, traffic["limits"])
    if trace:
        summary = tr.summary(("gpubench.", "phase."))
        L = int(config["max_token_length"])
        # The processors leave the ASCII corpus as it is: a text's
        # positions are its file's bytes.
        positions = done_bytes
        out["trace"] = {
            "requests": len(times), "request_s": float(sum(times)),
            "phases": phases, "busy_s": summary["busy_s"],
            "window_s": summary["window_s"],
            "kernels": summary["kernels"],
            "bound_s": {
                "match_probe": kernels_work.match_probe(
                    positions, L, len(vocab), len(times)),
                "viterbi_scan": kernels_work.viterbi_scan(positions, L)},
        }
        out["breakdown"] = summary["breakdown"]
    return out
