"""Merge traffic: a closed loop of merge stage runs.

Each run hands `VocabularyMerger(...).merge` (the public API the CLI's
`merge` uses, on the device backend) a fresh model of the start
vocabulary and the same files, with the configuration's settings, and
waits for the merged model; runs follow back to back and the window
closes at the end of the last run begun within `--seconds`. During a run
the program's pair count (`estep_device.count_pairs_arrays`) is wrapped
so that each pass's model size and the pair arrays it returned are
recorded (the check follows the last run pass by pass); the merged
model's own tokens are the passes' models, since a merge only appends.

The start vocabulary is the configuration's `vocab.merge` rule (the
words rule at 32,768 tokens) filtered by the port's `VocabularyFilter`
to its size, made once in set-up.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import compare, harness, inputs, kernels_work, pairs_work
from gpubench.reference import merge as rm


def build(config: dict, traffic: dict, seed: int) -> dict:
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.train.filter import VocabularyFilter

    files = inputs.build_files(config["train_corpus_bytes"], traffic, seed)
    rule = config["vocab"]["merge"]
    words = inputs.build_vocab(config, "merge", files, int(rule["size"]),
                               seed)
    filt = VocabularyFilter(int(rule["filter"]["vocab_size"]),
                            rule["filter"]["min_score"])
    model = filt.filter(Model(scored(words)))
    vocab = [(t.value, t.score, t.keep) for t in model.vocab]
    return {"files": files, "vocab": vocab}


def scored(vocab):
    from tokengeex_tpu_torch import ScoredToken

    return [ScoredToken(v, s, k) for v, s, k in vocab]


def allow_regex(config: dict) -> str:
    from tokengeex_tpu_torch.train.patterns import (build_allow_regex,
                                                    load_patterns)

    return build_allow_regex(load_patterns(config["allow"]))


def stage_run(config: dict, data: dict) -> tuple:
    """One stage run: (passes, the merged model), each pass (its model's
    size, the pair keys and counts the program's pair count returned)."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.merge import VocabularyMerger

    m = config["merge"]
    merger = VocabularyMerger(
        data["allow"], num_merges=int(config["num_merges"]),
        step=int(m["step"]), scale_factor=float(m["scale_factor"]),
        max_token_length=int(m["max_token_length"]), backend="device",
        device=data["device"])
    passes = []
    count = ed.count_pairs_arrays

    def recorded(model, *args, **kwargs):
        keys, counts = count(model, *args, **kwargs)
        passes.append((model.vocab_size(), keys, counts))
        return keys, counts

    ed.count_pairs_arrays = recorded
    try:
        out = merger.merge(Model(data["tokens"]), data["files"])
    finally:
        ed.count_pairs_arrays = count
    return passes, out


def check(config: dict, traffic: dict, start: list, files, passes: list,
          out, device, log=lambda msg: None) -> dict:
    """Follows one recorded stage run pass by pass: each pass's pair
    counts against the reference's on the same model (pairs_l1, the
    largest over the passes of sum |c - c_ref| / sum c_ref; top_pairs_l1,
    the same over the reference's first `top_pairs` pairs), and each
    pass's merges worked out again from the program's own counts by
    upstream's selection (merges_wrong: tokens whose bytes, score beyond
    1e-9 or order differ, plus any size difference and any pass left
    undone). Also the work counts of each pass for the rooflines."""
    m = config["merge"]
    num, step = int(config["num_merges"]), int(m["step"])
    max_len, scale = int(m["max_token_length"]), float(m["scale_factor"])
    out_v = [(t.value, t.score, t.keep) for t in out.vocab] if out else []
    values = {"pairs_l1": None, "top_pairs_l1": None, "merges_wrong": 0}
    n0 = len(start)
    if not passes or len(out_v) < n0:
        values["merges_wrong"] = num
        return values
    wrong = _tokens_wrong(out_v[:n0], start)
    t = time.perf_counter()
    sizes = [n for n, _, _ in passes]
    ref = rm.pair_counts([[v[:2] for v in out_v[:n]] for n in sizes], files,
                         device)
    log(f"reference pair counts of {len(sizes)} passes in "
        f"{time.perf_counter() - t:.1f} s")
    allow = rm.allow_fn(config["allow"])
    refused: set = set()
    l1 = top = 0.0
    cur, new = n0, None
    for (n, keys, counts), r in zip(passes, ref):
        got = dict(zip(keys.tolist(), counts.tolist()))
        l1 = max(l1, rm.l1(got, r["keys"], r["counts"]))
        top = max(top, rm.top_l1(got, r["keys"], r["counts"],
                                 int(traffic["top_pairs"])))
        if n != cur:  # the pass did not start where the last one ended
            wrong += abs(n - cur)
        model = [v[:2] for v in out_v[:n]]
        new = rm.select(model, keys, counts, min(step, num - (n - n0)),
                        max_len, scale, allow, refused)
        made = out_v[n : n + len(new)]
        bad = _tokens_wrong(made, [(v, s, False) for v, s in new])
        if bad:
            log(f"pass at {n}: {bad} merges differ")
        wrong += bad
        cur = n + len(new)
        if not new:
            break
    # The run ends where the last selection does; one whose last pass
    # made merges short of num_merges left a pass undone.
    wrong += abs(len(out_v) - cur)
    if new and cur < n0 + num:
        wrong += n0 + num - cur
    values.update(pairs_l1=l1, top_pairs_l1=top, merges_wrong=wrong)
    short = np.array([0 < len(f) <= pairs_work.PACK_CAP for f in files])
    values["work"] = [{"short_tokens": int(r["tokens"][short].sum()),
                       "short_spans": int(short.sum()),
                       "short_distinct": int(r["short_distinct"])}
                      for r in ref]
    return values


def _tokens_wrong(got: list, want: list) -> int:
    """Tokens that differ (bytes, keep, or score beyond 1e-9 relative),
    plus the difference in size."""
    bad = abs(len(got) - len(want))
    for (gv, gs, gk), (wv, ws, wk) in zip(got, want):
        if gv != wv or gk != wk or abs(gs - ws) > 1e-9 * max(1.0, abs(ws)):
            bad += 1
    return bad


def run(ctx: dict) -> dict:
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    dev, trace = ctx["device"], ctx["trace"]
    t = time.perf_counter()
    data = build(config, traffic, seed)
    data.update(tokens=scored(data["vocab"]), device=dev,
                allow=allow_regex(config))
    ctx["log"](f"inputs in {time.perf_counter() - t:.3f} s: "
               f"{len(data['files'])} files, {len(data['vocab'])} tokens "
               f"-> {len(data['vocab']) + int(config['num_merges'])}")
    t = time.perf_counter()
    # A program that raises in the warm-up (as one without the exact redo
    # of the bucket probe's false matches does on some seeds) gives a
    # failed run and a whole result line, not a traceback; the window's
    # runs are still made, and stop at their first failure.
    failed = 0
    try:
        stage_run(config, data)  # warm-up
        ctx["sync"]()
        ctx["log"](f"warm-up stage run in {time.perf_counter() - t:.3f} s")
    except Exception as err:  # the run reports it as failed
        failed += 1
        ctx["log"](f"warm-up stage run failed: {err!r}")
    ctx["setup_done"]()

    runs, record, run_s = 0, None, []
    with harness.Trace(trace) as tr:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < ctx["seconds"]:
            # Only the last run's record is checked: the one before goes
            # now, so that no run carries another's objects.
            record = None
            t = time.perf_counter()
            try:
                with harness.annotate("gpubench.stage", trace):
                    record = stage_run(config, data)
                ctx["sync"]()
            except Exception as err:  # the run reports it as failed
                failed += 1
                ctx["log"](f"stage run {runs + 1} failed: {err!r}")
                break
            runs += 1
            run_s.append(time.perf_counter() - t)
        window = time.perf_counter() - w0
    ctx["window_closed"]()
    ctx["log"](f"{runs} stage runs in {window:.3f} s: "
               + ", ".join(f"{s:.3f}" for s in run_s))
    passes, merged = record or ([], None)
    ctx["log"]("the checked run's passes: " + " -> ".join(
        str(n) for n, _, _ in passes) + (f" -> {len(merged.vocab)}"
                                         if merged else ""))
    out = {"attempted": runs + failed, "failed": failed,
           "end_to_end": {"train_stage_s": window / runs if runs else None}}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = check(config, traffic, data["vocab"], data["files"], passes,
                   merged, dev, ctx["log"])
    ctx["log"](f"check in {time.perf_counter() - t:.1f} s")
    work = values.pop("work", [])
    out["checks"] = compare.numbers(values, traffic["limits"])
    if trace:
        try:
            summary = tr.summary(("gpubench.", "tgx."))
        except RuntimeError:  # no device work: every run failed before it
            if not failed:
                raise
            summary = {"busy_s": 0.0, "window_s": window, "kernels": {},
                       "breakdown": None}
        L = int(config["merge"]["max_token_length"])
        positions = sum(len(f) for f in data["files"])
        scan = sum(kernels_work.viterbi_scan(positions, L) for _ in work)
        pairs = sum(pairs_work.pair_insert(w["short_tokens"],
                                           w["short_spans"],
                                           w["short_distinct"])
                    for w in work)
        out["trace"] = {
            "runs": runs, "run_s": float(sum(run_s)),
            "corpus_bytes": positions, "busy_s": summary["busy_s"],
            "window_s": summary["window_s"], "kernels": summary["kernels"],
            # Every run makes the same passes: the bound of the checked
            # run's passes, once a run.
            "bound_s": {"viterbi_scan": scan * runs,
                        "pair_insert": pairs * runs}}
        out["breakdown"] = summary["breakdown"]
    return out
