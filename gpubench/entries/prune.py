"""Prune traffic: a closed loop of prune stage runs.

Each run hands `VocabularyPruner.prune` a fresh model of the start
vocabulary and the same files, with the configuration's settings, and
waits for the pruned model; runs follow back to back and the window
closes at the end of the last run begun within `--seconds`. A subclass
of the pruner records what each pass returned (the check follows the
last run step by step) and, in traced runs, times the session build, the
E-steps, the frequency passes and the alternatives, synchronising at
each boundary.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from gpubench import compare, harness, inputs, kernels_work


def build(config: dict, traffic: dict, seed: int) -> dict:
    files = inputs.build_files(config["train_corpus_bytes"], traffic, seed)
    start, target = inputs.prune_sizes(config, traffic)
    vocab = inputs.build_vocab(config, "prune", files, start, seed)
    return {"files": files, "vocab": vocab, "target": target}


def scored(vocab):
    from tokengeex_tpu_torch import ScoredToken

    return [ScoredToken(v, s, k) for v, s, k in vocab]


def pruner_class():
    from tokengeex_tpu_torch.train.prune import VocabularyPruner

    class Recorder(VocabularyPruner):
        """Records each pass's result in `events` as (kind, model,
        value); with `spans` a dict, times the passes into it."""

        events: list
        spans: object = None
        sync: object = None

        def _span(self, name, fn, *args):
            with harness.span("gpubench." + name, self.spans, self.sync):
                return fn(*args)

        def _new_session(self, model, samples):
            return self._span("session", super()._new_session, model,
                              samples)

        def run_e_step(self, model, samples):
            out = self._span("e_step", super().run_e_step, model, samples)
            self.events.append(("e_step", model, out))
            return out

        def _count_frequencies(self, model, samples, task):
            out = self._span("frequencies", super()._count_frequencies,
                             model, samples, task)
            self.events.append(("frequencies", model, out))
            return out

        def _alternatives(self, model):
            out = self._span("alternatives", super()._alternatives, model)
            self.events.append(("alternatives", model, out))
            return out

    return Recorder


def stage_run(cls, config: dict, data: dict, seed: int, spans=None,
              sync=None) -> list:
    """One stage run; returns its events, the rounds' models and the
    returned one included."""
    from tokengeex_tpu_torch import Model

    p = config["prune"]
    pruner = cls(vocab_size=data["target"],
                 shrink_factor=float(p["shrink_factor"]),
                 em_subiters=int(p["em_subiters"]),
                 dropout=float(p["dropout"]),
                 seed=inputs.subseed(seed, inputs.PRUNER),
                 device=data["device"])
    pruner.events, pruner.spans, pruner.sync = [], spans, sync
    model = Model(data["tokens"])
    out = pruner.prune(model, data["files"], checkpoint_cb=lambda m, r:
                       pruner.events.append(("round", m, None)))
    pruner.events.append(("output", out, None))
    return pruner.events


def run(ctx: dict) -> dict:
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    dev, trace = ctx["device"], ctx["trace"]
    t = time.perf_counter()
    data = build(config, traffic, seed)
    data["tokens"] = scored(data["vocab"])
    data["device"] = dev
    cls = pruner_class()
    ctx["log"](f"inputs in {time.perf_counter() - t:.3f} s: "
               f"{len(data['files'])} files, {len(data['vocab'])} tokens "
               f"-> {data['target']}")
    t = time.perf_counter()
    stage_run(cls, config, data, seed)  # warm-up
    ctx["sync"]()
    ctx["log"](f"warm-up stage run in {time.perf_counter() - t:.3f} s")
    ctx["setup_done"]()

    spans = defaultdict(float) if trace else None
    runs, events, failed, run_s = 0, None, 0, []
    with harness.Trace(trace) as tr:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < ctx["seconds"]:
            # Only the last run's record is checked: the one before goes
            # now, so that no run carries another's objects.
            events = None
            t = time.perf_counter()
            try:
                with harness.annotate("gpubench.stage", trace):
                    events = stage_run(cls, config, data, seed, spans,
                                       ctx["sync"] if trace else None)
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
    ctx["log"]("the checked run's models: " + " -> ".join(
        f"{kind} {len(model.vocab)}" for kind, model, _ in events or []
        if kind in ("e_step", "round")))
    out = {"attempted": runs + failed, "failed": failed,
           "end_to_end": {"train_stage_s": window / runs if runs else None}}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = compare.prune(config, data["vocab"], data["files"],
                           events or [], data["target"],
                           inputs.subseed(seed, inputs.REF_COINS), dev,
                           ctx["log"])
    ctx["log"](f"check in {time.perf_counter() - t:.1f} s")
    hits = values.pop("hits")
    out["checks"] = compare.numbers(values, traffic["limits"])
    if trace:
        summary = tr.summary(("gpubench.",))
        L = int(config["max_token_length"])
        positions = sum(len(f) for f in data["files"])
        dropout = float(config["prune"]["dropout"]) > 0
        by_id = {v: i for i, (v, _, _) in enumerate(data["vocab"])}
        fwd = seg = 0.0
        for kind, model, _ in events or []:
            if kind != "e_step":
                continue
            tokens = [t.value for t in model.vocab]
            h = int(hits[[by_id[v] for v in tokens]].sum()) \
                if hits is not None else 0
            fwd += kernels_work.forward_scan(positions, L, dropout)
            seg += kernels_work.seg_weights_gather(positions, h,
                                                   len(tokens), dropout)
        out["trace"] = {
            "runs": runs, "run_s": float(sum(run_s)),
            "spans": dict(spans), "busy_s": summary["busy_s"],
            "window_s": summary["window_s"],
            "kernels": summary["kernels"],
            # Every run does the same passes: the bound of the checked
            # run's E-steps, once a run.
            "bound_s": {"forward_scan": fwd * runs,
                        "seg_weights_gather": seg * runs}}
        out["breakdown"] = summary["breakdown"]
    return out
