"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (reference/), each number beside its limit
(the traffic file's `limits`, set from the readings in PERF.md)."""

from __future__ import annotations

import time
import unicodedata
from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import lattice as rl
from .reference import prune as rp


def preprocess(text: str, config: dict) -> bytes:
    """The configuration's processors, as upstream src/processor.rs."""
    for name in config["processors"]:
        if name == "crlf":
            text = text.replace("\r\n", "\n")
        else:
            text = unicodedata.normalize(name.upper(), text)
    for special in config["special_tokens"]:
        if special in text:
            raise ValueError("a special token in a checked text")
    return text.encode("utf-8")


def numbers(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    return {k: (values[k], limits[k]) for k in limits}


def within(checks: dict) -> bool:
    return all(v is not None and v <= lim for v, lim in checks.values())


def encode(config: dict, vocab: List[tuple], texts: Sequence[str],
           ids: Sequence[List[int]], device) -> Dict[str, float]:
    """ids_wrong: texts whose ids do not spell the processed text;
    score_gap: the widest relative gap by which a path's score lies below
    the best segmentation's."""
    data = [preprocess(t, config) for t in texts]
    tokens = [t[0] for t in vocab]
    scores = torch.tensor([t[1] for t in vocab], dtype=torch.float64,
                          device=device)
    best, _ = rl.encode(data, rl.Lookup(tokens, device), scores,
                        want_ids=False)
    sc = np.array([t[1] for t in vocab])
    wrong, gap = 0, 0.0
    for d, b, got in zip(data, best, ids):
        got = list(got)
        if any(not 0 <= i < len(tokens) for i in got) or \
                b"".join(tokens[i] for i in got) != d:
            wrong += 1
            continue
        s = float(sc[got].sum()) if got else 0.0
        gap = max(gap, (b - s) / max(1.0, abs(b)))
    return {"ids_wrong": wrong, "score_gap": gap}


def _as_tuples(model) -> List[tuple]:
    if isinstance(model, list):
        return model
    return [(t.value, t.score, t.keep) for t in model.vocab]


def _vocab_wrong(got: List[tuple], want: List[tuple]) -> int:
    """Tokens that differ (bytes, keep, or score beyond 1e-9 relative),
    plus the difference in size."""
    n = min(len(got), len(want))
    bad = abs(len(got) - len(want))
    for (gv, gs, gk), (wv, ws, wk) in zip(got[:n], want[:n]):
        if gv != wv or gk != wk or abs(gs - ws) > 1e-9 * max(1.0, abs(ws)):
            bad += 1
    return bad


def _first_difference(got: List[tuple], want: List[tuple]) -> str:
    for i, (g, w) in enumerate(zip(got, want)):
        if g[0] != w[0] or g[2] != w[2] or \
                abs(g[1] - w[1]) > 1e-9 * max(1.0, abs(w[1])):
            return f"first at {i}: {g!r} against {w!r}"
    return f"sizes {len(got)} against {len(want)}"


def l1(got: np.ndarray, ref: np.ndarray) -> float:
    """sum |got - ref| / sum ref; infinite where the shapes differ."""
    got = np.asarray(got, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    return float(np.abs(got - ref).sum() / ref.sum())


def length_l1(vocab: List[tuple], got: np.ndarray, ref: np.ndarray) -> float:
    """sum over token lengths l of |sum_l got - sum_l ref| / sum ref: the
    counts' split over token lengths, which the dropout coins hardly move
    (each length's sum runs over millions of entries) and which dropping
    the dropout, or scaling the counts, moves by percents."""
    lens = np.array([len(t[0]) for t in vocab])
    got = np.asarray(got, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    return float(np.abs(np.bincount(lens, weights=got)
                        - np.bincount(lens, weights=ref)).sum() / ref.sum())


def alternatives_wrong(vocab: List[tuple], keep_p, alts_p, device) -> int:
    """Tokens whose keep flag or alternative disagrees with the
    reference's nbest(2), where the two best scores do not tie within
    1e-9: a kept token's alternative has to spell the token and score as
    the reference's second best."""
    keep_r, _, s_w, s_m = rp.alternatives(vocab, device)
    tokens = [t[0] for t in vocab]
    sc = np.array([t[1] for t in vocab])
    keep_p = np.asarray(keep_p, bool)
    if keep_p.shape[0] != len(vocab) or len(alts_p) != len(vocab):
        return abs(keep_p.shape[0] - len(vocab)) + len(vocab)
    tol = 1e-9 * np.maximum(1.0, np.abs(s_w))
    has_m = np.isfinite(s_m)
    tie = has_m & (np.abs(s_w - s_m) <= tol)
    bad = int(((keep_p != keep_r) & ~tie).sum())
    for i in np.flatnonzero(keep_p == keep_r).tolist() + \
            np.flatnonzero((keep_p != keep_r) & tie).tolist():
        alt = alts_p[i]
        if keep_p[i] and has_m[i]:
            if (len(alt) < 2 or any(not 0 <= a < len(tokens) for a in alt)
                    or b"".join(tokens[a] for a in alt) != tokens[i]
                    or abs(sc[alt].sum() - s_m[i]) > tol[i]):
                bad += 1
        elif alt:
            bad += 1
    return bad


def prune(config: dict, start: List[tuple], files: Sequence[bytes],
          events: list, target: int, coins: int, device,
          log=lambda msg: None) -> dict:
    """Follows one recorded stage run step by step from its start:
    estep_l1, the largest over the E-steps of sum |E - E_ref| / sum E_ref,
    each E-step's counts against the reference's on the same model at the
    same dropout (its own coins), and estep_len_l1, the same over the
    counts summed by token length (`length_l1`); each M-step and each
    round's removal worked out again from the program's counts
    (vocab_wrong, with every model the program used and the one it
    returned), each round's alternatives (alternatives_wrong) and
    frequencies (freq_l1, the largest over the rounds, against the
    reference's Viterbi counts). `hits` is each token's lattice entries
    under the start model, for the roofline's work."""
    p = config["prune"]
    e_steps = [v for k, _, v in events if k == "e_step"]
    out = {"estep_l1": None, "estep_len_l1": None, "freq_l1": None,
           "alternatives_wrong": None, "vocab_wrong": 0, "hits": None}
    if not e_steps:
        out["vocab_wrong"] = len(start)
        return out
    if not any(k == "output" for k, _, _ in events):
        out["vocab_wrong"] = len(start)  # the stage returned no model
    gen = torch.Generator(device=device).manual_seed(coins)
    out["estep_l1"] = out["estep_len_l1"] = 0.0
    cur = start
    keep_p = alts_p = freqs_p = None
    for kind, model, value in events:
        t = time.perf_counter()
        model = _as_tuples(model)
        if kind == "output":
            # A stage that stops above its target left rounds undone.
            bad = _vocab_wrong(model, cur) + max(0, len(cur) - target)
            if bad:
                log(f"output: {bad} wrong ({len(model)} tokens returned, "
                    f"{len(cur)} by the reference, target {target}); "
                    + _first_difference(model, cur))
            out["vocab_wrong"] += bad
            continue
        if kind == "round":
            if freqs_p is None or keep_p is None:
                out["vocab_wrong"] += len(model) or 1
                continue
            cur = rp.select(cur, freqs_p, keep_p, alts_p, len(files),
                            target, float(p["shrink_factor"]))
            bad = _vocab_wrong(model, cur)
            if bad:
                log(f"round: {bad} tokens differ; "
                    + _first_difference(model, cur))
            out["vocab_wrong"] += bad
            keep_p = alts_p = freqs_p = None
            continue
        bad = _vocab_wrong(model, cur)
        if bad:
            log(f"{kind}: {bad} tokens of its model differ; "
                + _first_difference(model, cur))
        out["vocab_wrong"] += bad
        if kind == "e_step":
            got = np.asarray(value, np.float64)
            if got.shape != (len(cur),):
                out["vocab_wrong"] += len(cur)
                out["estep_l1"] = out["estep_len_l1"] = float("inf")
                return out
            ref, hits = rp.e_step(cur, files, float(p["dropout"]), gen,
                                  device)
            if out["hits"] is None:
                out["hits"] = hits
            out["estep_l1"] = max(out["estep_l1"], l1(got, ref))
            out["estep_len_l1"] = max(out["estep_len_l1"],
                                      length_l1(cur, got, ref))
            cur = rp.m_step(cur, got)
        elif kind == "alternatives":
            keep_p, alts_p = value
            out["alternatives_wrong"] = (out["alternatives_wrong"] or 0) \
                + alternatives_wrong(cur, keep_p, alts_p, device)
        elif kind == "frequencies":
            freqs_p = np.asarray(value, np.int64)
            out["freq_l1"] = max(out["freq_l1"] or 0.0, l1(
                freqs_p, rp.frequencies(cur, files, device)))
        log(f"reference {kind} in {time.perf_counter() - t:.2f} s")
    return out
