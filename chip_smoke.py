#!/usr/bin/env python3
"""GPU smoke run of tokengeex_tpu_torch, the PyTorch / CUDA port.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA
     versions; builds every CUDA kernel from csrc/ (one nvcc per source,
     all started together) and prints the build time;
  2. kernels against their plain PyTorch versions, at the shapes the
     main paths give them: viterbi_chunk (the chunk API, C = 512) with dp,
     best_l and hist equal; the whole-width Viterbi scans on encode's
     first row group (W = 8192, L = 16, 512 rows, rows cut into chains
     every SCAN_SEGMENT positions): viterbi_scan over the 32k
     vocabulary's start-indexed cache and fused_forward_chunk(viterbi)
     with the 4k vocabulary (bits 13), at dropout 0 and 0.1, equal to
     their twins bit for bit (dp, best_l, and the fused kind's run
     length), each with one chain alone (B = 1) for the latency of a
     step, the group's longest chain and the chain floor; forward_chunk,
     backward_chunk and its betas mode on seeded slabs with 40 % NEG holes
     and a step with no candidate, A, marg and betas within rtol 1e-5 and
     hist within rtol 1e-6; the whole-width scans forward_scan and
     backward_betas_scan (the same two kernels as forward_chunk and the
     betas mode, the session's route) on the session's first group of
     the 32k vocabulary (W = 8192, L = 16, 512 rows, its start-indexed
     cache, chains cut every SCAN_SEGMENT positions) at dropout 0 and
     0.1, within rtol 1e-5, and one chain alone (B = 1) for the latency
     of a step, which times the longest chain gives the chain floor;
     the fused log-sum-exp scans fused_forward_chunk(logsumexp) and
     fused_backward_chunk on the same group with the 4k vocabulary
     (bits 13), rows cut by the group's chains, at dropout 0 and 0.1,
     equal to their twins bit for bit (a and run length; betas: the
     forward's history is rebuilt from a in PyTorch, not by the kernel),
     with one chain alone for the step latency and the table gathers
     counted beside the bound; the marginal scan backward_marginal_scan
     (the per-pass E-step's backward, and backward_chunk's kernel) on the
     same session group and on the per-pass E-step's first group (W =
     1024, 4096 rows), over the group's cache, its backward chains and
     the forward values of the same cache, at dropout 0 and 0.1, equal to
     its twin bit for bit (marginals and betas), timed beside
     backward_betas_scan on the same inputs, with one chain alone;
     seg_weights on seeded inputs at H = 2^22 with n_hit inside the last
     block (the single-length entry), cf within rtol 1e-5 with equal
     finite masks; and the session's segsum in two launches per group,
     seg_weights_gather and seg_sums, on the session group's real
     SegStruct (the 32k vocabulary's rank space) at dropout 0 and 0.1,
     every output equal to its twin bit for bit, with the whole
     segsum_expected call timed (with the twins' tail too), its launches
     counted and its device kernels listed (two); and
     viterbi_walk, the backpointer walk with the exact-probe ids, on
     encode's first group of both routes (the 32k vocabulary's
     viterbi_scan backpointers and the 4k vocabulary's fused ones), in
     count and ids mode, equal to its twin bit for bit (counts; the flat
     ids and tokens per span), also timed as device time alone (the
     calls queued), beside the recorded device time of the walk's first
     design (one thread per span, experiments/torch_walk_design.py), with
     the chain floor (the longest span's row alone); and dfa_mask, the
     generate feed's candidate mask, on the feed's first group of the
     corpus (W8 = 8192, 1,024 rows) under the allow regex of all named
     patterns (245 DFA states) at L = 16, p = 1.0 and 0.01, on the
     shared and the global table route, bit for bit against its twin,
     its bound's terms printed (bytes, and the table lookups this data
     needs at the card's shared-memory rate); and the prune's
     alternatives' two kernels on the first group of the masked f64 pass
     over the 49,152-token vocabulary's own bytes (every token a sample,
     W = 512, spans of at most 16 bytes): viterbi_scan's double
     instantiation and viterbi_walk in both modes, bit for bit against
     their twins; and pair_count, merge's pair count, on the merge's
     first group (the 4k vocabulary at the merge's table hints, the
     group's ids walked on the card), on a skewed group (one key over
     half the pairs) and on a spill group (more distinct keys than a
     block's shared table holds, a hint so small that the global table
     grows): the kernel's compacted table sorted by key equal to
     pair_count_plain (integers, max |err| 0); the merge group timed as
     a merge pass runs it (a table sized from the hint a pass has, the
     insert, a readback of the state, the compaction and its readback;
     unqueued) and its launches
     alone (queued), with the rows it sends to the global table, beside
     the first design's recorded times (PAIR_FIRST_DESIGN_MS, from
     experiments/torch_pair_design.py) and
     torch.unique(return_counts=True) on the same keys; and match_cache,
     the slab route's vocabulary probe (csrc/match_probe.cu, one launch a
     group), on encode (a)'s first group (W = 8192, L = 16, 512 rows, the
     32k vocabulary) in bucket and fast mode, slots on and off, and in
     exact mode at float32 and float64 on a chained window of the f64
     phase's long samples (W = 32768, lead = L, 128 rows), score and slot
     equal to match_cache_plain bit for bit; each timed with CUDA events
     beside its plain version, its bound and the first design's recorded
     times (PROBE_FIRST_DESIGN_MS, from experiments/torch_probe_design.py),
     with the kernel's branch (the bucket filter in shared memory, or
     every valid point gathering) and, in bucket mode, the filter's rule
     counted on the group in torch ops (`filter_counts`: the valid points
     it keeps from gathering, the gathers in rows that place an entry
     past 3); bucket mode also on the cached prune's 49,152-token table
     (buckets at bits 17, the 128 KB filter: the kernel's one-block-an-SM
     launch, as the prune and the README-shape merge run it) over the same
     group, slots on and off;
  3. encode end to end, Tokenizer.encode_batch(backend="device") on the
     card, for two configurations over a seeded ~8 MB code-like corpus
     at L = 16: (a) a 32,768-token vocabulary (slab route: the bucket
     probe kernel, match_cache, + viterbi_scan), (b) a 4,096-token
     vocabulary (fused probe kernel). Each checks exact decode round
     trips, equality with the CPU plain run on the first 64 samples,
     dropout=1.0 -> single bytes, a > 2^15-byte sample through the
     chained path, and that its Viterbi kernel was launched, (a)'s probe
     kernel launched (no twin called on the card) and viterbi_walk (ids
     mode: the walk writes the flat ids; no backpointers leave the card)
     called once per row group;
     prints bytes/s, the peak device memory and the time per phase;
  3b. the EM E-step, run_e_step_device on the card, for (a) and (b) at
     dropout 0 and 0.05 (the dropout-0.05 pass once, unsynchronised):
     forward_scan and backward_marginal_scan each launched once per row
     group, counts on the first 64 samples equal to the CPU
     plain run (rtol 1e-3 / atol 1e-4 per
     token, 1e-5 on the total: the CPU's exp/log differ from the card's
     in the last ulp, and one ulp of a forward value near 4e3 moves the
     marginals after it by 2.4e-4), total count within 2e-3 of the f64
     oracle over the same 1024-byte snippets (f32 drift, as in the JAX
     package's f32 E-step: tests/test_torch_estep_oracle.py); prints
     bytes/s and the time per phase, at both dropouts;
  3d. the probe-once training session, DeviceTrainSession on the card,
     for (a) (cached route: forward_scan, backward_betas_scan,
     seg_weights_gather, seg_sums) and (b) (fused route:
     fused_forward_chunk(logsumexp), fused_backward_chunk,
     seg_weights_gather, seg_sums) at dropout 0 and 0.05: the first pass
     (probe, remap, SegStruct build) and a steady-state pass timed apart, with
     bytes/s and a synchronised phase split of each; the route's kernels
     launched, each once per group in a steady pass;
     at dropout 0 the second pass equal to the
     first, the counts within rtol 1e-3 / atol 1e-4 per token and 1e-4 on
     the total of run_e_step_device on the card (segsum against scatter,
     and expf ulps), and a session over the first 64 samples within 2e-3
     of the f64 oracle's total; then, for (a) and (b) at dropout 0 and
     0.05, a session with no cache budget (the over-budget branch: every
     pass probes, through the probe kernel, and counts through
     backward_marginal_scan, once per group, and the scatter), two passes
     each within rtol 1e-3 / atol
     1e-4 per token and 1e-4 on the total of the budgeted session's
     counts, its peak device memory and phase split printed;
  3c. the trainer: VocabularyPruner (the README recipe's settings)
     prunes a 49,152-token vocabulary to 32,768 over the corpus (2
     rounds, 4 E-steps, 2 frequency passes) through one session, on the
     cached route (table bits 17), then a 16,384-token vocabulary to
     8,192 on the fused route (bits 15: its E-steps launch the fused
     scans); every frequency pass launches the route's Viterbi kernel
     (viterbi_scan, fused_forward_chunk(viterbi)) and calls viterbi_walk
     (count mode) once per group (the cached route's frequency groups also
     the probe kernel, no twin on the card), and the first pass's counts
     equal a host
     backtrack of the same groups; every round's alternatives (one
     masked f64 Viterbi pass over the vocabulary's bytes: viterbi_scan's
     double instantiation and viterbi_walk) equal the oracle route's
     nbest(2) for the whole vocabulary (keep flags; lists but where two
     paths tie, counted and printed); each session is closed after; each
     result is a subset of its input vocabulary and encodes and decodes
     the first 64 samples exactly on the card; prints each round's size,
     seconds and split (e_steps, frequencies, alternatives, m_step, model
     builds, loss ranking, rebinds, the session's build, this script's
     checks, rest); then the
     alternatives of the README's 500,000-token generate vocabulary
     (experiments/table500k.py's) on the card, timed and split, 2,000
     seeded tokens of it held against the oracle's nbest(2);
  3e. merge on the card: VocabularyMerger over the corpus from the
     4,096-token vocabulary, 200 merges in steps of 50 (four passes, each
     an encode of the corpus packed and uploaded once, its ids walked and
     their pairs counted in a hash table on the card, only the sorted
     arrays read back) under an anchored identifier / punctuation allow
     pattern the allow-DFA compiles; the fused Viterbi kernel and
     viterbi_walk once per group a pass, pair_count at least once per
     group a pass plus the compaction (counts set to 0 just before the
     run); a second run, each pass split by phase (pairs, readback, ...),
     holds every pass's pair list equal to the host route's (np.unique
     over encode's ids, `host_pairs`) and merges the same vocabulary; on
     the first 64 samples the pair counts and the merged vocabulary equal
     to a CPU run's; prints the seconds per merge pass; then one pass at
     the README recipe's merge shape (the 32,768-token vocabulary, slab
     route, hints of --num-merges 2000): first and steady pass timed, the
     steady pass's launches counted (viterbi_scan, the probe kernel and
     the walk once a group), a split pass, its pairs equal to the host
     route's;
  3f. generate on the card: VocabularyGenerator (L = 16, p = 0.01, the
     allow regex of all named patterns) feeds the corpus, dfa_mask
     launched once per group, then generate(500_000); prints MB/s, a
     synchronised phase split (pack, mask, drain, readback, decode,
     generate) and the device's idle share; at p = 1 on the first 64
     samples the counts equal the host `_feed_part` sets';
  3g. the README recipe through the CLI: regex -> generate -> prune ->
     filter -> merge -> encode -> decode, each a `python -m
     tokengeex_tpu_torch.cli` process on the card, over a NUL-separated
     .bin file of a ~2 MB slice of the corpus (sizes cut as printed under
     `reduced`); each exits 0 and the decoded text equals the input;
     prints each stage's seconds;
  3h. the f64 / exact conformance mode on the card: encode at float64
     (the exact probe, viterbi_scan's double instantiation, the walk) of
     the corpus's first 64 samples and 8 samples of 40-80 KB (the chained
     route, its dp tail carried in f64), ids equal to the oracle's; the
     f64 E-step (81,920-byte snippets, forward_scan's and
     backward_marginal_scan's double instantiations, an f64 scatter into
     token-id bins), its total within rtol 1e-8 of the CPU f64 run's,
     every count within rtol 1e-8 / atol 1e-9; each double kernel (the
     probe's too) launched on the path and no f32 scan; MB/s of both beside the f32 encode's
     and E-step's on the same samples;
  3i. multi-GPU on the one card (parallel/mesh.py), each rank a process
     this script starts (`chip_smoke.py --rank-worker ...`; a rank that
     fails or outlasts MG_RANK_S fails the run): world size 1 under NCCL
     runs the session (a)'s first and steady pass, encode (a) and
     VocabularyPruner(corpus_sharded=True) on the fused route (16,384 ->
     8,192) over the corpus, counts, ids and vocabulary bit-equal to
     phases 3d, 3 and 3c, each route's kernels launched as there; prints
     the seconds beside the unsharded ones and the all_reduce time of the
     (V,) counts. Then two gloo ranks sharing the card (each an explicit
     cache_budget, a quarter of the free memory): the session (a) at the
     recipe's shapes (W = 8192, 1,024 rows, each group's rows split
     between the ranks), counts within rtol 1e-4 / atol 1e-4 and 1e-5 on
     the total of phase 3d's, printed beside MULTICHIP_r05.json's gap;
     encode (a)'s gathered ids equal to phase 3's on both ranks; merge's
     pair count (a) with every rank's table gathered into a fresh one
     (the weighted entry launched on each rank), equal to phase 3e's
     single-process pass on both ranks; generate
     at p = 1 over the first 64 samples as two shards equal to phase 3f's
     counts; the corpus-sharded fused prune of the 2 MB slice on disjoint
     shards: the same vocabulary on both ranks, a subset, at most 8,192
     tokens, its overlap with one process's prune printed; which
     collectives gloo takes on CUDA tensors; seconds per rank, labelled
     "2 ranks sharing one card" (not a scaling figure);
  4. the kernels line (eighteen entries: the ten kernels, the three
     double instantiations, viterbi_scan's double instantiation and
     viterbi_walk at the alternatives' shape, with the prunes' launches,
     pair_count with the merge run's launches, and match_cache and its
     double instantiation with encode (a)'s and the f64 phase's
     launches), then the device line as the last line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import functools
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores
L_MAX = 16
CORPUS_BYTES = 8_000_000
SEED = 0
# Device ms (calls queued behind a sleep) of the walk's first design, one
# thread per span, on encode's first group of each route, as
# experiments/torch_walk_design.py measured it beside the package's walk
# in one process; chip_smoke.py prints them beside the walk's own.
WALK_FIRST_DESIGN_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
WALK_FIRST_DESIGN_MS = {
    "slab": {"ids": 0.1668, "count": 0.2877, "floor": 0.1071},
    "fused": {"ids": 0.2081, "count": 0.3516, "floor": 0.1496},
}
# Milliseconds of dfa_mask's first design (one 1,024-thread block an SM
# over the full (S, 256) table, experiments/torch_dfa_first.cu) on the
# feed's first group at p = 0.01, as experiments/torch_dfa_design.py
# measured it beside the package's kernel in one process; chip_smoke.py
# prints them beside the kernel's own.
DFA_FIRST_DESIGN_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
DFA_FIRST_DESIGN_MS = {"shared": 0.3504, "global": 0.3595}
# Milliseconds of pair_count's first design (one global atomic a pair, a
# table sized from the pairs, experiments/torch_pair_first.cu) on the
# merge's first group, as experiments/torch_pair_design.py's A/B measured
# it beside the package's kernel in one process: a group as a pass runs it
# (table, insert, compaction and readback; two runs, unqueued) and its
# launches alone (queued). chip_smoke.py prints them beside the kernel's
# own.
PAIR_FIRST_DESIGN_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
PAIR_FIRST_DESIGN_MS = {"group": 0.3239, "group_2": 0.3125,
                        "device": 0.2548}
# Milliseconds of match_probe's first design (a block a 32 x 32 tile, one
# launch over every tile, each valid point gathering its whole row:
# experiments/torch_probe_first.cu) per phase 2 case, unqueued (through the
# package's wrapper) and queued (device), as
# experiments/torch_probe_design.py measured them beside the package's
# kernel in one process; chip_smoke.py prints them beside the kernel's own.
PROBE_FIRST_DESIGN_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
PROBE_FIRST_DESIGN_MS = {
    "bucket": {"ms": 1.055, "device_ms": 1.0479},
    "bucket, slots": {"ms": 1.1074, "device_ms": 1.0999},
    "fast": {"ms": 0.9838, "device_ms": 0.9759},
    "fast, slots": {"ms": 1.0132, "device_ms": 1.0076},
    "exact": {"ms": 0.1699, "device_ms": 0.161},
    "exact, slots": {"ms": 0.2563, "device_ms": 0.2518},
    "exact[f64]": {"ms": 0.2559, "device_ms": 0.2493},
    "exact[f64], slots": {"ms": 0.3563, "device_ms": 0.3484},
    "bucket[bits 17]": {"ms": 1.0811, "device_ms": 1.0728},
    "bucket[bits 17], slots": {"ms": 1.1193, "device_ms": 1.114},
}


START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_start(name: str) -> None:
    log(f"-- phase {name} at {time.perf_counter() - START:.1f} s")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# Seeded corpus and vocabularies
# ---------------------------------------------------------------------------


def build_corpus(nbytes: int, seed: int = SEED, pool_size: int = 12000):
    """Code-like text: Zipf-weighted identifiers (keywords first, then
    random-letter names for lexical diversity) joined by code
    punctuation, cut into samples of 1-8 KB like source files."""
    rng = np.random.default_rng(seed)
    keywords = [
        "def", "return", "value", "data", "self", "import", "print",
        "class", "for", "in", "range", "len", "if", "else", "while",
        "try", "except", "yield", "lambda", "none", "true", "false",
        "result", "index", "count", "total", "items", "key", "object",
    ]
    pool = list(keywords)
    seen = set(pool)
    while len(pool) < pool_size:
        w = "".join(chr(97 + int(c))
                    for c in rng.integers(0, 26, rng.integers(3, 11)))
        if w not in seen:
            seen.add(w)
            pool.append(w)
    weights = 1.0 / (1.0 + np.arange(len(pool))) ** 0.7
    weights /= weights.sum()
    seps = [" ", "(", ") ", ", ", "._", " = ", ": ", "[0]", "();\n    ",
            " == 1", "...", "{}", " += 2", "'%s'"]
    # Draw in bulk: ~60 bytes per line on average, with headroom.
    n_lines = nbytes // 40 + 1
    per_line = rng.integers(3, 12, n_lines)
    picks = rng.choice(len(pool), size=int(per_line.sum()), p=weights)
    joins = rng.integers(0, len(seps), int(per_line.sum()))
    lines, size, k = [], 0, 0
    for n in per_line:
        words = [pool[i] for i in picks[k : k + n]]
        line = words[0] + "".join(seps[j] + w for j, w in
                                  zip(joins[k + 1 : k + n], words[1:]))
        k += n
        lines.append(line)
        size += len(line) + 1
        if size >= nbytes:
            break
    text = "\n".join(lines).encode()[:nbytes]
    samples, pos = [], 0
    while pos < len(text):
        n = int(min(8192, max(256, rng.lognormal(math.log(3000), 0.6))))
        samples.append(text[pos : pos + n])
        pos += n
    return samples


def build_vocab(samples, size: int, max_len: int = L_MAX,
                prefixes: bool = True):
    """All 256 bytes plus the most frequent word-shaped substrings
    (words with their leading separator byte, and with `prefixes` word
    prefixes, counted over the first quarter of the corpus; without, over
    all of it), scored by log relative frequency. Without prefixes nearly
    every token is some segmentation's best piece, so EM keeps it: the
    vocabulary a pruning round starts from."""
    import re
    from collections import Counter

    from tokengeex_tpu_torch import ScoredToken

    counts: Counter = Counter()
    for s in (samples[: max(1, len(samples) // 4)] if prefixes
              else samples):
        for m in re.finditer(rb"[^a-z]?[a-z]+|[^a-z]+", s):
            w = m.group(0)[:max_len]
            counts[w] += 1
            if prefixes:
                for k in range(2, len(w)):
                    counts[w[:k]] += 1
    # Whole-line prefixes of max_len bytes, so the longest token is L.
    long = [s[:max_len] for s in samples[:64] if len(s) >= max_len]
    long = list(dict.fromkeys(long))[:32]
    for w in long:
        counts[w] += 1
    common = [w for w, _ in counts.most_common()
              if len(w) > 1 and w not in set(long)]
    chosen = long + common[: size - 256 - len(long)]
    check(len(chosen) == size - 256,
          f"corpus has only {len(common)} candidate tokens for {size}")
    total = sum(counts[w] for w in chosen) + 256
    vocab = [ScoredToken(bytes([b]), math.log(1.0 / total) - 4.0)
             for b in range(256)]
    vocab += [ScoredToken(w, math.log(counts[w] / total)) for w in chosen]
    return vocab


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int, warmup: int = 1, queued: bool = False) -> float:
    """Mean device milliseconds of `fn` between two CUDA events over
    `iters` calls. A call whose host work outlasts its kernels times the
    host too; queued=True first parks the stream on a ~20 ms sleep kernel,
    so that every call's launches are queued before the first event and
    run back to back: the device time of the launches alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_busy(fn) -> dict:
    """Device busy and idle share of one call, from a torch.profiler
    trace: the summed time of the device's kernels and copies (one
    stream, so they do not overlap) over the call's wall time. The
    profiler's own host overhead lengthens the wall time a little."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    check(busy_us > 0, "the profiler recorded no device time")
    busy = busy_us / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"busy_s": busy, "wall_s": wall, "idle_share": 1 - busy / wall,
            "top_kernels_ms": [(e.key[:60], e.count,
                                round(e.self_device_time_total / 1e3, 3))
                               for e in top]}


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ids_digest(ids) -> str:
    """sha256 of token id lists (their lengths, then the ids)."""
    h = hashlib.sha256(np.asarray([len(r) for r in ids], np.int64).tobytes())
    for r in ids:
        h.update(np.asarray(r, np.int32).tobytes())
    return h.hexdigest()


def vocab_digest(tokens) -> str:
    """sha256 of a vocabulary: each token's bytes, score and keep flag."""
    h = hashlib.sha256()
    for t in tokens:
        h.update(len(t.value).to_bytes(4, "little") + t.value
                 + np.float64(t.score).tobytes() + bytes([t.keep]))
    return h.hexdigest()


def pairs_digest(keys, counts) -> str:
    """sha256 of a pair count's (keys, counts) int64 arrays, in order."""
    return hashlib.sha256(np.ascontiguousarray(keys, np.int64).tobytes()
                          + np.ascontiguousarray(counts, np.int64).tobytes()
                          ).hexdigest()


def counter_digest(counts) -> str:
    """sha256 of a Counter of strings, in key order."""
    return hashlib.sha256(json.dumps(sorted(counts.items())).encode()
                          ).hexdigest()


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the entries both hold as finite scores
    (NEG sentinels compare by equality of the masks)."""
    fg, fw = got > -1.5e38, want > -1.5e38
    check(bool((fg == fw).all()), "finite masks differ")
    if not bool(fw.any()):
        return 0.0
    return float((got[fw].double() - want[fw].double()).abs().max())


def assert_rel(got, want, name: str, rtol: float) -> float:
    """Equal finite masks and |got - want| <= rtol |want| on every
    finite entry; returns the max |err|."""
    err = max_abs_err(got, want)
    fw = want > -1.5e38
    diff = (got[fw].double() - want[fw].double()).abs()
    check(bool((diff <= rtol * want[fw].double().abs()).all()),
          f"{name} beyond rtol {rtol}")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_viterbi_chunk(lc, C: int, L: int, B: int, dev):
    g = torch.Generator().manual_seed(1)
    s = torch.round(torch.empty(C, L, B).uniform_(-12, -1, generator=g) * 2) / 2
    s[torch.rand(C, L, B, generator=g) < 0.4] = lc.NEG  # holes
    s[7] = lc.NEG  # a step with no candidate
    starts = (torch.rand(C, B, generator=g) < 0.002).float()
    hist0 = torch.round(torch.empty(L, B).uniform_(-30, 0, generator=g) * 2) / 2
    args = [t.to(dev).contiguous() for t in (s, starts, hist0)]

    want = lc.viterbi_chunk_plain(*args)
    got = lc.viterbi_chunk(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got[0], want[0])
    for i, name in enumerate(("dp", "best_l", "hist")):
        check(torch.equal(got[i], want[i]), f"viterbi_chunk: {name} differs")

    ms = cuda_ms(lambda: lc.viterbi_chunk(*args), iters=50)
    plain_ms = cuda_ms(lambda: lc.viterbi_chunk_plain(*args), iters=1)
    nbytes = 4 * (C * L * B + C * B + 2 * L * B + 2 * C * B)
    b_ms, b_by = bound(nbytes, 3 * C * L * B)
    log(f"viterbi_chunk (C={C}, L={L}, B={B}): {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"C": C, "L": L, "B": B}}


def lse_slab(C: int, L: int, B: int, seed: int):
    """Seeded slab with 40 % NEG holes and a step with no candidate,
    sample boundaries, a history, and forward values and normalisers
    that keep the backward pass's marginals near [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    s = torch.round(torch.empty(C, L, B).uniform_(-12, -1, generator=g) * 2) / 2
    s[torch.rand(C, L, B, generator=g) < 0.4] = -3.0e38
    s[7] = -3.0e38
    bounds = (torch.rand(C, B, generator=g) < 0.002).float()
    hist0 = torch.round(torch.empty(L, B).uniform_(-30, 0, generator=g) * 2) / 2
    a = torch.empty(C, B).uniform_(-1, 0, generator=g)
    z = torch.empty(C, B).uniform_(0, 1, generator=g)
    return s, bounds, hist0, a, z


def check_forward_chunk(lc, C: int, L: int, B: int, dev):
    s, starts, hist0, _, _ = lse_slab(C, L, B, 3)
    args = [t.to(dev).contiguous() for t in (s, starts, hist0)]
    want = lc.forward_chunk_plain(*args)
    got = lc.forward_chunk(*args)
    torch.cuda.synchronize()
    check(bool((want[0] <= -1.5e38).any()), "forward_chunk: no NEG step")
    err = max(assert_rel(got[0], want[0], "forward_chunk: A", 1e-5),
              assert_rel(got[1], want[1], "forward_chunk: hist", 1e-6))
    ms = cuda_ms(lambda: lc.forward_chunk(*args), iters=20)
    plain_ms = cuda_ms(lambda: lc.forward_chunk_plain(*args), iters=1)
    # Bytes: slab, starts, A out, history in and out. Operations: per
    # (position, length) an add, a max, a subtraction, an exp and an add.
    nbytes = 4 * (C * L * B + 2 * C * B + 2 * L * B)
    b_ms, b_by = bound(nbytes, 5 * C * L * B + 4 * C * B)
    log(f"forward_chunk (C={C}, L={L}, B={B}): {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"C": C, "L": L, "B": B}}


def check_backward_chunk(lc, C: int, L: int, B: int, dev):
    s, ends, hist0, a, z = lse_slab(C, L, B, 4)
    args = [t.to(dev).contiguous() for t in (s, a, z, ends, hist0)]
    want = lc.backward_chunk_plain(*args)
    got = lc.backward_chunk(*args)
    torch.cuda.synchronize()
    check(float(want[0].max()) > 1e-3, "backward_chunk: all marginals ~0")
    err = max(assert_rel(got[0], want[0], "backward_chunk: marg", 1e-5),
              assert_rel(got[1], want[1], "backward_chunk: hist", 1e-6))
    ms = cuda_ms(lambda: lc.backward_chunk(*args), iters=20)
    plain_ms = cuda_ms(lambda: lc.backward_chunk_plain(*args), iters=1)
    # Bytes: slab in, marginals out, a / z / ends, history in and out.
    # Operations: per (position, length) five for the marginal and five
    # for the beta log-sum-exp.
    nbytes = 4 * (2 * C * L * B + 3 * C * B + 2 * L * B)
    b_ms, b_by = bound(nbytes, 10 * C * L * B + 4 * C * B)
    log(f"backward_chunk (C={C}, L={L}, B={B}): {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"C": C, "L": L, "B": B}}


def drop_words(batch, dropout: float, dev, seed: int = 2):
    if dropout <= 0.0:
        return None
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                         generator=g, dtype=torch.int32, device=dev)


def one_chain(args):
    """A fused scan's positional arguments cut to row 0 (B = 1): all but
    the two tables and the two inverse-power streams (args 0, 1, 4, 5)
    end in the row axis."""
    return [t if i in (0, 1, 4, 5) or t is None else t[..., :1].contiguous()
            for i, t in enumerate(args)]


def check_fused_scan(lat, lcf, tbl, batch, dropout: float, dev,
                     direction: str):
    """One fused scan against its twin on a group, rows cut by the
    group's chains: equal bit for bit (the kernel's outputs: the
    forward's a and run length, the Viterbi kind's dp, best_l and run
    length, the betas). The forward kinds' history is not compared: the
    wrapper and the twin both rebuild it from the values with the same
    PyTorch function. Timed beside the twin and its bound, and one chain
    alone (B = 1) for the latency of a step."""
    chains = lat.chain_bounds(batch)
    W = batch.width
    B = batch.p1.shape[0]
    L = tbl.max_len
    du = drop_words(batch, dropout, dev)
    kw = dict(L=L, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    inb = batch.sid[:, batch.pad : batch.pad + W].t() >= 0
    # Operations per (position, length) of the recurrence: an add, a max,
    # a subtraction, an exp and an add (log-sum-exp); an add, a max and a
    # compare (Viterbi).
    step_ops = 5
    if direction in ("forward", "viterbi"):
        kind = "logsumexp" if direction == "forward" else "viterbi"
        name = f"fused_forward({kind})"
        args = lat.fused_inputs(tbl, batch, du, dropout)
        seg = chains[0]

        def fn(*a, **k):
            return lcf.fused_forward_chunk(kind, *a, **k)

        def plain(*a, **k):
            return lcf.fused_forward_chunk_plain(kind, *a, **k)
        # Probes run where the length fits the run ending at the byte.
        runs = lcf.run_lengths(inb, batch.is_start[:, :W].t(), args[10])
        # a (or dp and best_l), hist and rl written once
        out_bytes = 4 * ((W if kind == "logsumexp" else 2 * W) * B + L * B
                         + B)
        step_ops = 5 if kind == "logsumexp" else 3
    else:
        name = "fused_backward"
        args = lat.fused_bwd_inputs(tbl, batch, du, dropout)
        seg = chains[1]
        fn, plain = lcf.fused_backward_chunk, lcf.fused_backward_chunk_plain
        # Probes run where the length fits the run starting at the byte.
        runs = lcf.start_run_lengths(inb, batch.is_start[:, 1:].t())
        out_bytes = 4 * W * B  # the betas written once
    want = []
    plain_ms = cuda_ms(lambda: want.append(plain(*args, **kw, seg=seg)),
                       iters=1, warmup=0)
    want = want[0]
    got = fn(*args, **kw, seg=seg)
    torch.cuda.synchronize()
    if direction == "forward":
        check(torch.equal(got[3], want[3]), f"{name}: rl differs")
        got, want = got[0], want[0]
        compared = " (a; rl equal; hist is rebuilt from a, not compared)"
    elif direction == "viterbi":
        for i, what in ((1, "best_l"), (3, "rl")):
            check(torch.equal(got[i], want[i]),
                  f"{name} (dropout {dropout}): {what} differs")
        check(bool((want[1] > 1).any()), f"{name}: no multi-byte token")
        got, want = got[0], want[0]
        compared = (" (dp; best_l and rl equal; hist is rebuilt from dp, "
                    "not compared)")
    else:
        check(bool((want == 0).any()), f"{name}: no sample end")
        compared = ""
    err = max_abs_err(got, want)
    check(torch.equal(got, want),
          f"{name} (dropout {dropout}): max |err| {err} against its twin")
    ms = cuda_ms(lambda: fn(*args, **kw, seg=seg), iters=10)
    # Bytes: every input read once (the chain bounds too), the outputs
    # written once. Operations: ~20 integer ops per probed (position,
    # length) -- the fingerprints, slots, compares and the coin -- and
    # step_ops for the recurrence of each (position, length); probes
    # counted on this data.
    nbytes = sum(t.numel() * t.element_size() for t in args if t is not None)
    nbytes += seg.numel() * 4 + out_bytes
    probes = int(runs.clamp(max=L).sum())
    b_ms, b_by = bound(nbytes, 20 * probes + step_ops * W * L * B)
    # The table gathers, beside the bound: 2 rows of 8 bytes per (position,
    # length), each one 32-byte sector of L2 or L1.
    sectors = 2 * W * L * B
    longest = int((seg[1:] - seg[:-1]).max())
    one = one_chain(args)
    one_ms = cuda_ms(lambda: fn(*one, **kw), iters=3)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "probes": probes,
           "gather_sectors": sectors, "longest_chain": longest,
           "chains": (seg.shape[0] - 1) * B,
           "one_chain_ms": one_ms, "us_per_step": one_ms * 1e3 / W,
           "chain_floor_ms": longest * one_ms / W,
           "shape": {"W": W, "L": L, "B": B, "bits": tbl.bits,
                     "dropout": dropout,
                     "segments": seg.shape[0] - 1}}
    log(f"{name} (W={W}, L={L}, B={B}, bits={tbl.bits}, dropout={dropout}, "
        f"{seg.shape[0] - 1} segments): {ms:.4f} ms, plain {plain_ms:.1f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {probes} probes, {sectors} table "
        f"sectors ({sectors * 32 / 1e9:.2f} GB), max |err| {err}{compared}; "
        f"one chain (B=1) {one_ms:.4f} ms = {res['us_per_step']:.4f} us per "
        f"step, "
        f"longest chain {longest} -> chain floor "
        f"{res['chain_floor_ms']:.4f} ms")
    return res


def check_backward_betas(lc, C: int, L: int, B: int, dev):
    s, ends, hist0, _, _ = lse_slab(C, L, B, 5)
    args = [t.to(dev).contiguous() for t in (s, ends, hist0)]
    want = lc.backward_betas_chunk_plain(*args)
    got = lc.backward_betas_chunk(*args)
    torch.cuda.synchronize()
    check(bool((want[0] == 0).any()), "backward_betas_chunk: no sample end")
    err = max(assert_rel(got[0], want[0], "backward_betas_chunk: betas", 1e-5),
              assert_rel(got[1], want[1], "backward_betas_chunk: hist", 1e-6))
    ms = cuda_ms(lambda: lc.backward_betas_chunk(*args), iters=20)
    plain_ms = cuda_ms(lambda: lc.backward_betas_chunk_plain(*args), iters=1)
    # Bytes: slab and ends in, betas out, history in and out. Operations:
    # per (position, length) an add, a max, a subtraction, an exp and an add.
    nbytes = 4 * (C * L * B + 2 * C * B + 2 * L * B)
    b_ms, b_by = bound(nbytes, 5 * C * L * B + 4 * C * B)
    log(f"backward_chunk(betas) (C={C}, L={L}, B={B}): {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"C": C, "L": L, "B": B}}


def check_scans(lat, lc, lcf, tbl, batch, dev):
    """forward_scan and backward_betas_scan against their twins on one
    group's start-indexed cache at dropout 0 and 0.1; one chain alone
    for the latency of a step."""
    cache = lat.match_cache(tbl, batch)[0]
    W, L, B = cache.shape
    chains = lat.chain_bounds(batch)
    K = chains[0].shape[0] - 1
    flags = {"forward": batch.is_start[:, 1:].t().float().contiguous(),
             "backward": batch.is_end[:, :W].t().float().contiguous()}
    hist = {"forward": lat._hist0(batch, L, None).clamp(min=lc.NEG).t()
            .contiguous(),
            "backward": lcf.betas_hist0(batch.is_end[:, W], L)}
    fns = {"forward": (lc.forward_scan, lc.forward_scan_plain),
           "backward": (lc.backward_betas_scan, lc.backward_betas_scan_plain)}
    out = {}
    for i, name in enumerate(("forward", "backward")):
        fn, plain = fns[name]
        res = {"longest_chain": int((chains[i][1:] - chains[i][:-1]).max()),
               "chains": K * B}
        for dropout in (0.0, 0.1):
            args = (cache, flags[name], hist[name], chains[i])
            kw = {"pad": batch.pad}
            du = drop_words(batch, dropout, dev)
            if du is not None:
                kw.update(du=du.t().contiguous(), dropout=dropout)
            want = []
            plain_ms = cuda_ms(lambda: want.append(plain(*args, **kw)),
                               iters=1, warmup=0)
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            err = assert_rel(got, want[0], f"{name}_scan (dropout "
                             f"{dropout})", 1e-5)
            ms = cuda_ms(lambda: fn(*args, **kw), iters=20)
            # Bytes: the cache, flags, history, chain bounds and dropout
            # words read once, the values written once. Operations: per
            # (position, length) an add, a max, a subtraction, an exp and
            # an add, and per position the log and the reset.
            nbytes = (4 * (W * L * B + 2 * W * B + L * B + (K + 1) * B)
                      + (du.numel() * 4 if du is not None else 0))
            b_ms, b_by = bound(nbytes, 5 * W * L * B + 4 * W * B)
            res[f"dropout_{dropout}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"{name}_scan (W={W}, L={L}, B={B}, {K} segments, dropout "
                f"{dropout}): {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), max |err| {err}")
        one = [t[..., :1].contiguous() for t in (cache, flags[name],
                                                 hist[name])]
        one_ms = cuda_ms(lambda: fn(*one), iters=5)
        res["us_per_step"] = one_ms * 1e3 / W
        res["chain_floor_ms"] = res["longest_chain"] * one_ms / W
        log(f"{name}_scan: one chain (B=1, W={W}) {one_ms:.4f} ms = "
            f"{res['us_per_step']:.4f} us per step; longest chain "
            f"{res['longest_chain']} steps -> chain floor "
            f"{res['chain_floor_ms']:.4f} ms")
        out[name] = res
    return out


def check_viterbi_scan(lat, lc, tbl, batch, dev):
    """viterbi_scan against its twin on encode (a)'s first group: the
    group's start-indexed score cache, its chains, at dropout 0 and 0.1,
    equal bit for bit (dp and best_l); one chain alone (B = 1) for the
    latency of a step."""
    cache = lat.match_cache(tbl, batch, C=512, slots=False)[0]
    W, L, B = cache.shape
    seg = lat.chain_bounds(batch)[0]
    K = seg.shape[0] - 1
    starts = batch.is_start[:, 1:].t().float().contiguous()
    hist = lat._hist0(batch, L, None).clamp(min=lc.NEG).t().contiguous()
    args = (cache, starts, hist, seg)
    res = {"longest_chain": int((seg[1:] - seg[:-1]).max()), "chains": K * B,
           "shape": {"W": W, "L": L, "B": B, "segments": K}}
    for dropout in (0.0, 0.1):
        kw = {"pad": batch.pad}
        du = drop_words(batch, dropout, dev)
        if du is not None:
            kw.update(du=du.t().contiguous(), dropout=dropout)
        want = []
        plain_ms = cuda_ms(lambda: want.append(
            lc.viterbi_scan_plain(*args, **kw)), iters=1, warmup=0)
        want = want[0]
        got = lc.viterbi_scan(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got[0], want[0])
        for i, name in enumerate(("dp", "best_l")):
            check(torch.equal(got[i], want[i]),
                  f"viterbi_scan (dropout {dropout}): {name} differs")
        check(bool((want[1] > 1).any()), "viterbi_scan: no multi-byte token")
        ms = cuda_ms(lambda: lc.viterbi_scan(*args, **kw), iters=20)
        # Bytes: the cache, starts, history, chain bounds and dropout words
        # read once, dp and best_l written once. Operations: per (position,
        # length) an add, a max and a compare, and with dropout the coin's
        # multiply, shift and compare.
        nbytes = (4 * (W * L * B + 3 * W * B + L * B + (K + 1) * B)
                  + (du.numel() * 4 if du is not None else 0))
        ops = (3 + (3 if du is not None else 0)) * W * L * B
        b_ms, b_by = bound(nbytes, ops)
        res[f"dropout_{dropout}"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}
        log(f"viterbi_scan (W={W}, L={L}, B={B}, {K} segments, dropout "
            f"{dropout}): {ms:.4f} ms in one launch, plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| "
            f"{err} (dp, best_l equal)")
    one = [t[..., :1].contiguous() for t in (cache, starts, hist)]
    one_ms = cuda_ms(lambda: lc.viterbi_scan(*one), iters=5)
    res["one_chain_ms"] = one_ms
    res["us_per_step"] = one_ms * 1e3 / W
    res["chain_floor_ms"] = res["longest_chain"] * one_ms / W
    log(f"viterbi_scan: one chain (B=1, W={W}) {one_ms:.4f} ms = "
        f"{res['us_per_step']:.4f} us per step; longest chain "
        f"{res['longest_chain']} steps -> chain floor "
        f"{res['chain_floor_ms']:.4f} ms, bound "
        f"{res['dropout_0.0']['bound_ms']:.4f} ms")
    return res


def check_seg_weights(lcs, H: int, dev):
    g = torch.Generator().manual_seed(6)
    # Hits' [alpha - Z] and betas, score differences with block anchors:
    # weights exp(r0 + r1 + ss) spread over (0, 1].
    r0 = torch.empty(H).uniform_(-6, 0, generator=g)
    r1 = torch.empty(H).uniform_(-6, 0, generator=g)
    d2 = torch.empty(H).uniform_(-0.05, 0.05, generator=g)
    d2[::lcs.SEG_BLK] = torch.empty(H // lcs.SEG_BLK).uniform_(-2, 0,
                                                               generator=g)
    n_hit = H - lcs.SEG_BLK + 57  # inside the last block
    args = [t.to(dev).contiguous() for t in (r0, r1, d2)]
    want = lcs.seg_weights_plain(*args, n_hit)
    got = lcs.seg_weights(*args, n_hit)
    torch.cuda.synchronize()
    err = max(assert_rel(got[0], want[0], "seg_weights: cf", 1e-5),
              assert_rel(got[1], want[1], "seg_weights: t", 1e-5))
    ms = cuda_ms(lambda: lcs.seg_weights(*args, n_hit), iters=20)
    plain_ms = cuda_ms(lambda: lcs.seg_weights_plain(*args, n_hit), iters=3)
    # Bytes: 16 per hit (r0, r1, d2 in, cf out) and the block totals.
    # Operations: per hit 14 scan adds, 2 adds, one exp and the mask.
    nbytes = 16 * H + 4 * (H // lcs.SEG_BLK)
    b_ms, b_by = bound(nbytes, 18 * H)
    log(f"seg_weights (H={H}, n_hit={n_hit}): {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"H": H, "n_hit": n_hit}}


def check_marginal_scan(lat, lc, tbl, batch, dev, tag: str):
    """backward_marginal_scan against its twin on one group's
    start-indexed cache, the group's backward chains, the forward values
    of the same cache, at dropout 0 and 0.1: equal bit for bit (marginals
    and betas). Timed beside its twin, its bound and backward_betas_scan
    on the same inputs (the target: within 1.5x of it); one chain alone
    (B = 1) for the latency of a step."""
    cache = lat.match_cache(tbl, batch)
    W, L, B = cache[0].shape
    seg = lat.chain_bounds(batch)[1]
    K = seg.shape[0] - 1
    res = {"longest_chain": int((seg[1:] - seg[:-1]).max()), "chains": K * B,
           "shape": {"W": W, "L": L, "B": B, "segments": K}}
    for dropout in (0.0, 0.1):
        du = drop_words(batch, dropout, dev)
        A = lat.forward(tbl, batch, cache, drop_u=du, dropout=dropout)
        a, z, ends, hist = lat._marginal_inputs(batch, A, L)
        args = (cache[0], a, z, ends, hist, seg)
        kw = {"pad": batch.pad}
        if du is not None:
            kw.update(du=du.t().contiguous(), dropout=dropout)
        want = []
        plain_ms = cuda_ms(lambda: want.append(
            lc.backward_marginal_scan_plain(*args, **kw)), iters=1, warmup=0)
        want = want[0]
        got = lc.backward_marginal_scan(*args, **kw)
        torch.cuda.synchronize()
        check(float(want[0].max()) > 0.5, f"{tag}: all marginals ~0")
        err = max(max_abs_err(got[1], want[1]),
                  float((got[0] - want[0]).abs().max()))
        for i, what in enumerate(("marginals", "betas")):
            check(torch.equal(got[i], want[i]),
                  f"{tag} (dropout {dropout}): {what} differ from the twin "
                  f"(max |err| {err})")
        del want, got
        ms = cuda_ms(lambda: lc.backward_marginal_scan(*args, **kw),
                     iters=10)
        betas_ms = cuda_ms(lambda: lc.backward_betas_scan(
            cache[0], ends, hist, seg, **kw), iters=10)
        # Bytes: the cache, a, z, ends, history, chain bounds and dropout
        # words read once, the marginals and betas written once.
        # Operations: per (position, length) five for the marginal (three
        # adds, a max, an exp) and five for the log-sum-exp; per position
        # the log and the reset.
        nbytes = (4 * (2 * W * L * B + 4 * W * B + L * B + (K + 1) * B)
                  + (du.numel() * 4 if du is not None else 0))
        b_ms, b_by = bound(nbytes, 10 * W * L * B + 4 * W * B)
        res[f"dropout_{dropout}"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "betas_scan_ms": betas_ms}
        log(f"{tag} (W={W}, L={L}, B={B}, {K} segments, dropout {dropout}): "
            f"{ms:.4f} ms in one launch, plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), max |err| {err} (marginals, betas "
            f"equal); backward_betas_scan on the same inputs {betas_ms:.4f} "
            f"ms ({ms / betas_ms:.2f}x)")
    one = [t[..., :1].contiguous() for t in args[:5]]
    one_ms = cuda_ms(lambda: lc.backward_marginal_scan(*one), iters=5)
    res["one_chain_ms"] = one_ms
    res["us_per_step"] = one_ms * 1e3 / W
    res["chain_floor_ms"] = res["longest_chain"] * one_ms / W
    log(f"{tag}: one chain (B=1, W={W}) {one_ms:.4f} ms = "
        f"{res['us_per_step']:.4f} us per step; longest chain "
        f"{res['longest_chain']} steps -> chain floor "
        f"{res['chain_floor_ms']:.4f} ms")
    return res


def segsum_profile(fn) -> list:
    """(name, launches) of every device kernel and copy one call of `fn`
    runs, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key[:60], e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def check_segsum(lat, lcs, table, tbl, batch, dev):
    """The session's segsum on one session group's real SegStruct (the
    32k vocabulary's rank space, as the session builds it), with the
    forward values and betas of the group's cache, at dropout 0 and 0.1:
    seg_weights_gather (alpha - Z, the score differences, the in-block
    scans and the whole-block sums in one cooperative launch) and seg_sums
    (the slots' counts) each equal to its twin bit for bit, and the counts
    never below 0. Each timed unqueued and queued (device time) beside its
    twin and its bound at the group's real hit counts; the whole
    segsum_expected call timed with the kernels and with the twins' tail
    on the card (seg_sums_plain after the gather kernel: the torch ops
    the parent's route ran), its launches counted (one of each kernel)
    and its device kernels listed by a profiler (two, nothing else)."""
    rank = lat.build_rank_space(table)
    _, raw = lat.match_cache(tbl, batch)
    slots = lat.remap_slots(torch.as_tensor(rank.lut, device=dev), raw)
    del raw
    rows = lat.rank_score_rows(rank, tbl)
    cache = (lat.score_from_slots(rows, slots), slots)
    seg = lat.build_seg_struct(slots, rank.n_pad)
    H = int(seg.perm_flat.shape[0])
    B, W = batch.p1.shape[0], batch.width
    L, OC = seg.occ_slot.shape
    caps = torch.tensor([p.shape[0] for p in seg.perm], device=dev)
    n_real = int((seg.end_pos != caps[:, None]).sum())
    nbins = lat.rows_nbins(rows)
    res = {"hits": list(seg.n_hit), "capacity": H,
           "shape": {"W": W, "B": B, "L": L, "H": H, "occurring": OC,
                     "entries": n_real, "nbins": nbins,
                     "chains": int((seg.nxt >= 0).sum())}}
    for dropout in (0.0, 0.1):
        du = drop_words(batch, dropout, dev)
        A = lat.forward(tbl, batch, cache, drop_u=du, dropout=dropout)
        Bt = lat.backward_betas(tbl, batch, cache, drop_u=du,
                                dropout=dropout)
        args = (seg, A, batch.end_index, batch.is_start, Bt, rows, du)
        kw = {"dropout": dropout, "pad": batch.pad}
        want = []
        plain_ms = cuda_ms(lambda: want.append(
            lcs.seg_weights_gather_plain(*args, **kw)), iters=1, warmup=0)
        want = want[0]
        got = lcs.seg_weights_gather(*args, **kw)
        torch.cuda.synchronize()
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        for i, what in enumerate(("cf", "t", "whole-block sums",
                                  "zeroed accumulator")):
            check(torch.equal(got[i], want[i]),
                  f"seg_weights_gather (dropout {dropout}): {what} differs "
                  f"from the twin (max |err| {err})")
        acc_want = []
        sums_plain_ms = cuda_ms(lambda: acc_want.append(lcs.seg_sums_plain(
            seg, *want[:3], want[3].clone())), iters=1, warmup=0)
        acc_want = acc_want[0]
        acc = lcs.seg_sums(seg, *got[:3], got[3].clone())
        torch.cuda.synchronize()
        sums_err = float((acc.double() - acc_want.double()).abs().max())
        check(torch.equal(acc, acc_want),
              f"seg_sums (dropout {dropout}): the counts differ from the "
              f"twin (max |err| {sums_err})")
        check(bool((acc >= 0).all()) and float(acc.sum()) > 0,
              f"seg_sums (dropout {dropout}): a count below 0, or none")
        del want, acc_want
        ms = cuda_ms(lambda: lcs.seg_weights_gather(*args, **kw), iters=20)
        dev_ms = cuda_ms(lambda: lcs.seg_weights_gather(*args, **kw),
                         iters=20, queued=True)
        sums_ms = cuda_ms(lambda: lcs.seg_sums(seg, *got[:3], got[3]),
                          iters=20)
        sums_dev_ms = cuda_ms(lambda: lcs.seg_sums(seg, *got[:3], got[3]),
                              iters=20, queued=True)

        def call():
            return lat.segsum_expected(tbl, batch, A, Bt, seg, rows, du,
                                       dropout)

        def twin_tail():
            out = lcs.seg_weights_gather(*args, **kw)
            return lcs.seg_sums_plain(seg, *out)[:nbins]

        before = (lcs.seg_weights_gather.launches, lcs.seg_sums.launches)
        counts = call()
        torch.cuda.synchronize()
        launched = (lcs.seg_weights_gather.launches - before[0],
                    lcs.seg_sums.launches - before[1])
        check(launched == (1, 1), f"segsum_expected launched "
              f"seg_weights_gather / seg_sums {launched} times, not once")
        check(torch.equal(counts, acc[:nbins]),
              "segsum_expected differs from the kernels called alone")
        profile = segsum_profile(call)
        names = " ".join(n for n, _ in profile)
        check(sum(c for _, c in profile) == 2 and "seg_gather_kernel" in names
              and "seg_sums_kernel" in names,
              f"segsum_expected ran other device work than its two "
              f"kernels: {profile}")
        segsum_ms = cuda_ms(call, iters=10)
        segsum_dev_ms = cuda_ms(call, iters=10, queued=True)
        tail_ms = cuda_ms(twin_tail, iters=5)
        check(torch.equal(twin_tail(), counts),
              "the twins' tail differs from seg_sums")
        # seg_weights_gather. Bytes: per hit its position in and cf out;
        # per block its slot and entry in and its total out; the entries'
        # slots, bounds; the (B, W + 1) forward values, betas and start
        # flags, the (B, W) sample ends, the score column and the dropout
        # words read once; the whole-block sums and the accumulator
        # written once. Operations: per hit 14 scan adds, two adds, an exp,
        # the mask and ~5 for the gathers' index arithmetic; ~6 per
        # position for alpha - Z.
        nbytes = (8 * H + 12 * (H // lcs.SEG_BLK) + 12 * L * OC
                  + 9 * B * (W + 1) + 4 * B * W + 4 * (nbins + 1)
                  + (du.numel() * 4 if du is not None else 0)
                  + 8 * L * OC + 4 * (nbins + 1))
        b_ms, b_by = bound(nbytes, 23 * H + 6 * B * W)
        # seg_sums. Bytes: the entries' slots, bounds and chain links and
        # the whole-block sums read once; per real entry two cf and one
        # block total read, its count written. Operations: ~10 per real
        # entry.
        s_bytes = 24 * L * OC + 16 * n_real
        s_ms, s_by = bound(s_bytes, 10 * n_real)
        res[f"dropout_{dropout}"] = {
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "segsum_ms": segsum_ms, "segsum_device_ms": segsum_dev_ms,
            "segsum_twin_tail_ms": tail_ms, "profile": profile,
            "sums": {"max_abs_err": sums_err, "ms": sums_ms,
                     "device_ms": sums_dev_ms, "plain_ms": sums_plain_ms,
                     "bound_ms": s_ms, "bound_by": s_by}}
        log(f"seg_weights_gather (W={W}, B={B}, {L} lengths, H={H}, dropout "
            f"{dropout}): {ms:.4f} ms in one launch (device {dev_ms:.4f}), "
            f"plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), max "
            f"|err| {err} (cf, t, sums, accumulator equal)")
        log(f"seg_sums ({L} x {OC} entries, {n_real} real, "
            f"{res['shape']['chains']} chained): {sums_ms:.4f} ms (device "
            f"{sums_dev_ms:.4f}), plain {sums_plain_ms:.2f} ms, bound "
            f"{s_ms:.4f} ms ({s_by}), max |err| {sums_err} (equal)")
        log(f"segsum_expected (dropout {dropout}): {segsum_ms:.4f} ms "
            f"(device {segsum_dev_ms:.4f}); with the twins' tail "
            f"{tail_ms:.4f} ms; device work of one call {profile}")
    log(f"seg_weights_gather: hits per length {res['hits']}, capacity {H}")
    return res


# ---------------------------------------------------------------------------
# Phase 3: the main path end to end
def check_viterbi_walk(lat, tbl, batch, spans, dev, route: str, scan=None):
    """viterbi_walk against its twin on encode's first group of `route`
    (or, with `scan`, the (dp, best_l) of another pass over `batch`):
    the route's own Viterbi backpointers, the group's spans, counts and
    ids bit-equal, each mode timed beside the twin (as every kernel is,
    host work included) and as device time alone (queued), and the chain
    floor: the row of the longest span, alone."""
    dp, best_l = scan or lat.viterbi(tbl, batch, backend=route)
    B, W = best_l.shape
    index = lat.walk_index(spans, B, W, dev)
    ok = torch.isfinite(index.dp_ends(dp))
    args, kw = lat._walk_tables(tbl, batch)
    walk = (best_l, *args, index)
    torch.cuda.synchronize()
    res = {"route": route, "spans": len(spans)}
    walked = int(ok.sum())
    # in_t1[id]: the token's exact row lies in T1, so its probe needs no
    # T2 row; every other token (bin V too) needs both.
    in_t1 = torch.zeros(tbl.vocab_size + 1, dtype=torch.bool, device=dev)
    t1_ids = tbl.t1_exact[:, 2] & 0xFFFFFF
    in_t1[t1_ids[t1_ids < tbl.vocab_size].long()] = True
    first = WALK_FIRST_DESIGN_MS.get(route)
    for mode in ("count", "ids"):
        ids = mode == "ids"
        want = []
        plain_ms = cuda_ms(lambda: want.append(lat.viterbi_walk_plain(
            *walk, ok=ok, ids=ids, **kw)), iters=1, warmup=0)
        want = want[0]
        got = lat.viterbi_walk(*walk, ok=ok, ids=ids, **kw)
        torch.cuda.synchronize()
        if ids:
            check(torch.equal(got[1], want[1])
                  and torch.equal(got[2], want[2]),
                  f"viterbi_walk ({route}): token counts per span or their "
                  "offsets differ")
            total = int(want[1].sum())
            g, w = got[0][:total], want[0][:total]
            check(torch.equal(g, w), f"viterbi_walk ({route}): ids differ")
            err = float((g - w).abs().max()) if total else 0.0
            check(int(g.max()) < tbl.vocab_size,
                  f"viterbi_walk ({route}): a token matched no table row")
            seen = torch.zeros_like(in_t1)
            seen[w.long()] = True
        else:
            check(torch.equal(got, want),
                  f"viterbi_walk ({route}): counts differ")
            err = float((got - want).abs().max())
            total = int(got[:-1].sum())
            check(int(got[-1]) == 0,
                  f"viterbi_walk ({route}): a token matched no table row")
            seen = want > 0
        ms = cuda_ms(lambda: lat.viterbi_walk(*walk, ok=ok, ids=ids, **kw),
                     iters=20)
        # The launches alone: the calls queue behind a sleep, so the
        # wrapper's host work does not enter the time.
        device_ms = cuda_ms(lambda: lat.viterbi_walk(*walk, ok=ok, ids=ids,
                                                     **kw),
                            iters=20, queued=True)
        # Bytes, each input read once: best_l and the span arrays; the two
        # prefix-hash words of every token boundary (tokens tile a walked
        # span, so it has tokens + 1 boundaries); the two (pad + W,)
        # inverse-power arrays every row shares; the 16-byte T1 row of
        # each distinct token this run resolves, and its T2 row where T1
        # does not hold it (at most the tables' H rows each); the ids and
        # token counts (ids) or the counts (count) written.
        H = tbl.t1_exact.shape[0]
        distinct = int(seen.sum())
        t2_rows = int((seen & ~in_t1).sum())
        nbytes = (best_l.numel() * best_l.element_size() + 13 * len(spans)
                  + 8 * (total + walked) + 8 * args[2].numel()
                  + 16 * min(distinct, H) + 16 * min(t2_rows, H)
                  + (4 * (total + len(spans)) if ids
                     else 4 * (tbl.vocab_size + 1)))
        b_ms, b_by = bound(nbytes, 0)
        res[mode] = {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "tokens": total,
                     "distinct_ids": distinct, "t2_rows": t2_rows,
                     "bytes": nbytes}
        log(f"viterbi_walk ({route}, {mode} mode, W={W}, B={B}, "
            f"{len(spans)} spans, {total} tokens, {distinct} distinct ids, "
            f"{t2_rows} of them in T2, {nbytes} bytes): {ms:.4f} ms "
            f"({device_ms:.4f} ms queued, the launches alone: the byte "
            f"copy and {'two launches and a cumsum' if ids else 'one launch'}"
            + (f"; the first design {first[mode]:.4f} ms measured the same "
               "way by experiments/torch_walk_design.py on "
               f"{WALK_FIRST_DESIGN_ON}" if first else "")
            + f"), plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"max |err| {err} (equal)")
    # The chain floor: the row of the longest span, alone.
    k = int(torch.argmax((index.ends - index.starts) * ok))
    one = lat.walk_index([spans[k]], B, W, dev)
    ok1 = ok[k : k + 1].contiguous()
    rows8 = best_l.to(torch.uint8).contiguous()  # no group-wide copy
    res["floor_ms"] = cuda_ms(lambda: lat.viterbi_walk(
        rows8, *args, one, ok=ok1, **kw), iters=20, queued=True)
    res["longest_span"] = int(index.ends[k] - index.starts[k])
    log(f"viterbi_walk ({route}): chain floor, the longest span's row "
        f"alone ({res['longest_span']} bytes, count mode, queued) "
        f"{res['floor_ms']:.4f} ms"
        + (f", the first design {first['floor']:.4f} ms" if first else ""))
    return res


def check_chained_walk(lat, ed, samples, vocabs, dev):
    """chained_walk against its twin at the merge cell's shape: 54 samples
    of 32 KiB + 1 to 94 KiB (the cell's files past the pack cap: 2-3
    windows of 32 KiB each, a row batch of 128), cut from the corpus and
    encoded through `_encode_chained` over each vocabulary's table
    (`vocabs`: L = 16 and L = 20). The walk's own inputs run through the
    kernel and the twin on the card: ids, tokens a window and flags equal;
    the kernel timed beside the twin (host work included) and queued
    (device time alone). Bytes: a position's backpointer and byte, two
    exact-table rows of 16 B and an id of 4 B a token."""
    from tokengeex_tpu_torch.ops.match_table import TokenTable

    W = ed.chained_width()
    rng = np.random.default_rng(SEED + 24)
    lens = [94 * 1024] + rng.integers(W + 1, 94 * 1024, 53).tolist()
    big = b"\n".join(samples)
    check(len(big) >= sum(lens), "chained walk: corpus too short")
    offs = np.cumsum([0] + lens)
    long = [(i, big[offs[i] : offs[i + 1]]) for i in range(len(lens))]
    res = {}
    for name, vocab in vocabs.items():
        dt = lat.DeviceTables.from_table(TokenTable.build(vocab), dev)
        L = dt.max_len
        seen = {}
        walk = lat.chained_walk

        # Wrapped, so that the launches the module counts on the name
        # `chained_walk` land on the spy while it stands there.
        @functools.wraps(walk)
        def spy(*a, **k):
            seen["args"], seen["kw"] = a, k
            return walk(*a, **k)

        lat.chained_walk = spy
        try:
            ed._encode_chained(dt, long, W, backend=ed._eff_backend(
                dt, None, torch.float32), dropout=0.0, seed=0x5151,
                probe=None, device=dev)
        finally:
            lat.chained_walk = walk
        a, kw = seen["args"], seen["kw"]
        bl, nwin = a[0], a[2]
        K, NW = int(nwin.max()), bl.shape[0]
        check(K == 3 and NW == int(nwin.sum()) and NW >= 3 * len(long) // 2,
              f"chained walk ({name}): {NW} windows, {K} at most")
        want = []
        plain_ms = cuda_ms(lambda: want.append(lat.chained_walk_plain(
            *a, **kw)), iters=1, warmup=0)
        got = walk(*a, **kw)
        torch.cuda.synchronize()
        flat, ntok, bad = want[0]
        total = int(ntok.sum())
        check(torch.equal(got[1], ntok) and torch.equal(got[2], bad),
              f"chained walk ({name}): tokens a window or flags differ")
        check(torch.equal(got[0][:total], flat[:total])
              and not bool(got[0][total:].any()),
              f"chained walk ({name}): ids differ")
        check(total > 0 and int(flat[:total].max()) <= dt.vocab_size,
              f"chained walk ({name}): ids out of range")
        ms = cuda_ms(lambda: walk(*a, **kw), iters=20)
        device_ms = cuda_ms(lambda: walk(*a, **kw), iters=20, queued=True)
        positions = sum(lens)
        nbytes = 2 * positions + 36 * total
        b_ms, b_by = bound(nbytes, 0)
        res[name] = {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "L": L, "bits": dt.bits,
                     "samples": len(long), "windows": NW, "max_windows": K,
                     "scan_rows": -(-len(long) // ed.ROW_MULT) * ed.ROW_MULT,
                     "positions": positions, "tokens": total,
                     "false": int(bad.sum()), "bytes": nbytes}
        log(f"chained_walk ({name}, L={L}, {len(long)} samples, {NW} "
            f"windows of {W}, {K} at most, {total} tokens, {nbytes} bytes): "
            f"{ms:.4f} ms ({device_ms:.4f} ms queued: two launches and a "
            f"cumsum), plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {ms / b_ms:.1f} x bound, equal")
        del dt
    return res


def probe_bytes_ops(tbl, batch, mode, lead, slots, dtype):
    """(bytes, operations) the probe of `batch` needs: the score (and
    slot) caches written once, the prefix hashes and sample ids over the
    probed positions and the inverse powers read once, the mode's table
    read once (every row: a group's ~10^7 valid probes touch them all);
    ~14 integer operations a (position, length, row) point (the two
    fingerprints, the slot hash, the checks)."""
    B, W, L = batch.p1.shape[0], batch.width, tbl.max_len
    Q = lead + W
    points = Q * L * B
    out = points * (torch.empty((), dtype=dtype).element_size()
                     + (4 if slots else 0))
    streams = 3 * 4 * B * (Q + L) + 2 * 4 * Q
    if mode == "bucket":
        table = tbl.t_bucket.numel() * 4
    elif mode == "exact":
        table = (tbl.t1_exact.numel() + tbl.t2_exact.numel()) * 4 \
            + tbl.scores.numel() * tbl.scores.element_size()
    else:
        table = (tbl.t1_fast.numel() + tbl.t2_fast.numel()) * 4
    return out + streams + table, 14 * points


def chained_window(lat, ed, samples, L: int, dev):
    """The second chained window (k = 1, every row's tail real) of
    `samples` at the chained encode's width, as `_encode_chained` makes
    it: rows [last L bytes of window 0 | body], padded to ROW_MULT."""
    W = ed.MAX_ENCODE_WIDTH
    Rp = -(-len(samples) // ed.ROW_MULT) * ed.ROW_MULT
    rows = np.zeros((Rp, L + W), dtype=np.uint8)
    n_valid = np.zeros(Rp, dtype=np.int32)
    has_tail = np.zeros(Rp, dtype=bool)
    for r, s in enumerate(samples):
        check(len(s) > W, "chained window: a sample fits one window")
        body = s[W : 2 * W]
        rows[r, :L] = np.frombuffer(s[W - L : W], dtype=np.uint8)
        rows[r, L : L + len(body)] = np.frombuffer(body, dtype=np.uint8)
        n_valid[r] = len(body)
        has_tail[r] = True
    return lat.prepare_chained_batch(rows, n_valid, has_tail, L, W, dev)


def filter_counts(tbl, batch, lead, C=256):
    """The bucket filter's rule counted on a probe of `batch` at `lead`,
    in torch ops (not inside the kernel): the valid points, the points
    whose tag bit is set in their row's filter byte (the ones that
    gather) and the gathers in rows with bit 7 set (a row placing an
    entry past 3: at most these read a second sector)."""
    from tokengeex_tpu_torch.ops import hashing as H
    from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp

    L, dev = tbl.max_len, batch.p1.device
    tags = tbl.bk_filter.tags.to(torch.int64)
    lens = torch.arange(1, L + 1, device=dev)
    mix = H.wrap_i32(lens * int(H.IDX_A1)) ^ H.i32(tbl.bk_salt)
    n = {"valid": 0, "gathered": 0, "overflow_rows": 0}
    for q0 in range(0, lead + batch.width, C):
        g, m = batch.pad - lead + q0, min(C, lead + batch.width - q0)
        ends = torch.arange(m, device=dev)[:, None] + lens  # (m, L)

        def fp(p, rinv):  # (B, m, L)
            s = p[:, g : g + m + L]
            return H.mul_i32(H.sub_i32(s[:, ends], s[:, :m, None]),
                             rinv[g : g + m][None, :, None])

        sid = batch.sid[:, g : g + m + L - 1]
        valid = (sid[:, :m, None] >= 0) & (sid[:, ends - 1]
                                           == sid[:, :m, None])
        row = H.srl_i32(H.mul_i32(fp(batch.p1, batch.rinv1) ^ mix,
                                  H.i32(int(H.IDX_M1))), 32 - tbl.bk_bits)
        f = tags[row.long()]
        live = valid & (((f >> lcp.filter_tag(fp(batch.p2, batch.rinv2)))
                         & 1) == 1)
        n["valid"] += int(valid.sum())
        n["gathered"] += int(live.sum())
        n["overflow_rows"] += int((live & (f >= 128)).sum())
    return n


def check_match_cache(lat, ed, vocab, vocab_prune, batch, long_samples,
                      dev):
    """match_cache (csrc/match_probe.cu, one launch a group) against
    match_cache_plain on the card, score and slot bit for bit: on encode
    (a)'s first group (`batch`, the 32k vocabulary) in bucket and fast
    mode, and in bucket mode with the cached prune's table (`vocab_prune`,
    buckets at bits 17), slots on and off; in exact mode at float32 and
    float64 (the f64 route's tables) on the chained window of the f64
    phase's long samples, lead = L, slots on and off. Each case timed
    unqueued (as the path calls it: the checks, the outputs' allocation,
    the launch) and queued (device time), beside the twin, the bound and
    the first design's recorded times, with the kernel's branch; in
    bucket mode with the filter's counts (`filter_counts`)."""
    from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
    from tokengeex_tpu_torch.ops.match_table import TokenTable

    table = TokenTable.build(vocab)
    tables = {torch.float32: lat.DeviceTables.from_table(table, dev),
              torch.float64: lat.DeviceTables.from_table(table, dev,
                                                         torch.float64)}
    prune_table = TokenTable.build(vocab_prune)
    check(prune_table.bk_bits == 17,
          f"the prune's table at bits {prune_table.bk_bits}, not 17")
    tables["bits 17"] = lat.DeviceTables.from_table(prune_table, dev)
    L = tables[torch.float32].max_len
    window = chained_window(lat, ed, long_samples, L, dev)
    cases = [("bucket", torch.float32, batch, 0),
             ("bucket", "bits 17", batch, 0),
             ("fast", torch.float32, batch, 0),
             ("exact", torch.float32, window, L),
             ("exact", torch.float64, window, L)]
    res = {}
    for mode, key, b, lead in cases:
        tbl = tables[key]
        dtype = torch.float64 if key == torch.float64 else torch.float32
        for slots in (False, True):
            tag = (f"{mode}{'[f64]' if dtype == torch.float64 else ''}"
                   f"{'[bits 17]' if key == 'bits 17' else ''}"
                   f"{', slots' if slots else ''}")
            args = (tbl, b)
            kw = {"probe": mode, "lead": lead, "slots": slots,
                  "dtype": dtype}
            want = []
            plain_ms = cuda_ms(lambda: want.append(lat.match_cache_plain(
                *args, C=ed.CHUNK, **kw)), iters=1, warmup=0)
            want = want[0]
            got = lat.match_cache(*args, C=ed.CHUNK, **kw)
            torch.cuda.synchronize()
            check(got[0].dtype == dtype and torch.equal(got[0], want[0]),
                  f"match_cache ({tag}): scores differ from the twin's")
            check(slots == (got[1] is not None)
                  and (not slots or torch.equal(got[1], want[1])),
                  f"match_cache ({tag}): slots differ from the twin's")
            err = max_abs_err(got[0], want[0])
            hits = int(torch.isfinite(want[0]).sum())
            check(hits > 0, f"match_cache ({tag}): no token matched")
            del got, want
            branch = lcp.probe_branch(tbl, mode)
            check(branch == ("filtered" if mode == "bucket" else "gather"),
                  f"match_cache ({tag}): the {branch} branch")
            shares = {}
            if branch == "filtered":
                n = filter_counts(tbl, b, lead)
                shares = {**n, "filtered_share": 1 - n["gathered"]
                          / max(n["valid"], 1),
                          "overflow_share": n["overflow_rows"]
                          / max(n["gathered"], 1)}
            ms = cuda_ms(lambda: lat.match_cache(*args, C=ed.CHUNK, **kw),
                         iters=10)
            dev_ms = cuda_ms(lambda: lat.match_cache(*args, C=ed.CHUNK,
                                                     **kw),
                             iters=10, queued=True)
            nbytes, ops = probe_bytes_ops(tbl, b, mode, lead, slots, dtype)
            b_ms, b_by = bound(nbytes, ops)
            Q, B = lead + b.width, b.p1.shape[0]
            first = PROBE_FIRST_DESIGN_MS.get(tag)
            res[tag] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "bytes": nbytes, "ops": ops,
                        "hits": hits, "shape": [Q, L, B],
                        "branch": branch, **shares,
                        "first_design_ms": first,
                        "library_ms": None}
            log(f"match_cache ({tag}; {Q} x {L} x {B}, lead {lead}, "
                f"{hits} hits, {branch} branch): {ms:.4f} ms (device "
                f"{dev_ms:.4f}), plain {plain_ms:.2f} ms, bound {b_ms:.4f} "
                f"ms ({b_by}: {nbytes} bytes, {ops} operations), "
                f"x{ms / b_ms:.1f} the bound; equal to the twin (max |err| "
                f"{err})")
            if shares:
                log(f"match_cache ({tag}): the filter's rule on the group "
                    f"(counted in torch ops): {shares['valid']} valid "
                    f"points, {shares['gathered']} gather "
                    f"({shares['filtered_share']:.4f} kept from the L2); "
                    f"{shares['overflow_rows']} gathers in rows placing an "
                    f"entry past 3 ({shares['overflow_share']:.6f}; at most "
                    "these read a second sector)")
            if first:
                log(f"match_cache ({tag}): the first design "
                    f"{first['ms']:.4f} ms (device {first['device_ms']:.4f}"
                    f"; recorded on {PROBE_FIRST_DESIGN_ON})")
            torch.cuda.empty_cache()
    del window
    return res


def check_alternatives_kernels(lat, lc, ed, vocab, dev):
    """The prune alternatives' two kernels on the first row group of the
    masked f64 pass over `vocab`'s own bytes (ed.alternative_groups: every
    token a sample, W = 512, spans of at most L bytes, chains every
    ALT_SEGMENT positions): viterbi_scan's double instantiation over the
    masked exact-probe cache, bit-equal to its twin, timed beside its f32
    instantiation on the same inputs cast to float32, its plain version
    and its bound; then viterbi_walk in both modes on its backpointers
    (check_viterbi_walk)."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops.match_table import TokenTable

    f64 = torch.float64
    dt = lat.DeviceTables.from_table(TokenTable.build(vocab), dev, f64)
    sub, batch, cache, chains, _, _ = next(
        ed.alternative_groups(Model(vocab), dt))
    W, L, B = cache.shape
    K = chains[0].shape[0] - 1
    starts = batch.is_start[:, 1:].t().to(f64).contiguous()
    hist = lat._hist0(batch, L, None, f64).clamp(min=lc.NEG).t().contiguous()
    args = (cache, starts, hist, chains[0])
    kw = {"pad": batch.pad}
    want = []
    plain_ms = cuda_ms(lambda: want.append(lc.viterbi_scan_plain(*args,
                                                                  **kw)),
                       iters=1, warmup=0)
    got = lc.viterbi_scan(*args, **kw)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want[0]):
        check(torch.equal(g_, w_), "viterbi_scan[f64] (alternatives) "
              "differs from its twin")
    err = max_abs_err(got[0], want[0][0])
    del want
    ms = cuda_ms(lambda: lc.viterbi_scan(*args, **kw), iters=20)
    a32 = [a.float() if a.is_floating_point() else a for a in args]
    ms32 = cuda_ms(lambda: lc.viterbi_scan(*a32, **kw), iters=20)
    del a32
    # The cache, starts, history and chain bounds read, dp (8) and best_l
    # (4) written; an add, a max and a compare per (position, length).
    b_ms, b_by = bound(8 * (W * L * B + W * B + L * B) + 4 * (K + 1) * B
                       + 12 * W * B, 3 * W * L * B, F64_OPS_PER_S)
    scan = {"max_abs_err": err, "ms": ms, "f32_ms": ms32,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"viterbi_scan[f64] (alternatives: W={W}, L={L}, B={B}, "
        f"{len(sub.spans)} tokens, {K} segments): {ms:.4f} ms (f32 on the "
        f"same inputs {ms32:.4f} ms), plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), max |err| {err:.3e} (equal)")
    walk = check_viterbi_walk(lat, dt, batch, sub.spans, dev,
                              "alternatives",
                              scan=(lat._finish(got[0].t()), got[1].t()))
    return {"shape": {"W": W, "L": L, "B": B, "segments": K,
                      "tokens": len(sub.spans)},
            "viterbi_scan": scan, "walk": walk}


# ---------------------------------------------------------------------------


def count_plain_probes(lat):
    """Count the probe twin's calls on CUDA tensors: `lat.match_cache_plain`
    wrapped, its count in `.launches` beside the kernels' (0 on the main
    path: the card takes the kernel)."""
    plain = lat.match_cache_plain

    def counted(tbl, batch, *args, **kwargs):
        if batch.p1.is_cuda:
            counted.launches += 1
        return plain(tbl, batch, *args, **kwargs)

    counted.launches = 0
    lat.match_cache_plain = counted
    return counted


def check_probes(tag, launches, want) -> None:
    """The probe kernel launched `want` times (f32) and its twin never on
    the card."""
    check(launches["match_cache"] == want
          and launches["match_cache_plain"] == 0,
          f"{tag}: the probe kernel launched {launches['match_cache']} "
          f"times (want {want}), its twin called "
          f"{launches['match_cache_plain']} times on the card")


def run_config(name, vocab, samples, long_sample, expect, groups, kernels,
               dev):
    """Phase 3: encode on the card; `expect` names the route's Viterbi
    kernel, which the encode must launch once per row group (`groups`)."""
    from tokengeex_tpu_torch import Model, Tokenizer
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.train import estep_device as ed

    model = Model(vocab)
    tok = Tokenizer(model, device=dev)
    texts = [s.decode() for s in samples]
    total = sum(map(len, samples))
    tok.encode_batch(texts[:64])  # warm-up: allocator, constants
    torch.cuda.synchronize()

    for fn in kernels.values():
        fn.launches = 0
    walk = kernels["viterbi_walk"]
    calls = walk.calls
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ids = tok.encode_batch(texts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: fn.launches for k, fn in kernels.items()}
    # One launch of the route's Viterbi kernel and one call of the walk
    # (its launches: the byte copy, the token counts, the ids) per row
    # group.
    for k, n in ((expect, launches[expect]),
                 ("viterbi_walk calls", walk.calls - calls)):
        check(n == groups, f"{name}: the main path ran {k} {n} times for "
              f"{groups} groups")
    check(launches["viterbi_walk"] >= 2 * groups,
          f"{name}: {launches['viterbi_walk']} walk launches for "
          f"{groups} groups")
    # The slab route probes each group once, through the kernel.
    check_probes(name, launches, groups if expect == "viterbi_scan" else 0)
    rate = total / secs
    log(f"[{name}] encode {total} bytes in {secs:.3f} s = "
        f"{rate / 1e6:.2f} MB/s; launches {launches} ({groups} groups); "
        f"peak device memory {peak / 2**20:.1f} MiB on "
        f"{torch.cuda.get_device_name(dev)}")

    timer = lat.PhaseTimer(dev)
    t0 = time.perf_counter()
    ids_t = tok.encode_batch(texts, timer=timer)
    secs_t = time.perf_counter() - t0
    check(ids_t == ids, f"{name}: a second encode gave other ids")
    phases = {k: round(v, 6) for k, v in timer.seconds.items()}
    log(f"[{name}] phases (synchronised run, {secs_t:.3f} s): {phases}")
    busy = device_busy(lambda: tok.encode_batch(texts))
    log(f"[{name}] profiled run: device busy {busy['busy_s']:.4f} s of "
        f"{busy['wall_s']:.3f} s wall, idle share {busy['idle_share']:.4f}")

    for text, row in zip(texts, ids):
        if tok.decode(row) != text:
            fail(f"{name}: a sample does not decode back to its text")
    cpu = Tokenizer(model, device="cpu").encode_batch(texts[:64])
    check(cpu == ids[:64], f"{name}: ids differ from the CPU plain run")
    ones = tok.encode_batch(texts[:64], dropout=1.0)
    check([len(r) for r in ones] == [len(s) for s in samples[:64]],
          f"{name}: dropout=1.0 did not give single bytes")
    drop = tok.encode_batch(texts[:64], dropout=0.1, seed=5)
    check(all(tok.decode(r) == t for r, t in zip(drop, texts[:64])),
          f"{name}: a dropout=0.1 encode does not decode back")

    chained = {"calls": 0}
    orig = ed._encode_chained

    def counted(*a, **k):
        chained["calls"] += 1
        return orig(*a, **k)

    ed._encode_chained = counted
    try:
        long_text = long_sample.decode()
        lat.chained_walk.launches = 0
        long_ids = tok.encode_batch([long_text])[0]
        torch.cuda.synchronize()
        chained_launches = lat.chained_walk.launches
        long_cpu = Tokenizer(model, device="cpu").encode_batch([long_text])[0]
    finally:
        ed._encode_chained = orig
    check(chained["calls"] == 2, f"{name}: the long sample was not chained")
    # A byte copy of each window's backpointers, then the walk's two
    # launches.
    windows = -(-len(long_sample) // ed.chained_width())
    check(chained_launches == windows + 2,
          f"{name}: {chained_launches} chained walk launches for "
          f"{windows} windows")
    check(tok.decode(long_ids) == long_text,
          f"{name}: the chained sample does not decode back")
    check(long_ids == long_cpu, f"{name}: chained ids differ from CPU")
    log(f"[{name}] checks passed: decode, CPU plain run (64 samples), "
        f"dropout, chained {len(long_sample)}-byte sample "
        f"({chained_launches} chained walk launches)")
    return {"bytes": total, "seconds": secs, "bytes_per_s": rate,
            "launches": launches, "groups": groups, "peak_bytes": peak,
            "chained_launches": chained_launches,
            "phases": phases, "phases_run_seconds": secs_t, "profiled": busy,
            "tokens": sum(map(len, ids)), "ids_digest": ids_digest(ids)}


def oracle_total(model, samples, snippet: int) -> float:
    """Total expected count of the f64 oracle (Lattice.populate_marginal)
    over the samples cut into `snippet`-byte pieces, as the E-step cuts
    them."""
    from tokengeex_tpu_torch import Lattice

    expected = [0.0] * model.vocab_size()
    for s in samples:
        for off in range(0, len(s), snippet):
            lattice = Lattice(s[off : off + snippet])
            model.oracle.populate_nodes(lattice, 0.0)
            lattice.populate_marginal(expected)
    return float(sum(expected))


def run_estep(name, vocab, samples, kernels, dev):
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.prune import MAX_SAMPLE_LENGTH

    model = Model(vocab)
    total = sum(map(len, samples))

    def estep(batch, dropout=0.0, seed=0, device=dev, timer=None):
        return ed.run_e_step_device(model, batch, dropout, MAX_SAMPLE_LENGTH,
                                    seed=seed, device=device, timer=timer)

    estep(samples[:64])  # warm-up: allocator, constants
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    counts = estep(samples)
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    # Each scan once per row group.
    check(launches["forward_scan"] > 0 and launches["backward_marginal_scan"]
          == launches["forward_scan"],
          f"{name}: the E-step launched forward_scan "
          f"{launches['forward_scan']} and backward_marginal_scan "
          f"{launches['backward_marginal_scan']} times")
    check_probes(name, launches, launches["forward_scan"])
    check(bool(np.isfinite(counts).all()) and counts.sum() > 0,
          f"{name}: E-step counts not finite")
    rate = total / secs
    log(f"[{name}] E-step over {total} bytes in {secs:.3f} s = "
        f"{rate / 1e6:.2f} MB/s = {secs / (total / 1e9):.1f} s/GB; "
        f"launches {launches}; total count {counts.sum():.2f}")

    timer = lat.PhaseTimer(dev)
    t0 = time.perf_counter()
    counts_t = estep(samples, timer=timer)
    secs_t = time.perf_counter() - t0
    phases = {k: round(v, 6) for k, v in timer.seconds.items()}
    log(f"[{name}] E-step phases (synchronised run, {secs_t:.3f} s): "
        f"{phases}")
    check(bool(np.allclose(counts_t, counts, rtol=1e-4, atol=1e-4)),
          f"{name}: a second E-step gave other counts")
    busy = device_busy(lambda: estep(samples))
    log(f"[{name}] profiled E-step: device busy {busy['busy_s']:.4f} s of "
        f"{busy['wall_s']:.3f} s wall, idle share {busy['idle_share']:.4f}")

    t0 = time.perf_counter()
    drop = estep(samples, dropout=0.05, seed=3)
    secs_d = time.perf_counter() - t0
    check(bool(np.isfinite(drop).all()), f"{name}: dropout counts not finite")
    check(abs(drop.sum() - counts.sum()) / counts.sum() < 0.5,
          f"{name}: dropout 0.05 counts far from dropout 0")
    log(f"[{name}] E-step at dropout 0.05: {secs_d:.3f} s = "
        f"{total / secs_d / 1e6:.2f} MB/s; total count {drop.sum():.2f}")

    head = samples[:64]
    gpu = estep(head)
    cpu = estep(head, device="cpu")
    # The kernels equal their plain versions on the card (phase 2), but
    # the CPU's exp/log differ from the card's in the last ulp, which now
    # and then flips the rounding of a forward or backward value. At the
    # |A| of 2048-4096 that 1 KB snippets reach, one ulp is 2.44e-4, and
    # every marginal downstream moves by that much relative: rtol 1e-3
    # per token (up to ~4 such ulps); the total is held to 1e-5.
    tot_rel = abs(gpu.sum() - cpu.sum()) / cpu.sum()
    seen = cpu >= 0.5
    cnt_rel = float((np.abs(gpu - cpu)[seen] / cpu[seen]).max())
    check(bool(np.allclose(gpu, cpu, rtol=1e-3, atol=1e-4)) and
          tot_rel <= 1e-5,
          f"{name}: E-step counts differ from the CPU plain run "
          f"(max rel {cnt_rel:.2e}, total rel {tot_rel:.2e})")
    want = oracle_total(model, head, ed.DEVICE_EM_SNIPPET)
    rel = abs(gpu.sum() - want) / want
    # The f32 forward values drift over a 1 KB snippet (|A| reaches ~4e3,
    # where one ulp is 2.4e-4, and rounding adds up over 1024 steps). On
    # (b)'s 64 samples the drift alone is over 1e-3, so the bound is 2e-3.
    # tests/test_torch_estep_oracle.py is the second witness, on the CPU:
    # the JAX package's f32 E-step lies as far from the oracle on these
    # samples, and its f64 E-step agrees with it.
    check(rel <= 2e-3, f"{name}: total count {gpu.sum()} is {rel:.2e} from "
          f"the f64 oracle's {want}")
    log(f"[{name}] checks passed: CPU plain run (64 samples, max |diff| "
        f"{np.abs(gpu - cpu).max():.3e}, max rel on counts >= 0.5 "
        f"{cnt_rel:.3e}, total rel {tot_rel:.3e}), f64 oracle total "
        f"{want:.3f} vs {gpu.sum():.3f} (rel {rel:.2e}), dropout 0.05")
    return {"bytes": total, "seconds": secs, "bytes_per_s": rate,
            "seconds_per_gb": secs / (total / 1e9), "launches": launches,
            "phases": phases, "phases_run_seconds": secs_t,
            "profiled": busy, "dropout_0.05_seconds": secs_d,
            "oracle_total": want, "oracle_rel_err": rel, "cpu_max_abs_diff":
            float(np.abs(gpu - cpu).max()), "cpu_max_rel_diff": cnt_rel,
            "cpu_total_rel_diff": tot_rel}


def run_session(name, vocab, samples, expect, kernels, oracle, dev,
                counts=None):
    """Phase 3d: DeviceTrainSession on the card at dropout 0 and 0.05.
    `oracle` is phase 3b's f64 oracle total over the first 64 samples;
    `counts`, when given, keeps each dropout's first-pass counts."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
    from tokengeex_tpu_torch.train.prune import MAX_SAMPLE_LENGTH

    model = Model(vocab)
    total = sum(map(len, samples))

    def session(batch=samples, timer=None):
        return DeviceTrainSession(model, batch, MAX_SAMPLE_LENGTH,
                                  device=dev, timer=timer)

    out = {}
    for dropout in (0.0, 0.05):
        tag = f"[{name}, dropout {dropout}]"
        for fn in kernels.values():
            fn.launches = 0
        ctor = lat.PhaseTimer(dev)
        t0 = time.perf_counter()
        sess = session(timer=ctor)
        build_s = time.perf_counter() - t0
        # Each pass ends by reading its counts back: no synchronisation
        # is needed around the host clock.
        t0 = time.perf_counter()
        first = sess.e_step(model, dropout, 3)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = sess.e_step(model, dropout, 3)
        steady_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        for k in expect:
            check(launches[k] > 0, f"{tag}: the session launched {k} no time")
        check(bool(np.isfinite(first).all()) and first.sum() > 0,
              f"{tag}: counts not finite")
        route = "fused" if sess._fused() else "cached"
        groups = sess._groups()
        shape = {"width": sess.width, "rows": groups[0][1].rows,
                 "block_rows": [sub.rows for _, sub in groups],
                 "groups": len(groups), "route": route,
                 "cache_bytes": sess.cache_used,
                 "cache_budget": sess.cache_budget}
        steady_timer = lat.PhaseTimer(dev)
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        sess.e_step(model, dropout, 3, timer=steady_timer)
        steady_t_s = time.perf_counter() - t0
        steady_launches = {k: fn.launches for k, fn in kernels.items()}
        for k in expect:
            check(steady_launches[k] == len(groups),
                  f"{tag}: a steady pass launched {k} "
                  f"{steady_launches[k]} times for {len(groups)} groups")
        busy = (device_busy(lambda: sess.e_step(model, dropout, 3))
                if dropout == 0.0 else None)
        sess.close()
        del sess
        # The first pass's phase split, on a fresh session.
        sess = session()
        first_timer = lat.PhaseTimer(dev)
        t0 = time.perf_counter()
        sess.e_step(model, dropout, 3, timer=first_timer)
        first_t_s = time.perf_counter() - t0
        sess.close()
        del sess
        torch.cuda.empty_cache()

        def split(timer):
            return {k: round(v, 6) for k, v in timer.seconds.items()}

        log(f"{tag} session {shape}; built in {build_s:.3f} s "
            f"{split(ctor)}; launches {launches}; a steady pass's "
            f"{steady_launches}")
        log(f"{tag} first pass {first_s:.3f} s = {total / first_s / 1e6:.2f} "
            f"MB/s; steady pass {steady_s:.3f} s = "
            f"{total / steady_s / 1e6:.2f} MB/s; total count "
            f"{first.sum():.2f}")
        log(f"{tag} first-pass phases (synchronised, {first_t_s:.3f} s): "
            f"{split(first_timer)}")
        log(f"{tag} steady phases (synchronised, {steady_t_s:.3f} s): "
            f"{split(steady_timer)}")
        res = {"shape": shape, "build_seconds": build_s,
               "build_phases": split(ctor), "first_seconds": first_s,
               "first_bytes_per_s": total / first_s,
               "steady_seconds": steady_s,
               "steady_bytes_per_s": total / steady_s,
               "first_phases": split(first_timer),
               "first_phases_run_seconds": first_t_s,
               "steady_phases": split(steady_timer),
               "steady_phases_run_seconds": steady_t_s,
               "launches": launches, "steady_launches": steady_launches,
               "total_count": float(first.sum()),
               "second_equals_first": bool(np.array_equal(first, second))}
        if busy is not None:
            log(f"{tag} profiled steady pass: device busy "
                f"{busy['busy_s']:.4f} s of {busy['wall_s']:.3f} s wall, "
                f"idle share {busy['idle_share']:.4f}; device ms by kernel "
                f"(name, calls, ms) {busy['top_kernels_ms']}")
            res["profiled"] = busy
        if dropout == 0.0:
            check(res["second_equals_first"],
                  f"{tag}: the steady pass gave other counts than the first")
            ref = ed.run_e_step_device(model, samples, 0.0, MAX_SAMPLE_LENGTH,
                                       device=dev)
            # The same lattices: the session sums marginals by segsum, the
            # per-pass E-step by scatter, and the two routes' kernels round
            # expf/logf apart; per token rtol 1e-3 (as against the CPU in
            # phase 3b), 1e-4 on the total.
            tot_rel = abs(first.sum() - ref.sum()) / ref.sum()
            seen = ref >= 0.5
            cnt_rel = float((np.abs(first - ref)[seen] / ref[seen]).max())
            check(bool(np.allclose(first, ref, rtol=1e-3, atol=1e-4))
                  and tot_rel <= 1e-4,
                  f"{tag}: counts differ from run_e_step_device (max rel "
                  f"{cnt_rel:.2e}, total rel {tot_rel:.2e})")
            head = samples[:64]
            sess = session(head)
            got = sess.e_step(model, 0.0, 0)
            sess.close()
            want = oracle
            rel = abs(got.sum() - want) / want
            check(rel <= 2e-3, f"{tag}: total count {got.sum()} is "
                  f"{rel:.2e} from the f64 oracle's {want}")
            log(f"{tag} checks passed: second pass equal, run_e_step_device "
                f"(max rel on counts >= 0.5 {cnt_rel:.3e}, total rel "
                f"{tot_rel:.3e}), f64 oracle total {want:.3f} vs "
                f"{got.sum():.3f} (rel {rel:.2e})")
            res.update(estep_max_rel_diff=cnt_rel, estep_total_rel_diff=tot_rel,
                       oracle_rel_err=rel)
        else:
            base = out["dropout_0.0"]["total_count"]
            check(abs(first.sum() - base) / base < 0.5,
                  f"{tag}: counts far from dropout 0")
            log(f"{tag} second pass equal to the first: "
                f"{res['second_equals_first']}")
        out[f"dropout_{dropout}"] = res
        if counts is not None:
            counts[dropout] = first
    return out


def run_session_over_budget(name, vocab, samples, want, kernels, dev):
    """Phase 3d, the over-budget branch: a session with no cache budget
    probes every group on every pass and counts through the marginal scan
    (once per group and pass) and the scatter. Its counts must match the
    budgeted session's (`want`, by dropout) to rtol 1e-3 / atol 1e-4 per
    token and 1e-4 on the total (segsum against scatter, whose atomic
    adds land in no fixed order)."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
    from tokengeex_tpu_torch.train.prune import MAX_SAMPLE_LENGTH

    model = Model(vocab)
    total = sum(map(len, samples))
    out = {}
    for dropout in (0.0, 0.05):
        tag = f"[{name}, over budget, dropout {dropout}]"
        sess = DeviceTrainSession(model, samples, MAX_SAMPLE_LENGTH,
                                  device=dev, cache_budget=0)
        groups = len(sess._groups())
        torch.cuda.reset_peak_memory_stats(dev)
        passes = []
        for _ in range(2):
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            got = sess.e_step(model, dropout, 3)
            passes.append(time.perf_counter() - t0)
            launches = {k: fn.launches for k, fn in kernels.items()}
            for k in ("forward_scan", "backward_marginal_scan"):
                check(launches[k] == groups,
                      f"{tag}: a pass launched {k} {launches[k]} times for "
                      f"{groups} groups")
            check(launches["seg_weights_gather"] == 0
                  and launches["seg_sums"] == 0
                  and not sess.slot_cache and sess.cache_used == 0,
                  f"{tag}: the session cached a group")
            # A probe a group (the fused route probes twice: once for its
            # SegStruct, refused, then for the pass).
            check_probes(tag, launches, groups * (2 if sess._fused() else 1))
            ref = want[dropout]
            tot_rel = abs(got.sum() - ref.sum()) / ref.sum()
            seen = ref >= 0.5
            cnt_rel = float((np.abs(got - ref)[seen] / ref[seen]).max())
            check(bool(np.allclose(got, ref, rtol=1e-3, atol=1e-4))
                  and tot_rel <= 1e-4,
                  f"{tag}: counts differ from the budgeted session's (max "
                  f"rel {cnt_rel:.2e}, total rel {tot_rel:.2e})")
        peak = torch.cuda.max_memory_allocated(dev)
        timer = lat.PhaseTimer(dev)
        t0 = time.perf_counter()
        sess.e_step(model, dropout, 3, timer=timer)
        split_s = time.perf_counter() - t0
        sess.close()
        del sess
        torch.cuda.empty_cache()
        split = {k: round(v, 6) for k, v in timer.seconds.items()}
        log(f"{tag} {groups} groups; passes {passes[0]:.3f} / "
            f"{passes[1]:.3f} s = {total / passes[1] / 1e6:.2f} MB/s; "
            f"launches {launches}; peak device memory {peak / 2**20:.1f} "
            f"MiB; counts against the budgeted session: max rel on counts "
            f">= 0.5 {cnt_rel:.3e}, total rel {tot_rel:.3e}")
        log(f"{tag} phases (synchronised, {split_s:.3f} s): {split}")
        out[f"dropout_{dropout}"] = {
            "groups": groups, "pass_seconds": passes,
            "bytes_per_s": total / passes[1], "launches": launches,
            "peak_bytes": peak, "phases": split,
            "phases_run_seconds": split_s, "max_rel_diff": cnt_rel,
            "total_rel_diff": tot_rel}
    return out


def tie_kind(scores, a, b) -> str:
    """How two segmentations of one token, a and b, tie: "exact" when
    their f64 sums in the forward order are equal, "reordered" when they
    are the same tokens in another order (equal in exact arithmetic) and
    their f64 sums at most 2 ulps apart; "" otherwise."""
    sa = sb = 0.0
    for i in a:
        sa += scores[i]
    for i in b:
        sb += scores[i]
    if sa == sb:
        return "exact"
    if sorted(a) == sorted(b) and abs(sa - sb) <= 2 * np.spacing(abs(sa)):
        return "reordered"
    return ""


def check_alternatives(tag, vocab, got, want, tids=None) -> dict:
    """The card's (always_keep, alternatives) against the oracle route's
    on the tokens `tids` (every token by default): keep flags equal, lists
    equal but where two multi-token paths tie (`tie_kind`), each such list
    a segmentation of its token. Returns the tie counts."""
    tids = range(len(vocab)) if tids is None else tids
    scores = [t.score for t in vocab]
    ties = {"exact": 0, "reordered": 0}
    for k, t in enumerate(tids):
        check(bool(got[0][t]) == bool(want[0][k]),
              f"{tag}: token {t} ({vocab[t].value!r}) keep flag differs "
              "from the oracle route's")
        g, w = got[1][t], want[1][k]
        if g == w:
            continue
        kind = tie_kind(scores, g, w) if g and w else ""
        check(kind != "" and b"".join(vocab[i].value for i in g)
              == vocab[t].value,
              f"{tag}: token {t} ({vocab[t].value!r}) alternatives {g} "
              f"differ from the oracle route's {w}, not a tie")
        ties[kind] += 1
    return ties


def run_prune(name, vocab, target: int, samples, expect, fused: bool,
              kernels, dev):
    """Phase 3c: VocabularyPruner from `vocab` down to `target` tokens
    through one session, whose E-steps take the fused route when `fused`
    (the initial table has has_vscan) and the cached route otherwise;
    `expect` names the kernels the run must launch. Every frequency pass
    launches the route's Viterbi kernel once per frequency group; each
    round's alternatives (one masked f64 pass on the card) launch
    viterbi_scan's double instantiation and the walk, and are held against
    the oracle route's, outside the round's timed steps."""
    from tokengeex_tpu_torch import Model, NoPathError, Tokenizer
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import lattice_cuda as lc
    from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
    from tokengeex_tpu_torch.ops.match_table import TokenTable
    from tokengeex_tpu_torch.train import prune as prune_mod
    from tokengeex_tpu_torch.train.prune import VocabularyPruner

    tag = f"[prune {name}]"
    check(lat.has_vscan(lat.DeviceTables.from_table(TokenTable.build(vocab),
                                                    dev)) == fused,
          f"{tag}: the initial table does not take the "
          f"{'fused' if fused else 'cached'} route")

    pruner = VocabularyPruner(vocab_size=target, shrink_factor=0.8,
                              em_subiters=2, dropout=0.05, device=dev)
    rounds = []
    mark = [time.perf_counter()]
    # Host-clock seconds per step of a round, each step's own (a step
    # inside another is not the outer one's); each step ends in a readback
    # to the host or is host work, so no synchronisation is needed.
    # `checks` are this script's comparisons; `rest` is what none of the
    # named steps covers.
    keys = ("e_steps", "frequencies", "alternatives", "m_step", "model",
            "loss", "rebind", "session", "checks")
    spent = dict.fromkeys(keys, 0.0)
    stack = []

    class span:
        def __init__(self, key):
            self.key = key

        def __enter__(self):
            stack.append(self.key)
            self.t = time.perf_counter()

        def __exit__(self, *exc):
            took = time.perf_counter() - self.t
            stack.pop()
            spent[self.key] += took
            if stack:
                spent[stack[-1]] -= took

    def timed(key, fn):
        def run(*args, **kwargs):
            with span(key):
                return fn(*args, **kwargs)
        return run

    freq_kernel = "fused_forward_chunk" if fused else "viterbi_scan"
    freq = {"passes": 0, "launches": 0, "walks": 0, "probes": 0,
            "plain_probes": 0, "host_checked": False}
    count_freq = pruner._count_frequencies

    def counted_freq(model, *args, **kwargs):
        before = kernels[freq_kernel].launches
        probes = kernels["match_cache"].launches
        plain_probes = kernels["match_cache_plain"].launches
        walks = kernels["viterbi_walk"].calls
        first = not freq["host_checked"]
        if first:
            # The first pass (it packs the frequency groups) split by phase.
            timer = lat.PhaseTimer(dev)
            sess = sessions[0]
            plain = sess.count_frequencies
            sess.count_frequencies = lambda m, task=None: plain(
                m, task, timer=timer)
        try:
            got = count_freq(model, *args, **kwargs)
        finally:
            freq["passes"] += 1
            freq["launches"] += kernels[freq_kernel].launches - before
            freq["probes"] += kernels["match_cache"].launches - probes
            freq["plain_probes"] += (kernels["match_cache_plain"].launches
                                     - plain_probes)
            freq["walks"] += kernels["viterbi_walk"].calls - walks
            if first:
                sess.count_frequencies = plain
                freq["first_split"] = {k: round(v, 6)
                                       for k, v in timer.seconds.items()}
        if first:
            # The first pass's counts against the host backtrack of the
            # same groups, kept out of the round's frequency seconds.
            freq["host_checked"] = True
            with span("checks"):
                counts = {k: fn.launches for k, fn in kernels.items()}
                want = host_frequency_counts(lat, sessions[0], model)
                check(np.array_equal(got, want), f"{tag}: the walk's counts "
                      "differ from the host backtrack")
                # A second pass of the same model, split by phase.
                timer = lat.PhaseTimer(dev)
                t1 = time.perf_counter()
                again = sessions[0].count_frequencies(model, timer=timer)
                freq["split"] = {k: round(v, 6)
                                 for k, v in timer.seconds.items()}
                freq["split_seconds"] = time.perf_counter() - t1
                check(np.array_equal(again, got),
                      f"{tag}: a second pass differs")
                # Neither check counts as the prune's launches.
                for k, fn in kernels.items():
                    fn.launches = counts[k]
            log(f"{tag} first frequency pass: {int(got.sum())} tokens, "
                "equal to the host backtrack of the same groups, "
                f"synchronised split {freq['first_split']}; a second pass, "
                f"synchronised: {freq['split_seconds']:.3f} s; "
                f"{freq['split']}")
        return got

    alt = {"launches_f64": 0, "walk_launches": 0, "probe_launches_f64": 0,
           "ties": []}
    alternatives = pruner._alternatives
    oracle = VocabularyPruner(target, backend="oracle")

    def checked_alternatives(model):
        f64, walks = lc.viterbi_scan.launches_f64, lat.viterbi_walk.launches
        probes = lcp.match_probe.launches_f64
        got = alternatives(model)
        alt["launches_f64"] += lc.viterbi_scan.launches_f64 - f64
        alt["walk_launches"] += lat.viterbi_walk.launches - walks
        alt["probe_launches_f64"] += lcp.match_probe.launches_f64 - probes
        with span("checks"):
            # The oracle route on a model of its own: the pruner's model
            # keeps its trie unbuilt.
            t = time.perf_counter()
            want = VocabularyPruner._alternatives(
                oracle, Model(list(model.vocab)))
            oracle_s = time.perf_counter() - t
            ties = check_alternatives(tag, model.vocab, got, want)
        alt["ties"].append(ties)
        log(f"{tag} alternatives of {model.vocab_size()} tokens equal to "
            f"the oracle route's ({oracle_s:.3f} s on the host), ties "
            f"{ties}, {int((~got[0]).sum())} tokens not kept, "
            f"{sum(bool(a) for a in got[1])} with alternatives")
        return got

    pruner.run_e_step = timed("e_steps", pruner.run_e_step)
    pruner.run_m_step = timed("m_step", pruner.run_m_step)
    pruner.prune_vocab = timed("loss", pruner.prune_vocab)
    pruner._count_frequencies = timed("frequencies", counted_freq)
    pruner._alternatives = timed("alternatives", checked_alternatives)
    sessions, routes = [], []
    new_session = pruner._new_session

    rebind = {"seconds": 0.0, "calls": 0}

    def counted_session(*args):
        with span("session"):
            sess = new_session(*args)
        sessions.append(sess)
        routes.append(sess._fused())
        orig_rebind = sess._rebind

        def timed_rebind(model, *args):
            t = time.perf_counter()
            before = sess._model
            with span("rebind"):
                orig_rebind(model, *args)
            if sess._model is not before:
                rebind["seconds"] += time.perf_counter() - t
                rebind["calls"] += 1
        sess._rebind = timed_rebind
        return sess

    pruner._new_session = counted_session

    def on_round(model, k):
        now = time.perf_counter()
        split = {key: round(v, 6) for key, v in spent.items()}
        split["rest"] = round(now - mark[0] - sum(spent.values()), 6)
        rounds.append({"round": k, "vocab_size": model.vocab_size(),
                       "seconds": now - mark[0],
                       "seconds_without_checks": now - mark[0]
                       - spent["checks"], "split": split})
        log(f"{tag} round {k}: {model.vocab_size()} tokens in "
            f"{now - mark[0]:.3f} s, {now - mark[0] - spent['checks']:.3f} s "
            f"without this script's checks; {split}")
        mark[0] = now
        spent.update(dict.fromkeys(spent, 0.0))

    for fn in kernels.values():
        fn.launches = 0
    lc.viterbi_scan.launches_f64 = 0
    prune_mod.Model = timed("model", Model)
    t0 = time.perf_counter()
    try:
        final = pruner.prune(Model(vocab), samples, checkpoint_cb=on_round)
    except NoPathError as e:
        fail(f"{tag}: the frequency pass found no path ({e}): the M-step "
             "dropped a byte token the corpus needs")
    finally:
        prune_mod.Model = Model
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    for k in expect:
        check(launches[k] > 0, f"{tag}: launched {k} no time")
    check(len(sessions) == 1 and pruner._session is None
          and sessions[0].dt is None,
          f"{tag}: built {len(sessions)} sessions, or did not close one")
    check(routes == [fused], f"{tag}: the session took the other route")
    freq_groups = len(sessions[0]._freq_groups())
    for k, n in ((freq_kernel, freq["launches"]),
                 ("viterbi_walk calls", freq["walks"])):
        check(freq["passes"] > 0 and n == freq["passes"] * freq_groups,
              f"{tag}: {freq['passes']} frequency passes ran {k} "
              f"{n} times for {freq_groups} groups")
    check(freq["host_checked"], f"{tag}: no frequency pass was checked")
    # The cached route's frequency groups (packed at the encode width,
    # apart from the E-step's) probe once a group a pass, through the
    # kernel; the fused route probes in its Viterbi kernel.
    want_probes = (0 if fused or sessions[0]._freq_shared
                   else freq["passes"] * freq_groups)
    check(freq["probes"] == want_probes and freq["plain_probes"] == 0,
          f"{tag}: {freq['passes']} frequency passes launched the probe "
          f"kernel {freq['probes']} times (want {want_probes}) and called "
          f"its twin {freq['plain_probes']} times on the card")
    check(alt["probe_launches_f64"] == alt["launches_f64"],
          f"{tag}: the alternatives launched the probe kernel "
          f"{alt['probe_launches_f64']} times for "
          f"{alt['launches_f64']} viterbi_scan[f64] launches")
    check(len(alt["ties"]) == freq["passes"]
          and alt["launches_f64"] >= freq["passes"]
          and lc.viterbi_scan.launches_f64 == alt["launches_f64"]
          and alt["walk_launches"] >= 2 * freq["passes"],
          f"{tag}: {len(alt['ties'])} alternatives calls launched "
          f"viterbi_scan[f64] {alt['launches_f64']} and viterbi_walk "
          f"{alt['walk_launches']} times in {freq['passes']} rounds")
    size = final.vocab_size()
    log(f"{tag} {len(vocab)} -> {size} tokens in {len(rounds)} rounds, "
        f"{secs:.3f} s with this script's checks, "
        f"{sum(r['seconds_without_checks'] for r in rounds):.3f} s without, "
        f"through one session (closed); {rebind['calls']} "
        f"rebinds took {rebind['seconds']:.3f} s; launches {launches}, "
        f"the alternatives' viterbi_scan[f64] {alt['launches_f64']} and "
        f"viterbi_walk {alt['walk_launches']}; {freq['passes']} frequency "
        f"passes x {freq_groups} groups = {freq['launches']} launches of "
        f"{freq_kernel}, {freq['walks']} calls of viterbi_walk")
    check(size <= target, f"{tag}: {size} tokens left, above {target}")
    check({t.value for t in final.vocab} <= {t.value for t in vocab},
          f"{tag}: a kept token is not in the input vocabulary")
    tok = Tokenizer(final, device=dev)
    texts = [s.decode() for s in samples[:64]]
    ids = tok.encode_batch(texts)
    check(all(tok.decode(r) == t for r, t in zip(ids, texts)),
          f"{tag}: the pruned tokenizer does not round-trip")
    log(f"{tag} checks passed: route, size, subset, alternatives, 64-sample "
        "round trip")
    return {"route": "fused" if fused else "cached", "seconds": secs,
            "seconds_without_checks": sum(r["seconds_without_checks"]
                                          for r in rounds),
            "rounds": rounds, "initial_size": len(vocab), "final_size": size,
            "launches": launches, "rebind": rebind,
            "alternatives": alt,
            "frequency_passes": freq["passes"],
            "frequency_launches": freq["launches"],
            "frequency_probes": freq["probes"],
            "frequency_walks": freq["walks"],
            "frequency_split": freq["split"],
            "frequency_first_split": freq["first_split"],
            "frequency_groups": freq_groups,
            "vocab_digest": vocab_digest(final.vocab)}


# The README recipe's generate size: the vocabulary the first prune round
# starts from (experiments/table500k.py builds it), and the tokens of it
# held against the oracle's nbest(2).
ALT_BIG = 500_000
ALT_SAMPLE = 2_000


def table500k_vocab():
    """The 500,000-token vocabulary of experiments/table500k.py:24-35
    (seed 0): the 256 bytes, then words of 1-7 of 16 syllables cut at 16
    bytes, scores uniform in (-12, -2]."""
    from tokengeex_tpu_torch import ScoredToken

    rng = np.random.default_rng(0)
    vocab = [ScoredToken(bytes([b]), -10.0) for b in range(256)]
    seen = set(t.value for t in vocab)
    syll = [b"an", b"er", b"ti", b"on", b"ra", b"lo", b"de", b"mi",
            b"cu", b"va", b"be", b"so", b"ne", b"pa", b"ge", b"st"]
    while len(vocab) < ALT_BIG:
        n = rng.integers(1, 8)
        w = b"".join(syll[i] for i in rng.integers(0, 16, n))[:16]
        if w not in seen:
            seen.add(w)
            vocab.append(ScoredToken(w, float(-2 - 10 * rng.random())))
    return vocab


def run_alternatives_big(dev):
    """Phase 3c: the alternatives of the 500,000-token vocabulary on the
    card, over a table built once as a prune session's (its build timed
    apart): a first and a second call (equal), a third split by phase;
    viterbi_scan[f64] and viterbi_walk launched; ALT_SAMPLE seeded tokens
    held against the oracle's nbest(2) (check_alternatives)."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.models.oracle import Lattice, OracleModel
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import lattice_cuda as lc
    from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
    from tokengeex_tpu_torch.ops.match_table import TokenTable
    from tokengeex_tpu_torch.train import estep_device as ed

    tag = "[alternatives 500k]"
    t = time.perf_counter()
    vocab = table500k_vocab()
    vocab_s = time.perf_counter() - t
    model = Model(vocab)
    t = time.perf_counter()
    table = TokenTable.build(vocab)
    dt = lat.DeviceTables.from_table(table, dev, torch.float64)
    table_s = time.perf_counter() - t
    f64, walks = lc.viterbi_scan.launches_f64, lat.viterbi_walk.launches
    probes = lcp.match_probe.launches_f64
    seconds, got = [], None
    for _ in range(2):
        t = time.perf_counter()
        res = ed.prune_alternatives_device(model, table=dt, device=dev)
        seconds.append(time.perf_counter() - t)
        check(got is None or (np.array_equal(res[0], got[0])
                              and res[1] == got[1]),
              f"{tag}: a second call differs")
        got = res
    launches = {"viterbi_scan[f64]": (lc.viterbi_scan.launches_f64 - f64) // 2,
                "viterbi_walk": (lat.viterbi_walk.launches - walks) // 2,
                "match_cache[f64]":
                    (lcp.match_probe.launches_f64 - probes) // 2}
    check(min(launches.values()) > 0
          and launches["match_cache[f64]"] == launches["viterbi_scan[f64]"],
          f"{tag}: launches {launches}")
    timer = lat.PhaseTimer(dev)
    ed.prune_alternatives_device(model, table=dt, device=dev, timer=timer)
    split = {k: round(v, 6) for k, v in timer.seconds.items()}
    t = time.perf_counter()
    om = OracleModel(vocab)
    trie_s = time.perf_counter() - t
    tids = sorted(np.random.default_rng(SEED + 500).choice(
        len(vocab), ALT_SAMPLE, replace=False).tolist())
    keep, alts = [], []
    t = time.perf_counter()
    for tid in tids:
        lattice = Lattice(vocab[tid].value)
        om.populate_nodes(lattice, 0.0)
        nb = lattice.nbest(2)
        keep.append(not (len(nb) > 1 and len(nb[0]) > 1))
        alts.append([n.token_id for n in nb[1]]
                    if len(nb) > 1 and len(nb[0]) == 1 else [])
    nbest_s = time.perf_counter() - t
    ties = check_alternatives(tag, vocab, got, (keep, alts), tids)
    res = {"tokens": len(vocab), "bytes": sum(len(t.value) for t in vocab),
           "vocab_seconds": vocab_s, "table_seconds": table_s,
           "seconds": seconds, "split": split, "launches": launches,
           "not_kept": int((~got[0]).sum()),
           "with_alternatives": sum(bool(a) for a in got[1]),
           "sample": ALT_SAMPLE, "ties": ties, "trie_seconds": trie_s,
           "nbest_seconds": nbest_s}
    log(f"{tag} {len(vocab)} tokens ({res['bytes']} bytes; built in "
        f"{vocab_s:.2f} s, its table in {table_s:.2f} s): alternatives on "
        f"the card {seconds[0]:.3f} / {seconds[1]:.3f} s (first / second "
        f"call), synchronised split {split}, launches {launches} a call; "
        f"{res['not_kept']} tokens not kept, {res['with_alternatives']} with "
        f"alternatives; {ALT_SAMPLE} seeded tokens equal to the oracle's "
        f"nbest(2) (its trie {trie_s:.2f} s, the lattices {nbest_s:.2f} s "
        f"on the host), ties {ties}")
    return res


def host_frequency_counts(lat, sess, model):
    """Viterbi counts of the session's frequency groups with the host
    backtrack: each group's Viterbi on the card, its backpointers read
    back and walked by `lattice.backtrack` (the corpus has no sample past
    the frequency packing's cap)."""
    from tokengeex_tpu_torch.utils.packing import PackedBatch

    check(not sess._freq_long, "a sample past the frequency cap")
    index = lat.TokenIndex(model.oracle.token_to_ids)
    counts = np.zeros(model.vocab_size(), np.int64)
    for gi, sub in sess._freq_groups():
        batch = sess._freq_batch(gi, sub)
        dp, best_l = lat.viterbi(sess.dt, batch,
                                 backend="fused" if sess._fused() else "slab")
        spans = sess._freq_info(gi, sub)["countable"]
        view = PackedBatch(sub.bytes_arr, sub.sample_id, sub.is_start,
                           sub.end_index, spans)
        ids = lat.backtrack(view, dp.cpu().numpy(),
                            best_l.to(torch.int8).cpu().numpy(), index)
        counts += np.bincount(np.concatenate(
            [np.asarray(r, np.int64) for r in ids]), minlength=len(counts))
    return counts


def merge_group_ids(lat, ed, vocab, sub, hints, dev):
    """The merge pass's walk of one row group: the route's Viterbi over
    tables built with the merge's `hints`, then `walk_ids_device`;
    (flat, incl, dead, vocabulary size), on the card."""
    from tokengeex_tpu_torch.ops.match_table import TokenTable

    dt = lat.DeviceTables.from_table(
        TokenTable.build(vocab, min_bits=hints[0], min_len=hints[1]), dev)
    batch = lat.prepare_batch(sub, dt.max_len, dev)
    dp, best_l = lat.viterbi(dt, batch, C=ed.CHUNK,
                             backend=ed._eff_backend(dt, None))
    index = lat.walk_index(sub.spans, *best_l.shape, dev)
    flat, _, incl, dead = lat.walk_ids_device(dt, batch, dp, best_l, index)
    torch.cuda.synchronize()
    return flat, incl, dead, dt.vocab_size


def table_pair_count(pc, flat, incl, vocab_size, hint):
    """One group's pair count through a PairTable on the card, as
    `pair_count_plain` gives it (keys ascending, counts, mismatch): a table
    sized from `hint`, the insert, the compaction (which drains any
    spilled rows) and its readback, a sort by key; and the state just
    after the insert."""
    table = pc.PairTable(flat.device, hint)
    table.insert_ids(flat, incl, vocab_size)
    state = table.read()
    keys, counts = table.compact()
    keys, order = torch.sort(keys)
    return (keys, counts[order], table.state[pc.MISMATCH] != 0), state, \
        table.slots


def check_pair_group(pc, tag, flat, incl, vocab_size, hint) -> dict:
    """pair_count against pair_count_plain on one group (integers: equal,
    max |err| 0); its pairs, distinct keys, the rows the insert sent to
    the global table and spilled, and the table's slots before and after
    the compaction's drain."""
    want = pc.pair_count_plain(flat, incl, vocab_size)
    before = pc.table_slots(0, hint)
    got, state, slots = table_pair_count(pc, flat, incl, vocab_size, hint)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("keys", "counts", "mismatch")):
        check(torch.equal(g, w), f"pair_count ({tag}): {name} differ from "
              "the plain version's")
    return {"pairs": int(want[1].sum()), "distinct": int(want[0].numel()),
            "top_count": int(want[1].max()) if want[1].numel() else 0,
            "sent": state[pc.SENT], "spilled": state[pc.SPILLED],
            "slots": before, "slots_after": slots,
            "max_abs_err": float((got[1] - want[1]).abs().max())
            if want[1].numel() else 0.0}


def check_pair_count(lat, pc, ed, vocab, samples, sub, hints, dev):
    """pair_count against its plain version on the merge's first row group
    (the 4k vocabulary, tables at the merge's hints): the group's walked
    ids and offsets on the card, the kernel's compacted table sorted by key
    equal to `pair_count_plain` (integers: max |err| 0); then on a skewed
    group (one key over half the pairs) and a spill group (random 31-bit
    ids, every pair its own key, more than a block's shared table holds a
    block; a hint of 4,096 keys, so the table's slots fill, the rest
    spill and the compaction grows the table). Timed: one group's count as
    the merge pass runs it (a table sized from the hint a pass has, the
    distinct pairs of a pass over the corpus at this vocabulary; the
    insert; a readback of the state; the compaction and its readback),
    unqueued; its launches alone
    queued (the table's fill, the insert, the compaction; the fill and
    the insert; the fill alone), printed beside the first design's
    recorded times (`PAIR_FIRST_DESIGN_MS`);
    torch.unique(return_counts=True) on the same keys; the plain
    version."""
    from tokengeex_tpu_torch import Model

    flat, incl, dead, V = merge_group_ids(lat, ed, vocab, sub, hints, dev)
    check(not bool(dead.any()), "pair_count: a span of the group is dead")
    corpus = ed.DeviceCorpus(samples, device=dev)
    ed.count_pairs_arrays(Model(vocab), samples, table_hints=hints,
                          corpus=corpus)
    hint = corpus.pair_hint
    del corpus
    keys, ids = pc.pair_keys(flat, incl)
    tokens, pairs, spans = ids.numel(), keys.numel(), incl.numel()
    want = []
    plain_ms = cuda_ms(lambda: want.append(pc.pair_count_plain(flat, incl,
                                                               V)),
                       iters=1, warmup=0)
    want = want[0]
    merge = check_pair_group(pc, "merge group", flat, incl, V, hint)
    check(merge["sent"] < pairs and merge["slots"] <= 1 << 20,
          f"pair_count: the merge group sent {merge['sent']} rows of "
          f"{pairs} pairs to a table of {merge['slots']} slots")

    def group(launch_only=False, insert_only=False):
        table = pc.PairTable(dev, hint)
        table.insert_ids(flat, incl, V)
        if insert_only:
            return table
        return (table._compact_launch(merge["distinct"]) if launch_only
                else table.compact())

    t = {}
    for name, fn, queued in (
            ("ms", group, False), ("ms_2", group, False),
            ("device_ms", lambda: group(launch_only=True), True),
            ("device_ms_2", lambda: group(launch_only=True), True),
            ("insert_device_ms", lambda: group(insert_only=True), True),
            ("fill_device_ms", lambda: pc.PairTable(dev, hint), True)):
        t[name] = cuda_ms(fn, iters=20, queued=queued)
    library_ms = cuda_ms(lambda: torch.unique(keys, return_counts=True),
                         iters=20)
    # The skewed group: runs of one id (p = 0.8), so its pair takes ~64 %
    # of the pairs; the spill group: random ids, a table of 4,096 slots.
    rng = np.random.default_rng(SEED)
    ntok = np.diff(incl.cpu().numpy(), prepend=0)
    hot = np.where(rng.random(tokens) < 0.8, 7, rng.integers(0, V, tokens))
    hot_flat = torch.from_numpy(hot.astype(np.int32)).to(dev)
    skewed = check_pair_group(pc, "skewed group", hot_flat, incl, V, hint)
    check(skewed["top_count"] * 2 > skewed["pairs"],
          f"pair_count: the skewed group's top key holds "
          f"{skewed['top_count']} of {skewed['pairs']} pairs")
    del hot, hot_flat
    spill_ntok = np.tile(ntok, 3)
    rand = rng.integers(0, 2**31, int(spill_ntok.sum()))
    spill = check_pair_group(
        pc, "spill group", torch.from_numpy(rand.astype(np.int32)).to(dev),
        torch.from_numpy(np.cumsum(spill_ntok).astype(np.int32)).to(dev),
        2**31, pc.MIN_SLOTS // 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(spill["spilled"] > 0 and spill["slots_after"] > spill["slots"]
          and spill["distinct"] > 2 * sms * 8192,
          f"pair_count: the spill group {spill} did not spill and regrow, "
          "or holds too few keys")
    del rand
    # Bytes the function needs: the ids and the offsets read once, each
    # distinct (key, count) row written once. This design's own traffic is
    # logged beside it: the ids and offsets, 16 B a row sent to the table,
    # the table's fill and the compaction's read (16 B a slot each), the
    # rows written.
    distinct = merge["distinct"]
    nbytes = 4 * tokens + 4 * spans + 16 * distinct
    table_bytes = (4 * tokens + 4 * spans + 16 * merge["sent"]
                   + 32 * merge["slots"] + 16 * distinct)
    b_ms, b_by = bound(nbytes, 0)
    table_ms = bound(table_bytes, 0)[0]
    err = max(g["max_abs_err"] for g in (merge, skewed, spill))
    log(f"pair_count (merge's first group: {spans} spans, {tokens} tokens, "
        f"{pairs} pairs, {distinct} distinct; hint {hint}, a table of "
        f"{merge['slots']} slots, {merge['sent']} rows sent to it, "
        f"{merge['spilled']} spilled): {t['ms']:.4f} / {t['ms_2']:.4f} ms a "
        f"group (table, insert, state readback, compaction and its "
        f"readback; queued: "
        f"{t['device_ms']:.4f} / {t['device_ms_2']:.4f} ms, the fill and "
        f"the insert alone {t['insert_device_ms']:.4f} ms, the fill "
        f"{t['fill_device_ms']:.4f} ms); the first design "
        f"{PAIR_FIRST_DESIGN_MS} (recorded on {PAIR_FIRST_DESIGN_ON}); "
        f"torch.unique on "
        f"the same keys {library_ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {nbytes} bytes: the ids and offsets read, "
        f"the distinct rows written; this design's own traffic "
        f"{table_bytes} bytes, {table_ms:.4f} ms), max |err| {err} (equal)")
    log(f"pair_count (skewed group: {skewed['pairs']} pairs, the top key "
        f"{skewed['top_count']}, {skewed['distinct']} distinct, "
        f"{skewed['sent']} rows sent); (spill group: {spill['pairs']} "
        f"pairs, {spill['distinct']} distinct, {spill['sent']} rows sent, "
        f"{spill['spilled']} spilled, {spill['slots']} -> "
        f"{spill['slots_after']} slots): equal to the plain version")
    return {"max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            **{k: v for k, v in t.items() if k != "ms"},
            "first_design_ms": PAIR_FIRST_DESIGN_MS,
            "first_design_on": PAIR_FIRST_DESIGN_ON,
            "spans": spans, "tokens": tokens, "pairs": pairs,
            "distinct": distinct, "hint": hint, "slots": merge["slots"],
            "sent": merge["sent"], "spilled": merge["spilled"],
            "bytes": nbytes, "table_bytes": table_bytes,
            "table_bound_ms": table_ms, "skewed": skewed, "spill": spill}


def host_pairs(ed, model, samples, hints, corpus):
    """The pair count's old host route, for the checks: the ids of
    `encode_corpus_device` for the same model read back into one list a
    sample, then np.unique over the keys of each sample's adjacent ids,
    by descending count (stable): (keys, counts)."""
    encoded = ed.encode_corpus_device(model, samples, table_hints=hints,
                                      corpus=corpus, device=corpus.dev)
    keys = [(a[:-1] << 32) | a[1:]
            for a in (np.asarray(r, np.int64) for r in encoded) if a.size > 1]
    uniq, cnt = np.unique(np.concatenate(keys) if keys
                          else np.zeros(0, np.int64), return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    return uniq[order], cnt[order]


def check_pairs_equal(tag, got, want) -> None:
    check(got[0].shape == want[0].shape and np.array_equal(got[0], want[0])
          and np.array_equal(got[1], want[1]),
          f"[{tag}] the pair list differs from the host route's "
          f"({got[0].size} against {want[0].size} pairs)")


# An anchored identifier / punctuation class the allow-DFA compiles.
MERGE_ALLOW = r"^(?: ?[A-Za-z_][A-Za-z0-9_]*|[[:punct:]]+)$"


# The caching allocator's counters a split merge pass logs the change of
# (cudaMalloc / cudaFree calls, and frees of the cache after a failed
# cudaMalloc), beside the bytes it holds after the pass.
ALLOCATOR_EVENTS = ("num_device_alloc", "num_device_free",
                    "num_alloc_retries")


def pair_table_steps(pc):
    """Patches PairTable so that each of its steps in a pass is timed alone
    (the device synchronised before and after): its tables' allocation and
    fill, the spill buffer's allocation, the ids inserts (the first apart
    from the rest), the rehash and drain, the compaction launch. Returns
    (seconds by step, a function that restores the class)."""
    steps = {}
    saved = {}

    def timed(name, label):
        fn = getattr(pc.PairTable, name)
        saved[name] = fn

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            key = label(steps)
            steps[key] = round(steps.get(key, 0.0)
                               + time.perf_counter() - t, 6)
            return out
        setattr(pc.PairTable, name, run)

    timed("_alloc", lambda _: "alloc")
    timed("_spill_room", lambda _: "spill")
    timed("_drain", lambda _: "drain")
    timed("_compact_launch", lambda _: "compact")
    timed("insert_ids", lambda st: ("ids_first" if "ids_first" not in st
                                    else "ids_rest"))

    def restore():
        for name, fn in saved.items():
            setattr(pc.PairTable, name, fn)
    return steps, restore


def run_merge(vocab, samples, groups, kernels, dev):
    """Phase 3e: VocabularyMerger on the card over the corpus, 200 merges
    in steps of 50 (four passes, each a re-encode of the corpus packed and
    uploaded once, the ids walked and their pairs counted on the card,
    only the sorted arrays read back). The merge run times each pass; its
    kernels' counts are set to 0 just before it and read just after: the
    fused Viterbi kernel and the walk once a group a pass, pair_count at
    least once a group a pass plus the compaction. A second run of the
    same merge, each pass split by phase (synchronised), holds every
    pass's pair list equal to the host route's over the same model
    (`host_pairs`, run outside the pass's timing) and merges the same
    vocabulary; on the first 64 samples, the pair counts and the merged
    vocabulary equal to a CPU run's."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.core.redfa import compile_is_match_dfa
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import pair_count as pc
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.merge import VocabularyMerger

    compile_is_match_dfa(MERGE_ALLOW)  # the DFA takes it, no host regex
    kw = dict(allow=MERGE_ALLOW, num_merges=200, step=50)
    count_pairs = ed.count_pairs_arrays
    passes, checked = [], []

    def timed(*args, **kwargs):
        t = time.perf_counter()
        walks = kernels["viterbi_walk"].calls
        keys, counts = count_pairs(*args, **kwargs)  # ends in a readback
        passes.append({"seconds": time.perf_counter() - t,
                       "walks": kernels["viterbi_walk"].calls - walks,
                       "pairs": int(keys.size)})
        return keys, counts

    def split(model, samples_, task, table_hints, corpus):
        timer = lat.PhaseTimer(dev)
        steps, restore = pair_table_steps(pc)
        before = torch.cuda.memory_stats(dev)
        t = time.perf_counter()
        try:
            got = count_pairs(model, samples_, task, table_hints=table_hints,
                              corpus=corpus, timer=timer)
        finally:
            restore()
        secs = time.perf_counter() - t
        after = torch.cuda.memory_stats(dev)
        check_pairs_equal(f"merge pass {len(checked)}", got, host_pairs(
            ed, model, samples_, table_hints, corpus))
        checked.append({"seconds": secs, "pairs": int(got[0].size),
                        "split": {k: round(v, 6)
                                  for k, v in timer.seconds.items()},
                        "pair_steps": steps,
                        "allocator": {
                            **{k: after.get(k, 0) - before.get(k, 0)
                               for k in ALLOCATOR_EVENTS},
                            "reserved_bytes": after.get(
                                "reserved_bytes.all.current", 0)}})
        return got

    path = ("fused_forward_chunk", "viterbi_walk")
    try:
        ed.count_pairs_arrays = timed
        merger = VocabularyMerger(device=dev, **kw)
        torch.cuda.synchronize()
        for name in path:
            kernels[name].launches = 0
        pc.PairTable.launches = 0
        t0 = time.perf_counter()
        merged = merger.merge(Model(vocab), samples)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {name: kernels[name].launches for name in path}
        launches["pair_count"] = pc.PairTable.launches
        ed.count_pairs_arrays = split
        again = VocabularyMerger(device=dev, **kw).merge(Model(vocab),
                                                         samples)
    finally:
        ed.count_pairs_arrays = count_pairs
    check(merged.vocab_size() == len(vocab) + 200,
          f"[merge] {merged.vocab_size()} tokens, not {len(vocab) + 200}")
    check(len(passes) == 4 and all(p["walks"] == groups for p in passes),
          f"[merge] passes {passes}: not 4 passes of {groups} walks")
    check(launches["fused_forward_chunk"] == 4 * groups,
          f"[merge] the fused Viterbi kernel ran "
          f"{launches['fused_forward_chunk']} times for 4 x {groups} groups")
    check(launches["pair_count"] >= 4 * (groups + 1),
          f"[merge] pair_count launched {launches['pair_count']} times for "
          f"4 passes of {groups} groups")
    check(vocab_digest(again.vocab) == vocab_digest(merged.vocab),
          "[merge] the split run merged another vocabulary")
    check(len(checked) == 4, f"[merge] {len(checked)} passes checked")
    total = sum(map(len, samples))
    for k, (p, c) in enumerate(zip(passes, checked)):
        log(f"[merge] pass {k}: {p['seconds']:.3f} s = "
            f"{total / p['seconds'] / 1e6:.2f} MB/s, {p['walks']} walks, "
            f"{p['pairs']} distinct pairs (equal to the host route's); "
            f"synchronised {c['seconds']:.3f} s: {c['split']}; the pair "
            f"table's steps {c['pair_steps']} (ids_first, ids_rest include "
            f"spill), allocator {c['allocator']}")
    log(f"[merge] {len(vocab)} -> {merged.vocab_size()} tokens in "
        f"{secs:.3f} s on {torch.cuda.get_device_name(dev)}; launches "
        f"{launches} ({groups} groups a pass)")
    # One more pass over the merged vocabulary, through the list.
    timer = lat.PhaseTimer(dev)
    t = time.perf_counter()
    ed.count_pairs_device(merged, samples, corpus=merger._corpus, timer=timer)
    pass_split = {k: round(v, 6) for k, v in timer.seconds.items()}
    log(f"[merge] a count_pairs_device pass over the merged vocabulary, "
        f"synchronised: {time.perf_counter() - t:.3f} s; {pass_split}")
    head = samples[:64]
    pairs = ed.count_pairs_device(Model(vocab), head, device=dev)
    check(pairs == ed.count_pairs_device(Model(vocab), head, device="cpu"),
          "[merge] pair counts on 64 samples differ from the CPU run")
    small = VocabularyMerger(device=dev, **kw).merge(Model(vocab), head)
    small_cpu = VocabularyMerger(device="cpu", **kw).merge(Model(vocab), head)
    check([(t.value, t.score) for t in small.vocab]
          == [(t.value, t.score) for t in small_cpu.vocab],
          "[merge] the vocabulary merged over 64 samples differs from the "
          "CPU run's")
    log(f"[merge] checks passed: 4 passes x {groups} walks, every pass's "
        f"pairs equal to the host route's; on 64 samples {len(pairs)} pair "
        f"counts and the merged vocabulary ({small.vocab_size()} tokens) "
        "equal to the CPU run's")
    return {"seconds": secs, "passes": passes, "checked_passes": checked,
            "launches": launches, "bytes": total, "pass_split": pass_split,
            "initial_size": len(vocab), "final_size": merged.vocab_size(),
            "pairs_64": len(pairs)}


def run_merge_pass(vocab, samples, groups, kernels, dev):
    """A pair-count pass at the README recipe's merge shape: the 32,768-
    token vocabulary (slab route: viterbi_scan) with the hints of
    `--num-merges 2000`, over a DeviceCorpus packed once; the first pass
    (its inputs uploaded) and a steady one timed, the kernels' counts set
    to 0 just before the steady pass and read just after (viterbi_scan and
    the walk once a group, pair_count at least once a group plus the
    compaction), one more pass split by phase, and its pair list equal to
    the host route's."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import pair_count as pc
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.merge import merge_table_hints

    model = Model(vocab)
    hints = merge_table_hints(len(vocab), 2000, 24)
    corpus = ed.DeviceCorpus(samples, device=dev)
    secs = []
    for k in range(2):
        torch.cuda.synchronize()
        if k:
            for name in ("viterbi_scan", "viterbi_walk", "match_cache",
                         "match_cache_plain"):
                kernels[name].launches = 0
            pc.PairTable.launches = 0
            calls = kernels["viterbi_walk"].calls
        t = time.perf_counter()
        got = ed.count_pairs_arrays(model, samples, table_hints=hints,
                                    corpus=corpus)
        secs.append(time.perf_counter() - t)
    launches = {"viterbi_scan": kernels["viterbi_scan"].launches,
                "viterbi_walk calls": kernels["viterbi_walk"].calls - calls,
                "pair_count": pc.PairTable.launches,
                "match_cache": kernels["match_cache"].launches,
                "match_cache_plain": kernels["match_cache_plain"].launches}
    check_probes("[merge (a)]", launches, groups)
    check(launches["viterbi_scan"] == groups
          and launches["viterbi_walk calls"] == groups,
          f"[merge (a)] launches {launches} for {groups} groups")
    check(launches["pair_count"] >= groups + 1,
          f"[merge (a)] pair_count launched {launches['pair_count']} times "
          f"for {groups} groups")
    timer = lat.PhaseTimer(dev)
    t = time.perf_counter()
    again = ed.count_pairs_arrays(model, samples, table_hints=hints,
                                  corpus=corpus, timer=timer)
    split_s = time.perf_counter() - t
    split = {k: round(v, 6) for k, v in timer.seconds.items()}
    for arrays in (got, again):
        check_pairs_equal("merge (a)", arrays, host_pairs(
            ed, model, samples, hints, corpus))
    total = sum(map(len, samples))
    log(f"[merge (a): {len(vocab)} tokens, slab route, hints {hints}] a "
        f"pair-count pass: first {secs[0]:.3f} s, steady {secs[1]:.3f} s = "
        f"{total / secs[1] / 1e6:.2f} MB/s, {got[0].size} distinct pairs "
        f"(equal to the host route's); launches {launches}; synchronised "
        f"{split_s:.3f} s: {split}")
    return {"first_seconds": secs[0], "seconds": secs[1], "bytes": total,
            "pairs": int(got[0].size), "launches": launches,
            "split_seconds": split_s, "split": split, "hints": hints,
            "digest": pairs_digest(*got)}


# ---------------------------------------------------------------------------
# The generate stage: the candidate mask, the feed, the CLI recipe
# ---------------------------------------------------------------------------


def allow_all_patterns() -> str:
    """The allow regex of all named patterns (train/patterns.py)."""
    from tokengeex_tpu_torch.train.patterns import (PATTERNS,
                                                    build_allow_regex,
                                                    load_patterns)

    return build_allow_regex(load_patterns([p[0] for p in PATTERNS]))


def smem_lookups_per_s(dev):
    """The card's shared-memory lookup rate: each SM's 32 banks serve one
    4-byte access each per clock, at the card's maximum SM clock
    (`nvidia-smi --query-gpu=clocks.max.sm`). Returns (rate, SMs, MHz)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 32 * mhz * 1e6, sms, mhz


def dfa_walk_steps(ddfa, rows, lens, L: int) -> int:
    """Table lookups the mask kernel makes on this data: from every start
    inside a sample on a char start, one a step until the walk leaves the
    sample, reaches L or falls into the dead state."""
    B, W = rows.shape
    cls = ddfa.byte_class.to(torch.int64)[rows.to(torch.int64)]
    pos = torch.arange(W, device=rows.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    alive = (pos < lens) & ((rows.to(torch.int64) & 0xC0) != 0x80)
    room = lens - pos
    state = torch.full((B, W), ddfa.start, dtype=torch.int64,
                       device=rows.device)
    tab = ddfa.next_states().reshape(-1)
    steps = 0
    for l in range(1, L + 1):
        alive &= room >= l
        steps += int(alive.sum())
        state = tab[state * ddfa.num_classes
                    + torch.nn.functional.pad(cls[:, l - 1:], (0, l - 1))]
        alive &= state != 0
    return steps


def check_dfa_mask(dd, samples, dfa, dev):
    """dfa_mask on the generate feed's first group of the corpus (W8 =
    8192, 1024 rows) under the allow regex of all named patterns, at L =
    16, p = 1.0 and 0.01, on both table routes, bit for bit against its
    plain version; timed beside it, its bound and its first design's
    recorded time."""
    W8, B = dd.group_shape(samples, dd.GROUP_BYTES)
    arr, lens = dd.pack_group(samples[:B], B, W8)
    rows = torch.from_numpy(arr).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    ddfa = dd._device_dfa_for(dfa, dev)
    S, C = ddfa.num_states, ddfa.num_classes
    check(dd.pick_route(ddfa) == "shared", f"a {S}-state table must take "
          "the shared route")
    res = {"W8": W8, "B": B, "states": S, "classes": C,
           "entry_bytes": ddfa.entry_bytes,
           "smem_bytes": dd.shared_table_bytes(ddfa),
           "first_design_ms": DFA_FIRST_DESIGN_MS,
           "first_design_on": DFA_FIRST_DESIGN_ON}
    for p in (1.0, 0.01):
        want = dd.packed_candidate_mask_plain(ddfa, rows, lens, L_MAX, p,
                                              SEED, 0)
        plain_ms = cuda_ms(lambda: dd.packed_candidate_mask_plain(
            ddfa, rows, lens, L_MAX, p, SEED, 0), 1, warmup=0)
        cands = sum(int(((want >> i) & 1).sum()) for i in range(8))
        row = {"plain_ms": plain_ms, "candidates": cands}
        for route in ("shared", "global"):
            got = dd.packed_candidate_mask(ddfa, rows, lens, L_MAX, p, SEED,
                                           0, table=route)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"dfa_mask ({route} table, p = {p}) differs from its twin")
            row[route] = cuda_ms(lambda: dd.packed_candidate_mask(
                ddfa, rows, lens, L_MAX, p, SEED, 0, table=route), 20)
            row[f"{route}_device"] = cuda_ms(lambda: dd.packed_candidate_mask(
                ddfa, rows, lens, L_MAX, p, SEED, 0, table=route), 20,
                queued=True)
        res[f"p_{p}"] = row
        del want
    # Bound: the rows, lengths and mask once, the table as the kernel reads
    # it once (the class table, its accept flags and the byte -> class
    # map; the first design's full int32 table beside it); the table
    # lookups at the shared-memory rate, counted on this data.
    table_bytes = S * C * ddfa.entry_bytes + S + 256
    first_table_bytes = S * 256 * 4 + S
    nbytes = B * W8 + B * 4 + B * L_MAX * W8 // 8 + table_bytes
    lookups = dfa_walk_steps(ddfa, rows, lens, L_MAX)
    rate, sms, mhz = smem_lookups_per_s(dev)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lookups / rate * 1e3
    res.update({"bytes": nbytes, "table_bytes": table_bytes,
                "first_table_bytes": first_table_bytes, "lookups": lookups,
                "bytes_ms": t_bytes, "lookups_ms": t_ops,
                "smem_lookups_per_s": rate,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": 0.0, "ms": res["p_0.01"]["shared"],
                "plain_ms": res["p_0.01"]["plain_ms"]})
    for p in (1.0, 0.01):
        row = res[f"p_{p}"]
        log(f"[dfa_mask] W8={W8} B={B} L={L_MAX} S={S} C={C} p={p}: shared "
            f"table {row['shared']:.4f} ms (device {row['shared_device']:.4f}"
            f"), global table {row['global']:.4f} ms (device "
            f"{row['global_device']:.4f}), plain {row['plain_ms']:.2f} ms; "
            f"{row['candidates']} candidates; equal to the twin bit for bit "
            "on both routes")
    log(f"[dfa_mask] first design at p = 0.01 (recorded by "
        f"experiments/torch_dfa_design.py on {DFA_FIRST_DESIGN_ON}): "
        f"{DFA_FIRST_DESIGN_MS}")
    log(f"[dfa_mask] bound {res['bound_ms']:.4f} ms ({res['bound_by']}): "
        f"{nbytes} bytes (table {table_bytes}; the first design's full "
        f"table {first_table_bytes}) / 3.35 TB/s = {t_bytes:.4f} ms; "
        f"{lookups} table lookups / ({sms} SMs x 32 banks x {mhz:.0f} MHz "
        f"= {rate:.3e}/s) = {t_ops:.4f} ms; shared route "
        f"{res['smem_bytes']} B of shared memory a block")
    return res


def run_generate(dd, samples, allow, dfa, dev):
    """Phase 3f: VocabularyGenerator over the corpus on the card (L = 16,
    p = 0.01, the allow regex of all named patterns), then generate(500_000)
    (the README recipe's settings); dfa_mask launched once per group;
    at p = 1 on the first 64 samples the counts equal the host sets'."""
    from collections import Counter

    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.train.generate import VocabularyGenerator

    texts = [s.decode("utf-8") for s in samples]
    total = sum(map(len, samples))
    W8, B = dd.group_shape(samples, dd.GROUP_BYTES)
    groups = -(-len(samples) // B)

    def generator(p=0.01):
        return VocabularyGenerator(max_token_length=L_MAX,
                                   insert_probability=p, allow=allow,
                                   seed=SEED, device=dev)

    gen = generator()
    dd.packed_candidate_mask.launches = 0
    t0 = time.perf_counter()
    gen.feed(texts)  # ends in the counts' readback
    feed_s = time.perf_counter() - t0
    launches = dd.packed_candidate_mask.launches
    check(launches == groups, f"[generate] dfa_mask launched {launches} "
          f"times for {groups} groups")
    t0 = time.perf_counter()
    vocab = gen.generate(500_000)
    gen_s = time.perf_counter() - t0
    check(256 <= len(vocab) <= 500_000, f"[generate] {len(vocab)} tokens")
    timer = lat.PhaseTimer(dev)
    t0 = time.perf_counter()
    generator().feed(texts, timer=timer)
    split_s = time.perf_counter() - t0
    split = {k: round(v, 6) for k, v in timer.seconds.items()}
    split["generate"] = round(gen_s, 6)
    busy = device_busy(lambda: generator().feed(texts))
    log(f"[generate] feed {feed_s:.3f} s = {total / feed_s / 1e6:.2f} MB/s "
        f"({len(samples)} samples, {groups} groups of {B} rows at W8 = "
        f"{W8}, dfa_mask launched {launches} times), "
        f"{len(gen.frequencies)} distinct candidates; generate(500000) "
        f"{gen_s:.3f} s -> {len(vocab)} tokens")
    log(f"[generate] synchronised feed {split_s:.3f} s; {split}; device busy "
        f"{busy['busy_s']:.4f} of {busy['wall_s']:.3f} s, idle share "
        f"{busy['idle_share']:.4f}; top {busy['top_kernels_ms'][:4]}")
    host: Counter = Counter()
    ref = generator(1.0)
    for t in texts[:64]:
        found: set = set()
        ref._feed_part(t, found)
        host.update(found)
    got = dd.feed_counts(dfa, samples[:64], L_MAX, 1.0, SEED, device=dev)
    check(got == host, "[generate] p = 1 counts on 64 samples differ from "
          "the host sets")
    log(f"[generate] checks passed: {launches} launches for {groups} "
        f"groups; at p = 1 on 64 samples {len(got)} candidates, "
        f"{sum(got.values())} counts equal to the host sets")
    return {"feed_seconds": feed_s, "mb_per_s": total / feed_s / 1e6,
            "bytes": total, "groups": groups, "launches": launches,
            "distinct": len(gen.frequencies), "generate_seconds": gen_s,
            "vocab": len(vocab), "split": split,
            "split_seconds": split_s, "busy": busy,
            "p1_64_candidates": len(got), "p1_64_digest": counter_digest(got)}


# ---------------------------------------------------------------------------
# The f64 / exact conformance mode
# ---------------------------------------------------------------------------

F64_LONG = 8  # samples of 40-80 KB in the f64 phase
F64_SHORT = 64  # the corpus's first samples in the f64 phase


def f64_samples(samples):
    """The f64 phase's samples: the corpus's first 64, then 8 of 40-80 KB
    cut from the corpus joined (the chained encode route and the
    81,920-byte E-step snippets)."""
    import random

    rng = random.Random(SEED + 64)
    big = b"\n".join(samples[F64_SHORT:])
    longs, off = [], 0
    for _ in range(F64_LONG):
        n = rng.randint(40_000, 80_000)
        longs.append(big[off : off + n])
        off += n
    check(all(len(s) > 32768 for s in longs), "f64 phase: long samples")
    return list(samples[:F64_SHORT]) + longs


def check_f64_scans(lat, lc, vocab, samples, dev):
    """The double instantiations of viterbi_scan, forward_scan and
    backward_marginal_scan against their f64 twins on the card, on the f64
    encode's and E-step's group of the corpus's first 64 samples (W =
    8192, the exact probe's f64 cache, its chains): viterbi_scan bit for
    bit, the two log-sum-exp scans within rtol 1e-12 (the card's double
    exp / log against torch's); each timed beside its f32 instantiation
    on the same inputs cast to float32, its plain version and its bound
    (f64 operations at 34 TFLOP/s)."""
    from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
    from tokengeex_tpu_torch.ops.match_table import TokenTable
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.utils.packing import pack_samples

    f64 = torch.float64
    tbl = lat.DeviceTables.from_table(TokenTable.build(vocab), dev, f64)
    width = ed._pick_width(samples, None)
    sub = next(g for _, g in ed._padded_groups(
        pack_samples(samples, width=width), width, ed.ROW_MULT))
    batch = lat.prepare_batch(sub, L_MAX, dev)
    cache = lat.match_cache(tbl, batch, C=ed.CHUNK, dtype=f64)
    W, L, B = cache[0].shape
    fwd, bwd = lat.chain_bounds(batch)
    K = fwd.shape[0] - 1
    starts = batch.is_start[:, 1:].t().to(f64).contiguous()
    hist = lat._hist0(batch, L, None, f64).clamp(min=lc.NEG).t().contiguous()
    kw = {"pad": batch.pad}
    A = lat.forward(tbl, batch, cache, chains=(fwd, bwd))
    m_args = (cache[0], *lat._marginal_inputs(batch, A, L), bwd)
    cases = {
        "viterbi_scan": (lc.viterbi_scan, lc.viterbi_scan_plain,
                         (cache[0], starts, hist, fwd),
                         # the cache, starts, history and chain bounds
                         # read, dp (8) and best_l (4) written; an add, a
                         # max and a compare per (position, length)
                         8 * (W * L * B + W * B + L * B) + 4 * (K + 1) * B
                         + 12 * W * B, 3 * W * L * B),
        "forward_scan": (lc.forward_scan, lc.forward_scan_plain,
                         (cache[0], starts, hist, fwd),
                         8 * (W * L * B + 2 * W * B + L * B)
                         + 4 * (K + 1) * B, 5 * W * L * B + 4 * W * B),
        "backward_marginal_scan": (
            lc.backward_marginal_scan, lc.backward_marginal_scan_plain,
            m_args,
            # the cache, a, z, ends and history read, the marginals and
            # betas written; per (position, length) the marginal's three
            # adds, max and exp besides the betas' five operations
            8 * (2 * W * L * B + 4 * W * B + L * B) + 4 * (K + 1) * B,
            10 * W * L * B + 4 * W * B),
    }
    res = {"shape": {"W": W, "L": L, "B": B, "segments": K}}
    for name, (fn, plain, args, nbytes, ops) in cases.items():
        want = []
        plain_ms = cuda_ms(lambda: want.append(plain(*args, **kw)), iters=1,
                           warmup=0)
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        if name == "viterbi_scan":
            for g_, w_ in zip(got, want[0]):
                check(torch.equal(g_, w_), f"{name}[f64] differs from its "
                      "twin")
            err = max_abs_err(got[0], want[0][0])
        elif name == "forward_scan":
            err = assert_rel(got, want[0], f"{name}[f64]", 1e-12)
        else:
            err = max(assert_rel(g_, w_, f"{name}[f64]", 1e-12)
                      for g_, w_ in zip(got, want[0]))
        del want
        ms = cuda_ms(lambda: fn(*args, **kw), iters=10)
        a32 = [a.float() if a.is_floating_point() else a for a in args]
        ms32 = cuda_ms(lambda: fn(*a32, **kw), iters=10)
        b_ms, b_by = bound(nbytes, ops, F64_OPS_PER_S)
        res[name] = {"max_abs_err": err, "ms": ms, "f32_ms": ms32,
                     "f64_over_f32": ms / ms32, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"{name}[f64] (W={W}, L={L}, B={B}, {K} segments): {ms:.4f} ms "
            f"(f32 on the same inputs {ms32:.4f} ms, x{ms / ms32:.2f}), "
            f"plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max "
            f"|err| {err:.3e} against its f64 twin")
        del a32
    return res


def run_f64(vocab, samples, dev):
    """Phase 3h: the f64 / exact conformance mode on the card (see the
    module docstring)."""
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import lattice_cuda as lc
    from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.prune import MAX_SAMPLE_LENGTH

    f64 = torch.float64
    model = Model(vocab)
    batch = f64_samples(samples)
    total = sum(map(len, batch))
    scans = (lc.viterbi_scan, lc.forward_scan, lc.backward_marginal_scan,
             lcp.match_probe)
    ed.encode_corpus_device(model, batch[:4], dtype=f64, device=dev)  # warm
    torch.cuda.synchronize()
    for fn in scans:
        fn.launches = fn.launches_f64 = 0
    t0 = time.perf_counter()
    ids = ed.encode_corpus_device(model, batch, dtype=f64, device=dev)
    enc_s = time.perf_counter() - t0
    enc_launches = lc.viterbi_scan.launches_f64
    check(enc_launches > 0 and lc.viterbi_scan.launches == 0,
          f"[f64] encode launched viterbi_scan[f64] {enc_launches} and "
          f"viterbi_scan {lc.viterbi_scan.launches} times")
    # The exact probe's double instantiation once a group or window.
    enc_probes = lcp.match_probe.launches_f64
    check(enc_probes == enc_launches and lcp.match_probe.launches == 0,
          f"[f64] encode launched match_cache[f64] {enc_probes} and "
          f"match_cache {lcp.match_probe.launches} times")
    t0 = time.perf_counter()
    want = [model.oracle.encode(s) for s in batch]
    oracle_s = time.perf_counter() - t0
    check(ids == want, "[f64] encode ids differ from the oracle's")
    t0 = time.perf_counter()
    ed.encode_corpus_device(model, batch, device=dev)
    enc32_s = time.perf_counter() - t0

    def estep(device=dev, dtype=f64):
        return ed.run_e_step_device(model, batch, 0.0, MAX_SAMPLE_LENGTH,
                                    dtype=dtype, device=device)

    estep()  # warm
    torch.cuda.synchronize()
    for fn in scans:
        fn.launches = fn.launches_f64 = 0
    t0 = time.perf_counter()
    got = estep()
    est_s = time.perf_counter() - t0
    est_launches = {"forward_scan": lc.forward_scan.launches_f64,
                    "backward_marginal_scan":
                        lc.backward_marginal_scan.launches_f64}
    check(est_launches["forward_scan"] > 0
          and est_launches["backward_marginal_scan"]
          == est_launches["forward_scan"]
          and lc.forward_scan.launches == 0
          and lc.backward_marginal_scan.launches == 0,
          f"[f64] E-step launches {est_launches}, f32 "
          f"{lc.forward_scan.launches} / {lc.backward_marginal_scan.launches}")
    est_probes = lcp.match_probe.launches_f64
    check(est_probes == est_launches["forward_scan"]
          and lcp.match_probe.launches == 0,
          f"[f64] E-step launched match_cache[f64] {est_probes} and "
          f"match_cache {lcp.match_probe.launches} times")
    t0 = time.perf_counter()
    estep(dtype=None)
    est32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = estep(device="cpu")
    cpu_s = time.perf_counter() - t0
    tot_rel = abs(got.sum() - cpu.sum()) / cpu.sum()
    check(tot_rel <= 1e-8 and bool(np.allclose(got, cpu, rtol=1e-8,
                                               atol=1e-9)),
          f"[f64] E-step total {got.sum()} is {tot_rel:.2e} from the CPU "
          f"f64 run's {cpu.sum()}")
    seen = cpu >= 0.5
    cnt_rel = float((np.abs(got - cpu)[seen] / cpu[seen]).max())
    res = {"samples": len(batch), "bytes": total,
           "long_samples": F64_LONG,
           "encode_seconds": enc_s, "encode_mb_per_s": total / enc_s / 1e6,
           "encode_f32_seconds": enc32_s,
           "encode_f32_mb_per_s": total / enc32_s / 1e6,
           "encode_launches_f64": enc_launches, "oracle_seconds": oracle_s,
           "probe_launches_f64": {"encode": enc_probes,
                                  "estep": est_probes},
           "estep_seconds": est_s, "estep_mb_per_s": total / est_s / 1e6,
           "estep_f32_seconds": est32_s,
           "estep_f32_mb_per_s": total / est32_s / 1e6,
           "estep_launches_f64": est_launches, "cpu_seconds": cpu_s,
           "total": float(got.sum()), "cpu_total": float(cpu.sum()),
           "total_rel_diff": tot_rel, "max_rel_diff_counts_ge_0.5": cnt_rel,
           "tokens": sum(map(len, ids))}
    log(f"[f64] {len(batch)} samples, {total} bytes ({F64_LONG} of 40-80 "
        f"KB): encode {enc_s:.3f} s = {res['encode_mb_per_s']:.2f} MB/s "
        f"(f32 {enc32_s:.3f} s = {res['encode_f32_mb_per_s']:.2f} MB/s), "
        f"viterbi_scan[f64] launched {enc_launches} times, ids equal to the "
        f"oracle's ({oracle_s:.2f} s on the host); E-step {est_s:.3f} s = "
        f"{res['estep_mb_per_s']:.2f} MB/s (f32, 1 KB snippets, "
        f"{est32_s:.3f} s = {res['estep_f32_mb_per_s']:.2f} MB/s), launches "
        f"{est_launches}; total {got.sum():.6f} vs the CPU f64 run's "
        f"{cpu.sum():.6f} (rel {tot_rel:.2e}, {cpu_s:.1f} s), max rel on "
        f"counts >= 0.5 {cnt_rel:.2e}")
    return res


# The README recipe through the CLI, cut to a ~2 MB slice of the corpus
# and smaller sizes so that it fits the run's time.
CLI_BYTES = 2_000_000
CLI_REDUCED = ["corpus 8 MB -> a 2 MB slice", "generate -v 500,000 -> 16,384",
               "prune -v 32,768 -> 8,192", "filter -v 30,000 -> 8,000",
               "merge --num-merges 2,000 -> 100"]


def cli_slice(samples):
    """The corpus's first samples, ~CLI_BYTES of them."""
    part, size = [], 0
    for s in samples:
        if size >= CLI_BYTES:
            break
        part.append(s)
        size += len(s)
    return part


def run_cli_recipe(samples, dev):
    """Phase 3g: regex -> generate -> prune -> filter -> merge -> encode ->
    decode as `python -m tokengeex_tpu_torch.cli` processes on the card
    (on the CPU with `--device cpu`), over a NUL-separated .bin file of a
    ~2 MB slice of the corpus; each exits 0, and the decoded text equals
    the encoded one."""
    from tokengeex_tpu_torch.train.patterns import PATTERNS

    root = HERE / "build" / "chip_smoke_cli"
    root.mkdir(parents=True, exist_ok=True)
    part = cli_slice(samples)
    size = sum(map(len, part))
    (root / "train.bin").write_bytes(b"\x00".join(part))
    env = dict(os.environ, PYTHONPATH=str(HERE))
    where = ["--device", "cpu"] if dev.type == "cpu" else []
    stages = {}

    def cli(name, *args, stdin=None):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "tokengeex_tpu_torch.cli", name, *args,
             *where], cwd=root, env=env, input=stdin, capture_output=True,
            text=True, timeout=900)
        stages[name] = time.perf_counter() - t0
        check(r.returncode == 0, f"[cli] {name} exited {r.returncode}:\n"
              f"{r.stderr[-3000:]}")
        return r.stdout

    train = ["--train", "code:train.bin"]
    cli("regex", "-o", "allow.regex",
        *[a for p in PATTERNS for a in ("-p", p[0])])
    cli("generate", "-v", "16384", "-o", "v0.json", *train, "--processor",
        "crlf", "--allow", "allow.regex", "--insert-probability", "0.01",
        "--max-token-length", str(L_MAX), "--special", "<|eos|>")
    cli("prune", "-i", "v0.json", "-o", "v1.json", "-v", "8192", *train,
        "--dropout", "0.05", "--shrink-factor", "0.8", "--em-subiters", "2")
    cli("filter", "-i", "v1.json", "-o", "v2.json", "-v", "8000",
        "--min-score", "-13.0")
    cli("merge", "-i", "v2.json", "-o", "v3.json", *train, "--allow",
        "allow.regex", "--num-merges", "100")
    text = part[0].decode("utf-8") + "<|eos|>" + part[1].decode("utf-8")
    ids = cli("encode", "-v", "v3.json", stdin=text)
    out = cli("decode", "-v", "v3.json", stdin=ids)
    check(out == text + "\n", "[cli] decode(encode(text)) differs from "
          "the text")
    sizes = [len(json.loads((root / f"v{i}.json").read_text())["vocab"])
             for i in range(4)]
    check(sizes[0] <= 16384 and sizes[1] <= 8192
          and sizes[2] <= min(8000, sizes[1]) and sizes[3] > sizes[2],
          f"[cli] vocabulary sizes {sizes}")
    log(f"[cli] reduced: {'; '.join(CLI_REDUCED)}")
    log(f"[cli] {size} bytes in {len(part)} samples; vocabularies "
        f"{' -> '.join(map(str, sizes))}; seconds per stage (each a "
        f"process): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; {len(json.loads(ids))} ids round-trip {len(text)} chars")
    return {"bytes": size, "samples": len(part), "stages": stages,
            "sizes": sizes, "reduced": CLI_REDUCED}


# ---------------------------------------------------------------------------
# Phase 3i: multi-GPU on the one card
# ---------------------------------------------------------------------------

MG_DIR = HERE / "build" / "chip_smoke_3i"
MG_RANK_S = 420  # a rank's whole run
MG_COLLECTIVE_S = 180  # a collective's wait for the other ranks
# The JAX package's sharded rank-space segsum at the recipe's shapes
# (MULTICHIP_r05.json: its own vocabulary and corpus, 8 devices): the sum
# and the largest per-token gap against one device.
MULTICHIP_R05 = {"sum": 2397695.10, "sum_one_device": 2397695.08,
                 "max_abs_diff": 7.81e-3}


def mg_launch(mode: str, world: int, data: Path, label: str) -> list:
    """Run `world` ranks of this script's worker (`rank_worker`) as
    processes and return each rank's results; a rank that fails or
    outlasts MG_RANK_S fails the phase."""
    import pickle
    import shutil

    run = MG_DIR / mode
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(HERE))
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), "--rank-worker", mode,
         str(r), str(world), str(data), str(run)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MG_RANK_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"[{label}] a rank outlasted {MG_RANK_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"  [{label}, rank {r}] {line}")
        check(p.returncode == 0, f"[{label}] rank {r} exited {p.returncode}")
    ranks = []
    for r in range(world):
        with open(run / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def gloo_cuda_probe(dev) -> dict:
    """Which collectives the installed torch's gloo backend takes on CUDA
    tensors (the port's collectives hand gloo host arrays either way)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    ops = {"all_reduce": lambda t: dist.all_reduce(t),
           "broadcast": lambda t: dist.broadcast(t, 0),
           "all_gather": lambda t: dist.all_gather(
               [torch.empty_like(t) for _ in range(n)], t)}
    out = {}
    for name, op in ops.items():
        t = torch.ones(4, device=dev)
        try:
            op(t)
            torch.cuda.synchronize()
            out[name] = "yes"
        except RuntimeError as e:
            out[name] = f"no ({str(e).splitlines()[0][:100]})"
    return out


def rank_worker(mode: str, rank: str, world: str, data_path: str,
                out_dir: str) -> None:
    """One rank of phase 3i on the card: mode "nccl" (world size 1 under
    NCCL: the session (a), encode (a), the corpus-sharded fused prune of
    the whole corpus) or "gloo" (two ranks sharing the card: the session
    (a), encode (a) and merge's pair count (a) over the replicated corpus,
    generate at p = 1 and the corpus-sharded fused prune of the CLI slice
    on disjoint shards).
    Pickles its results to OUT/rank{RANK}.pkl."""
    import pickle

    sys.path.insert(0, str(HERE))
    from tokengeex_tpu_torch import Model, ScoredToken, Tokenizer
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import lattice_cuda as lc
    from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
    from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
    from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs
    from tokengeex_tpu_torch.parallel import mesh
    from tokengeex_tpu_torch.train.device_session import DeviceTrainSession
    from tokengeex_tpu_torch.train.generate import VocabularyGenerator
    from tokengeex_tpu_torch.train.prune import (MAX_SAMPLE_LENGTH,
                                                 VocabularyPruner)

    rank, world = int(rank), int(world)
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    dev = torch.device(data["device"])
    t0 = time.perf_counter()
    mesh.distributed_initialize(
        dev, backend=mode if dev.type == "cuda" else "gloo",
        init_method=f"file://{out_dir}/store", world_size=world, rank=rank,
        timeout=MG_COLLECTIVE_S)
    log(f"joined a {mode} group of {world} in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels = {"forward_scan": lc.forward_scan,
               "backward_betas_scan": lc.backward_betas_scan,
               "seg_weights_gather": lcs.seg_weights_gather,
               "seg_sums": lcs.seg_sums,
               "viterbi_scan": lc.viterbi_scan,
               "fused_forward_chunk": lcf.fused_forward_chunk,
               "fused_backward_chunk": lcf.fused_backward_chunk,
               "viterbi_walk": lat.viterbi_walk,
               "match_cache": lcp.match_probe}
    reduce_s = []
    plain_reduce = mesh.all_reduce_counts

    def timed_reduce(counts):
        t = time.perf_counter()
        try:
            return plain_reduce(counts)
        finally:
            reduce_s.append(time.perf_counter() - t)

    mesh.all_reduce_counts = timed_reduce

    def zero():
        for fn in kernels.values():
            fn.launches = 0
        reduce_s.clear()

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}

    def vocab(rows):
        return [ScoredToken(v, sc) for v, sc in rows]

    samples = data["samples"]
    texts = [s.decode() for s in samples]
    model_a = Model(vocab(data["vocab_a"]))
    res = {"gloo_cuda": gloo_cuda_probe(dev) if mode == "gloo" else None}

    # The session (a) over the replicated corpus: this rank's block of
    # each group's rows.
    t0 = time.perf_counter()
    sess = DeviceTrainSession(model_a, samples, MAX_SAMPLE_LENGTH,
                              device=dev, cache_budget=data["cache_budget"])
    build_s = time.perf_counter() - t0
    zero()
    t0 = time.perf_counter()
    first = sess.e_step(model_a, 0.0, 3)
    first_s = time.perf_counter() - t0
    zero()
    t0 = time.perf_counter()
    steady = sess.e_step(model_a, 0.0, 3)
    steady_s = time.perf_counter() - t0
    res["session"] = {
        "first": first, "steady": steady, "build_seconds": build_s,
        "first_seconds": first_s, "steady_seconds": steady_s,
        "steady_launches": counts(), "steady_reduce_seconds": sum(reduce_s),
        "groups": len(sess._groups()), "route": sess._fused(),
        "block_rows": [sub.rows for _, sub in sess._groups()],
        "cache_budget": sess.cache_budget, "cache_used": sess.cache_used}
    sess.close()
    del sess
    torch.cuda.empty_cache()

    # Encode (a): each rank walks its block, the ids are gathered.
    tok = Tokenizer(model_a, device=dev)
    tok.encode_batch(texts[:64])  # warm-up, on every rank
    zero()
    calls = lat.viterbi_walk.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = tok.encode_batch(texts)
    torch.cuda.synchronize()
    res["encode"] = {"digest": ids_digest(ids),
                     "seconds": time.perf_counter() - t0,
                     "launches": counts(),
                     "walk_calls": lat.viterbi_walk.calls - calls}
    del ids

    if mode == "gloo":
        # Merge's pair count at the README's shape (phase 3e's pass over
        # vocabulary (a)): each rank counts its block of every group, the
        # ranks' compacted tables are gathered and inserted into a fresh
        # table on every rank (the weighted entry). Every launch of the
        # table's three entries is counted by name.
        from collections import Counter

        from tokengeex_tpu_torch.ops import pair_count as pc
        from tokengeex_tpu_torch.train import estep_device as ed
        from tokengeex_tpu_torch.train.merge import merge_table_hints

        entries = Counter()
        launch = pc._launch

        def counted(name, *args):
            entries[name] += 1
            return launch(name, *args)

        pc._launch = counted
        try:
            t0 = time.perf_counter()
            keys, pair_counts = ed.count_pairs_arrays(
                model_a, samples, device=dev,
                table_hints=merge_table_hints(len(data["vocab_a"]), 2000,
                                              24))
            secs = time.perf_counter() - t0
        finally:
            pc._launch = launch
        res["pairs"] = {"digest": pairs_digest(keys, pair_counts),
                        "pairs": int(keys.size), "seconds": secs,
                        "entries": dict(entries)}

    # The (V,) count array's all_reduce alone, as a pass pays it.
    V = len(data["vocab_a"])
    times = []
    for _ in range(21):
        t0 = time.perf_counter()
        plain_reduce(np.ones(V, np.float64))
        times.append(time.perf_counter() - t0)
    res["all_reduce_ms"] = float(np.median(times[1:]) * 1e3)

    pruner = dict(vocab_size=data["prune_target"], shrink_factor=0.8,
                  em_subiters=2, dropout=0.05, device=dev,
                  corpus_sharded=True)
    if mode == "gloo":
        gen = VocabularyGenerator(max_token_length=L_MAX,
                                  insert_probability=1.0,
                                  allow=data["allow"], seed=SEED, device=dev)
        gen.feed(texts[:64][rank::world])
        gen.allreduce_frequencies()
        res["generate_digest"] = counter_digest(gen.frequencies)
        part = data["slice"][rank::world]
    else:
        part = samples
    zero()
    t0 = time.perf_counter()
    final = VocabularyPruner(**pruner).prune(Model(vocab(data["vocab_f"])),
                                             part)
    res["prune"] = {"digest": vocab_digest(final.vocab),
                    "tokens": [t.value for t in final.vocab],
                    "seconds": time.perf_counter() - t0,
                    "launches": counts(), "reduces": len(reduce_s),
                    "reduce_seconds": sum(reduce_s), "samples": len(part)}
    mesh.shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    log(f"done in {time.perf_counter() - START:.1f} s")


def run_multigpu(samples, vocab_a, vocab_f, prune_target, allow, expect,
                 dev):
    """Phase 3i: the multi-GPU entry points on the one card, each rank a
    process this script starts (see the module docstring). `expect` holds
    the earlier phases' results the ranks are held against."""
    import pickle

    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.train.prune import VocabularyPruner

    MG_DIR.mkdir(parents=True, exist_ok=True)
    data = MG_DIR / "data.pkl"
    cli_part = cli_slice(samples)

    def save(budget):
        with open(data, "wb") as f:
            pickle.dump({"samples": samples, "slice": cli_part,
                         "vocab_a": [(t.value, t.score) for t in vocab_a],
                         "vocab_f": [(t.value, t.score) for t in vocab_f],
                         "prune_target": prune_target, "allow": allow,
                         "cache_budget": budget, "device": str(dev)}, f)

    groups = expect["encode_groups"]
    sess_groups = expect["session_groups"]
    out = {}

    # 1. World size 1 under NCCL: bit-equal to the unsharded runs.
    save(None)
    (one,) = mg_launch("nccl", 1, data, "3i nccl, world 1")
    se, en, pr = one["session"], one["encode"], one["prune"]
    check(np.array_equal(se["first"], expect["session_counts"])
          and np.array_equal(se["steady"], se["first"]),
          "[3i nccl] the session's counts differ from phase 3d's")
    check(en["digest"] == expect["encode_digest"],
          "[3i nccl] encode's ids differ from phase 3's")
    check(pr["digest"] == expect["prune_digest"],
          "[3i nccl] the corpus-sharded prune differs from phase 3c's")
    for k in ("forward_scan", "backward_betas_scan", "seg_weights_gather",
              "seg_sums"):
        check(se["steady_launches"][k] == sess_groups,
              f"[3i nccl] a steady pass launched {k} "
              f"{se['steady_launches'][k]} times for {sess_groups} groups")
    check(en["launches"]["viterbi_scan"] == groups
          and en["launches"]["match_cache"] == groups
          and en["walk_calls"] == groups,
          f"[3i nccl] encode launched viterbi_scan "
          f"{en['launches']['viterbi_scan']} times, the probe kernel "
          f"{en['launches']['match_cache']}, the walk "
          f"{en['walk_calls']}, for {groups} groups")
    for k in ("fused_forward_chunk", "fused_backward_chunk",
              "seg_weights_gather", "seg_sums", "viterbi_walk"):
        check(pr["launches"][k] > 0, f"[3i nccl] the prune launched {k} "
              "no time")
    log(f"[3i nccl, world 1] bit-equal to phases 3d, 3 and 3c; seconds "
        f"(unsharded beside): session steady pass {se['steady_seconds']:.4f}"
        f" ({expect['session_steady_s']:.4f}), first {se['first_seconds']:.3f}"
        f"; encode (a) {en['seconds']:.3f} ({expect['encode_s']:.3f}); "
        f"corpus-sharded prune {pr['seconds']:.3f} ({expect['prune_s']:.3f}"
        f"); all_reduce of the ({len(vocab_a)},) f64 counts "
        f"{one['all_reduce_ms']:.4f} ms (steady pass: "
        f"{se['steady_reduce_seconds'] * 1e3:.4f} ms)")
    out["nccl_world1"] = {
        "encode": en, "all_reduce_ms": one["all_reduce_ms"],
        "prune": {k: v for k, v in pr.items() if k != "tokens"},
        "session": {k: v for k, v in se.items()
                    if k not in ("first", "steady")}}

    # 2. Two gloo ranks sharing the card.
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    budget = free // 4
    log(f"[3i gloo] cache_budget {budget / 2**30:.2f} GiB a rank (a quarter "
        f"of {free / 2**30:.2f} GiB free)")
    t0 = time.perf_counter()
    ref = VocabularyPruner(vocab_size=prune_target, shrink_factor=0.8,
                           em_subiters=2, dropout=0.05, device=dev).prune(
        Model(vocab_f), cli_part)
    ref_s = time.perf_counter() - t0
    save(budget)
    ranks = mg_launch("gloo", 2, data, "3i gloo, 2 ranks sharing one card")
    want = expect["session_counts"]
    for r, res in enumerate(ranks):
        se = res["session"]
        for name in ("first", "steady"):
            got = se[name]
            tot = abs(got.sum() - want.sum()) / want.sum()
            gap = float(np.abs(got - want).max())
            check(bool(np.allclose(got, want, rtol=1e-4, atol=1e-4))
                  and tot <= 1e-5,
                  f"[3i gloo] rank {r}'s {name} counts: max |diff| {gap:.3e},"
                  f" total rel {tot:.2e}")
        check(se["block_rows"] == [n // 2 for n in
                                   expect["session_rows"]],
              f"[3i gloo] rank {r}'s blocks {se['block_rows']}")
        check(res["encode"]["digest"] == expect["encode_digest"],
              f"[3i gloo] rank {r}'s gathered ids differ from phase 3's")
        check(res["encode"]["launches"]["viterbi_scan"] == groups
              and res["encode"]["launches"]["match_cache"] == groups,
              f"[3i gloo] rank {r} launched viterbi_scan "
              f"{res['encode']['launches']['viterbi_scan']} and the probe "
              f"kernel {res['encode']['launches']['match_cache']} times")
        check(res["generate_digest"] == expect["generate_digest"],
              f"[3i gloo] rank {r}'s sharded generate differs from 3f's")
        got_pairs = res["pairs"]
        check(got_pairs["digest"] == expect["pairs_digest"],
              f"[3i gloo] rank {r}'s gathered pair count "
              f"({got_pairs['pairs']} pairs) differs from phase 3e's "
              f"single-process pass ({expect['pairs_n']})")
        entries = got_pairs["entries"]
        check(entries.get("pair_insert_ids", 0) > 0
              and entries.get("pair_insert_weighted", 0) > 0
              and entries.get("pair_compact", 0) >= 2,
              f"[3i gloo] rank {r}'s pair count launched {entries}: "
              "the insert, the weighted insert of the gathered rows and "
              "both compactions must each run")
        tokens = res["prune"]["tokens"]
        check(len(tokens) <= prune_target
              and set(tokens) <= {t.value for t in vocab_f},
              f"[3i gloo] rank {r}'s pruned vocabulary: {len(tokens)} "
              "tokens, or not a subset")
    a, b = ranks
    check(np.array_equal(a["session"]["first"], b["session"]["first"])
          and a["prune"]["digest"] == b["prune"]["digest"],
          "[3i gloo] the two ranks disagree")
    got = a["session"]["first"]
    gap = float(np.abs(got - want).max())
    overlap = len(set(a["prune"]["tokens"]) & {t.value for t in ref.vocab})
    log(f"[3i gloo] gloo on CUDA tensors: {a['gloo_cuda']}")
    log(f"[3i gloo] session (a), W = {expect['session_width']}, rows "
        f"{expect['session_rows']} split 2 ways: counts sum {got.sum():.2f} "
        f"vs {want.sum():.2f} in one process, max |diff| {gap:.3e} "
        f"(MULTICHIP_r05.json, another vocabulary and corpus on 8 TPU "
        f"devices: {MULTICHIP_R05['sum']} vs {MULTICHIP_R05['sum_one_device']}"
        f", max |diff| {MULTICHIP_R05['max_abs_diff']})")
    log(f"[3i gloo] checks passed: counts within rtol 1e-4 / atol 1e-4 "
        f"(total 1e-5), both ranks' gathered ids equal phase 3's, both "
        f"ranks' gathered pair counts ({a['pairs']['pairs']} pairs) equal "
        f"phase 3e's single-process pass (launches by entry: "
        f"{[r['pairs']['entries'] for r in ranks]}; seconds "
        f"{[round(r['pairs']['seconds'], 3) for r in ranks]}), sharded "
        f"generate at p = 1 equal to phase 3f's, both ranks pruned "
        f"{len(cli_part)} samples (~2 MB, shards of "
        f"{[r['prune']['samples'] for r in ranks]}) to the same "
        f"{len(a['prune']['tokens'])} tokens; {overlap} of them in the "
        f"single-process prune's {len(ref.vocab)} ({ref_s:.3f} s)")
    for r, res in enumerate(ranks):
        se, pr = res["session"], res["prune"]
        log(f"[3i gloo, 2 ranks sharing one card] rank {r}: session built "
            f"{se['build_seconds']:.3f} s, first pass "
            f"{se['first_seconds']:.3f} s, steady pass "
            f"{se['steady_seconds']:.4f} s (gloo all_reduce "
            f"{se['steady_reduce_seconds'] * 1e3:.3f} ms of it); encode (a) "
            f"{res['encode']['seconds']:.3f} s; prune {pr['seconds']:.3f} s "
            f"({pr['reduces']} all_reduces, {pr['reduce_seconds']:.4f} s); "
            f"all_reduce of the ({len(vocab_a)},) counts alone "
            f"{res['all_reduce_ms']:.4f} ms")
    out["gloo_2_ranks"] = [{
        "session": {k: v for k, v in r["session"].items()
                    if k not in ("first", "steady")},
        "encode": r["encode"], "all_reduce_ms": r["all_reduce_ms"],
        "pairs": r["pairs"],
        "prune": {k: v for k, v in r["prune"].items() if k != "tokens"},
        "gloo_cuda": r["gloo_cuda"]} for r in ranks]
    out["gloo_2_ranks_session_max_abs_diff"] = gap
    out["gloo_2_ranks_prune_overlap"] = [overlap, len(ref.vocab)]
    return out



def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, str(HERE))
    try:
        import tokengeex_tpu_torch
        from tokengeex_tpu_torch.core.redfa import compile_dfa
        from tokengeex_tpu_torch.ops import _build
        from tokengeex_tpu_torch.ops import dfa_device as dd
        from tokengeex_tpu_torch.ops import lattice as lat
        from tokengeex_tpu_torch.ops import lattice_cuda as lc
        from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
        from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
        from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs
        from tokengeex_tpu_torch.ops import pair_count as pc
        from tokengeex_tpu_torch.ops.match_table import TokenTable
        from tokengeex_tpu_torch.train import device_session as ds
        from tokengeex_tpu_torch.train import estep_device as ed
        from tokengeex_tpu_torch.train.merge import merge_table_hints
        from tokengeex_tpu_torch.utils.packing import pack_samples
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    check(Path(tokengeex_tpu_torch.__file__).resolve().parents[1] == HERE,
          "imported a tokengeex_tpu_torch from outside this checkout")
    dev = torch.device("cuda", 0)

    # -- 1. environment + build --
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_logs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(build_logs)} in {build_s:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- corpus, vocabularies, main-path shapes --
    samples = build_corpus(CORPUS_BYTES)
    long_sample = b"\n".join(samples[:40])[: (1 << 15) + 7000]
    check(len(long_sample) > ed.MAX_ENCODE_WIDTH, "long sample too short")
    vocab_a = build_vocab(samples, 32768)
    vocab_b = build_vocab(samples, 4096)
    vocab_c = build_vocab(samples, 49152, prefixes=False)
    width = ed._pick_width(samples, None)
    rows = ed.GROUP_BYTES // width
    em_width = ed._pick_width(samples, ed.DEVICE_EM_SNIPPET)
    em_rows = ed.GROUP_BYTES // em_width
    sess_rows = ed.GROUP_BYTES // ds.PACK_WIDTH
    sess_segs = -(-ds.PACK_WIDTH // lat.SCAN_SEGMENT)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    enc_segs = -(-width // lat.SCAN_SEGMENT)
    log(f"corpus {sum(map(len, samples))} bytes in {len(samples)} samples; "
        f"encode: pack width {width}, {rows} rows per group, "
        f"{enc_segs * -(-rows // 2)} one-warp blocks per Viterbi scan "
        f"({enc_segs} segments of {lat.SCAN_SEGMENT}); E-step: width "
        f"{em_width}, {em_rows} rows = {-(-em_rows // 32)} blocks; "
        f"session: width {ds.PACK_WIDTH}, {sess_rows} rows = "
        f"{-(-sess_rows // 32)} blocks per chunk kernel, "
        f"{sess_segs * -(-sess_rows // 32)} one-warp blocks per scan "
        f"({sess_segs} segments of {lat.SCAN_SEGMENT}); {sms} SMs")

    # -- 2. kernels against their plain versions --
    phase_start("2")
    vit = check_viterbi_chunk(lc, ed.CHUNK, L_MAX, rows, dev)
    fwd = check_forward_chunk(lc, ed.CHUNK, L_MAX, em_rows, dev)
    bwd = check_backward_chunk(lc, ed.CHUNK, L_MAX, em_rows, dev)
    torch.cuda.empty_cache()
    tbl_b = TokenTable.build(vocab_b)
    dt_b = lat.DeviceTables.from_table(tbl_b, dev)
    check(lat.has_vscan(dt_b) and dt_b.max_len == L_MAX, "4k table layout")
    check(not lat.has_vscan(lat.DeviceTables.from_table(
        TokenTable.build(vocab_a), dev)), "32k table must take the slab route")
    # Encode's first row group, (a) and (b) alike: whole samples packed at
    # the encode width, its rows cut into chains.
    packed = pack_samples(samples, width=width)
    enc_groups = list(ed._padded_groups(packed, width, ed.ROW_MULT))
    batch = lat.prepare_batch(enc_groups[0][1], L_MAX, dev)
    fused = [check_fused_scan(lat, lcf, dt_b, batch, d, dev, "viterbi")
             for d in (0.0, 0.1)]
    dt_a = lat.DeviceTables.from_table(TokenTable.build(vocab_a), dev)
    vit_scan = check_viterbi_scan(lat, lc, dt_a, batch, dev)
    probe_k = check_match_cache(lat, ed, vocab_a, vocab_c, batch,
                                f64_samples(samples)[F64_SHORT:], dev)
    walk = {route: check_viterbi_walk(lat, tbl, batch,
                                      enc_groups[0][1].spans, dev, route)
            for route, tbl in (("slab", dt_a), ("fused", dt_b))}
    chained_k = check_chained_walk(lat, ed, samples, {
        "L16": vocab_a, "L20": build_vocab(samples, 32768, max_len=20)}, dev)
    del batch
    torch.cuda.empty_cache()
    # The merge's first row group (phase 3e's: the 4k vocabulary at the
    # merge's table hints).
    pairs_k = check_pair_count(lat, pc, ed, vocab_b, samples,
                               enc_groups[0][1],
                               merge_table_hints(len(vocab_b), 200, 24),
                               dev)
    torch.cuda.empty_cache()
    # The cached prune's alternatives: its vocabulary's own bytes.
    alts_k = check_alternatives_kernels(lat, lc, ed, vocab_c, dev)
    torch.cuda.empty_cache()
    betas = check_backward_betas(lc, ed.CHUNK, L_MAX, sess_rows, dev)
    seg = check_seg_weights(lcs, 1 << 22, dev)
    # The session's first row group of (b): 1 KiB snippets packed at 8192.
    packed_s = pack_samples(samples, width=ds.PACK_WIDTH,
                            max_snippet=ed.DEVICE_EM_SNIPPET)
    sub_s = next(g for _, g in ed._padded_groups(packed_s, ds.PACK_WIDTH,
                                                 ed.ROW_MULT))
    check(sub_s.rows == sess_rows, f"session group of {sub_s.rows} rows")
    batch_s = lat.prepare_batch(sub_s, L_MAX, dev)
    fused_lse = [check_fused_scan(lat, lcf, dt_b, batch_s, d, dev, "forward")
                 for d in (0.0, 0.1)]
    fused_bwd = [check_fused_scan(lat, lcf, dt_b, batch_s, d, dev,
                                  "backward") for d in (0.0, 0.1)]
    # The same group with the 32k vocabulary's cache: the session's
    # cached route.
    scans = check_scans(lat, lc, lcf, dt_a, batch_s, dev)
    torch.cuda.empty_cache()
    # The marginal scan on the same group (a session group over budget),
    # and the session's segsum on its real SegStruct.
    marg_s = check_marginal_scan(lat, lc, dt_a, batch_s, dev,
                                 "backward_marginal_scan (session group)")
    torch.cuda.empty_cache()
    segsum = check_segsum(lat, lcs, TokenTable.build(vocab_a), dt_a, batch_s,
                          dev)
    del batch_s
    torch.cuda.empty_cache()
    # The per-pass E-step's first row group of (a): 1 KiB snippets packed
    # at the snippet width, 4096 rows.
    packed_e = pack_samples(samples, width=em_width,
                            max_snippet=ed.DEVICE_EM_SNIPPET)
    sub_e = next(g for _, g in ed._padded_groups(packed_e, em_width,
                                                 ed.ROW_MULT))
    check(sub_e.rows == em_rows, f"E-step group of {sub_e.rows} rows")
    marg_e = check_marginal_scan(lat, lc, dt_a,
                                 lat.prepare_batch(sub_e, L_MAX, dev), dev,
                                 "backward_marginal_scan (E-step group)")
    del dt_a
    torch.cuda.empty_cache()
    # The generate feed's first group: the candidate mask under the allow
    # regex of all named patterns.
    allow = allow_all_patterns()
    dfa_all = compile_dfa(allow)
    mask = check_dfa_mask(dd, samples, dfa_all, dev)
    torch.cuda.empty_cache()
    # The double instantiations on the f64 route's group.
    scans64 = check_f64_scans(lat, lc, vocab_a,
                              f64_samples(samples)[:F64_SHORT], dev)
    torch.cuda.empty_cache()

    # -- 3. end to end --
    phase_start("3")
    kernels = {"viterbi_chunk": lc.viterbi_chunk,
               "viterbi_scan": lc.viterbi_scan,
               "fused_forward_chunk": lcf.fused_forward_chunk,
               "forward_chunk": lc.forward_chunk,
               "forward_scan": lc.forward_scan,
               "backward_chunk": lc.backward_chunk,
               "backward_marginal_scan": lc.backward_marginal_scan,
               "backward_betas_chunk": lc.backward_betas_chunk,
               "backward_betas_scan": lc.backward_betas_scan,
               "fused_backward_chunk": lcf.fused_backward_chunk,
               "seg_weights": lcs.seg_weights,
               "seg_weights_gather": lcs.seg_weights_gather,
               "seg_sums": lcs.seg_sums,
               "viterbi_walk": lat.viterbi_walk,
               "match_cache": lcp.match_probe,
               "match_cache_plain": count_plain_probes(lat)}
    e2e = {
        "a_32k_slab": run_config("a: 32768 tokens, slab route", vocab_a,
                                 samples, long_sample, "viterbi_scan",
                                 len(enc_groups), kernels, dev),
        "b_4k_fused": run_config("b: 4096 tokens, fused route", vocab_b,
                                 samples, long_sample, "fused_forward_chunk",
                                 len(enc_groups), kernels, dev),
    }

    torch.cuda.empty_cache()
    phase_start("3b")
    estep = {
        "a_32k": run_estep("a: 32768 tokens", vocab_a, samples, kernels, dev),
        "b_4k": run_estep("b: 4096 tokens", vocab_b, samples, kernels, dev),
    }
    torch.cuda.empty_cache()
    phase_start("3d")
    counts_a, counts_b = {}, {}
    session = {
        "a_32k": run_session("a: 32768 tokens", vocab_a, samples,
                             ("forward_scan", "backward_betas_scan",
                              "seg_weights_gather", "seg_sums"), kernels,
                             estep["a_32k"]["oracle_total"], dev, counts_a),
        "b_4k": run_session("b: 4096 tokens", vocab_b, samples,
                            ("fused_forward_chunk", "fused_backward_chunk",
                             "seg_weights_gather", "seg_sums"), kernels,
                            estep["b_4k"]["oracle_total"], dev, counts_b),
    }
    torch.cuda.empty_cache()
    over_budget = {
        "a_32k": run_session_over_budget("a: 32768 tokens", vocab_a, samples,
                                         counts_a, kernels, dev),
        "b_4k": run_session_over_budget("b: 4096 tokens", vocab_b, samples,
                                        counts_b, kernels, dev),
    }
    torch.cuda.empty_cache()
    phase_start("3c")
    pruned = run_prune("cached", vocab_c,
                       32768, samples, ("forward_scan", "backward_betas_scan",
                                        "seg_weights_gather", "seg_sums",
                                        "viterbi_scan"),
                       False, kernels, dev)
    # A table of 16,384 tokens has 15 bits: the fused route's E-steps.
    vocab_f = build_vocab(samples, 16384, prefixes=False)
    pruned_f = run_prune("fused", vocab_f, 8192, samples,
                         ("fused_forward_chunk", "fused_backward_chunk",
                          "seg_weights_gather", "seg_sums"), True, kernels,
                         dev)
    torch.cuda.empty_cache()
    alts_big = run_alternatives_big(dev)

    torch.cuda.empty_cache()
    phase_start("3e")
    merged = run_merge(vocab_b, samples, len(enc_groups), kernels, dev)
    torch.cuda.empty_cache()
    merged["readme_pass"] = run_merge_pass(vocab_a, samples, len(enc_groups),
                                           kernels, dev)
    torch.cuda.empty_cache()
    phase_start("3f")
    generated = run_generate(dd, samples, allow, dfa_all, dev)
    torch.cuda.empty_cache()
    phase_start("3g")
    recipe = run_cli_recipe(samples, dev)
    torch.cuda.empty_cache()
    phase_start("3h")
    conform = run_f64(vocab_a, samples, dev)
    torch.cuda.empty_cache()
    phase_start("3i")
    a_sess = session["a_32k"]["dropout_0.0"]
    multigpu = run_multigpu(samples, vocab_a, vocab_f, 8192, allow, {
        "encode_groups": len(enc_groups),
        "encode_digest": e2e["a_32k_slab"]["ids_digest"],
        "encode_s": e2e["a_32k_slab"]["seconds"],
        "session_counts": counts_a[0.0],
        "session_groups": a_sess["shape"]["groups"],
        "session_rows": a_sess["shape"]["block_rows"],
        "session_width": a_sess["shape"]["width"],
        "session_steady_s": a_sess["steady_seconds"],
        "prune_digest": pruned_f["vocab_digest"],
        "prune_s": pruned_f["seconds"],
        "generate_digest": generated["p1_64_digest"],
        "pairs_digest": merged["readme_pass"]["digest"],
        "pairs_n": merged["readme_pass"]["pairs"]}, dev)

    # -- 4. kernels line --
    phase_start("4")
    def entry(name, source, replaces, launches, res, err=None):
        return {"name": name, "route": "cuda",
                "source": f"tokengeex_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": res["max_abs_err"] if err is None else err,
                "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms")}

    pallas = "tokengeex_tpu/ops/lattice_pallas.py"
    fused_py = "tokengeex_tpu/ops/lattice_pallas_fused.py"
    b_sess = session["b_4k"]["dropout_0.0"]["launches"]
    line = {"kernels": [
        entry("viterbi_scan", "viterbi_chunk.cu", f"{pallas}:72",
              e2e["a_32k_slab"]["launches"]["viterbi_scan"],
              vit_scan["dropout_0.0"],
              max(vit_scan[f"dropout_{d}"]["max_abs_err"]
                  for d in (0.0, 0.1))),
        entry("fused_forward_chunk(viterbi)", "fused_forward.cu",
              f"{fused_py}:377",
              e2e["b_4k_fused"]["launches"]["fused_forward_chunk"], fused[0],
              max(f["max_abs_err"] for f in fused)),
        entry("fused_forward_chunk(logsumexp)", "fused_forward.cu",
              f"{fused_py}:377", b_sess["fused_forward_chunk"], fused_lse[0],
              max(f["max_abs_err"] for f in fused_lse)),
        entry("forward_chunk", "forward_chunk.cu", f"{pallas}:176",
              pruned["launches"]["forward_scan"],
              scans["forward"]["dropout_0.0"],
              max(scans["forward"][f"dropout_{d}"]["max_abs_err"]
                  for d in (0.0, 0.1))),
        entry("backward_chunk", "backward_chunk.cu", f"{pallas}:238",
              estep["a_32k"]["launches"]["backward_marginal_scan"],
              marg_e["dropout_0.0"],
              max(m[f"dropout_{d}"]["max_abs_err"] for m in (marg_e, marg_s)
                  for d in (0.0, 0.1))),
        entry("backward_chunk(betas)", "backward_chunk.cu",
              "tokengeex_tpu/ops/lattice_jax.py:1742",
              pruned["launches"]["backward_betas_scan"],
              scans["backward"]["dropout_0.0"],
              max(scans["backward"][f"dropout_{d}"]["max_abs_err"]
                  for d in (0.0, 0.1))),
        entry("fused_backward_chunk", "fused_backward.cu", f"{fused_py}:444",
              b_sess["fused_backward_chunk"], fused_bwd[0],
              max(f["max_abs_err"] for f in fused_bwd)),
        entry("seg_weights", "seg_weights.cu", f"{fused_py}:531",
              pruned["launches"]["seg_weights_gather"],
              segsum["dropout_0.0"],
              max(segsum[f"dropout_{d}"]["max_abs_err"] for d in (0.0, 0.1))),
        entry("seg_sums", "seg_weights.cu",
              "tokengeex_tpu/ops/lattice_jax.py:2206 (_segsum_expected_impl:"
              " the interval sums and the accumulate)",
              pruned["launches"]["seg_sums"], segsum["dropout_0.0"]["sums"],
              max(segsum[f"dropout_{d}"]["sums"]["max_abs_err"]
                  for d in (0.0, 0.1))),
        entry("viterbi_walk", "viterbi_walk.cu",
              "tokengeex_tpu/ops/lattice_jax.py:2374",
              e2e["a_32k_slab"]["launches"]["viterbi_walk"],
              walk["slab"]["ids"],
              max(w[m]["max_abs_err"] for w in walk.values()
                  for m in ("count", "ids"))),
        entry("chained_walk", "viterbi_walk.cu",
              "tokengeex_tpu/train/estep_device.py:613 (the chained "
              "windows' host backtrack)",
              e2e["a_32k_slab"]["chained_launches"], chained_k["L20"]),
        entry("dfa_mask", "dfa_mask.cu",
              "tokengeex_tpu/ops/dfa_device.py:75", generated["launches"],
              mask),
        entry("viterbi_scan[f64]", "viterbi_chunk.cu", f"{pallas}:72",
              conform["encode_launches_f64"], scans64["viterbi_scan"]),
        entry("forward_chunk[f64]", "forward_chunk.cu", f"{pallas}:176",
              conform["estep_launches_f64"]["forward_scan"],
              scans64["forward_scan"]),
        entry("backward_chunk[f64]", "backward_chunk.cu", f"{pallas}:238",
              conform["estep_launches_f64"]["backward_marginal_scan"],
              scans64["backward_marginal_scan"]),
        entry("viterbi_scan[f64](alternatives)", "viterbi_chunk.cu",
              f"{pallas}:72", sum(p["alternatives"]["launches_f64"]
                                  for p in (pruned, pruned_f)),
              alts_k["viterbi_scan"]),
        entry("viterbi_walk(alternatives)", "viterbi_walk.cu",
              "tokengeex_tpu/ops/lattice_jax.py:2374",
              sum(p["alternatives"]["walk_launches"]
                  for p in (pruned, pruned_f)),
              alts_k["walk"]["ids"],
              max(alts_k["walk"][m]["max_abs_err"]
                  for m in ("count", "ids"))),
        entry("pair_count", "pair_count.cu",
              "native/tokengeex_native.cpp:542",
              merged["launches"]["pair_count"], pairs_k),
        entry("match_cache", "match_probe.cu",
              "tokengeex_tpu/ops/lattice_jax.py:448 (_match_slab, driven "
              "by :665 _match_cache_impl)",
              e2e["a_32k_slab"]["launches"]["match_cache"], probe_k["bucket"],
              max(r["max_abs_err"] for t, r in probe_k.items()
                  if "[f64]" not in t)),
        entry("match_cache[f64]", "match_probe.cu",
              "tokengeex_tpu/ops/lattice_jax.py:448 (_match_slab, driven "
              "by :665 _match_cache_impl)",
              sum(conform["probe_launches_f64"].values()),
              probe_k["exact[f64], slots"],
              max(r["max_abs_err"] for t, r in probe_k.items()
                  if "[f64]" in t)),
    ]}
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_seconds": build_s,
              "viterbi_chunk": vit, "viterbi_scan": vit_scan,
              "fused_forward": fused,
              "forward_chunk": fwd, "backward_chunk": bwd,
              "backward_betas_chunk": betas, "scans": scans,
              "seg_weights": seg, "backward_marginal_scan": {
                  "e_step_group": marg_e, "session_group": marg_s},
              "seg_weights_gather": segsum,
              "fused_forward_logsumexp": fused_lse,
              "fused_backward": fused_bwd, "viterbi_walk": walk,
              "chained_walk": chained_k,
              "encode": e2e, "estep": estep, "merge": merged,
              "session": session, "session_over_budget": over_budget,
              "prune": pruned, "prune_fused": pruned_f,
              "alternatives_kernels": alts_k, "alternatives_500k": alts_big,
              "dfa_mask": mask, "pair_count": pairs_k,
              "match_cache": probe_k,
              "generate": generated,
              "cli_recipe": recipe, "f64_scans": scans64, "f64": conform,
              "multigpu": multigpu,
              "kernels": line["kernels"]}
    out = HERE / "chiprun_out"
    try:
        out.mkdir(exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    except OSError:
        pass
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(*sys.argv[2:7])
    else:
        main()
