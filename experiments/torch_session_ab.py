#!/usr/bin/env python3
"""The port end to end on the card, for one checkout: chip_smoke.py's
encode of configurations (a) and (b) (phase 3), its session E-step of
(b) (phase 3d), both prunes (phase 3c) and the merge (phase 3e), run
with the checkout's own chip_smoke.py on its own package.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU,
naming the checkout to measure (this one by default):

    python3 experiments/torch_session_ab.py [ROOT [PART ...]]

PART names what to run (encode, session, session_a, segsum,
prune_cached, prune_fused, merge); all of them by default.

To compare two commits, unpack the other one into a git-ignored
directory (`git archive <commit> | tar -x -C build/parent`) and run this
script on both in turns in one call (parent, change, change, parent).
The measuring code is ROOT's chip_smoke.py (`run_config`, `run_session`,
`run_prune`, `run_merge`, `oracle_total`), so that its checks match its
package; the package and its kernels, built into ROOT/build, are ROOT's.

With chip_smoke.py's seeded ~8 MB corpus at L = 16 it runs:

  - `run_config` over the 32,768-token vocabulary (slab route) and the
    4,096-token one (fused route): encode seconds, phase split and idle
    share, with the encode's checks;
  - `run_session` over the 4,096-token vocabulary (bits 13, the fused
    route) at dropout 0 and 0.05: first and steady pass, their phase
    splits, the device busy and idle share of a steady pass at dropout 0,
    and the session's checks; `session_a` the same over the
    32,768-token vocabulary (the cached route);
  - `check_segsum` on the first row group of session (a) (W = 8192, 512
    rows, the 32k vocabulary's rank space) at dropout 0 and 0.1: the
    whole `segsum_expected` call per group (`segsum_ms`) and its kernels
    against their twins;
  - `run_prune` from 49,152 to 32,768 tokens (cached route) and from
    16,384 to 8,192 tokens (fused route) with the README recipe's
    settings through one session each: seconds and split per round;
  - `run_merge`: 200 merges into the 4,096-token vocabulary, seconds per
    pass.

It also times a fixed pure-Python loop before the first part and after
each (`host_s`), a yardstick of the host's speed during the run: host
clocks on a shared machine swing between runs, and the end-to-end
seconds are host bound. `gc` gives the seconds Python's cyclic garbage
collector took in each part and the number of its full (generation 2)
collections, and `merge_pass_gc` the same for each merge pass (the
first four are `run_merge`'s timed passes).

Prints one JSON object as its last line.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
PARTS = ("encode", "session", "session_a", "segsum", "prune_cached",
         "prune_fused", "merge")
RUN = sys.argv[2:] or list(PARTS)
sys.path.insert(0, str(ROOT))  # the package and chip_smoke.py: ROOT's

import chip_smoke as cs  # noqa: E402


def host_yardstick() -> float:
    """Seconds of a fixed pure-Python loop."""
    t = time.perf_counter()
    sum(i * i for i in range(5_000_000))
    return time.perf_counter() - t


class GcClock:
    """Seconds spent in Python's cyclic garbage collector, and its full
    collections, since the clock was made (a gc callback)."""

    def __init__(self):
        self.seconds, self.full, self._t = 0.0, 0, 0.0
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t
            self.full += info["generation"] == 2

    def since(self, mark):
        return [round(self.seconds - mark[0], 6), self.full - mark[1]]

    def mark(self):
        return (self.seconds, self.full)


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures the port on a GPU")
    cs.check(set(RUN) <= set(PARTS), f"parts {RUN}: not among {PARTS}")
    import tokengeex_tpu_torch
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import lattice_cuda as lc
    from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
    from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs
    from tokengeex_tpu_torch.ops.match_table import TokenTable
    from tokengeex_tpu_torch.train import device_session as ds
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.merge import VocabularyMerger
    from tokengeex_tpu_torch.utils.packing import pack_samples

    for path in (tokengeex_tpu_torch.__file__, cs.__file__):
        cs.check(ROOT in Path(path).resolve().parents,
                 f"imported {path}, outside {ROOT}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(f"{smi}; package from {ROOT}")
    samples = cs.build_corpus(cs.CORPUS_BYTES)
    long_sample = b"\n".join(samples[:40])[: (1 << 15) + 7000]
    vocab_a = cs.build_vocab(samples, 32768)
    vocab_b = cs.build_vocab(samples, 4096)
    width = ed._pick_width(samples, None)
    groups = len(list(ed._padded_groups(pack_samples(samples, width=width),
                                        width, ed.ROW_MULT)))
    kernels = {"viterbi_scan": lc.viterbi_scan,
               "forward_scan": lc.forward_scan,
               "backward_betas_scan": lc.backward_betas_scan,
               "fused_forward_chunk": lcf.fused_forward_chunk,
               "fused_backward_chunk": lcf.fused_backward_chunk,
               "seg_weights_gather": lcs.seg_weights_gather,
               "viterbi_walk": lat.viterbi_walk}
    if hasattr(cs, "check_probes"):
        # ROOT's phases count the slab probe kernel's launches and its
        # twin's calls on the card.
        from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp

        kernels["match_cache"] = lcp.match_probe
        kernels["match_cache_plain"] = cs.count_plain_probes(lat)
    segsum = ("seg_weights_gather",)
    if hasattr(lcs, "seg_sums"):
        # ROOT's segsum launches its sums kernel too.
        kernels["seg_sums"] = lcs.seg_sums
        segsum += ("seg_sums",)
    fused = ("fused_forward_chunk", "fused_backward_chunk") + segsum
    res = {"root": str(ROOT), "device": smi, "host_s": [host_yardstick()],
           "gc": {}, "merge_pass_gc": []}
    clock = GcClock()
    count_pairs = VocabularyMerger._count_pairs

    def gc_per_pass(self, *args, **kwargs):
        mark = clock.mark()
        try:
            return count_pairs(self, *args, **kwargs)
        finally:
            res["merge_pass_gc"].append(clock.since(mark))

    VocabularyMerger._count_pairs = gc_per_pass

    def encode():
        return {"encode_a": cs.run_config(
                    "a: 32768 tokens, slab route", vocab_a, samples,
                    long_sample, "viterbi_scan", groups, kernels, dev),
                "encode_b": cs.run_config(
                    "b: 4096 tokens, fused route", vocab_b, samples,
                    long_sample, "fused_forward_chunk", groups, kernels,
                    dev)}

    def session():
        oracle = cs.oracle_total(Model(vocab_b), samples[:64],
                                 ed.DEVICE_EM_SNIPPET)
        return {"session_b": cs.run_session("b: 4096 tokens", vocab_b,
                                            samples, fused, kernels, oracle,
                                            dev)}

    def session_a():
        oracle = cs.oracle_total(Model(vocab_a), samples[:64],
                                 ed.DEVICE_EM_SNIPPET)
        return {"session_a": cs.run_session(
            "a: 32768 tokens", vocab_a, samples,
            ("forward_scan", "backward_betas_scan") + segsum, kernels,
            oracle, dev)}

    def segsum_call():
        sub = next(g for _, g in ed._padded_groups(
            pack_samples(samples, width=ds.PACK_WIDTH,
                         max_snippet=ed.DEVICE_EM_SNIPPET),
            ds.PACK_WIDTH, ed.ROW_MULT))
        table = TokenTable.build(vocab_a)
        return {"segsum": cs.check_segsum(
            lat, lcs, table, lat.DeviceTables.from_table(table, dev),
            lat.prepare_batch(sub, cs.L_MAX, dev), dev)}

    def prune_cached():
        return {"prune_cached": cs.run_prune(
            "cached", cs.build_vocab(samples, 49152, prefixes=False), 32768,
            samples, ("forward_scan", "backward_betas_scan", "viterbi_scan")
            + segsum, False, kernels, dev)}

    def prune_fused():
        return {"prune_fused": cs.run_prune(
            "fused", cs.build_vocab(samples, 16384, prefixes=False), 8192,
            samples, fused, True, kernels, dev)}

    def merge():
        return {"merge": cs.run_merge(vocab_b, samples, groups, kernels,
                                      dev)}

    runs = {"encode": encode, "session": session, "session_a": session_a,
            "segsum": segsum_call, "prune_cached": prune_cached,
            "prune_fused": prune_fused, "merge": merge}
    for name in PARTS:
        if name in RUN:
            torch.cuda.empty_cache()
            mark = clock.mark()
            res.update(runs[name]())
            res["gc"][name] = clock.since(mark)
            res["host_s"].append(host_yardstick())
    print(json.dumps(res, default=str), flush=True)


if __name__ == "__main__":
    main()
