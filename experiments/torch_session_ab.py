#!/usr/bin/env python3
"""The fused route end to end on the card, for one checkout of the port:
chip_smoke.py's session E-step of configuration (b) (phase 3d) and its
fused-route prune (phase 3c), run on the package of the checkout named.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU,
naming the checkout to measure (this one by default):

    python3 experiments/torch_session_ab.py [ROOT]

To compare two commits, unpack the other one into a git-ignored
directory (`git archive <commit> | tar -x -C build/parent`) and run this
script on both in turns in one call (parent, change, change, parent).
The measuring code is this checkout's chip_smoke.py (`run_session`,
`run_prune`, `oracle_total`) for both; the package and its kernels, built
into ROOT/build, are ROOT's.

With chip_smoke.py's seeded ~8 MB corpus at L = 16 it runs:

  - `run_session` over the 4,096-token vocabulary (bits 13, the fused
    route) at dropout 0 and 0.05: first and steady pass, their phase
    splits, the device busy and idle share of a steady pass at dropout 0,
    and the session's checks;
  - `run_prune` from 16,384 to 8,192 tokens with the README recipe's
    settings through one session on the fused route: seconds and split
    per round.

Prints one JSON object as its last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402  (this checkout's)

sys.path.insert(0, str(ROOT))  # the package measured: ROOT's


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures the port on a GPU")
    import tokengeex_tpu_torch
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
    from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs
    from tokengeex_tpu_torch.train import estep_device as ed

    cs.check(Path(tokengeex_tpu_torch.__file__).resolve().parents[1] == ROOT,
             f"imported a tokengeex_tpu_torch from outside {ROOT}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(f"{smi}; package from {ROOT}")
    samples = cs.build_corpus(cs.CORPUS_BYTES)
    vocab = cs.build_vocab(samples, 4096)
    expect = ("fused_forward_chunk", "fused_backward_chunk", "seg_weights")
    kernels = {"fused_forward_chunk": lcf.fused_forward_chunk,
               "fused_backward_chunk": lcf.fused_backward_chunk,
               "seg_weights": lcs.seg_weights}
    oracle = cs.oracle_total(Model(vocab), samples[:64], ed.DEVICE_EM_SNIPPET)
    res = {"root": str(ROOT), "device": smi,
           "session_b": cs.run_session("b: 4096 tokens", vocab, samples,
                                       expect, kernels, oracle, dev),
           "prune_fused": cs.run_prune(
               "fused", cs.build_vocab(samples, 16384, prefixes=False), 8192,
               samples, expect, True, kernels, dev)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
