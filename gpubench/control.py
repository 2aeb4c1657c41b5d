"""The control of the comparison that decides `correct`, on the chip.

    python3 gpubench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does, puts the plain
reference computed in bfloat16 (the precision below the configuration's
float32) in the program's place, and compares what that gives with the
float64 reference by the cell's own numbers. Each seed prints one JSON
line: the numbers beside the cell's limits. Every number that the
control reads at or under its limit is a limit that lets the control
through; the limits in the traffic files are set so that none does.
The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def encode_control(files: dict, seed: int, dev, dtype) -> dict:
    import numpy as np
    import torch

    from gpubench import compare, harness, inputs
    from gpubench.reference import lattice as rl

    config, traffic = files["config"], files["traffic"]
    enc = harness.entry("encode")
    data = enc.build(config, traffic, seed)
    sizes = np.array([len(f) for f in data["files"]])
    chk = traffic["check"]
    rng = np.random.default_rng(inputs.subseed(seed, inputs.SAMPLE))
    longest = np.argsort(-sizes, kind="stable")[: int(chk["longest_files"])]
    rest = np.setdiff1d(np.arange(sizes.size), longest)
    pick = longest.tolist() + rng.permutation(rest)[
        : int(chk["random_files"])].tolist()
    texts = [data["texts"][i] for i in pick]
    vocab = data["vocab"]
    scores = torch.tensor([t[1] for t in vocab], dtype=torch.float64,
                          device=dev)
    _, ids = rl.encode([compare.preprocess(t, config) for t in texts],
                       rl.Lookup([t[0] for t in vocab], dev), scores, dtype)
    return compare.encode(config, vocab, texts, ids, dev)


def prune_control(files: dict, seed: int, dev, dtype) -> dict:
    """Each pass of the stage in `dtype` on the start model, against the
    float64 reference's on the same model: the E-step (its own coins),
    the alternatives and the frequencies. (A whole stage in bfloat16 does
    not run through: its E-step counts overflow, and the M-step's scores
    with them.) The M-step and the removal are host float64 in the
    program; vocab_wrong has no control reading."""
    import torch

    from gpubench import compare, harness, inputs
    from gpubench.reference import prune as rp

    config, traffic = files["config"], files["traffic"]
    data = harness.entry("prune").build(config, traffic, seed)
    vocab, docs = data["vocab"], data["files"]
    dropout = float(config["prune"]["dropout"])
    ref_gen = torch.Generator(device=dev).manual_seed(
        inputs.subseed(seed, inputs.REF_COINS))
    gen = torch.Generator(device=dev).manual_seed(
        inputs.subseed(seed, inputs.PRUNER))
    e_ref = rp.e_step(vocab, docs, dropout, ref_gen, dev)[0]
    e_ctl = rp.e_step(vocab, docs, dropout, gen, dev, dtype)[0]
    keep, alts, _, _ = rp.alternatives(vocab, dev, dtype)
    f_ctl = rp.frequencies(vocab, docs, dev, dtype)
    f_ref = rp.frequencies(vocab, docs, dev)
    return {"estep_l1": compare.l1(e_ctl, e_ref),
            "estep_len_l1": compare.length_l1(vocab, e_ctl, e_ref),
            "freq_l1": compare.l1(f_ctl, f_ref),
            "alternatives_wrong": compare.alternatives_wrong(
                vocab, keep, alts, dev),
            "vocab_wrong": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gpubench import harness

    files = harness.cell_files(args.workload)
    if args.device == "cuda":
        harness.require_devices(int(files["cell"]["chips"]))
    dev = torch.device(args.device)
    dtype = getattr(torch, args.dtype)
    fn = {"encode": encode_control,
          "prune": prune_control}[files["traffic"]["entry"]]
    for seed in args.seeds:
        t = time.perf_counter()
        values = fn(files, seed, dev, dtype)
        limits = files["traffic"]["limits"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": args.dtype,
            "seconds": time.perf_counter() - t,
            "numbers": {k: {"value": values[k], "limit": limits[k]}
                        for k in limits},
            "refused": any(values[k] is not None and values[k] > limits[k]
                           for k in limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
