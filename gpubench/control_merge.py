"""The control of the merge cell's comparison, on the chip.

    python3 gpubench/control_merge.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does and follows the
float64 reference's own passes (its pair counts, upstream's selection)
from the start vocabulary; on each pass's model it puts the reference's
pair counts computed in bfloat16 (the precision below the
configuration's float32) in the program's place and compares them with
the float64 counts by the cell's own numbers. Each seed prints one JSON
line: the numbers beside the cell's limits. `merges_wrong` has no
control reading: the selection is host float64 in the program, and the
control's own selection follows its own counts. The benchmark's runs do
not run this (gpubench/control.py covers the encode and prune entries).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def merge_control(files: dict, seed: int, dev, dtype) -> dict:
    from gpubench import harness
    from gpubench.reference import merge as rm

    config, traffic = files["config"], files["traffic"]
    data = harness.entry("merge").build(config, traffic, seed)
    m = config["merge"]
    num, step = int(config["num_merges"]), int(m["step"])
    allow = rm.allow_fn(config["allow"])
    cur = [(v, s) for v, s, _ in data["vocab"]]
    n0, refused, models, refs = len(cur), set(), [], []
    while len(cur) < n0 + num:
        r = rm.pair_counts([cur], data["files"], dev)[0]
        models.append(cur)
        refs.append(r)
        new = rm.select(cur, r["keys"], r["counts"],
                        min(step, n0 + num - len(cur)),
                        int(m["max_token_length"]),
                        float(m["scale_factor"]), allow, refused)
        if not new:
            break
        cur = cur + new
    ctl = rm.pair_counts(models, data["files"], dev, dtype)
    l1 = top = 0.0
    for r, c in zip(refs, ctl):
        got = dict(zip(c["keys"].tolist(), c["counts"].tolist()))
        l1 = max(l1, rm.l1(got, r["keys"], r["counts"]))
        top = max(top, rm.top_l1(got, r["keys"], r["counts"],
                                 int(traffic["top_pairs"])))
    return {"pairs_l1": l1, "top_pairs_l1": top, "merges_wrong": None}


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
    if files["traffic"]["entry"] != "merge":
        raise SystemExit(f"{args.workload} is no merge cell")
    if args.device == "cuda":
        harness.require_devices(int(files["cell"]["chips"]))
    dev = torch.device(args.device)
    dtype = getattr(torch, args.dtype)
    for seed in args.seeds:
        t = time.perf_counter()
        values = merge_control(files, seed, dev, dtype)
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
