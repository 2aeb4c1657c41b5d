"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the CUDA context, the inputs made from the seed, the
warm-up) is timed from the start of this process to the first timed
request; the window then measures for `--seconds`; the program's output
is checked against the plain reference after the window. The last line
of standard output is the result; the numbers compared, each with its
limit, are the last lines of standard error. Needs CUDA: without a card,
or with fewer than the cell asks for, it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The kernels build once a checkout into the program's own fixed
# directory, build/tokengeex_tpu_torch/, unless this overrides it.
os.environ.pop("TGX_TORCH_BUILD_DIR", None)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import harness

    files = harness.cell_files(args.workload)
    harness.require_devices(int(files["cell"]["chips"]))
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    result = run_cell(files, args.seed, args.seconds, bool(args.trace), dev)
    return harness.finish(**result)


def run_cell(files: dict, seed: int, seconds: float, trace: bool, dev,
             start: float = T0) -> dict:
    """Drive the cell's entry and gather what `harness.finish` prints.
    The device may be the CPU (the harness's tests); the command refuses
    one."""
    import torch

    from gpubench import compare, harness

    cell, traffic = files["cell"], files["traffic"]
    state = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def setup_done():
        state["setup_s"] = time.perf_counter() - start
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def window_closed():
        sync()
        state["peak"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)

    def log(msg):
        print(f"gpubench: {msg}", file=sys.stderr, flush=True)

    ctx = {"config": files["config"], "traffic": traffic, "seed": seed,
           "seconds": seconds, "trace": trace, "device": dev, "sync": sync,
           "setup_done": setup_done, "window_closed": window_closed,
           "log": log}
    log(f"imports in {time.perf_counter() - start:.3f} s")
    out = harness.entry(traffic["entry"]).run(ctx)
    log(f"setup {state['setup_s']:.3f} s, device memory peak "
        f"{state['peak']} bytes")
    m = files["manifest"]
    if trace:
        top = sorted(out["trace"]["kernels"].items(), key=lambda kv: -kv[1])
        for name, sec in top[:25]:
            log(f"device {sec:.6f} s {name[:160]}")
        ctx.update(out["trace"])
        metrics = harness.read_per_layer(
            harness.cell_metrics(m, cell["name"], True), ctx)
    else:
        values = dict(out["end_to_end"], setup_s=state["setup_s"])
        metrics = {}
        for metric in harness.cell_metrics(m, cell["name"], False):
            v = values.get(metric["name"])
            if v is not None:
                metrics[metric["name"]] = {"value": v,
                                           "unit": metric["unit"]}
    device = (harness.device_info(dev, int(cell["chips"]), state["peak"])
              if dev.type == "cuda" else {"platform": "cpu", "count": 1,
                                          "memory_peak_bytes": 0})
    if trace:
        device.update(busy_s=out["trace"]["busy_s"],
                      window_s=out["trace"]["window_s"])
    checks = out["checks"]
    correct = out["failed"] == 0 and out["attempted"] > 0 and \
        compare.within(checks)
    return {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device,
            "checks": checks, "breakdown": out.get("breakdown")}


if __name__ == "__main__":
    sys.exit(main())
