#!/usr/bin/env python3
"""One traced benchmark run of a prune cell, and what its result line
does not hold: the device's idle gaps put down to the program's own
spans, the window's `Memcpy HtoD` events against the program's upload
counter, and the program's span tree and counters.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 experiments/torch_trace_breakdown.py <cell> <seed> \
        [seconds [out.json]]

It runs `gpubench/run.py --trace 1` in this process, with the harness's
`Trace.summary` wrapped: the result line is the benchmark's own. The idle
gaps by span are the harness's own `breakdown` with the program's prefix
(`tgx.`, utils/trace.py) added to the benchmark's (`gpubench.`): each gap
goes to the latest-starting span of either prefix that holds its
midpoint, the ten largest kept. Besides, it counts the window's
`Memcpy HtoD` events and the span marks copied onto the device's
timeline, and gives each path's calls, seconds and self seconds a stage
run. It prints lines starting with `TRACE`, and with `out.json` writes
them all there.
"""

import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from gpubench import harness  # noqa: E402

extra = {}
_summary = harness.Trace.summary


def summary(self, prefixes=()):
    out = _summary(self, prefixes)
    spanned = _summary(self, tuple(prefixes) + ("tgx.",))
    from torch.autograd import DeviceType

    htod, tgx = [], 0
    marks_on_device = defaultdict(int)
    for e in self.prof.events():
        tr = e.time_range
        if e.name.startswith(("gpubench.", "tgx.")):
            if e.device_type == DeviceType.CUDA:
                # A mark copied onto the device's timeline (user scope).
                marks_on_device[e.name.split(".")[0]] += 1
            elif e.name == "gpubench.window":
                w0, w1 = tr.start, tr.end
            elif e.name.startswith("tgx."):
                tgx += 1
        elif e.device_type == DeviceType.CUDA and "HtoD" in e.name:
            htod.append((tr.start, tr.end))
    htod = [min(b, w1) - max(a, w0) for a, b in htod if b > w0 and a < w1]
    extra.update(idle_by_span=spanned["breakdown"]["idle_gaps"],
                 htod_events=len(htod), htod_s=sum(htod) / 1e6,
                 marks_on_device=dict(marks_on_device),
                 tgx_events=tgx, window_s=spanned["window_s"])
    return out


def main(argv) -> int:
    cell, seed = argv[0], argv[1]
    seconds = argv[2] if len(argv) > 2 else "51"
    harness.Trace.summary = summary
    run = harness.load_module(ROOT / "gpubench" / "run.py", "gprun")
    rc = run.main(["--workload", cell, "--seed", seed, "--seconds", seconds,
                   "--trace", "1"])
    from tokengeex_tpu_torch.utils import trace

    rec = trace.record()
    runs = max(1, rec.calls("prune"))
    tree = {p: {"calls": c / runs, "s": s / runs, "self_s": (s - ch) / runs}
            for p, (c, s, ch) in sorted(rec.spans.items())}
    totals = defaultdict(float)
    for (_, name), v in rec.counters.items():
        totals[name] += v / runs
    extra.update(rc=rc, runs=runs, tree=tree, counters=dict(totals),
                 counters_by_path={f"{p}:{k}": v / runs for (p, k), v
                                   in sorted(rec.counters.items())},
                 spans_opened_per_run=sum(c for c, _, _ in
                                          rec.spans.values()) / runs)
    if len(argv) > 3:
        with open(argv[3], "w") as f:
            json.dump(extra, f, indent=1)
    print("TRACE", json.dumps({k: extra[k] for k in (
        "runs", "htod_events", "htod_s", "marks_on_device", "tgx_events",
        "spans_opened_per_run")}), flush=True)
    print("TRACE counters", json.dumps(extra["counters"]), flush=True)
    print("TRACE idle", json.dumps(extra["idle_by_span"]), flush=True)
    for path, v in sorted(tree.items(), key=lambda kv: -kv[1]["self_s"]):
        print(f"TRACE span {path} calls {v['calls']:.2f} s {v['s']:.4f} "
              f"self {v['self_s']:.4f}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
