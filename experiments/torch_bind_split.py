#!/usr/bin/env python3
"""Where a prune session's binding of a model spends its seconds: one
benchmark run of a prune cell, with each binding's pieces timed.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 experiments/torch_bind_split.py <cell> <seed> [seconds]

It runs `gpubench/run.py --trace 0` in this process, with the session's
binding (train/device_session.py `_rebind`) and its parts wrapped: each
part is timed between two `torch.cuda.synchronize()` calls, so a part's
seconds hold its device work too. The parts: the layout's host id map
(`ResidentLayout.id_map`), the gathers on the device (`ResidentLayout
.bind`, its uploads of the id map and the scores apart as `bind.upload`),
the rank rows (`rank_score_rows`, its upload of the rank words apart) and
the alternatives' float64 scores (`tables_f64` less its own binding).
`rest` is a binding less its timed parts: the token lists, the score
array, the rank ids through the id map. It prints the result line, then
one line `SPLIT {json}`: each part's calls and median, min and max
seconds a binding.
"""

import functools
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gpubench import run  # noqa: E402
from tokengeex_tpu_torch.ops import lattice as lat  # noqa: E402
from tokengeex_tpu_torch.train import device_session as ds  # noqa: E402

bindings = []  # part -> seconds, one dict a binding
f64 = []  # tables_f64's own seconds a call, its binding left out
stack = []  # the timed parts open now: [name, seconds of timed children]


def timed(name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if name == "rebind":
            bindings.append(defaultdict(float))
        stack.append([name, 0.0])
        try:
            return fn(*args, **kwargs)
        finally:
            _, kids = stack.pop()
            torch.cuda.synchronize()
            s = time.perf_counter() - t
            if stack:
                stack[-1][1] += s
            if name == "rebind":
                bindings[-1]["rebind"] = s
                bindings[-1]["rest"] = s - kids
            elif name == "tables_f64":
                f64.append(s - kids)
            elif any(n == "rebind" for n, _ in stack):
                bindings[-1][name] += s
    return wrapped


def rebind(fn):
    """The binding, timed only where it binds (not for the same model)."""
    timed_fn = timed("rebind", fn)

    @functools.wraps(fn)
    def wrapped(self, model, *args, **kwargs):
        if model is self._model:
            return fn(self, model, *args, **kwargs)
        return timed_fn(self, model, *args, **kwargs)
    return wrapped


def upload(fn):
    """An upload inside `bind` or the rank rows, timed under its name."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if stack and stack[-1][0] in ("bind", "rank_score_rows"):
            return timed(stack[-1][0] + ".upload", fn)(*args, **kwargs)
        return fn(*args, **kwargs)
    return wrapped


lat.upload = upload(lat.upload)
lat.ResidentLayout.id_map = timed("id_map", lat.ResidentLayout.id_map)
lat.ResidentLayout.bind = timed("bind", lat.ResidentLayout.bind)
lat.rank_score_rows = timed("rank_score_rows", lat.rank_score_rows)
ds.DeviceTrainSession._rebind = rebind(ds.DeviceTrainSession._rebind)
ds.DeviceTrainSession.tables_f64 = timed("tables_f64",
                                         ds.DeviceTrainSession.tables_f64)


def main():
    cell, seed = sys.argv[1], sys.argv[2]
    secs = sys.argv[3] if len(sys.argv) > 3 else "12"
    rc = run.main(["--workload", cell, "--seed", seed, "--seconds", secs,
                   "--trace", "0"])
    parts = defaultdict(list)
    for one in bindings:
        for k, v in one.items():
            parts[k].append(v)
    parts["tables_f64"] = f64
    out = {k: {"calls": len(v), "median": statistics.median(v),
               "min": min(v), "max": max(v)}
           for k, v in parts.items() if v}
    print("SPLIT " + json.dumps(out, sort_keys=True), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
