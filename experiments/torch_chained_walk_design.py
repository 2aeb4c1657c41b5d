#!/usr/bin/env python3
"""Probe of tokengeex_tpu_torch's chained walk, on the card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_chained_walk_design.py [SEED] [out.json]

The corpus and the start vocabulary of the benchmark's merge cell
(`exact-32k-merged.merge-first`, made from SEED by gpubench/entries/
merge.py): its files past the 32 KiB pack cap go through the chained
encode (`estep_device._encode_chained`) over the first pass's table
(bits 16, L = 20, the slab route) and over the vocabulary's own at bits
16 (L = 16, the slab route). For each, with CUDA events:

  - `lattice.chained_walk` on the encode's own inputs (every window's
    backpointers and rows; two launches and a cumsum), unqueued (as
    chip_smoke.py times kernels: a call's host work included where it
    outlasts its launches) and queued (device time: the calls behind a
    sleep kernel); its plain twin `chained_walk_plain` on the card; the
    kernel's outputs equal to the twin's;
  - the whole chained encode (the windows' scans, the walk, the
    readback), synchronised, and the host walk it replaced (the windows'
    backpointers read back and walked token by token in Python:
    tests/test_torch_chained_walk.py `_host_backtrack`) on the same
    windows, its ids equal to the kernel's;
  - the walk's bound: each input byte read once (a position's
    backpointer and byte, two exact-table rows of 16 B a token) and each
    id written once (4 B), over 3.35 TB/s.

Prints one JSON object as its last line, and writes it to out.json when a
path is given.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from chip_smoke import cuda_ms  # noqa: E402
from gpubench import harness  # noqa: E402
from gpubench.entries import merge as gm  # noqa: E402
from test_torch_chained_walk import _host_backtrack  # noqa: E402
from tokengeex_tpu_torch import Model  # noqa: E402
from tokengeex_tpu_torch.ops import lattice as lat  # noqa: E402
from tokengeex_tpu_torch.ops.match_table import TokenTable  # noqa: E402
from tokengeex_tpu_torch.train import estep_device as ed  # noqa: E402
from tokengeex_tpu_torch.train.merge import merge_table_hints  # noqa: E402

CELL = "exact-32k-merged.merge-first"
BW = 3.35e12


def probe(model, samples, hints, dev) -> dict:
    dt = lat.DeviceTables.from_table(
        TokenTable.build(model.vocab, min_bits=hints[0], min_len=hints[1]),
        dev)
    backend = ed._eff_backend(dt, None, torch.float32)
    W = ed.chained_width()
    long = [(i, s) for i, s in enumerate(samples) if len(s) > W]
    kw = dict(backend=backend, dropout=0.0, seed=0x5151, probe=None,
              device=dev)
    seen, windows = {}, []
    walk, scan = lat.chained_walk, lat.viterbi

    @functools.wraps(walk)
    def spy_walk(*a, **k):
        seen["args"], seen["kw"] = a, k
        return walk(*a, **k)

    def spy_scan(*a, **k):
        windows.append(scan(*a, **k))
        return windows[-1]

    lat.chained_walk, lat.viterbi = spy_walk, spy_scan
    try:
        got = ed._encode_chained(dt, long, W, **kw)
    finally:
        lat.chained_walk, lat.viterbi = walk, scan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _host_backtrack([s for _, s in long], model.token_to_ids, W,
                           windows)
    host_s = time.perf_counter() - t0
    ids = got.lists()
    assert ids == want, "the chained walk's ids differ from the host walk's"

    a, k = seen["args"], seen["kw"]
    out = walk(*a, **k)
    twin = lat.chained_walk_plain(*a, **k)
    for x, y in zip(out, twin):
        assert torch.equal(x, y), "the kernel differs from its twin"
    before = lat.chained_walk.launches
    ms = cuda_ms(lambda: walk(*a, **k), 20, 2)
    queued = cuda_ms(lambda: walk(*a, **k), 20, 2, queued=True)
    launches = (lat.chained_walk.launches - before) // 44
    plain = cuda_ms(lambda: lat.chained_walk_plain(*a, **k), 2, 1)
    encode = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ed._encode_chained(dt, long, W, **kw)
        torch.cuda.synchronize()
        encode.append(time.perf_counter() - t0)
    tokens = got.total
    positions = sum(len(s) for _, s in long)
    nbytes = 2 * positions + 36 * tokens
    bound_ms = nbytes / BW * 1e3
    return {"L": dt.max_len, "bits": dt.bits, "backend": backend,
            "samples": len(long), "windows": int(sum(-(-len(s) // W)
                                                     for _, s in long)),
            "rows": -(-len(long) // ed.ROW_MULT) * ed.ROW_MULT,
            "K": int(a[2].max()), "windows_walked": int(a[0].shape[0]),
            "positions": positions, "tokens": tokens,
            "walk_ms_unqueued": ms, "walk_ms_queued": queued,
            "walk_launches_a_call": launches, "plain_ms": plain,
            "bound_bytes": nbytes, "bound_ms": bound_ms,
            "x_bound": ms / bound_ms, "x_bound_queued": queued / bound_ms,
            "host_walk_s": host_s, "encode_s": encode}


def main() -> int:
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 3900024001
    dev = torch.device("cuda", torch.cuda.current_device())
    files = harness.cell_files(CELL)
    config, traffic = files["config"], files["traffic"]
    t0 = time.perf_counter()
    data = gm.build(config, traffic, seed)
    model = Model(gm.scored(data["vocab"]))
    res = {"device": torch.cuda.get_device_name(0),
           "power_limit": subprocess.run(
               ["nvidia-smi", "--query-gpu=power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "seed": seed, "inputs_s": time.perf_counter() - t0}
    m = config["merge"]
    res["L20"] = probe(model, data["files"], merge_table_hints(
        model.vocab_size(), config["num_merges"], m["max_token_length"]),
        dev)
    res["L16"] = probe(model, data["files"], (16, 16), dev)
    line = json.dumps(res)
    if len(sys.argv) > 2:
        Path(sys.argv[2]).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
