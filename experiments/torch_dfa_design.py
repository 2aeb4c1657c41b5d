#!/usr/bin/env python3
"""Design probe for tokengeex_tpu_torch's candidate mask, on the card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_dfa_design.py [out.json] [NAME=PATH.cu ...]

`dfa_mask` (csrc/dfa_mask.cu) walks the allow DFA's byte-class table
from every start of a feed group, in blocks of 128 threads, several to an
SM. Its first design, kept here as `torch_dfa_first.cu`, ran one block of
1,024 threads an SM over the full (S, 256) table. This probe builds that
source beside the package's and times, with CUDA events, in turns in one
process on the same inputs (the feed's first group of chip_smoke.py's
corpus: W8 = 8192, 1,024 rows, L = 16, the 245-state allow DFA of all
named patterns, p = 0.01 and 1):

  - the first design on both table routes;
  - the first design with no DFA (table = 0), and with its mask stores
    removed, with and without the DFA, to split its time;
  - the package's kernel on both routes and with no DFA;
  - patched copies of the package's source (VARIANTS: cuts after a phase,
    for a breakdown; SHAPES: other block shapes, a warp owning 128 or 512
    of a tile's positions) and other versions with its C interface
    (NAME=PATH.cu arguments), on the shared route.

Each is timed both ways: unqueued, as chip_smoke.py times every kernel
(a call's host work included where it outlasts its launch), and queued
(device time alone: the calls parked behind a sleep kernel). Every
design that stores in full is held equal to the package's twin
(`packed_candidate_mask_plain`) bit for bit. Prints the card's name and
power limit, then one JSON object as its last line, written to out.json
when a path is given. chip_smoke.py prints the first design's times
recorded here (`DFA_FIRST_DESIGN_MS`) beside the kernel's own.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tokengeex_tpu_torch.ops import _build  # noqa: E402

FIRST_SOURCE = Path(__file__).resolve().with_name("torch_dfa_first.cu")
FIRST_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6
                  + (ctypes.c_uint, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_void_p))
ROUNDS = 2  # first, package, package, first: each round both orders
ITERS = 50
SOURCE = ROOT / "tokengeex_tpu_torch" / "csrc" / "dfa_mask.cu"
# Patches of the package's source (old -> new), each built and timed on
# the shared route; none of them writes the whole mask.
VARIANTS = {
    "cut_steps": [("for (int l = 2; n > 0; ++l) {",
                   "for (int l = 2; n > 0 && l < 2; ++l) {")],
    "cut_stores": [("o[static_cast<size_t>(l) * words + k] = s_out[l * 32 + k];",
                    "if (s_out[l * 32 + k] == 0x9E3779B9u)\n"
                    "        o[static_cast<size_t>(l) * words + k] = 0u;")],
}
# Other block shapes of the package's source (128 threads, 8 starts a
# thread: a warp owns 256 of a tile's 1,024 positions), held equal to the
# twin: a warp owning 128 or 512.
SHAPES = {
    f"threads{t}_starts{k}": [
        ("constexpr int kThreads = 128;", f"constexpr int kThreads = {t};"),
        ("constexpr int kStarts = 8; ", f"constexpr int kStarts = {k}; ")]
    for t, k in ((256, 4), (64, 16))
}


def load_first():
    """Build the first design with the package's flags; its entry."""
    out = _build.build_dir() / "dfa_design"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "first.so"
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(FIRST_SOURCE)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {FIRST_SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).tgx_dfa_mask_first
    fn.argtypes = list(FIRST_ARGTYPES)
    fn.restype = ctypes.c_int
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line]
    return fn, regs


def load_sources(sources: dict) -> dict:
    """Build each source (name -> path) with the package's flags, all
    nvcc started together; name -> its `tgx_dfa_mask` entry."""
    out = _build.build_dir() / "dfa_design"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        lib = out / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).tgx_dfa_mask
        fn.argtypes = list(_build.KERNELS["dfa_mask"][2])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def patched_sources() -> dict:
    """VARIANTS written beside the build: name -> path."""
    out = _build.build_dir() / "dfa_design"
    out.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    paths = {}
    for name, patches in {**VARIANTS, **SHAPES}.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch target missing")
            text = text.replace(old, new)
        paths[name] = out / f"{name}.cu"
        paths[name].write_text(text)
    return paths


def main() -> None:
    import chip_smoke as cs
    from tokengeex_tpu_torch.core.redfa import compile_dfa
    from tokengeex_tpu_torch.ops import dfa_device as dd

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures kernels on a GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    logs = _build.build(["dfa_mask"])
    first, first_regs = load_first()
    extra = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    checked = set(extra) | set(SHAPES)  # these write the whole mask
    extra.update(patched_sources())
    extra_fns = load_sources(extra)
    regs = {"first": first_regs,
            "package": [line.strip() for line in
                        logs["dfa_mask.cu"].splitlines()
                        if "registers" in line]}
    cs.log(f"registers: {regs}")

    samples = cs.build_corpus(cs.CORPUS_BYTES)
    W8, B = dd.group_shape(samples, dd.GROUP_BYTES)
    arr, lens = dd.pack_group(samples[:B], B, W8)
    rows = torch.from_numpy(arr).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    dfa = compile_dfa(cs.allow_all_patterns())
    ddfa = dd._device_dfa_for(dfa, dev)
    L = cs.L_MAX
    S = ddfa.num_states
    next_flat = torch.as_tensor(np.ascontiguousarray(
        dfa.next, dtype=np.int32).reshape(-1)).to(dev)
    accept = ddfa.accept.to(torch.uint8)
    out = torch.empty((B, L, W8 // 8), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_first(p, table, store):
        rc = first(rows.data_ptr(), lens.data_ptr(), next_flat.data_ptr(),
                   accept.data_ptr(), out.data_ptr(), B, W8, L, S,
                   ddfa.start, table, dd.seed_key(cs.SEED), 0,
                   dd.coin_threshold(p), store, stream)
        if rc:
            raise RuntimeError(f"first design: CUDA error {rc}")
        return out

    def run_package(p, route):
        return dd.packed_candidate_mask(None if route is None else ddfa,
                                        rows, lens, L, p, cs.SEED, 0,
                                        table=route)

    package_load = dd._build.load

    def run_extra(p, name):
        """The package's wrapper launching another build's entry."""
        dd._build.load = lambda _name: extra_fns[name]
        try:
            return run_package(p, "shared")
        finally:
            dd._build.load = package_load

    res = {"device": smi, "W8": W8, "B": B, "L": L, "states": S,
           "classes": ddfa.num_classes, "entry_bytes": ddfa.entry_bytes,
           "smem_first_shared": S * 512 + -(-S // 16) * 16 + 1088,
           "smem_package_shared": dd.shared_table_bytes(ddfa),
           "registers": regs}
    firsts = {"first_shared": (1, 1), "first_global": (2, 1),
              "first_no_dfa": (0, 1), "first_shared_no_stores": (1, 0),
              "first_no_dfa_no_stores": (0, 0)}
    packages = {"shared": "shared", "global": "global", "no_dfa": None}
    for p in (0.01, 1.0):
        want = dd.packed_candidate_mask_plain(ddfa, rows, lens, L, p,
                                              cs.SEED, 0)
        free = dd.packed_candidate_mask_plain(None, rows, lens, L, p,
                                              cs.SEED, 0)
        for name, (table, store) in firsts.items():
            if store:
                run_first(p, table, 1)
                torch.cuda.synchronize()
                cs.check(torch.equal(out, want if table else free),
                         f"first design {name} at p = {p} differs")
        for name, route in packages.items():
            got = run_package(p, route)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want if route else free),
                     f"package {name} at p = {p} differs")
        for name in sorted(checked):
            got = run_extra(p, name)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"{name} at p = {p} differs")
        calls = {name: (lambda t=table, st=store: run_first(p, t, st))
                 for name, (table, store) in firsts.items()}
        calls.update({name: (lambda r=route: run_package(p, r))
                      for name, route in packages.items()})
        calls.update({name: (lambda n=name: run_extra(p, n))
                      for name in extra_fns})
        times = {k: {"unqueued": [], "queued": []} for k in calls}
        for _ in range(ROUNDS):
            for order in ("first", "package", "package", "first"):
                for name, fn in calls.items():
                    if (name in firsts) != (order == "first"):
                        continue
                    times[name]["unqueued"].append(cs.cuda_ms(fn, ITERS))
                    times[name]["queued"].append(
                        cs.cuda_ms(fn, ITERS, queued=True))
        row = {k: {mode: {"mean_ms": sum(v) / len(v), "min_ms": min(v),
                          "max_ms": max(v)} for mode, v in t.items()}
               for k, t in times.items()}
        row["candidates"] = sum(int(((want >> i) & 1).sum())
                                for i in range(8))
        res[f"p_{p}"] = row
        for k, v in row.items():
            if k != "candidates":
                cs.log(f"[dfa design] p={p} {k}: device "
                       f"{v['queued']['mean_ms']:.4f} ms (min "
                       f"{v['queued']['min_ms']:.4f}), unqueued "
                       f"{v['unqueued']['mean_ms']:.4f} ms")
    line = json.dumps(res)
    paths = [a for a in sys.argv[1:] if "=" not in a]
    if paths:
        Path(paths[0]).write_text(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
