#!/usr/bin/env python3
"""Design probe for tokengeex_tpu_torch's two Viterbi scans, on the card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_viterbi_design.py [out.json]

At encode's shape (chip_smoke.py's corpus, its first 8192-wide group of
512 rows, L = 16) it times `viterbi_scan` over the 32,768-token
vocabulary's score cache and the fused Viterbi kind over the 4,096-token
vocabulary (bits 13) with CUDA events, for each layout of a chain's 16
lengths (csrc/scan_lanes.cuh, the kernels' sources rebuilt with
-DTGX_LANES16=G: G lanes per chain, 32 / G chains per warp; 16 is the
package's), each held equal to the package's output bit for bit:

  - the group loaded, its rows cut into chains (S = 1024), at dropout 0
    and 0.1;
  - the group uncut (one 8,192-step chain per row);
  - one chain alone (B = 1): the latency of a step;
  - one chain alone in the group's layout (all 512 rows' arrays, every
    chain but row 0's empty): the same step with the loaded group's
    strides and footprint.

The registers and spills of every build (-Xptxas -v) are printed beside
them. Prints one JSON object as its last line, and writes it to out.json
when a path is given.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tokengeex_tpu_torch.ops import _build  # noqa: E402
from tokengeex_tpu_torch.ops import lattice as lat  # noqa: E402
from tokengeex_tpu_torch.ops import lattice_cuda as lc  # noqa: E402
from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf  # noqa: E402
from tokengeex_tpu_torch.ops.match_table import TokenTable  # noqa: E402
from tokengeex_tpu_torch.train import estep_device as ed  # noqa: E402
from tokengeex_tpu_torch.utils.packing import pack_samples  # noqa: E402

LANES = {"viterbi_scan": (1, 2, 4, 8, 16), "fused_forward": (2, 4, 8, 16)}
SOURCES = {"viterbi_scan": "viterbi_chunk.cu",
           "fused_forward": "fused_forward.cu"}


def compile_all(jobs):
    """Run nvcc for every (kernel, lanes) job at once; the entry points
    and each build's register lines."""
    out = _build.build_dir() / "viterbi_design"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, g in jobs:
        lib = out / f"{name}_lanes{g}.so"
        procs[(name, g)] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, f"-DTGX_LANES16={g}", "-o",
             str(lib), str(_build.CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, regs = {}, {}
    for (name, g), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc failed for {name}, {g} lanes:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), _build.KERNELS[name][1])
        fn.argtypes = list(_build.KERNELS[name][2])
        fn.restype = ctypes.c_int
        fns[(name, g)] = fn
        regs[f"{name}_lanes{g}"] = [
            line.strip() for line in log.splitlines()
            if "registers" in line or ("spill" in line and " 0 bytes spill"
                                       not in line)]
    return fns, regs


def alone_bounds(B: int, W: int, dev) -> torch.Tensor:
    """(2, B) chain bounds with one chain, row 0's [0, W); every other
    row's chain is empty. The card does not check bounds against the
    width (the kernels clamp), so the wrappers' CPU check is not met."""
    seg = torch.zeros((2, B), dtype=torch.int32, device=dev)
    seg[1, 0] = W
    return seg


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures the scans on a GPU")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    fns, regs = compile_all([(n, g) for n, gs in LANES.items() for g in gs])
    for k, v in regs.items():
        cs.log(f"{k}: {v}")

    samples = cs.build_corpus(cs.CORPUS_BYTES)
    width = ed._pick_width(samples, None)
    packed = pack_samples(samples, width=width)
    sub = next(g for _, g in ed._padded_groups(packed, width, ed.ROW_MULT))
    batch = lat.prepare_batch(sub, cs.L_MAX, dev)
    W, B, L = batch.width, batch.p1.shape[0], cs.L_MAX
    seg = lat.chain_bounds(batch)[0]
    alone = alone_bounds(B, W, dev)
    du = cs.drop_words(batch, 0.1, dev)
    thr = lc.dropout_threshold_half(0.1)
    res = {"device": smi, "shape": {"W": W, "L": L, "B": B},
           "longest_chain": int((seg[1:] - seg[:-1]).max()),
           "registers": regs}

    # viterbi_scan over the 32k vocabulary's cache.
    dt = lat.DeviceTables.from_table(
        TokenTable.build(cs.build_vocab(samples, 32768)), dev)
    cache = lat.match_cache(dt, batch, C=512, slots=False)[0]
    starts = batch.is_start[:, 1:].t().float().contiguous()
    hist = lat._hist0(batch, L, None).clamp(min=lc.NEG).t().contiguous()
    du_t = du.t().contiguous()

    def scan_args(b, chains, drop):
        c, st, h = ((cache, starts, hist) if b == B else
                    tuple(t[..., :b].contiguous()
                          for t in (cache, starts, hist)))
        return c, st, h, chains, du_t if drop else None, drop

    def run_scan(g, args, out):
        c, st, h, chains, d, drop = args
        b = c.shape[2]
        K = 1 if chains is None else chains.shape[0] - 1
        ptrs = [t if t is None else t.data_ptr()
                for t in (c, st, h, chains, d, *out)]
        rc = fns[("viterbi_scan", g)](*ptrs, None, W, L, b, K, 1, 0,
                                      batch.pad, thr if drop else 0,
                                      int(drop), stream)
        cs.check(rc == 0, f"viterbi_scan, {g} lanes: CUDA error {rc}")

    # The fused kind over the 4k vocabulary.
    dtb = lat.DeviceTables.from_table(
        TokenTable.build(cs.build_vocab(samples, 4096)), dev)
    cs.check(dtb.bits <= 13, f"4k table of {dtb.bits} bits")
    fin = {False: lat.fused_inputs(dtb, batch),
           True: lat.fused_inputs(dtb, batch, du, 0.1)}

    def fused_args(b, chains, drop):
        args = fin[drop]
        return (args if b == B else cs.one_chain(args)), chains, drop

    def run_fused(g, args, out):
        streams, chains, drop = args
        b = streams[2].shape[1]
        K = 1 if chains is None else chains.shape[0] - 1
        ptrs = [t if t is None else t.data_ptr()
                for t in (*streams, chains, *out)]
        rc = fns[("fused_forward", g)](*ptrs, W, L, b, K, batch.pad,
                                       dtb.bits, int(drop),
                                       thr if drop else 0, stream)
        cs.check(rc == 0, f"fused viterbi, {g} lanes: CUDA error {rc}")

    def outputs(b, fused):
        out = (torch.empty((W, b), dtype=torch.float32, device=dev),
               torch.empty((W, b), dtype=torch.int32, device=dev))
        if fused:
            out += (torch.empty((b,), dtype=torch.int32, device=dev),)
        return out

    kernels = {
        "viterbi_scan": (scan_args, run_scan, False, lambda a: lc.viterbi_scan(
            *a[:5], pad=batch.pad, dropout=0.1 if a[5] else 0.0)),
        "fused_forward": (fused_args, run_fused, True,
                          lambda a: lcf.fused_forward_chunk(
                              "viterbi", *a[0], L=L, bits=dtb.bits,
                              pad=batch.pad, dropout=0.1 if a[2] else 0.0,
                              seg=a[1]))}
    cases = {"chains": (B, seg, False), "chains_dropout": (B, seg, True),
             "uncut": (B, None, False), "one_chain": (1, None, False),
             "alone_in_layout": (B, alone, False)}
    for name, (make, run, fused, package) in kernels.items():
        rows = {}
        for case, (b, chains, drop) in cases.items():
            args = make(b, chains, drop)
            want = package(args)
            row = {}
            for g in LANES[name]:
                out = outputs(b, fused)
                run(g, args, out)
                torch.cuda.synchronize()
                if case != "alone_in_layout":  # other rows' outputs unset
                    cs.check(torch.equal(out[0], want[0])
                             and torch.equal(out[1], want[1]),
                             f"{name} ({case}): {g} lanes differ from the "
                             "package's")
                ms = cs.cuda_ms(lambda: run(g, args, out), iters=5)
                row[f"lanes_{g}"] = {"ms": ms}
                if b == 1 or case == "alone_in_layout":
                    row[f"lanes_{g}"]["us_per_step"] = ms * 1e3 / W
            rows[case] = row
            cs.log(f"{name} {case}: {row}")
        res[name] = rows
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
