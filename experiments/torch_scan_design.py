#!/usr/bin/env python3
"""Design probe for tokengeex_tpu_torch's whole-width E-step scans, on the
card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_scan_design.py [out.json]

At the session's shape (chip_smoke.py's corpus, its first 8192-wide group
of 512 rows, the 32,768-token vocabulary's cache, L = 16) it times
`forward_scan` and `backward_betas_scan` with CUDA events:

  - for each layout of a chain's 16 lengths (csrc/scan_lanes.cuh, the
    kernels' sources rebuilt with -DTGX_LANES16=G): on 1 lane (one thread
    per chain, the history in registers), 4, 8 or 16 lanes (shuffle max,
    ascending sum through shared memory; 16 is the package's), each held
    equal to the package's output bit for bit;
  - for the rows cut every S = 512, 1024, 2048 positions and uncut
    (S = W), beside each split's longest chain and the longest span a
    warp walks (its rows' chains in lockstep);
  - one chain alone (B = 1, uncut) per direction and layout: the latency
    of a step;
  - beside them, the forward with 16 lanes and a butterfly sum
    (experiments/torch_scan_lanes.cu, each chain on its own range), held
    against `forward_scan` within rtol 1e-5: what the ascending order
    costs;
  - the fused log-sum-exp scans (`fused_forward_chunk("logsumexp")`,
    `fused_backward_chunk`) on the same group with the 4,096-token
    vocabulary (bits 13) and the group's chains: the package's kernels,
    tables read from global memory, against the same bodies with both
    tables staged into shared memory per 16-warp block
    (experiments/torch_fused_smem.cu), timed in turns (global, shared,
    shared, global) and held equal bit for bit; both uncut (one chain per
    row), and one chain alone (B = 1) for the latency of a step.

Prints one JSON object as its last line, and writes it to out.json when
a path is given.
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
from tokengeex_tpu_torch.train import device_session as ds  # noqa: E402
from tokengeex_tpu_torch.train import estep_device as ed  # noqa: E402
from tokengeex_tpu_torch.utils.packing import pack_samples  # noqa: E402

LANES = (1, 4, 8, 16)  # lanes per chain timed at L = 16
SEGMENTS = (512, 1024, 2048)


def compile_all(jobs):
    """Run nvcc for every (source, library, extra flags) job at once; the
    loaded libraries by library name."""
    out = _build.build_dir() / "scan_design"
    out.mkdir(parents=True, exist_ok=True)
    procs = [(lib, subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out / lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for src, lib, flags in jobs]
    libs = {}
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc failed for {lib}:\n{log}")
        libs[lib] = ctypes.CDLL(str(out / lib))
    return libs


def entry(lib, symbol: str, name: str):
    """A C entry point with the package's signature for kernel `name`."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(_build.KERNELS[name][2])
    fn.restype = ctypes.c_int
    return fn


def fused_placements(libs, samples, batch, dev) -> dict:
    """The fused LSE scans with the tables in global memory (the
    package's libraries) and in shared memory (torch_fused_smem.cu), per
    direction: ms per group in turns, the uncut rows and one
    chain alone (B = 1)."""
    dt = lat.DeviceTables.from_table(
        TokenTable.build(cs.build_vocab(samples, 4096)), dev)
    cs.check(dt.bits <= 13, f"4k table of {dt.bits} bits")
    W, B, L = batch.width, batch.p1.shape[0], dt.max_len
    chains = lat.chain_bounds(batch)
    fns = {"forward": {"global": _build.load("fused_forward_lse"),
                       "shared": entry(libs["fused_smem.so"],
                                       "tgx_fused_forward_lse_smem",
                                       "fused_forward_lse")},
           "backward": {"global": _build.load("fused_backward"),
                        "shared": entry(libs["fused_smem.so"],
                                        "tgx_fused_backward_smem",
                                        "fused_backward")}}
    inputs = {"forward": lat.fused_inputs(dt, batch),
              "backward": lat.fused_bwd_inputs(dt, batch)}
    res = {"bits": dt.bits, "shape": {"W": W, "L": L, "B": B}}
    for name, seg in zip(("forward", "backward"), chains):
        args = inputs[name]
        row = {}

        def run(place, args, seg, out):
            """One launch as the package's wrapper makes it (no dropout):
            the streams, the chain bounds, the outputs, the widths."""
            b = args[2].shape[1]
            K = 1 if seg is None else seg.shape[0] - 1
            ptrs = [None if t is None else t.data_ptr()
                    for t in (*args, seg, *out)]
            rc = fns[name][place](*ptrs, W, L, b, K, batch.pad, dt.bits, 0,
                                  0, torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"fused {name}, {place} tables: CUDA error {rc}")

        def outputs(b):
            a = torch.empty((W, b), dtype=torch.float32, device=dev)
            if name == "backward":
                return (a,)
            return (a, torch.empty((b,), dtype=torch.int32, device=dev))

        got = {p: outputs(B) for p in ("global", "shared")}
        for place, out in got.items():
            run(place, args, seg, out)
        torch.cuda.synchronize()
        cs.check(all(torch.equal(x, y) for x, y in zip(got["global"],
                                                       got["shared"])),
                 f"fused {name}: shared-memory tables differ from global")
        times = {"global": [], "shared": []}
        for place in ("global", "shared", "shared", "global"):
            out = got[place]
            times[place].append(cs.cuda_ms(
                lambda: run(place, args, seg, out), iters=10))
        for place, ts in times.items():
            row[f"ms_{place}"] = sum(ts) / len(ts)
            row[f"ms_{place}_runs"] = ts
            out = got[place]
            row[f"ms_{place}_uncut"] = cs.cuda_ms(
                lambda: run(place, args, None, out), iters=2)
            one, one_out = cs.one_chain(args), outputs(1)
            ms = cs.cuda_ms(lambda: run(place, one, None, one_out), iters=3)
            row[f"one_chain_us_per_step_{place}"] = ms * 1e3 / W
        res[name] = row
        cs.log(f"fused {name}: {row}")
    return res


def warp_span(bounds: torch.Tensor) -> int:
    """Longest range a warp walks: per segment and 32 rows, the last
    chain end minus the first chain start."""
    lo, hi = bounds[:-1], bounds[1:]
    K, B = lo.shape
    pad = -B % 32
    lo = torch.nn.functional.pad(lo, (0, pad), value=2**30).view(K, -1, 32)
    hi = torch.nn.functional.pad(hi, (0, pad), value=0).view(K, -1, 32)
    return int((hi.max(dim=2).values - lo.min(dim=2).values).max())


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures the scans on a GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    _build.build(["forward_scan", "backward_betas_scan", "fused_forward_lse",
                  "fused_backward"])
    jobs = [(ROOT / "experiments" / "torch_scan_lanes.cu", "butterfly.so", ()),
            (ROOT / "experiments" / "torch_fused_smem.cu", "fused_smem.so",
             ())]
    for g in LANES:
        for src in ("forward_chunk.cu", "backward_chunk.cu"):
            jobs.append((_build.CSRC / src, f"{src[:-3]}_lanes{g}.so",
                         (f"-DTGX_LANES16={g}",)))
    libs = compile_all(jobs)
    butterfly = libs["butterfly.so"].tgx_lane_forward
    butterfly.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    butterfly.restype = ctypes.c_int
    layouts = {g: {"forward": entry(libs[f"forward_chunk_lanes{g}.so"],
                                    "tgx_forward_scan", "forward_scan"),
                   "backward": entry(libs[f"backward_chunk_lanes{g}.so"],
                                     "tgx_backward_betas_scan",
                                     "backward_betas_scan")}
               for g in LANES}

    samples = cs.build_corpus(cs.CORPUS_BYTES)
    dt = lat.DeviceTables.from_table(
        TokenTable.build(cs.build_vocab(samples, 32768)), dev)
    packed = pack_samples(samples, width=ds.PACK_WIDTH,
                          max_snippet=ed.DEVICE_EM_SNIPPET)
    sub = next(g for _, g in ed._padded_groups(packed, ds.PACK_WIDTH,
                                               ed.ROW_MULT))
    batch = lat.prepare_batch(sub, cs.L_MAX, dev)
    cache = lat.match_cache(dt, batch, C=ed.CHUNK)[0]
    W, L, B = cache.shape
    scans = {
        "forward": (lc.forward_scan, batch.is_start[:, 1:].t().float()
                    .contiguous(),
                    lat._hist0(batch, L, None).clamp(min=lc.NEG).t()
                    .contiguous()),
        "backward": (lc.backward_betas_scan, batch.is_end[:, :W].t().float()
                     .contiguous(), lcf.betas_hist0(batch.is_end[:, W], L))}
    res = {"device": smi, "shape": {"W": W, "L": L, "B": B},
           "default_segment": lat.SCAN_SEGMENT, "segments": {}}

    def layout_run(g, name, src, flags, hist, seg, out):
        """One launch of layout g's scan over the cache `src`, as the
        package's wrapper makes it (whole width, no dropout)."""
        W_, L_, B_ = src.shape
        K = 1 if seg is None else seg.shape[0] - 1
        args = [src.data_ptr(), flags.data_ptr(), hist.data_ptr(),
                None if seg is None else seg.data_ptr(), None,
                out.data_ptr(), None, W_, L_, B_, K]
        args += [1, 0, 0, 0] if name == "forward" else [0, 0, 0]
        rc = layouts[g][name](*args, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"{name} scan, {g} lanes: CUDA error {rc}")

    for S in SEGMENTS + (W,):
        bounds = dict(zip(("forward", "backward"), lat.chain_bounds(batch, S)))
        row = {"chains": (bounds["forward"].shape[0] - 1) * B}
        for name, (fn, flags, hist) in scans.items():
            seg = bounds[name]
            row[f"{name}_longest_chain"] = int((seg[1:] - seg[:-1]).max())
            row[f"{name}_warp_span"] = warp_span(seg)
            want = fn(cache, flags, hist, seg)
            got = torch.empty_like(want)
            for g in LANES:
                layout_run(g, name, cache, flags, hist, seg, got)
                torch.cuda.synchronize()
                cs.check(torch.equal(got, want),
                         f"{name} scan: {g} lanes differ from the package's")
                row[f"{name}_ms_lanes_{g}"] = cs.cuda_ms(
                    lambda: layout_run(g, name, cache, flags, hist, seg, got),
                    iters=10)
        fn, flags, hist = scans["forward"]
        seg = bounds["forward"]
        want = fn(cache, flags, hist, seg)
        a = torch.empty((W, B), dtype=torch.float32, device=dev)

        def run_butterfly():
            rc = butterfly(cache.data_ptr(), flags.data_ptr(),
                           hist.data_ptr(), seg.data_ptr(), a.data_ptr(), L,
                           B, seg.shape[0] - 1,
                           torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"butterfly forward: CUDA error {rc}")

        run_butterfly()
        torch.cuda.synchronize()
        row["forward_butterfly_max_abs_err"] = cs.assert_rel(
            a, want, f"butterfly forward (S={S})", 1e-5)
        row["forward_ms_butterfly_16"] = cs.cuda_ms(run_butterfly, iters=10)
        res["segments"][S] = row
        cs.log(f"S={S}: {row}")

    one = {}
    one_cache = cache[:, :, :1].contiguous()  # one chain: B = 1, uncut
    out = torch.empty((W, 1), dtype=torch.float32, device=dev)
    for name, (fn, flags, hist) in scans.items():
        flags, hist = flags[:, :1].contiguous(), hist[:, :1].contiguous()
        for g in LANES:
            ms = cs.cuda_ms(lambda: layout_run(g, name, one_cache, flags,
                                               hist, None, out), iters=3)
            one[f"{name}_lanes_{g}"] = {"ms": ms, "us_per_step": ms * 1e3 / W}
    res["one_chain"] = one
    cs.log(f"one chain (B=1, W={W}): {one}")
    res["fused_tables"] = fused_placements(libs, samples, batch, dev)
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
