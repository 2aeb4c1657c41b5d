#!/usr/bin/env python3
"""Design probe for tokengeex_tpu_torch's backpointer walk, on the card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_walk_design.py [out.json] [NAME=PATH.cu ...]

`viterbi_walk` (csrc/viterbi_walk.cu) walks a row's segments in
parallel: exit tables per (segment, entry), one composition per span, and
one emitting walk per crossed segment. Its first design, kept here as
`torch_walk_first.cu`, walked each whole span in one thread and left the
ids in a (B, W) grid that the caller compacted. This probe builds that
source beside the package's and times both, with CUDA events, in one
process on the same inputs (host clocks and cards differ between calls):

  - encode's first row group of chip_smoke.py's corpus on both routes
    (the 32k vocabulary's `viterbi_scan` backpointers, the 4k
    vocabulary's fused ones; W = 8192, 512 rows);
  - count mode and ids mode (the package: one launch, or two launches and
    a cumsum writing the flat ids; the first design's kernel alone, and
    with the compaction its caller ran), each both ways: as device time
    alone (the calls queued behind a sleep kernel, so no host work
    enters them) and unqueued, as chip_smoke.py times every kernel
    (a call's host work included where it outlasts its launches);
  - the package's kernel at segment lengths 128, 256 (WALK_SEGMENT) and
    512;
  - the chain floor: the row of the longest span, alone.

NAME=PATH.cu adds another version of csrc/viterbi_walk.cu with the same
C interface, timed beside the package's. Times not named `unqueued`
are device times (queued); a profiler split gives each launch's share.
VARIANTS patches the package's source (tunings, and cuts after each
phase for a breakdown). Every checked variant's output is held equal to
the package's (counts; ntok and the flat ids). Prints one JSON object as
its last line, and writes it to out.json when a path is given.
chip_smoke.py prints the first design's device times recorded here
(`WALK_FIRST_DESIGN_MS`) beside the walk's own.
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

from tokengeex_tpu_torch.ops import _build  # noqa: E402
from tokengeex_tpu_torch.ops.lattice import WALK_SEGMENT  # noqa: E402

FIRST_SOURCE = Path(__file__).resolve().with_name("torch_walk_first.cu")
FIRST_ARGTYPES = ((ctypes.c_void_p,) * 15 + (ctypes.c_longlong,) * 2
                + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))
SEGMENTS = (128, 256, 512)
STAGED = "  // (a) The speculative walks"
TABLED = "  const unsigned shift = 32u - (unsigned)a.bits;"
DENSE = "    // The tile's recorded cells into a dense list"
IDS = "    // The ids: TGX_WALK_ILP tokens a thread at once"
T2_LOAD = "        r2[u] = __ldg(a.t2 + i2);\n"
T2_USE = "          } else if ((uint32_t)r2[u].x == fp1[u] &&"
T2_MISS = ("          } else if ((r2[u] = __ldg(a.t2 + (((fp2[u] ^ (l[u] * "
           "TGX_IDX_A2)) * TGX_IDX_M2) >> shift))).x == (int)fp1[u] &&")
ILP = "#define TGX_WALK_ILP 4 "
HASH_BITS = "#define TGX_WALK_HASH_BITS 10 "
NO_ADD = ("__device__ __forceinline__ void tgx_no_add(int* p, int v) {\n"
          "  if (v == -12345) *p = 0;\n}\n")
# Patches of the package's source (old -> new), each built and timed
# beside it. `checked`: its outputs must equal the package's.
VARIANTS = {
    "ilp2": (True, [(ILP, ILP.replace(" 4 ", " 2 "))]),
    "ilp8": (True, [(ILP, ILP.replace(" 4 ", " 8 "))]),
    "hash_bits_1": (True, [(HASH_BITS, HASH_BITS.replace(" 10 ", " 1 "))]),
    "t2_on_miss": (True, [(T2_LOAD, ""), (T2_USE, T2_MISS)]),
    "no_global_adds": (False, [
        ("atomicAdd(counts + id, c);", "tgx_no_add(counts + id, c);"),
        ("atomicAdd(a.counts + hkey[h], hcnt[h]);",
         "tgx_no_add(a.counts + hkey[h], hcnt[h]);"),
        ("// Count mode folds", NO_ADD + "// Count mode folds")]),
    "stage_only": (False, [(STAGED, "  if (W > 0) return;\n" + STAGED)]),
    "stage_tables": (False, [(TABLED, "  if (W > 0) return;\n" + TABLED)]),
    "to_emit": (False, [(DENSE, "    if (W > 0) return;\n" + DENSE)]),
    "to_dense": (False, [(IDS, "    if (W > 0) return;\n" + IDS)]),
}


def patched_sources() -> dict:
    """Write each variant of the package's source; name -> path."""
    out = _build.build_dir() / "walk_design"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "viterbi_walk.cu").read_text()
    paths = {}
    for name, (_, patches) in VARIANTS.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            src = src.replace(old, new)
        paths[name] = out / f"{name}.cu"
        paths[name].write_text(src)
    return paths


def start_first():
    """Start nvcc on the first design's source (returns what `load_first`
    takes), so a caller can build it beside the package's sources."""
    out = _build.build_dir() / "walk_design"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "first.so"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(FIRST_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def load_first(started):
    """The first design's C entry point, once its nvcc has finished."""
    lib, proc = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {FIRST_SOURCE.name}:\n{log}")
    fn = ctypes.CDLL(str(lib)).tgx_viterbi_walk
    fn.argtypes = list(FIRST_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def first_walk(fn, best_l, args, index, ok, kw, ids: bool):
    """The first design's kernel on the package's inputs: (V + 1,)
    counts, or the (B, W) id grid (a span's ids in its last ntok cells)
    and ntok."""
    B, W = best_l.shape
    dev = best_l.device
    p1, p2, rinv1, rinv2, t1, t2 = args
    counts = grid = ntok = None
    if ids:
        grid = torch.empty((B, W), dtype=torch.int32, device=dev)
        ntok = torch.zeros(index.n, dtype=torch.int32, device=dev)
    else:
        counts = torch.zeros(kw["vocab_size"] + 1, dtype=torch.int32,
                             device=dev)
    ptrs = [t.data_ptr() if t is not None else None
            for t in (best_l, p1, p2, rinv1, rinv2, t1, t2, index.row_ptr,
                      index.order, index.starts, index.ends, ok, counts,
                      grid, ntok)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, best_l.stride(0), best_l.stride(1),
                best_l.element_size(), B, W, p1.stride(0), kw["pad"],
                kw["bits"], kw["vocab_size"], stream)
    if rc:
        raise RuntimeError(f"the first design failed to launch: CUDA error "
                           f"{rc}")
    return (grid, ntok) if ids else counts


def first_flat(grid, index, ntok) -> torch.Tensor:
    """The spans' ids of the first design's grid as one flat buffer, span
    after span: the compaction its caller ran (a cumsum, a
    repeat_interleave and a gather)."""
    W = grid.shape[1]
    nt = ntok.long()
    total = int(nt.sum())
    off = torch.cumsum(nt, 0) - nt
    base = index.rows.long() * W + index.ends.long() - nt - off
    idx = torch.repeat_interleave(base, nt, output_size=total)
    idx += torch.arange(total, device=grid.device)
    return grid.reshape(-1)[idx]


def load_sources(sources):
    """Build other versions of csrc/viterbi_walk.cu with the package's C
    interface (name -> path), all nvcc started together; their entry
    points and -Xptxas -v register lines."""
    out = _build.build_dir() / "walk_design"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        lib = out / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, regs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).tgx_viterbi_walk
        fn.argtypes = list(_build.KERNELS["viterbi_walk"][2])
        fn.restype = ctypes.c_int
        fns[name] = fn
        regs[name] = [line.strip() for line in log.splitlines()
                      if "registers" in line]
    return fns, regs


def walk_with(fn, best_l, args, index, ok, kw, ids: bool,
              segment: int = WALK_SEGMENT, keep_tables: bool = True):
    """The package wrapper's launches (ops/lattice.py `viterbi_walk`,
    checks left out) through another build's entry point `fn`, at
    `segment` positions a segment; keep_tables=False lets the ids launch
    walk its exit tables again."""
    dev = best_l.device
    B, W = best_l.shape
    if best_l.stride(1) != 1:
        rows = torch.empty((B, W), dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _build.load("walk_rows")(
                best_l.data_ptr(), rows.data_ptr(), best_l.stride(0),
                best_l.stride(1), best_l.element_size(), B, W, stream)
        if rc:
            raise RuntimeError(f"walk_rows launch failed: CUDA error {rc}")
        best_l = rows
    common = [t.data_ptr() for t in (best_l, *args, index.row_ptr,
                                     index.order, index.starts, index.ends,
                                     ok)]
    shape = (best_l.stride(0), best_l.stride(1), best_l.element_size(), B,
             W, args[0].stride(0), kw["pad"], kw["bits"], kw["vocab_size"],
             kw["max_len"], segment)

    def call(counts, ntok, incl, flat, tabs, mode):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            ptrs = [t.data_ptr() if t is not None else None
                    for t in (counts, ntok, incl, flat, tabs)]
            rc = fn(*common, *ptrs, *shape, mode, stream)
        if rc:
            raise RuntimeError(f"walk launch failed: CUDA error {rc}")

    if not ids:
        counts = torch.zeros(kw["vocab_size"] + 1, dtype=torch.int32,
                             device=dev)
        call(counts, None, None, None, None, 0)
        return counts
    ntok = torch.zeros(index.n, dtype=torch.int32, device=dev)
    flat = torch.empty(index.cap, dtype=torch.int32, device=dev)
    tabs = (torch.empty(B * 4 * -(-W // segment) * kw["max_len"],
                        dtype=torch.uint8, device=dev) if keep_tables
            else None)
    call(None, ntok, None, None, tabs, 1)
    incl = torch.cumsum(ntok, 0, dtype=torch.int32)
    call(None, ntok, incl, flat, tabs, 2)
    return flat, ntok


def kernel_split(cs, fn) -> list:
    """Device time by kernel of ten calls of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return [(e.key[:70], e.count, round(e.self_device_time_total / 10, 2))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def time_group(cs, lat, fn, extra, tbl, batch, spans, dev,
               route: str) -> dict:
    dp, best_l = lat.viterbi(tbl, batch, backend=route)
    B, W = best_l.shape
    index = lat.walk_index(spans, B, W, dev)
    ok = torch.isfinite(index.dp_ends(dp))
    args, kw = lat._walk_tables(tbl, batch)
    res = {"route": route, "W": W, "B": B, "spans": index.n}
    for mode in ("count", "ids"):
        ids = mode == "ids"
        want = lat.viterbi_walk(best_l, *args, index, ok=ok, ids=ids, **kw)
        old = first_walk(fn, best_l, args, index, ok, kw, ids)
        if ids:
            total = int(want[1].sum())
            cs.check(torch.equal(old[1], want[1]) and torch.equal(
                first_flat(old[0], index, old[1]), want[0][:total]),
                f"{route}: the first design's ids differ")
        else:
            cs.check(torch.equal(old, want),
                     f"{route}: the first design's counts differ")
        def package():
            return lat.viterbi_walk(best_l, *args, index, ok=ok, ids=ids,
                                    **kw)

        def first():
            return first_walk(fn, best_l, args, index, ok, kw, ids)

        # Parent-change-change-parent: first, package, package, first.
        r = {}
        for k, f, queued in (("first_kernel", first, True),
                             ("package", package, True),
                             ("package_2", package, True),
                             ("first_kernel_2", first, True),
                             ("first_kernel_unqueued", first, False),
                             ("package_unqueued", package, False),
                             ("package_unqueued_2", package, False),
                             ("first_kernel_unqueued_2", first, False)):
            r[f"{k}_ms"] = cs.cuda_ms(f, iters=20, queued=queued)
        if ids:
            r["first_path_unqueued_ms"] = cs.cuda_ms(lambda: first_flat(
                first()[0], index, old[1]), iters=20)
        kernel = _build.load("viterbi_walk")
        for S in SEGMENTS:
            got = walk_with(kernel, best_l, args, index, ok, kw, ids,
                            segment=S)
            same = (torch.equal(got[1], want[1]) and torch.equal(
                got[0][:total], want[0][:total])) if ids else \
                torch.equal(got, want)
            cs.check(same, f"{route}, segment {S}: the walk differs")
            r[f"segment_{S}_ms"] = cs.cuda_ms(lambda: walk_with(
                kernel, best_l, args, index, ok, kw, ids, segment=S),
                iters=20, queued=True)
        for name, f in extra.items():
            got = walk_with(f, best_l, args, index, ok, kw, ids)
            same = (torch.equal(got[1], want[1]) and torch.equal(
                got[0][:total], want[0][:total])) if ids else \
                torch.equal(got, want)
            checked = VARIANTS.get(name, (True,))[0]
            cs.check(same or not checked, f"{route}, {name}: the walk "
                     "differs")
            r[f"{name}_ms"] = cs.cuda_ms(lambda: walk_with(
                f, best_l, args, index, ok, kw, ids), iters=20, queued=True)
        if ids:
            r["tables_again_ms"] = cs.cuda_ms(lambda: walk_with(
                kernel, best_l, args, index, ok, kw, True,
                keep_tables=False), iters=20, queued=True)
        r["split_us"] = kernel_split(cs, package)
        res[mode] = r
        cs.log(f"walk ({route}, {mode} mode): " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items() if k.endswith("_ms"))
            + f"; device us by kernel {r['split_us']}")
    # The chain floor: the longest span's row alone.
    k = int(torch.argmax((index.ends - index.starts) * ok))
    one = lat.walk_index([spans[k]], B, W, dev)
    ok1 = ok[k : k + 1].contiguous()
    rows8 = best_l.to(torch.uint8).contiguous()  # no group-wide copy
    res["floor"] = {
        "bytes": int(index.ends[k] - index.starts[k]),
        "ms": cs.cuda_ms(lambda: lat.viterbi_walk(
            rows8, *args, one, ok=ok1, **kw), iters=20, queued=True),
        "first_design_ms": cs.cuda_ms(lambda: first_walk(
            fn, best_l, args, one, ok1, kw, False), iters=20, queued=True)}
    for name, f in extra.items():
        res["floor"][f"{name}_ms"] = cs.cuda_ms(lambda: walk_with(
            f, rows8, args, one, ok1, kw, False), iters=20, queued=True)
    cs.log(f"walk ({route}): chain floor {res['floor']}")
    return res


def main() -> None:
    import chip_smoke as cs
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops.match_table import TokenTable
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.utils.packing import pack_samples

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures kernels on a GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    sources = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    started = start_first()
    logs = _build.build(["viterbi_walk", "viterbi_scan", "fused_forward"])
    fn = load_first(started)
    sources.update(patched_sources())
    extra, regs = load_sources(sources)
    regs["package"] = [line.strip() for line in
                       logs["viterbi_walk.cu"].splitlines()
                       if "registers" in line]
    cs.log(f"registers: {regs}")
    samples = cs.build_corpus(cs.CORPUS_BYTES)
    width = ed._pick_width(samples, None)
    packed = pack_samples(samples, width=width)
    sub = next(g for _, g in ed._padded_groups(packed, width, ed.ROW_MULT))
    batch = lat.prepare_batch(sub, cs.L_MAX, dev)
    out = {"device": smi}
    for route, size in (("slab", 32768), ("fused", 4096)):
        tbl = lat.DeviceTables.from_table(
            TokenTable.build(cs.build_vocab(samples, size)), dev)
        cs.check(lat.has_vscan(tbl) == (route == "fused"),
                 f"{size} tokens do not take the {route} route")
        out[route] = time_group(cs, lat, fn, extra, tbl, batch, sub.spans,
                                dev, route)
    out["registers"] = regs
    line = json.dumps(out)
    paths = [a for a in sys.argv[1:] if "=" not in a]
    if paths:
        Path(paths[0]).write_text(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
