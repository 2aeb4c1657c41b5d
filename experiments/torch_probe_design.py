#!/usr/bin/env python3
"""Design probe for tokengeex_tpu_torch's slab probe, on the card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_probe_design.py [out.json]

`match_probe` (csrc/match_probe.cu) keeps a bucket table's miss filter in
shared memory, gathers one 32-byte sector a point where the filter lets
it, and walks tiles in persistent blocks. Its first design, kept here as
`torch_probe_first.cu`, launched a block a tile over every tile and
gathered the whole 64-byte row at every valid point. This probe builds
that source beside the package's and times both, with CUDA events, in one
process on the same inputs (chip_smoke.py's phase 2 cases: encode (a)'s
first row group, W = 8192, L = 16, 512 rows, the 32k vocabulary, in bucket
and fast mode, and the prune's 49,152-token table (buckets at bits 17) in
bucket mode; exact mode at float32 and float64 on the chained window of
the f64 phase's long samples, W = 32768, lead = L, 128 rows; slots off and
on):

  - each design through the package's wrapper (the first design's entry
    behind its C interface, the filter argument dropped), unqueued, as
    chip_smoke.py times every kernel (the wrapper's checks and allocations
    included), and queued (device time alone: the calls parked behind a
    sleep kernel), first / package / package / first;
  - the package's kernel on its gather branch for the same bucket table
    (the filter left out: FILTER_MAX_BITS patched to 0);
  - VARIANTS: the package's source with 512-thread blocks at every table
    size (one an SM at bits 17; held equal to the twin), or cut (no filter, a hashed filter
    verdict, no gathers, no stores, no probing) for a breakdown; exact mode runs the first design's kernel in
    the package too, so the cuts leave it whole;
  - the bucket filter's rule counted on the group in torch ops
    (chip_smoke.py `filter_counts`: valid points kept from the L2, gathers
    in rows placing an entry past 3).

Every design's output is held equal to the twin (`match_cache_plain`) bit
for bit, but the cuts'. Prints the card's name and power limit, the first
design's times in the form of chip_smoke.py's `PROBE_FIRST_DESIGN_MS`,
then one JSON object as its last line, written to out.json when a path
is given.
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

FIRST_SOURCE = Path(__file__).resolve().with_name("torch_probe_first.cu")
SOURCE = _build.CSRC / "match_probe.cu"
# The first design's C entry points: the package's arguments without the
# filter.
FIRST_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 9
                  + (ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p))
ITERS = 20


def _const(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


FILTER_READ = "const uint32_t f = valid ? s_filter[row] : 0u;"
STORES = ("          __stcs(out + (size_t)j * a.B, s);\n"
          "          if constexpr (SLOTS) __stcs(out_slot + (size_t)j * a.B, sl);")
ISSUE_LOADS = ["    if (live) {\n      w0 = __ldg", "    if (live) {\n      r1 = __ldg"]
# Builds of the package's source: name -> (checked, patches old -> new).
VARIANTS = {
    # 512-thread blocks only: two an SM where they fit, else one (bits 17).
    "threads_512_only": (True, [(
        "    const int one = launch_blocks<2 * kThreads, MODE,",
        "    const int one = launch_blocks<kThreads, MODE,")]),
    # Cuts, for a breakdown: one-sector gathers at every valid point (no
    # filter: a row's second sector never read); the filter's verdict from
    # a hash of the row instead of a shared-memory read (about 1 point in
    # 8 gathers); no table row gathered (the stream, the hashes, the filter
    # and the stores remain); no stores; no probing at all (the staging and
    # the barriers remain).
    "no_filter_one_sector": (False, [(FILTER_READ, FILTER_READ.replace(
        "s_filter[row]", "0x7Fu"))]),
    "filter_hash": (False, [(FILTER_READ, FILTER_READ.replace(
        "s_filter[row]", "((row * 0x9E3779B1u) >> 29 == 0 ? 0x7Fu : 0u)"))]),
    "no_gathers": (False, [(o, o.replace("(live)", "(live && a.B < 0)"))
                           for o in ISSUE_LOADS]),
    "no_stores": (False, [(STORES, STORES.replace(
        "__stcs(", "if (sl == -12345) __stcs("))]),
    "no_probe": (False, [("    probe_tile<NT, MODE, FILTER, SLOTS, T>(",
                          "    if (a.B < 0) probe_tile<NT, MODE, FILTER, SLOTS, "
                          "T>(")]),
}


def _nvcc(src: Path, lib: Path):
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def build_all():
    """The first design and the VARIANTS, all nvcc started together;
    returns ({name: (f32 entry, f64 entry)}, {name: register lines})."""
    out = _build.build_dir() / "probe_design"
    out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    srcs = {"first": FIRST_SOURCE}
    for name, (_, patches) in VARIANTS.items():
        t = text
        for old, new in patches:
            if old not in t:
                raise RuntimeError(f"variant {name}: patch target missing")
            t = t.replace(old, new)
        srcs[name] = out / f"{name}.cu"
        srcs[name].write_text(t)
    procs = {n: (out / f"{n}.so", _nvcc(p, out / f"{n}.so"))
             for n, p in srcs.items()}
    fns, regs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line]
        so = ctypes.CDLL(str(lib))
        pair = []
        for sym in ("tgx_match_probe", "tgx_match_probe_f64"):
            fn = getattr(so, sym)
            fn.argtypes = list(FIRST_ARGTYPES if name == "first"
                               else _build.KERNELS["match_probe"][2])
            fn.restype = ctypes.c_int
            pair.append(fn)
        fns[name] = tuple(pair)
    return fns, regs


def main() -> None:
    import chip_smoke as cs
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import lattice_cuda_probe as lcp
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
    logs = _build.build(["match_probe"])
    fns, regs = build_all()
    regs["package"] = [line.strip() for line in
                       logs["match_probe.cu"].splitlines()
                       if "registers" in line or "spill" in line]
    for name, lines in regs.items():
        used = [ln.split("Used ")[1].split(" reg")[0] for ln in lines
                if "registers" in ln]
        spills = sum("0 bytes spill stores" not in ln for ln in lines
                     if "spill" in ln)
        cs.log(f"[probe design] {name}: registers {used}, {spills} "
               "entries spill")

    samples = cs.build_corpus(cs.CORPUS_BYTES)
    vocab = cs.build_vocab(samples, 32768)
    width = ed._pick_width(samples, None)
    groups = list(ed._padded_groups(pack_samples(samples, width=width),
                                    width, ed.ROW_MULT))
    batch = lat.prepare_batch(groups[0][1], cs.L_MAX, dev)
    table = TokenTable.build(vocab)
    tables = {torch.float32: lat.DeviceTables.from_table(table, dev),
              torch.float64: lat.DeviceTables.from_table(table, dev,
                                                         torch.float64)}
    L = tables[torch.float32].max_len
    window = cs.chained_window(lat, ed, cs.f64_samples(samples)[cs.F64_SHORT:],
                               L, dev)

    package_load = _build.load

    def first_entry(n):
        """The first design's entry behind the package's C interface: its
        arguments without the filter."""
        fn = fns["first"][n == "match_probe_f64"]
        return lambda *args: fn(*args[:8], *args[9:])

    def run_package(tbl, b, mode, lead, slots, dtype, name="package"):
        """The package's wrapper (its checks, allocations and launch),
        launching `name`'s build: "package", "first" (the first design),
        "gather" (no filter) or a variant."""
        saved = lcp.FILTER_MAX_BITS
        if name in ("gather", "first"):
            lcp.FILTER_MAX_BITS = 0
        if name == "first":
            _build.load = first_entry
        elif name not in ("package", "gather"):
            _build.load = (lambda n: fns[name][n == "match_probe_f64"])
        try:
            return lat.match_cache(tbl, b, C=ed.CHUNK, probe=mode, lead=lead,
                                   slots=slots, dtype=dtype)
        finally:
            lcp.FILTER_MAX_BITS = saved
            _build.load = package_load

    # The prune's 49,152-token table: its buckets at bits 17, the filter
    # 128 KB (one block an SM).
    table_c = TokenTable.build(cs.build_vocab(samples, 49152, prefixes=False))
    tables["bits17"] = lat.DeviceTables.from_table(table_c, dev)
    cs.check(table_c.bk_bits == 17, f"49k table at bits {table_c.bk_bits}")
    cases = [("bucket", torch.float32, batch, 0),
             ("bucket", "bits17", batch, 0),
             ("fast", torch.float32, batch, 0),
             ("exact", torch.float32, window, L),
             ("exact", torch.float64, window, L)]
    res = {"device": smi, "registers": regs, "cases": {}}
    first_ms = {}
    for mode, key, b, lead in cases:
        tbl = tables[key]
        dtype = torch.float64 if key == torch.float64 else torch.float32
        for slots in (False, True):
            tag = (f"{mode}{'[f64]' if dtype == torch.float64 else ''}"
                   f"{'[bits 17]' if key == 'bits17' else ''}"
                   f"{', slots' if slots else ''}")
            args = (tbl, b, mode, lead, slots, dtype)
            want = lat.match_cache_plain(tbl, b, ed.CHUNK, mode, lead, slots,
                                         dtype)
            designs = {"first": lambda: run_package(*args, name="first"),
                       "package": lambda: run_package(*args)}
            if mode == "bucket":
                designs["gather"] = lambda: run_package(*args, name="gather")
            for name in VARIANTS:
                designs[name] = (lambda n=name: run_package(*args, name=n))
            for name, fn in designs.items():
                if name in VARIANTS and not VARIANTS[name][0]:
                    continue
                got = fn()
                torch.cuda.synchronize()
                cs.check(torch.equal(got[0], want[0]) and (
                    not slots or torch.equal(got[1], want[1])),
                    f"{name} ({tag}) differs from the twin")
                del got
            row = {"shares": None}
            if mode == "bucket":
                row["shares"] = cs.filter_counts(tbl, b, lead)
            del want
            times = {k: {"unqueued": [], "queued": []} for k in designs}
            for order in ("first", "package", "package", "first"):
                for name, fn in designs.items():
                    if (name == "first") != (order == "first"):
                        continue
                    times[name]["unqueued"].append(cs.cuda_ms(fn, ITERS))
                    times[name]["queued"].append(
                        cs.cuda_ms(fn, ITERS, queued=True))
            for name, t in times.items():
                row[name] = {m: {"mean_ms": sum(v) / len(v), "min_ms": min(v),
                                 "max_ms": max(v)} for m, v in t.items()}
                cs.log(f"[probe design] {tag} {name}: unqueued "
                       f"{row[name]['unqueued']['mean_ms']:.4f} ms, device "
                       f"{row[name]['queued']['mean_ms']:.4f} ms (min "
                       f"{row[name]['queued']['min_ms']:.4f})")
            if row["shares"]:
                cs.log(f"[probe design] {tag} shares: {row['shares']}")
            first_ms[tag] = {
                "ms": round(row["first"]["unqueued"]["mean_ms"], 4),
                "device_ms": round(row["first"]["queued"]["mean_ms"], 4)}
            res["cases"][tag] = row
            torch.cuda.empty_cache()
    cs.log(f"PROBE_FIRST_DESIGN_ON = {smi!r}")
    cs.log(f"PROBE_FIRST_DESIGN_MS = {first_ms!r}")
    res["first_design_ms"] = first_ms
    line = json.dumps(res)
    if sys.argv[1:]:
        Path(sys.argv[1]).write_text(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
