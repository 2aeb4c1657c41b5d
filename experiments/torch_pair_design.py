#!/usr/bin/env python3
"""Design probe for tokengeex_tpu_torch's pair count, on the card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_pair_design.py [out.json]

`pair_count` (csrc/pair_count.cu) folds each block's pairs in a table in
shared memory and sends each distinct row once to a global table of
16-byte {key, count} slots sized from a hint of the distinct keys. Its
first design, kept here as `torch_pair_first.cu`, made one global atomic
per pair into a table of two arrays sized from the pairs (`FirstTable`,
the PairTable that drove it). This probe builds that source beside the
package's and times both, with CUDA events, in one process on the same
inputs (host clocks and cards differ between calls):

  - the merge's first row group of chip_smoke.py's corpus (the 4k
    vocabulary at the merge's table hints: 1.64 M tokens), the package's
    table sized from the hint a merge pass has (the distinct pairs of a
    pass over the corpus at the same vocabulary);
  - each design's group as a merge pass runs it (a table, the insert, the
    compaction and its readbacks) unqueued, and its launches queued (the
    device time alone), first / package / package / first;
  - VARIANTS: the package's source built with other constants (256 or
    1,024 threads; one block an SM with a larger shared table, three or
    four with smaller ones; another tile) or patched (equal keys folded
    in a warp first; eight rows a flushing thread; a flush after every
    tile; no block fold; cuts: after the staging, the flush's sends, the
    shared count adds or claims, the global count adds), each but the
    cuts held equal to the plain version, and its fill and insert timed
    queued;
  - a skewed group (the merge group's spans, ids 7 with probability 0.8)
    through both designs, torch.unique and the checked variants;
  - a profiler split of the package's group by kernel.

Prints one JSON object as its last line, and writes it to out.json when a
path is given. chip_smoke.py times the first design beside the package's
kernel in its phase 2 through `start_first`, `load_first` and
`FirstTable`.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tokengeex_tpu_torch.ops import _build  # noqa: E402

FIRST_SOURCE = Path(__file__).resolve().with_name("torch_pair_first.cu")
P, I, U, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
# The first design's C entry points: name -> (symbol, argtypes).
FIRST_ENTRIES = {
    "insert_ids": ("tgx_pair_insert_ids", (P, P, I, U, P, P, LL, P, LL, P)),
    "insert_weighted": ("tgx_pair_insert_weighted",
                        (P, P, LL, P, P, LL, P, P)),
    "compact": ("tgx_pair_compact", (P, P, LL, P, P, LL, P, P)),
}
SPANS = "    // The spans ending in this tile"
FOLD = "      const int r = live ? shared_add(skey, scnt, key, w) : 0;"
FLUSH_SEND = "        send_from(s, key[u], cnt[u], slot[u], cur[u], claims);"
ONE = "      const unsigned w = 1;\n"
WARP_FOLD = ("      const unsigned peers = __match_any_sync(0xffffffffu, key);\n"
             "      live = live && __ffs(peers) - 1 == lane;\n"
             "      const unsigned w = __popc(peers);\n")
FLUSH_AT = "    if (claimed > kShared / 2) flush("
SHARED_ADD = "      atomicAdd(&scnt[slot], w);\n"
SHARED_CAS = "      cur = atomicCAS(&skey[slot], kEmpty, key);"
SHARED_STORE = "      skey[slot] = key;"
COUNT_ADD = "      atomicAdd(&s.table[slot].count, w);\n"
THREADS = "constexpr int kThreads = 512;"
BLOCKS = "constexpr int kBlocksPerSm = 2;"
SHARED = "constexpr int kShared = 8192;"
TILE = "constexpr int kTile = 4096;"


def _sizes(threads=512, blocks=2, shared=8192, tile=4096):
    """Patches of the ids kernel's block, occupancy and table constants."""
    return [(THREADS, f"constexpr int kThreads = {threads};"),
            (BLOCKS, f"constexpr int kBlocksPerSm = {blocks};"),
            (SHARED, f"constexpr int kShared = {shared};"),
            (TILE, f"constexpr int kTile = {tile};")]


# Builds of the package's source with other settings: name -> (checked: its
# counts must equal the plain version's, patches old -> new).
VARIANTS = {
    # Equal keys folded in a warp (__match_any_sync) before the shared
    # table.
    "warp_fold": (True, [(ONE, WARP_FOLD)]),
    "threads_256": (True, _sizes(threads=256)),
    "one_block_an_sm": (True, _sizes(threads=1024, blocks=1, shared=16384)),
    "four_blocks_an_sm": (True, _sizes(threads=256, blocks=4, shared=4096,
                                       tile=1024)),
    "tile_2048": (True, _sizes(tile=2048)),
    "three_blocks_an_sm": (True, _sizes(blocks=3, shared=4096, tile=2048)),
    # Eight rows a flushing thread probes at once.
    "batch_8": (True, [("constexpr int kBatch = 4;",
                        "constexpr int kBatch = 8;")]),
    # A flush after every tile: the global sends spread over the kernel.
    "flush_each_tile": (True, [(FLUSH_AT, "    if (claimed > 0) flush(")]),
    # Every pair straight to the global table.
    "no_block_fold": (True, [(FOLD, FOLD.replace(
        "shared_add(skey, scnt, key, w)", "-1"))]),
    # Cuts: the staging alone; the fold without the flush's global sends.
    "stage_only": (False, [(SPANS, "    if (V > 0) return;\n" + SPANS)]),
    "no_flush_sends": (False, [(FLUSH_SEND, "")]),
    # Cuts of the shared fold: its count adds; its claims as plain stores.
    "no_shared_adds": (False, [("  " + SHARED_ADD, ""), (SHARED_ADD, "")]),
    "no_shared_cas": (False, [(SHARED_CAS, SHARED_STORE)]),
    # Cut: the global table's count adds left out (claims and probes kept).
    "no_count_adds": (False, [("  " + COUNT_ADD, ""), (COUNT_ADD, "")]),
}


def _out_dir() -> Path:
    out = _build.build_dir() / "pair_design"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _nvcc(source: Path, lib: Path):
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def start_first():
    """Start nvcc on the first design's source (returns what `load_first`
    takes), so a caller can build it beside the package's sources."""
    lib = _out_dir() / "first.so"
    return lib, _nvcc(FIRST_SOURCE, lib)


def load_first(started) -> Dict[str, object]:
    """The first design's three C entry points, once its nvcc has
    finished."""
    lib, proc = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {FIRST_SOURCE.name}:\n{log}")
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for name, (symbol, argtypes) in FIRST_ENTRIES.items():
        fn = getattr(cdll, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, *args) -> None:
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc:
        raise RuntimeError(f"the first design failed to launch: CUDA error "
                           f"{rc}")


class FirstTable:
    """The first design's table as its own PairTable ran it on a group:
    int64 keys (EMPTY = -1) and counts in two arrays of the least power of
    two >= 2 x the pairs, one thread a token, a global atomic a pair."""

    def __init__(self, fns, pairs: int, device):
        self.fns = fns
        self.slots = 1 << max(2 * int(pairs) - 1, 0).bit_length()
        self.keys = torch.full((self.slots,), -1, dtype=torch.int64,
                               device=device)
        self.counts = torch.zeros(self.slots, dtype=torch.int64,
                                  device=device)
        self.state = torch.zeros(3, dtype=torch.int64, device=device)
        self.cap = int(pairs)

    def insert_ids(self, flat, incl, vocab_size: int) -> None:
        _call(self.fns["insert_ids"], flat, incl, incl.numel(), vocab_size,
              self.keys, self.counts, self.slots, self.state, flat.numel())

    def compact_launch(self):
        out_k = torch.empty(self.cap, dtype=torch.int64,
                            device=self.keys.device)
        out_c = torch.empty_like(out_k)
        cursor = torch.zeros(1, dtype=torch.int64, device=self.keys.device)
        _call(self.fns["compact"], self.keys, self.counts, self.slots,
              out_k, out_c, self.cap, cursor)
        return out_k, out_c, cursor

    def compact(self):
        out_k, out_c, cursor = self.compact_launch()
        n, _, overflow, _ = torch.cat([cursor, self.state]).tolist()
        if overflow or n > self.cap:
            raise RuntimeError("the first design's table overflowed")
        return out_k[:n], out_c[:n]


def first_group(fns, flat, incl, vocab_size: int, pairs: int,
                launch_only: bool = False, insert_only: bool = False):
    """One group through the first design, as its merge pass ran it."""
    table = FirstTable(fns, pairs, flat.device)
    table.insert_ids(flat, incl, vocab_size)
    if insert_only:
        return table
    return table.compact_launch() if launch_only else table.compact()


def load_variants() -> Dict[str, object]:
    """The package's pair_count.cu built per VARIANTS (all nvcc started
    together): name -> its tgx_pair_insert_ids."""
    text = (_build.CSRC / "pair_count.cu").read_text()
    procs = {}
    for name, (_, patches) in VARIANTS.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            src = src.replace(old, new)
        path = _out_dir() / f"{name}.cu"
        path.write_text(src)
        lib = _out_dir() / f"{name}.so"
        procs[name] = (lib, _nvcc(path, lib))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).tgx_pair_insert_ids
        fn.argtypes = list(_build.KERNELS["pair_insert_ids"][2])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def with_insert(pc, fn, call):
    """Runs call() with the package's PairTable launching `fn` for its ids
    insert (the other entries unchanged)."""
    launch = pc._launch

    def patched(name, *args):
        if name != "pair_insert_ids":
            return launch(name, *args)
        return _call(fn, *args)

    pc._launch = patched
    try:
        return call()
    finally:
        pc._launch = launch


def kernel_split(fn) -> list:
    """Device time by kernel of ten calls of fn (torch.profiler), us."""
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


def main() -> None:
    import chip_smoke as cs
    from tokengeex_tpu_torch import Model
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.ops import pair_count as pc
    from tokengeex_tpu_torch.train import estep_device as ed
    from tokengeex_tpu_torch.train.merge import merge_table_hints
    from tokengeex_tpu_torch.utils.packing import pack_samples

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures kernels on a GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    started = start_first()
    logs = _build.build(["pair_insert_ids", "fused_forward", "viterbi_walk"])
    fns = load_first(started)
    variants = load_variants()
    cs.log("registers: " + "; ".join(
        line.strip() for line in logs["pair_count.cu"].splitlines()
        if "registers" in line))
    samples = cs.build_corpus(cs.CORPUS_BYTES)
    vocab = cs.build_vocab(samples, 4096)
    hints = merge_table_hints(len(vocab), 200, 24)
    width = ed._pick_width(samples, None)
    sub = next(g for _, g in ed._padded_groups(
        pack_samples(samples, width=width), width, ed.ROW_MULT))
    flat, incl, dead, V = cs.merge_group_ids(lat, ed, vocab, sub, hints,
                                             dev)
    cs.check(not bool(dead.any()), "a span of the group is dead")
    corpus = ed.DeviceCorpus(samples, device=dev)
    ed.count_pairs_arrays(Model(vocab), samples, table_hints=hints,
                          corpus=corpus)
    hint = corpus.pair_hint
    keys, ids = pc.pair_keys(flat, incl)
    pairs = keys.numel()
    want = pc.pair_count_plain(flat, incl, V)
    old = first_group(fns, flat, incl, V, pairs)
    order = torch.argsort(old[0])
    cs.check(torch.equal(old[0][order], want[0])
             and torch.equal(old[1][order], want[1]),
             "the first design's counts differ from the plain version's")

    def package(launch_only=False, insert_only=False):
        table = pc.PairTable(dev, hint)
        table.insert_ids(flat, incl, V)
        if insert_only:
            return table
        return (table._compact_launch(want[0].numel()) if launch_only
                else table.compact())

    got = package()
    order = torch.argsort(got[0])
    cs.check(torch.equal(got[0][order], want[0])
             and torch.equal(got[1][order], want[1]),
             "the package's counts differ from the plain version's")
    state = package(insert_only=True).read()
    res = {"device": smi, "tokens": ids.numel(), "pairs": pairs,
           "spans": incl.numel(), "distinct": int(want[0].numel()),
           "hint": hint, "slots": pc.table_slots(0, hint),
           "sent": state[pc.SENT], "spilled": state[pc.SPILLED]}
    runs = (("first", lambda: first_group(fns, flat, incl, V, pairs), False),
            ("package", package, False), ("package_2", package, False),
            ("first_2", lambda: first_group(fns, flat, incl, V, pairs),
             False),
            ("first_device", lambda: first_group(
                fns, flat, incl, V, pairs, launch_only=True), True),
            ("package_device", lambda: package(launch_only=True), True),
            ("package_device_2", lambda: package(launch_only=True), True),
            ("first_device_2", lambda: first_group(
                fns, flat, incl, V, pairs, launch_only=True), True),
            ("first_fill_insert", lambda: first_group(
                fns, flat, incl, V, pairs, insert_only=True), True),
            ("package_fill_insert", lambda: package(insert_only=True), True),
            ("package_fill", lambda: pc.PairTable(dev, hint), True))
    for name, fn, queued in runs:
        res[f"{name}_ms"] = cs.cuda_ms(fn, iters=20, queued=queued)
    res["library_ms"] = cs.cuda_ms(
        lambda: torch.unique(keys, return_counts=True), iters=20)
    # The host's side alone: the group's calls up to the compaction's
    # launch, enqueued behind a sleep kernel (host clock, no readback).
    for name, fn in (("package", lambda: package(launch_only=True)),
                     ("first", lambda: first_group(
                         fns, flat, incl, V, pairs, launch_only=True))):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t = time.perf_counter()
        for _ in range(20):
            fn()
        res[f"{name}_host_ms"] = (time.perf_counter() - t) / 20 * 1e3
        torch.cuda.synchronize()
    for name, fn in variants.items():
        got = with_insert(pc, fn, package)
        order = torch.argsort(got[0])
        cs.check(not VARIANTS[name][0] or (
            torch.equal(got[0][order], want[0])
            and torch.equal(got[1][order], want[1])),
            f"{name}: the counts differ from the plain version's")
        res[f"{name}_fill_insert_ms"] = cs.cuda_ms(
            lambda: with_insert(pc, fn, lambda: package(insert_only=True)),
            iters=20, queued=True)
    # The skewed group: runs of one id (p = 0.8), its pair ~64 % of the
    # pairs, through each design and each checked variant.
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    hot = torch.where(torch.rand(ids.numel(), device=dev, generator=gen)
                      < 0.8, 7, torch.randint(0, V, (ids.numel(),),
                                              device=dev, generator=gen))
    hot = hot.to(torch.int32)
    hot_want = pc.pair_count_plain(hot, incl, V)
    res["skewed_top_share"] = float(hot_want[1].max() / hot_want[1].sum())

    def skewed(launch_only=True):
        table = pc.PairTable(dev, hint)
        table.insert_ids(hot, incl, V)
        return (table._compact_launch(hot_want[0].numel()) if launch_only
                else table.compact())

    res["skewed_first_device_ms"] = cs.cuda_ms(lambda: first_group(
        fns, hot, incl, V, pairs, launch_only=True), iters=20, queued=True)
    res["skewed_device_ms"] = cs.cuda_ms(skewed, iters=20, queued=True)
    res["skewed_library_ms"] = cs.cuda_ms(lambda: torch.unique(
        pc.pair_keys(hot, incl)[0], return_counts=True), iters=20)
    for name, fn in variants.items():
        if VARIANTS[name][0]:
            got = with_insert(pc, fn, lambda: skewed(launch_only=False))
            order = torch.argsort(got[0])
            cs.check(torch.equal(got[0][order], hot_want[0])
                     and torch.equal(got[1][order], hot_want[1]),
                     f"{name}: the skewed counts differ")
            res[f"skewed_{name}_device_ms"] = cs.cuda_ms(
                lambda: with_insert(pc, fn, skewed), iters=20, queued=True)
    res["split_us"] = kernel_split(lambda: package(launch_only=True))
    res["first_split_us"] = kernel_split(lambda: first_group(
        fns, flat, incl, V, pairs, launch_only=True))
    cs.log("pair_count design: " + ", ".join(
        f"{k} {v:.4f}" for k, v in res.items() if k.endswith("_ms")))
    cs.log(f"split (us, per call): package {res['split_us']}; first "
           f"{res['first_split_us']}")
    line = json.dumps(res)
    paths = sys.argv[1:2]
    if paths:
        Path(paths[0]).write_text(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
