#!/usr/bin/env python3
"""Design probe for tokengeex_tpu_torch's marginal scan and one-launch
segsum, on the card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 experiments/torch_marginal_design.py [out.json]

`backward_marginal_scan` (csrc/backward_chunk.cu) is the betas scan's
layout with a marginal written per (position, length). Written in the
cache's (W, L, B) order it took ~2.4x the betas scan loaded, while one
chain alone stepped as fast, so the loaded group paid for something the
recurrence does not. This probe times, with CUDA events, variants of the
package's source, each patched at build time (the package is not
changed):

  - package: as built by ops/_build.py, the marginals (W, B, L) in
    memory: a chain's 16 lengths on 64 contiguous bytes, a warp's two
    chains on one 128-byte line;
  - no_store: the marginals computed, summed per lane and written once at
    the chain's end (the stores' cost);
  - no_exp: the exponent's argument stored without its expf (the
    exponentials' cost);
  - streaming: the stores as st.global.cs (evict-first), so that the
    marginals do not push the cache's rows out of L2;
  - cache_layout: the marginals written in the cache's (W, L, B) order,
    so that a warp's store touches 16 sectors;

next to `backward_betas_scan` on the same inputs, at chip_smoke.py's
session group (W = 8192, L = 16, 512 rows, chains every 1024 positions)
and the per-pass E-step's (W = 1024, 4096 rows), dropout 0. For the
segsum launch it times `seg_weights_gather` on the session group's real
SegStruct at dropout 0 and 0.1 beside `seg_weights` streaming the same
number of hits from contiguous (H,) arrays (no gathers). Prints one JSON
object as its last line, and writes it to out.json when a path is given.
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
from tokengeex_tpu_torch.ops import lattice_cuda_seg as lcs  # noqa: E402
from tokengeex_tpu_torch.ops.match_table import TokenTable  # noqa: E402
from tokengeex_tpu_torch.train import device_session as ds  # noqa: E402
from tokengeex_tpu_torch.train import estep_device as ed  # noqa: E402
from tokengeex_tpu_torch.utils.packing import pack_samples  # noqa: E402

STORE = "      if (mine && j < L) mq[j] = m;"
EXP = "expf(fmaxf(ra[i] + sc[p] + h[p] - rz[i], TGX_NEG))"
SINK_DECL = "  const float hs0 = (b1 == n) ? hist_in[rr] : 0.0f;"
TAIL = "    if (q0 - i >= lo) step(i, q0 - i);  // uniform over the warp"
MQ = "    float* mq = marg + ((size_t)q * Bs + r) * L;"

VARIANTS = {
    "package": [],
    "no_store": [(STORE, "      sink += (mine && j < L) ? m : 0.0f;"),
                 (SINK_DECL, SINK_DECL + "\n  float sink = 0.0f;"),
                 (TAIL, TAIL + "\n  if (row && sink == 12345.0f) "
                               "marg[r] = sink;")],
    "no_exp": [(EXP, "fmaxf(ra[i] + sc[p] + h[p] - rz[i], TGX_NEG)")],
    "streaming": [(STORE, "      if (mine && j < L) __stcs(mq + j, m);")],
    "cache_layout": [(MQ, "    float* mq = marg + (size_t)q * L * Bs + r;"),
                     (STORE, "      if (mine && j < L) mq[j * Bs] = m;")],
}


def compile_all():
    """One nvcc per variant, all started together; the entry points and
    each build's register lines."""
    out = _build.build_dir() / "marginal_design"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "backward_chunk.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                cs.fail(f"{name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        path = out / f"{name}.cu"
        path.write_text(src)
        lib = out / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, regs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), "tgx_backward_marginal_scan")
        fn.argtypes = list(_build.KERNELS["backward_marginal_scan"][2])
        fn.restype = ctypes.c_int
        fns[name] = fn
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "backward_marginal_scan_kernelILi16ELi16ELb0" in line)
        regs[name] = [line.strip() for line in lines[at + 1 : at + 3]]
    return fns, regs


def time_group(fns, tbl, batch, dev, tag):
    cache = lat.match_cache(tbl, batch)
    W, L, B = cache[0].shape
    seg = lat.chain_bounds(batch)[1]
    A = lat.forward(tbl, batch, cache)
    a, z, ends, hist = lat._marginal_inputs(batch, A, L)
    want, betas = lc.backward_marginal_scan(cache[0], a, z, ends, hist, seg)
    res = {"shape": {"W": W, "L": L, "B": B, "segments": seg.shape[0] - 1}}
    res["betas_scan_ms"] = cs.cuda_ms(lambda: lc.backward_betas_scan(
        cache[0], ends, hist, seg), iters=10)
    for name, fn in fns.items():
        marg = torch.empty_like(cache[0])
        out_b = torch.empty_like(betas)

        def run():
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = fn(cache[0].data_ptr(), a.data_ptr(), z.data_ptr(),
                        ends.data_ptr(), hist.data_ptr(), seg.data_ptr(),
                        None, marg.data_ptr(), out_b.data_ptr(), None, W, L,
                        B, seg.shape[0] - 1, 0, 0, 0, stream)
            cs.check(rc == 0, f"{name}: launch failed ({rc})")

        run()
        torch.cuda.synchronize()
        cs.check(torch.equal(out_b, betas), f"{name}: betas differ")
        if name == "cache_layout":
            cs.check(torch.equal(marg, want), f"{name}: marginals differ")
        elif name != "no_store":
            got = marg.view(W, B, L).permute(0, 2, 1)
            cs.check(torch.equal(got, want) or name == "no_exp",
                     f"{name}: marginals differ")
        res[name] = cs.cuda_ms(run, iters=10)
    cs.log(f"{tag} (W={W}, L={L}, B={B}): "
           + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items()
                       if k != "shape"))
    return res


def time_segsum(table, tbl, batch, dev):
    rank = lat.build_rank_space(table)
    _, raw = lat.match_cache(tbl, batch)
    slots = lat.remap_slots(torch.as_tensor(rank.lut, device=dev), raw)
    del raw
    rows = lat.rank_score_rows(rank, tbl)
    cache = (lat.score_from_slots(rows, slots), slots)
    seg = lat.build_seg_struct(slots, rank.n_pad)
    H = int(seg.perm_flat.shape[0])
    res = {"H": H, "hits": list(seg.n_hit)}
    for dropout in (0.0, 0.1):
        du = cs.drop_words(batch, dropout, dev)
        A = lat.forward(tbl, batch, cache, drop_u=du, dropout=dropout)
        Bt = lat.backward_betas(tbl, batch, cache, drop_u=du, dropout=dropout)
        args = (seg, A, batch.end_index, batch.is_start, Bt, rows, du)
        res[f"gather_dropout_{dropout}_ms"] = cs.cuda_ms(
            lambda: lcs.seg_weights_gather(*args, dropout=dropout,
                                           pad=batch.pad), iters=20)
    g = torch.Generator(device=dev).manual_seed(1)
    r0, r1, d2 = (torch.rand(H, generator=g, device=dev) - 1.0
                  for _ in range(3))
    res["streams_ms"] = cs.cuda_ms(lambda: lcs.seg_weights(r0, r1, d2, H),
                                   iters=20)
    cs.log(f"segsum (H={H}): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in res.items() if k.endswith("_ms")))
    return res


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe measures kernels on a GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    _build.build(["backward_marginal_scan", "seg_weights_gather",
                  "forward_scan"])
    fns, regs = compile_all()
    for name, lines in regs.items():
        cs.log(f"{name}: {lines}")
    samples = cs.build_corpus(cs.CORPUS_BYTES)
    vocab = cs.build_vocab(samples, 32768)
    table = TokenTable.build(vocab)
    tbl = lat.DeviceTables.from_table(table, dev)
    packed = pack_samples(samples, width=ds.PACK_WIDTH,
                          max_snippet=ed.DEVICE_EM_SNIPPET)
    sub = next(g for _, g in ed._padded_groups(packed, ds.PACK_WIDTH,
                                               ed.ROW_MULT))
    batch = lat.prepare_batch(sub, cs.L_MAX, dev)
    out = {"device": smi, "registers": regs,
           "session_group": time_group(fns, tbl, batch, dev, "session group")}
    out["segsum"] = time_segsum(table, tbl, batch, dev)
    del batch
    torch.cuda.empty_cache()
    em_width = ed._pick_width(samples, ed.DEVICE_EM_SNIPPET)
    packed = pack_samples(samples, width=em_width,
                          max_snippet=ed.DEVICE_EM_SNIPPET)
    sub = next(g for _, g in ed._padded_groups(packed, em_width,
                                               ed.ROW_MULT))
    out["e_step_group"] = time_group(
        fns, tbl, lat.prepare_batch(sub, cs.L_MAX, dev), dev, "E-step group")
    line = json.dumps(out)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
