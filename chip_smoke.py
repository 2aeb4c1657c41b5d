#!/usr/bin/env python3
"""GPU smoke run of tokengeex_tpu_torch, the PyTorch / CUDA port.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA
     versions; builds every CUDA kernel from csrc/ (one nvcc per source,
     all started together) and prints the build time;
  2. kernels against their plain PyTorch versions, at the shapes the
     main path gives them: best_l / hist / rl equal, dp within
     rtol 1e-6; each timed with CUDA events beside its plain version and
     its bound;
  3. the main path end to end, Tokenizer.encode_batch(backend="device")
     on the card, for two configurations over a seeded ~8 MB code-like
     corpus at L = 16: (a) a 32,768-token vocabulary (slab route:
     bucket probe + viterbi_chunk), (b) a 4,096-token vocabulary (fused
     probe kernel). Each checks exact decode round trips, equality with
     the CPU plain run on the first 64 samples, dropout=1.0 -> single
     bytes, a > 2^15-byte sample through the chained path, and that its
     kernel was launched; prints bytes/s and the time per phase;
  4. the kernels line, then the device line as the last line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
L_MAX = 16
CORPUS_BYTES = 8_000_000
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# Seeded corpus and vocabularies
# ---------------------------------------------------------------------------


def build_corpus(nbytes: int, seed: int = SEED, pool_size: int = 12000):
    """Code-like text: Zipf-weighted identifiers (keywords first, then
    random-letter names for lexical diversity) joined by code
    punctuation, cut into samples of 1-8 KB like source files."""
    rng = np.random.default_rng(seed)
    keywords = [
        "def", "return", "value", "data", "self", "import", "print",
        "class", "for", "in", "range", "len", "if", "else", "while",
        "try", "except", "yield", "lambda", "none", "true", "false",
        "result", "index", "count", "total", "items", "key", "object",
    ]
    pool = list(keywords)
    seen = set(pool)
    while len(pool) < pool_size:
        w = "".join(chr(97 + int(c))
                    for c in rng.integers(0, 26, rng.integers(3, 11)))
        if w not in seen:
            seen.add(w)
            pool.append(w)
    weights = 1.0 / (1.0 + np.arange(len(pool))) ** 0.7
    weights /= weights.sum()
    seps = [" ", "(", ") ", ", ", "._", " = ", ": ", "[0]", "();\n    ",
            " == 1", "...", "{}", " += 2", "'%s'"]
    # Draw in bulk: ~60 bytes per line on average, with headroom.
    n_lines = nbytes // 40 + 1
    per_line = rng.integers(3, 12, n_lines)
    picks = rng.choice(len(pool), size=int(per_line.sum()), p=weights)
    joins = rng.integers(0, len(seps), int(per_line.sum()))
    lines, size, k = [], 0, 0
    for n in per_line:
        words = [pool[i] for i in picks[k : k + n]]
        line = words[0] + "".join(seps[j] + w for j, w in
                                  zip(joins[k + 1 : k + n], words[1:]))
        k += n
        lines.append(line)
        size += len(line) + 1
        if size >= nbytes:
            break
    text = "\n".join(lines).encode()[:nbytes]
    samples, pos = [], 0
    while pos < len(text):
        n = int(min(8192, max(256, rng.lognormal(math.log(3000), 0.6))))
        samples.append(text[pos : pos + n])
        pos += n
    return samples


def build_vocab(samples, size: int, max_len: int = L_MAX):
    """All 256 bytes plus the most frequent word-shaped substrings
    (words with their leading separator byte, and word prefixes),
    scored by log relative frequency."""
    import re
    from collections import Counter

    from tokengeex_tpu_torch import ScoredToken

    counts: Counter = Counter()
    for s in samples[: max(1, len(samples) // 4)]:
        for m in re.finditer(rb"[^a-z]?[a-z]+|[^a-z]+", s):
            w = m.group(0)[:max_len]
            counts[w] += 1
            for k in range(2, len(w)):
                counts[w[:k]] += 1
    # Whole-line prefixes of max_len bytes, so the longest token is L.
    long = [s[:max_len] for s in samples[:64] if len(s) >= max_len]
    long = list(dict.fromkeys(long))[:32]
    for w in long:
        counts[w] += 1
    common = [w for w, _ in counts.most_common()
              if len(w) > 1 and w not in set(long)]
    chosen = long + common[: size - 256 - len(long)]
    check(len(chosen) == size - 256,
          f"corpus has only {len(common)} candidate tokens for {size}")
    total = sum(counts[w] for w in chosen) + 256
    vocab = [ScoredToken(bytes([b]), math.log(1.0 / total) - 4.0)
             for b in range(256)]
    vocab += [ScoredToken(w, math.log(counts[w] / total)) for w in chosen]
    return vocab


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_busy(fn) -> dict:
    """Device busy and idle share of one call, from a torch.profiler
    trace: the summed time of the device's kernels and copies (one
    stream, so they do not overlap) over the call's wall time. The
    profiler's own host overhead lengthens the wall time a little."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    check(busy_us > 0, "the profiler recorded no device time")
    busy = busy_us / 1e6
    return {"busy_s": busy, "wall_s": wall, "idle_share": 1 - busy / wall}


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the entries both hold as finite scores
    (NEG sentinels compare by equality of the masks)."""
    fg, fw = got > -1.5e38, want > -1.5e38
    check(bool((fg == fw).all()), "finite masks differ")
    if not bool(fw.any()):
        return 0.0
    return float((got[fw].double() - want[fw].double()).abs().max())


def assert_dp(got, want, name: str) -> float:
    err = max_abs_err(got, want)
    fw = want > -1.5e38
    rel = ((got[fw].double() - want[fw].double()).abs()
           / want[fw].double().abs().clamp(min=1e-30))
    check(bool((rel <= 1e-6).all()), f"{name}: dp beyond rtol 1e-6")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_viterbi_chunk(lc, C: int, L: int, B: int, dev):
    g = torch.Generator().manual_seed(1)
    s = torch.round(torch.empty(C, L, B).uniform_(-12, -1, generator=g) * 2) / 2
    s[torch.rand(C, L, B, generator=g) < 0.4] = lc.NEG  # holes
    s[7] = lc.NEG  # a step with no candidate
    starts = (torch.rand(C, B, generator=g) < 0.002).float()
    hist0 = torch.round(torch.empty(L, B).uniform_(-30, 0, generator=g) * 2) / 2
    args = [t.to(dev).contiguous() for t in (s, starts, hist0)]

    want = lc.viterbi_chunk_plain(*args)
    got = lc.viterbi_chunk(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]), "viterbi_chunk: best_l differs")
    check(torch.equal(got[2], want[2]), "viterbi_chunk: hist differs")
    err = assert_dp(got[0], want[0], "viterbi_chunk")

    ms = cuda_ms(lambda: lc.viterbi_chunk(*args), iters=50)
    plain_ms = cuda_ms(lambda: lc.viterbi_chunk_plain(*args), iters=1)
    nbytes = 4 * (C * L * B + C * B + 2 * L * B + 2 * C * B)
    b_ms, b_by = bound(nbytes, 3 * C * L * B)
    log(f"viterbi_chunk (C={C}, L={L}, B={B}): {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"C": C, "L": L, "B": B}}


def check_fused(lat, lcf, tbl, batch, dropout: float, dev):
    drop_u = None
    if dropout > 0.0:
        g = torch.Generator(device=dev).manual_seed(2)
        drop_u = torch.randint(-(2**31), 2**31 - 1, tuple(batch.sid.shape),
                               generator=g, dtype=torch.int32, device=dev)
    args = lat.fused_inputs(tbl, batch, drop_u, dropout)
    kw = dict(L=tbl.max_len, bits=tbl.bits, pad=batch.pad, dropout=dropout)
    want = lcf.fused_forward_chunk_plain("viterbi", *args, **kw)
    got = lcf.fused_forward_chunk("viterbi", *args, **kw)
    torch.cuda.synchronize()
    for i, name in ((1, "best_l"), (2, "hist"), (3, "rl")):
        check(torch.equal(got[i], want[i]), f"fused_forward: {name} differs")
    err = assert_dp(got[0], want[0], "fused_forward")

    ms = cuda_ms(lambda: lcf.fused_forward_chunk("viterbi", *args, **kw),
                 iters=10)
    plain_ms = cuda_ms(
        lambda: lcf.fused_forward_chunk_plain("viterbi", *args, **kw),
        iters=1, warmup=0)
    W = batch.width
    B = batch.p1.shape[0]
    L = tbl.max_len
    # Bytes: every input read once, every output written once.
    nbytes = sum(t.numel() * t.element_size()
                 for t in args if t is not None)
    nbytes += 4 * (2 * W * B + L * B + B)
    # Operations: ~20 integer ops per probed (position, length) -- the
    # fingerprints, slot indices, compares and the coin -- and 3 for the
    # relaxation of each (position, length); probes only run where the
    # length fits the sample run (data-dependent: counted on this data).
    inb = batch.sid[:, batch.pad : batch.pad + W].t() >= 0
    rl = lcf.run_lengths(inb, batch.is_start[:, :W].t(), args[10])
    probes = int(rl.clamp(max=L).sum())
    b_ms, b_by = bound(nbytes, 20 * probes + 3 * W * L * B)
    log(f"fused_forward (W={W}, L={L}, B={B}, bits={tbl.bits}, "
        f"dropout={dropout}): {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {probes} probes, max |err| {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "probes": probes,
            "shape": {"W": W, "L": L, "B": B, "bits": tbl.bits,
                      "dropout": dropout}}


# ---------------------------------------------------------------------------
# Phase 3: the main path end to end
# ---------------------------------------------------------------------------


def run_config(name, vocab, samples, long_sample, expect, kernels, dev):
    from tokengeex_tpu_torch import Model, Tokenizer
    from tokengeex_tpu_torch.ops import lattice as lat
    from tokengeex_tpu_torch.train import estep_device as ed

    model = Model(vocab)
    tok = Tokenizer(model, device=dev)
    texts = [s.decode() for s in samples]
    total = sum(map(len, samples))
    tok.encode_batch(texts[:64])  # warm-up: allocator, constants
    torch.cuda.synchronize()

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ids = tok.encode_batch(texts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    check(launches[expect] > 0,
          f"{name}: the main path launched {expect} no time")
    rate = total / secs
    log(f"[{name}] encode {total} bytes in {secs:.3f} s = "
        f"{rate / 1e6:.2f} MB/s; launches {launches}")

    timer = lat.PhaseTimer(dev)
    t0 = time.perf_counter()
    ids_t = tok.encode_batch(texts, timer=timer)
    secs_t = time.perf_counter() - t0
    check(ids_t == ids, f"{name}: a second encode gave other ids")
    phases = {k: round(v, 6) for k, v in timer.seconds.items()}
    log(f"[{name}] phases (synchronised run, {secs_t:.3f} s): {phases}")
    busy = device_busy(lambda: tok.encode_batch(texts))
    log(f"[{name}] profiled run: device busy {busy['busy_s']:.4f} s of "
        f"{busy['wall_s']:.3f} s wall, idle share {busy['idle_share']:.4f}")

    for text, row in zip(texts, ids):
        if tok.decode(row) != text:
            fail(f"{name}: a sample does not decode back to its text")
    cpu = Tokenizer(model, device="cpu").encode_batch(texts[:64])
    check(cpu == ids[:64], f"{name}: ids differ from the CPU plain run")
    ones = tok.encode_batch(texts[:64], dropout=1.0)
    check([len(r) for r in ones] == [len(s) for s in samples[:64]],
          f"{name}: dropout=1.0 did not give single bytes")
    drop = tok.encode_batch(texts[:64], dropout=0.1, seed=5)
    check(all(tok.decode(r) == t for r, t in zip(drop, texts[:64])),
          f"{name}: a dropout=0.1 encode does not decode back")

    chained = {"calls": 0}
    orig = ed._encode_chained

    def counted(*a, **k):
        chained["calls"] += 1
        return orig(*a, **k)

    ed._encode_chained = counted
    try:
        long_text = long_sample.decode()
        long_ids = tok.encode_batch([long_text])[0]
        long_cpu = Tokenizer(model, device="cpu").encode_batch([long_text])[0]
    finally:
        ed._encode_chained = orig
    check(chained["calls"] == 2, f"{name}: the long sample was not chained")
    check(tok.decode(long_ids) == long_text,
          f"{name}: the chained sample does not decode back")
    check(long_ids == long_cpu, f"{name}: chained ids differ from CPU")
    log(f"[{name}] checks passed: decode, CPU plain run (64 samples), "
        f"dropout, chained {len(long_sample)}-byte sample")
    return {"bytes": total, "seconds": secs, "bytes_per_s": rate,
            "launches": launches, "phases": phases,
            "phases_run_seconds": secs_t, "profiled": busy,
            "tokens": sum(map(len, ids))}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, str(HERE))
    try:
        import tokengeex_tpu_torch
        from tokengeex_tpu_torch.ops import _build
        from tokengeex_tpu_torch.ops import lattice as lat
        from tokengeex_tpu_torch.ops import lattice_cuda as lc
        from tokengeex_tpu_torch.ops import lattice_cuda_fused as lcf
        from tokengeex_tpu_torch.ops.match_table import TokenTable
        from tokengeex_tpu_torch.train import estep_device as ed
        from tokengeex_tpu_torch.utils.packing import pack_samples
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    check(Path(tokengeex_tpu_torch.__file__).resolve().parents[1] == HERE,
          "imported a tokengeex_tpu_torch from outside this checkout")
    dev = torch.device("cuda", 0)

    # -- 1. environment + build --
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_logs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(build_logs)} in {build_s:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- corpus, vocabularies, main-path shapes --
    samples = build_corpus(CORPUS_BYTES)
    long_sample = b"\n".join(samples[:40])[: (1 << 15) + 7000]
    check(len(long_sample) > ed.MAX_ENCODE_WIDTH, "long sample too short")
    vocab_a = build_vocab(samples, 32768)
    vocab_b = build_vocab(samples, 4096)
    width = ed._pick_width(samples, None)
    rows = ed.GROUP_BYTES // width
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"corpus {sum(map(len, samples))} bytes in {len(samples)} samples; "
        f"pack width {width}, {rows} rows per group = {rows} threads in "
        f"{-(-rows // 32)} one-warp blocks on {sms} SMs")

    # -- 2. kernels against their plain versions --
    vit = check_viterbi_chunk(lc, ed.CHUNK, L_MAX, rows, dev)
    tbl_b = TokenTable.build(vocab_b)
    dt_b = lat.DeviceTables.from_table(tbl_b, dev)
    check(lat.has_vscan(dt_b) and dt_b.max_len == L_MAX, "4k table layout")
    check(not lat.has_vscan(lat.DeviceTables.from_table(
        TokenTable.build(vocab_a), dev)), "32k table must take the slab route")
    packed = pack_samples(samples, width=width)
    sub = next(g for _, g in ed._padded_groups(packed, width, ed.ROW_MULT))
    batch = lat.prepare_batch(sub, L_MAX, dev)
    fused = [check_fused(lat, lcf, dt_b, batch, d, dev) for d in (0.0, 0.1)]
    torch.cuda.empty_cache()

    # -- 3. end to end --
    kernels = {"viterbi_chunk": lc.viterbi_chunk,
               "fused_forward_chunk": lcf.fused_forward_chunk}
    e2e = {
        "a_32k_slab": run_config("a: 32768 tokens, slab route", vocab_a,
                                 samples, long_sample, "viterbi_chunk",
                                 kernels, dev),
        "b_4k_fused": run_config("b: 4096 tokens, fused route", vocab_b,
                                 samples, long_sample, "fused_forward_chunk",
                                 kernels, dev),
    }

    # -- 4. kernels line --
    line = {"kernels": [
        {"name": "viterbi_chunk", "route": "cuda",
         "source": "tokengeex_tpu_torch/csrc/viterbi_chunk.cu",
         "replaces": "tokengeex_tpu/ops/lattice_pallas.py:72",
         "launches": e2e["a_32k_slab"]["launches"]["viterbi_chunk"],
         "max_abs_err": vit["max_abs_err"], "ms": vit["ms"],
         "plain_ms": vit["plain_ms"], "bound_ms": vit["bound_ms"],
         "bound_by": vit["bound_by"], "library_ms": None},
        {"name": "fused_forward_chunk", "route": "cuda",
         "source": "tokengeex_tpu_torch/csrc/fused_forward.cu",
         "replaces": "tokengeex_tpu/ops/lattice_pallas_fused.py:377",
         "launches": e2e["b_4k_fused"]["launches"]["fused_forward_chunk"],
         "max_abs_err": max(f["max_abs_err"] for f in fused),
         "ms": fused[0]["ms"], "plain_ms": fused[0]["plain_ms"],
         "bound_ms": fused[0]["bound_ms"], "bound_by": fused[0]["bound_by"],
         "library_ms": None},
    ]}
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_seconds": build_s,
              "viterbi_chunk": vit, "fused_forward": fused, "encode": e2e,
              "kernels": line["kernels"]}
    out = HERE / "chiprun_out"
    try:
        out.mkdir(exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    except OSError:
        pass
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
