"""Device-backed batched Viterbi encode.

Counterpart of the encode half of tokengeex_tpu/train/estep_device.py:
samples are packed into fixed-shape (rows x width) byte batches
(utils/packing.py), processed in row groups, Viterbi-encoded on the
device (ops/lattice.py) and backtracked to token ids on the host.
Samples longer than MAX_ENCODE_WIDTH chain fixed-width windows with a
carried dp tail (_encode_chained).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import NoPathError
from ..models.unigram import Model
from ..ops import lattice as lat
from ..ops.match_table import TokenTable
from ..utils.device import resolve_device
from ..utils.packing import PackedBatch, pack_samples

# Position-chunk length of the slab route; width is padded to a multiple.
CHUNK = 512
# Target bytes per row group (rows_per_group * width).
GROUP_BYTES = 1 << 22
# Samples longer than this encode via chained fixed-width windows with a
# carried dp tail instead of inflating the pack width (see _encode_chained).
MAX_ENCODE_WIDTH = 1 << 15
# Row groups are padded to a multiple of this many rows; the same
# groups, padding and spans as the JAX package's kernel path.
ROW_MULT = 128


def _pick_width(samples: Sequence[bytes], max_snippet: Optional[int]) -> int:
    longest = max((len(s) for s in samples), default=1)
    if max_snippet is not None:
        longest = min(longest, max_snippet)
    width = max(CHUNK, -(-longest // CHUNK) * CHUNK)
    return width


def _row_groups(packed: PackedBatch, width: int):
    rows = packed.rows
    group = max(1, GROUP_BYTES // width)
    for start in range(0, rows, group):
        yield start, min(rows, start + group)


def pad_rows_to(packed: PackedBatch, rows: int) -> PackedBatch:
    """Append empty rows (no spans) up to `rows`."""
    extra = rows - packed.rows
    if extra <= 0:
        return packed
    W = packed.width
    return PackedBatch(
        bytes_arr=np.concatenate(
            [packed.bytes_arr, np.zeros((extra, W), np.uint8)]),
        sample_id=np.concatenate(
            [packed.sample_id, np.full((extra, W), -1, np.int32)]),
        is_start=np.concatenate(
            [packed.is_start, np.zeros((extra, W + 1), bool)]),
        end_index=np.concatenate(
            [packed.end_index, np.zeros((extra, W), np.int32)]),
        spans=list(packed.spans),
    )


def pad_rows_to_multiple(packed: PackedBatch, mult: int) -> PackedBatch:
    return pad_rows_to(packed, -(-packed.rows // mult) * mult)


def _padded_groups(packed: PackedBatch, width: int, pad_mult: int):
    """Row groups padded (a) to pad_mult and (b) the trailing group up to
    the leading groups' row count."""
    target = None
    for gi, (r0, r1) in enumerate(_row_groups(packed, width)):
        sub = _slice_packed(packed, r0, r1)
        if pad_mult > 1:
            sub = pad_rows_to_multiple(sub, pad_mult)
        if target is None:
            target = sub.rows
        elif sub.rows < target:
            sub = pad_rows_to_multiple(sub, target)
        yield gi, sub


def _slice_packed(packed: PackedBatch, r0: int, r1: int) -> PackedBatch:
    spans = [
        (r - r0, s, e, si, ci) for (r, s, e, si, ci) in packed.spans
        if r0 <= r < r1
    ]
    return PackedBatch(
        bytes_arr=packed.bytes_arr[r0:r1],
        sample_id=packed.sample_id[r0:r1],
        is_start=packed.is_start[r0:r1],
        end_index=packed.end_index[r0:r1],
        spans=spans,
    )


def _eff_backend(dt: lat.DeviceTables, probe: Optional[str]) -> str:
    """The fused probe kernel for tables small enough (has_vscan), the
    probed score slab + viterbi_chunk otherwise."""
    if probe in (None, "fast", "bucket", "em") and lat.has_vscan(dt):
        return "fused"
    return "slab"


def _drop_words(gen: torch.Generator, rows: int, cols: int, device):
    return torch.randint(-(2**31), 2**31 - 1, (rows, cols), generator=gen,
                         dtype=torch.int32, device=device)


def encode_corpus_device(
    model: Model,
    samples: Sequence[bytes],
    dropout: float = 0.0,
    seed: int = 0,
    table_hints: Optional[Tuple[int, int]] = None,
    probe: Optional[str] = None,
    max_width: Optional[int] = None,
    dtype=None,
    device=None,
    timer: Optional[lat.PhaseTimer] = None,
) -> List[List[int]]:
    """Viterbi-encode all samples on the device with the reference's
    semantics, NoPath included (src/model.rs:59-129). dropout > 0
    samples segmentations by skipping multi-byte candidates with
    probability dropout (src/model.rs:100), with coins drawn from a
    torch.Generator seeded with `seed`.

    device: a CUDA device by default; pass "cpu" to run the kernels'
    plain PyTorch versions. With no GPU and no device given this raises.
    Samples up to `max_width` (default MAX_ENCODE_WIDTH) pack into rows
    sized to the longest sample; longer samples chain fixed-width
    windows with a carried dp tail. probe selects the slab route's
    table layout ("bucket"/"fast"; "em" is an alias of "fast").
    `timer` collects the seconds per phase (tables, pack, prep, probe,
    kernel, readback, backtrack)."""
    lat.check_f32(dtype, probe)
    dev = resolve_device(device)
    with lat.phase(timer, "tables"):
        hb, hl = table_hints or (None, None)
        table = TokenTable.build(model.vocab, min_bits=hb, min_len=hl)
        dt = lat.DeviceTables.from_table(table, dev)
        index = lat.TokenIndex(model.oracle.token_to_ids)
    L = dt.max_len
    backend = _eff_backend(dt, probe)

    with lat.phase(timer, "pack"):
        cap = max_width or MAX_ENCODE_WIDTH
        cap = max(CHUNK, -(-cap // CHUNK) * CHUNK)
        long_idx = [si for si, s in enumerate(samples) if len(s) > cap]
        short = [s if len(s) <= cap else b"" for s in samples]
        width = _pick_width(short, None)
        packed = pack_samples(short, width=width, max_snippet=None)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if dropout > 0.0 else None)

    out: List[Optional[List[int]]] = [None] * len(samples)
    for _, sub in _padded_groups(packed, width, ROW_MULT):
        with lat.phase(timer, "prep"):
            batch = lat.prepare_batch(sub, L, dev)
            drop_u = (_drop_words(gen, sub.rows, batch.sid.shape[1], dev)
                      if gen is not None else None)
        dp, best_l = lat.viterbi(dt, batch, C=CHUNK, backend=backend,
                                 drop_u=drop_u, dropout=dropout, probe=probe,
                                 timer=timer)
        # Fetch backpointers as int8 and only the span-end dp values.
        with lat.phase(timer, "readback"):
            best_l_host = best_l.to(torch.int8).contiguous().cpu().numpy()
            rows_idx = [r for (r, _, _, _, _) in sub.spans]
            ends_idx = [max(e - 1, 0) for (_, _, e, _, _) in sub.spans]
            dp_ends = lat.pick_span_values(dp, rows_idx, ends_idx)
        with lat.phase(timer, "backtrack"):
            spans = lat.backtrack(sub, dp_ends, best_l_host, index)
        for (r, s, e, si, ci), ids in zip(sub.spans, spans):
            assert ci == 0, "encode packing must not chop samples"
            out[si] = ids

    if long_idx:
        chained = _encode_chained(
            model, dt, [(si, samples[si]) for si in long_idx], cap,
            backend=backend, dropout=dropout, seed=seed + 0x5151,
            probe=probe, device=dev, timer=timer)
        for si, ids in zip(long_idx, chained):
            out[si] = ids

    # Zero-length samples produce no packed span; they encode to [].
    return [ids if ids is not None else [] for ids in out]


def _encode_chained(
    model: Model,
    dt: lat.DeviceTables,
    long_samples: List[Tuple[int, bytes]],
    width: int,
    backend: str,
    dropout: float,
    seed: int,
    probe: Optional[str],
    device,
    timer: Optional[lat.PhaseTimer] = None,
) -> List[List[int]]:
    """Encode samples longer than the pack width by chaining fixed-width
    windows. Window k covers bytes [k*W, (k+1)*W); its device row is
    [last L bytes of window k-1 | body] with an origin-shifted hash
    stream (lat.prepare_chained_batch) so boundary-crossing tokens
    match, and the scan starts from the previous window's last L dp
    values passed through bit-exactly as the initial history. The host
    backtrack walks windows in reverse, jumping from non-positive
    positions into the previous window. Byte-exact against the
    reference's unchunked encode (src/model.rs:59-129): the dp depends
    only on the last L positions."""
    L = dt.max_len
    W = width
    R = len(long_samples)
    # Bound the row batch: every chained row costs transient device
    # memory for its hash streams and scores.
    max_rows = max(ROW_MULT, ((4 * GROUP_BYTES) // W // ROW_MULT) * ROW_MULT)
    if R > max_rows:
        out_parts: List[List[int]] = []
        for g0 in range(0, R, max_rows):
            out_parts.extend(_encode_chained(
                model, dt, long_samples[g0 : g0 + max_rows], width,
                backend=backend, dropout=dropout, seed=seed + g0,
                probe=probe, device=device, timer=timer))
        return out_parts
    Rp = -(-R // ROW_MULT) * ROW_MULT
    nchunks = max(-(-len(s) // W) for _, s in long_samples)
    gen = (torch.Generator(device=device).manual_seed(seed)
           if dropout > 0.0 else None)

    # Per sample, per window: host backpointers + end info.
    best_l_store: List[dict] = [dict() for _ in range(R)]
    end_info: List[Tuple[int, int, float]] = [(0, 0, 0.0)] * R  # (k, n, dp)
    carry_hist = torch.full((Rp, L), lat.NEG_INF, dtype=torch.float32,
                            device=device)
    mask = torch.zeros(Rp, dtype=torch.bool, device=device)

    for k in range(nchunks):
        with lat.phase(timer, "prep"):
            rows = np.zeros((Rp, L + W), dtype=np.uint8)
            n_valid = np.zeros(Rp, dtype=np.int32)
            has_tail = np.zeros(Rp, dtype=bool)
            active = []
            for r, (si, s) in enumerate(long_samples):
                a = k * W
                if a >= len(s):
                    continue
                b = min(a + W, len(s))
                if k > 0:
                    rows[r, :L] = np.frombuffer(s[a - L : a], dtype=np.uint8)
                    has_tail[r] = True
                rows[r, L : L + (b - a)] = np.frombuffer(s[a:b],
                                                         dtype=np.uint8)
                n_valid[r] = b - a
                active.append((r, b - a))
            batch = lat.prepare_chained_batch(rows, n_valid, has_tail, L, W,
                                              device)
            drop_u = (_drop_words(gen, Rp, batch.sid.shape[1], device)
                      if gen is not None else None)
        dp, best_l = lat.viterbi(dt, batch, C=CHUNK, backend=backend,
                                 drop_u=drop_u, dropout=dropout, probe=probe,
                                 carry=(mask, carry_hist), timer=timer)
        with lat.phase(timer, "readback"):
            best_l_host = best_l.to(torch.int8).cpu().numpy()
            dp_last = lat.pick_span_values(
                dp, [r for r, _ in active], [n - 1 for _, n in active])
            # Next carry: hist0[:, j] = dp[W - j] — the reversed dp tail,
            # bit-exact (dp[:, p-1] holds dp index p).
            tail = dp[:, W - L : W].flip(1)
            cont = np.zeros(Rp, dtype=bool)
            for i, (r, n) in enumerate(active):
                best_l_store[r][k] = best_l_host[r].copy()
                end_info[r] = (k, n, float(dp_last[i]))
                cont[r] = (k + 1) * W < len(long_samples[r][1])
            mask = torch.as_tensor(cont, device=device)
            carry_hist = torch.where(mask[:, None], tail,
                                     torch.tensor(lat.NEG_INF,
                                                  device=device))

    # Chained backtrack: positions <= 0 jump into the previous window.
    token_to_id = model.oracle.token_to_ids
    out: List[List[int]] = []
    with lat.phase(timer, "backtrack"):
        for r, (si, s) in enumerate(long_samples):
            k, n, dp_e = end_info[r]
            if not np.isfinite(dp_e):
                raise NoPathError(len(s), len(s))
            ids_rev: List[int] = []
            pos = n
            while True:
                bl = best_l_store[r][k]
                base = k * W
                while pos > 0:
                    length = int(bl[pos - 1])
                    a = base + pos
                    ids_rev.append(token_to_id[s[a - length : a]])
                    pos -= length
                if k == 0:
                    break
                pos += W
                k -= 1
            ids_rev.reverse()
            out.append(ids_rev)
    return out
