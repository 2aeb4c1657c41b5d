"""Device-backed corpus passes: batched Viterbi encode, the EM E-step,
Viterbi frequency counts, merge's pair counts and the prune round's
nbest(2) alternatives.

Counterpart of tokengeex_tpu/train/estep_device.py: samples are packed
into fixed-shape (rows x width) byte batches
(utils/packing.py) and processed in row groups on the device
(ops/lattice.py). Encode walks the backpointers and resolves the token
ids on the device (`lattice.walk_ids`) and reads back one flat id buffer
per group; samples longer than MAX_ENCODE_WIDTH chain fixed-width windows
with a carried dp tail and walk on the host (_encode_chained). The E-step
probes each group once, runs the forward and the backward DP over the
whole width in one scan each, and adds the token marginals into slot bins
that the host folds to expected counts per token. The merge loop
re-encodes one DeviceCorpus, packed and uploaded once, and counts
adjacent id pairs on the device, the walk's ids never leaving it
(count_pairs_arrays: a hash table, ops/pair_count.py). The pruner's
alternatives are one Viterbi pass over the vocabulary's own bytes with
each token's whole-token entry masked (prune_alternatives_device).

Under a process group (parallel/mesh.py, one rank a GPU) the corpus is
replicated: every rank packs every sample the same way and runs its block
of each row group's rows (`rank_groups`); the E-step's counts are summed
by one all_reduce a pass and encode's ids all_gathered, so every rank
returns the whole corpus's result.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import NoPathError
from ..models.unigram import Model
from ..ops import lattice as lat
from ..ops.match_table import TokenTable
from ..parallel import mesh as pmesh
from ..utils.device import resolve_device
from ..utils.packing import PackedBatch, pack_samples
from ..utils.task import Task

# Position-chunk length of the slab route's probe; width is padded to a
# multiple.
CHUNK = 512
# Target bytes per row group (rows_per_group * width).
GROUP_BYTES = 1 << 22
# Samples longer than this encode via chained fixed-width windows with a
# carried dp tail instead of inflating the pack width (see _encode_chained).
MAX_ENCODE_WIDTH = 1 << 15
# Row groups are padded to a multiple of this many rows; the same
# groups, padding and spans as the JAX package's kernel path.
ROW_MULT = 128
# f32 EM snippet cap. The reference chops E-step samples at 81920 bytes
# (src/prune.rs:75) with f64 lattices; in f32 the forward/backward
# log-probs reach ~90k nats at that length and their rounding drift
# scales the marginals by e^(noise). 1024 bytes bound the drift to ~1 %
# even at ~10 nats per byte (PARITY.md "known deviations"); the f64 route
# keeps the caller's cap (the reference's 81920).
DEVICE_EM_SNIPPET = 1024


def _em_snippet_cap(max_snippet: Optional[int],
                    dtype: Optional[torch.dtype] = None) -> Optional[int]:
    if max_snippet is None or dtype == torch.float64:
        return max_snippet
    return min(max_snippet, DEVICE_EM_SNIPPET)


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


def _padded_groups(packed: PackedBatch, width: int, pad_mult: int):
    """Row groups padded (a) to pad_mult and (b) the trailing group up to
    the leading groups' row count."""
    target = None
    for gi, (r0, r1) in enumerate(_row_groups(packed, width)):
        sub = pmesh.slice_rows(packed, r0, r1)
        if pad_mult > 1:
            sub = pmesh.pad_rows_to_multiple(sub, pad_mult)
        if target is None:
            target = sub.rows
        elif sub.rows < target:
            sub = pmesh.pad_rows_to_multiple(sub, target)
        yield gi, sub


def rank_groups(packed: PackedBatch, width: int, local: bool = False):
    """(gi, rows, lo, block) of each padded row group: its row count and
    this rank's block of its rows, from group row `lo` (`mesh.local_block`;
    the whole group at world size 1 or with `local`, the rows of this
    rank's own samples). Every rank walks every group of a replicated
    corpus, so each pass's collectives come after the loop and group
    counts need no agreement, nor pack widths (the JAX package's compile
    shapes, its _local_group_list)."""
    for gi, sub in _padded_groups(packed, width, ROW_MULT):
        block, lo = (sub, 0) if local else pmesh.local_block(sub)
        yield gi, sub.rows, lo, block


def block_drop_words(gen: torch.Generator, rows: int, lo: int,
                     block: PackedBatch, cols: int, device) -> torch.Tensor:
    """A block's dropout words: the whole group's `rows` drawn from `gen`,
    as one process draws them, then the block's rows (the rows padded for
    the world size get zeros; they hold no span). So a run on N ranks at
    dropout > 0 sees the single-process run's coins."""
    words = _drop_words(gen, rows, cols, device)
    if lo + block.rows > rows:
        words = torch.cat([words, torch.zeros(
            (lo + block.rows - rows, cols), dtype=words.dtype,
            device=device)])
    return words[lo : lo + block.rows]


# Device bytes a DeviceCorpus may hold in cached inputs (~2 bytes per
# corpus byte), as the JAX package's default.
INPUT_CACHE_BYTES = 2 << 30


class DeviceCorpus:
    """A corpus packed once for encode passes. Each row group's compact
    inputs (bytes and boundary flags, ~2 bytes per corpus byte), its chain
    bounds and its walk's span index stay on the device under `budget`
    bytes; they do not depend on the vocabulary, so one corpus serves
    every model, as the merge loop needs when it re-encodes the corpus
    after every batch of merges. Under a process group (parallel/mesh.py)
    the corpus is replicated: every rank packs every sample and keeps its
    block of each group's rows (`groups` holds the blocks, `blocks` each
    group's row count and first row); local=True keeps every row of this
    rank's own samples, for an encode with no collective."""

    def __init__(self, samples: Sequence[bytes],
                 max_width: Optional[int] = None, device=None,
                 budget: int = INPUT_CACHE_BYTES, local: bool = False):
        self.dev = resolve_device(device)
        self.samples = samples
        self.req_max_width = max_width
        self.local = local
        cap = max_width or MAX_ENCODE_WIDTH
        self.cap = max(CHUNK, -(-cap // CHUNK) * CHUNK)
        self.long_idx = [si for si, s in enumerate(samples)
                         if len(s) > self.cap]
        short = [s if len(s) <= self.cap else b"" for s in samples]
        self.width = _pick_width(short, None)
        self.packed = pack_samples(short, width=self.width, max_snippet=None)
        self.groups = []
        self.blocks = {}
        for gi, rows, lo, block in rank_groups(self.packed, self.width,
                                               local):
            self.groups.append((gi, block))
            self.blocks[gi] = (rows, lo)
        self.budget = budget
        self.used = 0
        # A bound of the distinct pairs the last pair count held
        # (count_pairs_arrays):
        # the next pass sizes its table from it.
        self.pair_hint: Optional[int] = None
        self._inputs: dict = {}
        self._chains: dict = {}
        self._walks: dict = {}

    def batch(self, gi: int, sub: PackedBatch, L: int) -> lat.DeviceBatch:
        """Group gi's DeviceBatch, from its inputs cached on the device."""
        if gi in self._inputs:
            gbytes, gflags = self._inputs[gi]
        else:
            gbytes, gflags = lat.prepare_batch_inputs(sub, self.dev)
            size = gbytes.numel() + gflags.numel()
            if self.used + size <= self.budget:
                self._inputs[gi] = (gbytes, gflags)
                self.used += size
        return lat.prepare_batch_from_inputs(gbytes, gflags, L)

    def chains(self, gi: int, batch: lat.DeviceBatch):
        """Group gi's chain bounds, kept beside its cached inputs."""
        if gi in self._chains:
            return self._chains[gi]
        chains = lat.chain_bounds(batch)
        if gi in self._inputs:
            self._chains[gi] = chains
        return chains

    def walk_index(self, gi: int, sub: PackedBatch) -> lat.WalkIndex:
        """Group gi's span index for the walk, kept beside its cached
        inputs."""
        if gi in self._walks:
            return self._walks[gi]
        index = lat.walk_index(sub.spans, sub.rows, self.width, self.dev)
        if gi in self._inputs:
            self._walks[gi] = index
        return index


def _eff_backend(dt: lat.DeviceTables, probe: Optional[str],
                 dtype: Optional[torch.dtype] = None) -> str:
    """The fused probe kernel for tables small enough (has_vscan) at f32
    with the fast probe, the probed score cache + viterbi_scan otherwise
    (the f64 / exact route among them)."""
    if dtype in (None, torch.float32) and \
            probe in (None, "fast", "bucket", "em") and lat.has_vscan(dt):
        return "fused"
    return "slab"


def _drop_words(gen: torch.Generator, rows: int, cols: int, device):
    return torch.randint(-(2**31), 2**31 - 1, (rows, cols), generator=gen,
                         dtype=torch.int32, device=device)


def _encode_setup(model: Model, samples: Sequence[bytes],
                  table_hints: Optional[Tuple[int, int]],
                  probe: Optional[str], max_width: Optional[int],
                  dtype: torch.dtype, dev: torch.device,
                  timer: Optional[lat.PhaseTimer],
                  table: Optional[TokenTable],
                  corpus: Optional["DeviceCorpus"], local: bool):
    """An encode pass's (DeviceTables, Viterbi route, DeviceCorpus): the
    tables built from `table_hints` unless `table` is given, and `corpus`
    unless it was packed from other samples, at another width or for other
    rows (its spans would be misassigned), else one packed now."""
    with lat.phase(timer, "tables"):
        if table is None:
            hb, hl = table_hints or (None, None)
            table = TokenTable.build(model.vocab, min_bits=hb, min_len=hl)
        dt = lat.DeviceTables.from_table(table, dev, dtype)
    if corpus is not None and (corpus.samples is not samples
                               or corpus.req_max_width != max_width
                               or corpus.dev != dev
                               or corpus.local != local):
        corpus = None
    with lat.phase(timer, "pack"):
        if corpus is None:
            corpus = DeviceCorpus(samples, max_width, dev, budget=0,
                                  local=local)
    return dt, _eff_backend(dt, probe, dtype), corpus


def _viterbi_groups(dt: lat.DeviceTables, corpus: "DeviceCorpus",
                    backend: str, gen: Optional[torch.Generator],
                    dropout: float, probe: Optional[str],
                    dtype: torch.dtype, timer: Optional[lat.PhaseTimer]):
    """Each row group of `corpus` through the route's Viterbi kernel:
    (sub, batch, index, dp, best_l), the group's packed rows, its
    DeviceBatch, its walk index and the backpointers, on the device."""
    dev = corpus.dev
    for gi, sub in corpus.groups:
        with lat.phase(timer, "prep"):
            batch = corpus.batch(gi, sub, dt.max_len)
            chains = corpus.chains(gi, batch)
            index = corpus.walk_index(gi, sub)
            drop_u = (block_drop_words(gen, *corpus.blocks[gi], sub,
                                       batch.sid.shape[1], dev)
                      if gen is not None else None)
        dp, best_l = lat.viterbi(dt, batch, C=CHUNK, dtype=dtype,
                                 backend=backend, drop_u=drop_u,
                                 dropout=dropout, probe=probe, timer=timer,
                                 chains=chains)
        assert all(sp[4] == 0 for sp in sub.spans), \
            "encode packing must not chop samples"
        yield sub, batch, index, dp, best_l


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
    table: Optional[TokenTable] = None,
    corpus: Optional["DeviceCorpus"] = None,
    local: bool = False,
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
    table layout ("bucket"/"fast"; "em" is an alias of "fast"; "exact"
    checks both fingerprints and the length and gathers scores by id).
    dtype float64 is the f64 / exact conformance route: the exact probe,
    f64 scores and the double `viterbi_scan`, the chained windows' dp
    tail carried in f64.
    `timer` collects the seconds per phase (tables, pack, prep, probe,
    kernel, walk, readback, split (with the ids' gather); backtrack for
    chained samples). `table`
    is a TokenTable bound to `model` to use instead of building one (a
    training session's). `corpus` is a DeviceCorpus packed from these very
    samples (same `max_width`), whose groups' inputs stay on the device.

    Under a process group (parallel/mesh.py) the corpus is replicated:
    every rank walks its block of each row group's rows, the blocks' flat
    ids are all_gathered as int32 tensors, and every rank returns every
    sample's ids, so every rank must call it (the JAX package's sharded
    Viterbi and allgather). A NoPath on any rank's rows raises on every
    rank. Samples past the pack cap take the chained encode on every rank,
    as in the JAX package. local=True encodes this rank's own samples with
    no collective (a corpus shard's, the JAX package's force_local)."""
    dtype = dtype or torch.float32
    dev = resolve_device(device)
    dt, backend, corpus = _encode_setup(model, samples, table_hints, probe,
                                        max_width, dtype, dev, timer, table,
                                        corpus, local)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if dropout > 0.0 else None)

    sids, ntoks, flats = [], [], []
    for sub, batch, index, dp, best_l in _viterbi_groups(
            dt, corpus, backend, gen, dropout, probe, dtype, timer):
        # The backpointers stay on the device: the walk reads back the
        # span-end dp values, the per-span token counts and the ids.
        flat, ntok = lat.walk_ids(dt, batch, dp, best_l, index, timer=timer)
        sids.append(np.asarray([sp[3] for sp in sub.spans], np.int64))
        ntoks.append(ntok)
        flats.append(flat)
    with lat.phase(timer, "split"):
        out: List[Optional[List[int]]] = [None] * len(samples)
        _place_ids(out, samples, sids, ntoks, flats, dt.vocab_size,
                   gather=not corpus.local)

    if corpus.long_idx:
        long_idx = corpus.long_idx
        chained = _encode_chained(
            model, dt, [(si, samples[si]) for si in long_idx], corpus.cap,
            backend=backend, dropout=dropout, seed=seed + 0x5151,
            probe=probe, device=dev, timer=timer, dtype=dtype)
        for si, ids in zip(long_idx, chained):
            out[si] = ids

    # Zero-length samples produce no packed span; they encode to [].
    return [ids if ids is not None else [] for ids in out]


def _cat(parts, dtype) -> np.ndarray:
    return (np.concatenate(parts).astype(dtype) if parts
            else np.zeros(0, dtype))


def _place_ids(out: list, samples, sids, ntoks, flats, V: int,
               gather: bool) -> None:
    """Split the walked ids into `out[sample]` once: this rank's groups'
    (sample ids, tokens per span (-1: no path), flat ids), and with
    `gather` every rank's, all_gathered as one int32 tensor a rank. Every
    rank then raises the same NoPath or mismatch."""
    si, nt, ids = _cat(sids, np.int64), _cat(ntoks, np.int64), \
        _cat(flats, np.int32)
    if gather:
        payload = np.concatenate([[si.size], si, nt, ids]).astype(np.int32)
        ranks = []
        for p in pmesh.allgather_ragged(payload):
            n = int(p[0])
            ranks.append((p[1 : 1 + n], p[1 + n : 1 + 2 * n], p[1 + 2 * n :]))
        si, nt, ids = (np.concatenate(col) for col in zip(*ranks))
    dead = np.nonzero(nt < 0)[0]
    if dead.size:
        n = len(samples[int(si[dead[0]])])
        raise NoPathError(n, n)
    if (ids >= V).any():
        raise KeyError("walk: a matched span is not a vocabulary token "
                       "(model/table mismatch)")
    parts = np.split(ids.astype(np.int64), np.cumsum(nt)[:-1])
    for k, part in zip(si.tolist(), parts):
        out[k] = part.tolist()


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
    dtype: torch.dtype = torch.float32,
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
                probe=probe, device=device, timer=timer, dtype=dtype))
        return out_parts
    Rp = -(-R // ROW_MULT) * ROW_MULT
    nchunks = max(-(-len(s) // W) for _, s in long_samples)
    gen = (torch.Generator(device=device).manual_seed(seed)
           if dropout > 0.0 else None)

    # Per sample, per window: host backpointers + end info.
    best_l_store: List[dict] = [dict() for _ in range(R)]
    end_info: List[Tuple[int, int, float]] = [(0, 0, 0.0)] * R  # (k, n, dp)
    carry_hist = torch.full((Rp, L), lat.NEG_INF, dtype=dtype,
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
        dp, best_l = lat.viterbi(dt, batch, C=CHUNK, dtype=dtype,
                                 backend=backend, drop_u=drop_u,
                                 dropout=dropout, probe=probe,
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
    token_to_id = model.token_to_ids
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


def run_e_step_device(
    model: Model,
    samples: Sequence[bytes],
    dropout: float,
    max_snippet: Optional[int],
    task: Optional[Task] = None,
    dtype=None,
    seed: int = 0,
    probe: Optional[str] = None,
    table_hints: Optional[Tuple[int, int]] = None,
    device=None,
    timer: Optional[lat.PhaseTimer] = None,
) -> np.ndarray:
    """Expected token counts over the corpus (reference:
    src/prune.rs:64-120), as (V,) float64.

    Samples are chopped into snippets of at most
    min(max_snippet, DEVICE_EM_SNIPPET) bytes (max_snippet itself at
    dtype float64, the f64 / exact conformance route: the exact probe,
    f64 scores, the double scans and an f64 scatter into token-id bins)
    and packed; each row group
    is probed once (`match_cache`), then runs the forward DP and the
    backward DP with the token marginals (one whole-width scan each, over
    the group's chain bounds, made once per group) and adds the marginals
    into slot bins on the device. dropout > 0 skips multi-byte candidates
    with coins from a torch.Generator seeded with `seed`, which both scans
    draw in their kernels from the dropout-free cache. Every snippet's
    normaliser is checked once, after the pass: a non-finite one (a
    snippet no token sequence covers) raises
    ValueError. device: a CUDA device by default, "cpu" for the kernels'
    plain versions; without a GPU and without `device` this raises.
    `timer` collects the seconds per phase (tables, pack, prep, probe,
    forward, backward, scatter, fold). Under a process group
    (parallel/mesh.py) the corpus is replicated: every rank runs its block
    of each group's rows (its coins sliced from the group's, so the counts
    equal one process's up to the summation order), and one
    all_reduce(SUM) of the folded counts ends the pass on every rank (the
    JAX package's sharded E-step and psum)."""
    dtype = dtype or torch.float32
    dev = resolve_device(device)
    with lat.phase(timer, "tables"):
        hb, hl = table_hints or (None, None)
        table = TokenTable.build(model.vocab, min_bits=hb, min_len=hl)
        dt = lat.DeviceTables.from_table(table, dev, dtype)
    L = dt.max_len
    mode = probe or lat._probe_mode(dt, dtype)
    with lat.phase(timer, "pack"):
        max_snippet = _em_snippet_cap(max_snippet, dtype)
        width = _pick_width(samples, max_snippet)
        packed = pack_samples(samples, width=width, max_snippet=max_snippet)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if dropout > 0.0 else None)

    acc = None
    z_parts: List[torch.Tensor] = []
    z_spans: list = []
    for _, rows, lo, sub in rank_groups(packed, width):
        with lat.phase(timer, "prep"):
            batch = lat.prepare_batch(sub, L, dev)
            drop_u = (block_drop_words(gen, rows, lo, sub,
                                       batch.sid.shape[1], dev)
                      if gen is not None else None)
        # Probe once per group; forward and backward share the cache,
        # rows * width * L * 8 bytes: 512 MiB at L = 16.
        with lat.phase(timer, "probe"):
            cache = lat.match_cache(dt, batch, C=CHUNK, probe=mode,
                                    dtype=dtype)
            chains = lat.chain_bounds(batch)
        A = lat.forward(dt, batch, cache, C=CHUNK, drop_u=drop_u,
                        dropout=dropout, timer=timer, chains=chains)
        exp_g = lat.backward_expected(dt, batch, A, cache, C=CHUNK,
                                      drop_u=drop_u, dropout=dropout,
                                      probe=mode, timer=timer,
                                      chains=chains)
        acc = exp_g if acc is None else acc.add_(exp_g)
        del cache
        if sub.spans:
            z_parts.append(lat.pick_span_values_device(
                A, [sp[0] for sp in sub.spans], [sp[2] for sp in sub.spans]))
            z_spans.extend(sub.spans)
        if task is not None:
            task.record(sum(e - s for (_, s, e, _, _) in sub.spans),
                        len({sp[3] for sp in sub.spans}))

    with lat.phase(timer, "fold"):
        expected = (lat.fold_expected(dt, acc, mode) if acc is not None
                    else np.zeros(dt.vocab_size, dtype=np.float64))
        z = (torch.cat(z_parts).cpu().numpy() if z_parts
             else np.zeros(0, np.float32))
    # Per-snippet normaliser check (reference: src/prune.rs:90-96), read
    # back once for the whole pass and agreed by every rank before any
    # raises.
    bad = np.nonzero(~np.isfinite(z))[0]
    si, zk = ((z_spans[int(bad[0])][3], float(z[bad[0]])) if bad.size
              else (-1, 0.0))
    si, zk = pmesh.allgather_fail(si, zk)
    if si >= 0:
        raise ValueError(
            f"normalization constant is not finite "
            f"(z={zk}, sample={si}, len={len(samples[si])})")
    return pmesh.all_reduce_counts(expected)


def count_frequencies_device(
    model: Model,
    samples: Sequence[bytes],
    task: Optional[Task] = None,
    table_hints: Optional[Tuple[int, int]] = None,
    device=None,
) -> np.ndarray:
    """Viterbi token frequencies (reference: src/prune.rs:205-246):
    `encode_corpus_device`, then the ids counted on the host."""
    encoded = encode_corpus_device(model, samples, table_hints=table_hints,
                                   device=device)
    ids = [np.asarray(r, dtype=np.int64) for r in encoded if r]
    freqs = np.bincount(np.concatenate(ids) if ids
                        else np.zeros(0, np.int64),
                        minlength=model.vocab_size())
    if task is not None:
        task.record(sum(len(s) for s in samples), len(samples))
    return freqs.astype(np.int64)


def _chained_pair_keys(ids: Sequence[List[int]]) -> np.ndarray:
    """The int64 keys (a << 32) | b of the adjacent ids of each list."""
    keys = [(a[:-1] << 32) | a[1:]
            for a in (np.asarray(r, np.int64) for r in ids) if a.size > 1]
    return np.concatenate(keys) if keys else np.zeros(0, np.int64)


# Failure codes of a pair count, by precedence (the largest is raised):
# a model/table mismatch, a span with no path, a table overflow.
_PAIRS_MISMATCH, _PAIRS_NOPATH, _PAIRS_OVERFLOW = 1, 2, 3


def _raise_pairs_failure(code: int, length: float) -> None:
    if code == _PAIRS_OVERFLOW:
        raise RuntimeError("pair count: a table insert overflowed")
    if code == _PAIRS_NOPATH:
        raise NoPathError(int(length), int(length))
    if code == _PAIRS_MISMATCH:
        raise KeyError("walk: a matched span is not a vocabulary token "
                       "(model/table mismatch)")


def count_pairs_arrays(model: Model, samples: Sequence[bytes],
                       task: Optional[Task] = None,
                       table_hints: Optional[Tuple[int, int]] = None,
                       corpus: Optional[DeviceCorpus] = None,
                       device=None, timer: Optional[lat.PhaseTimer] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Adjacent id pair counts of the device encode (reference:
    src/merge.rs:53-84) as arrays: (keys, counts), int64 (P,) each, key =
    (a << 32) | b, by descending count, equal counts in ascending key
    order. table_hints (min_bits, min_len) pins the table's shape across a
    merge loop's growing vocabulary; `corpus` is the loop's DeviceCorpus
    over `samples`.

    Each row group's ids stay on the device: the walk writes them
    (`lattice.walk_ids_device`) and one launch inserts the group's pairs
    into a hash table on the card (ops/pair_count.py `PairTable`, the
    kernels' plain twin on the CPU). The table is sized at twice a bound
    of the distinct keys: the corpus's `pair_hint` (the last pass's
    distinct count), else the keys the last group added, else (a run's
    first group) its pairs; one scalar readback a group (the group's
    pairs, its dead spans, the table's distinct keys, spilled rows and
    flags) grows it and drains the rows that found no slot. Samples past
    the pack cap take the chained encode and their pairs are inserted as
    rows. The table is compacted and sorted on the device; only the
    sorted arrays are read back. A span with no
    path raises NoPathError (the first such sample's length), an id that
    is no vocabulary token KeyError, as the encode does.

    Under a process group each rank counts its block of every row group,
    and the ranks' compacted tables are all_gathered and inserted into a
    fresh table on every rank, after every rank has learnt of any rank's
    failure; a local corpus counts its own samples with no collective.
    `timer` collects the encode's phases and the count's (pairs: inserts,
    compaction and sort; readback)."""
    from ..ops.pair_count import PairTable

    dev = resolve_device(corpus.dev if corpus is not None and device is None
                         else device)
    dt, backend, corpus = _encode_setup(
        model, samples, table_hints, None,
        corpus.req_max_width if corpus is not None else None,
        torch.float32, dev, timer, None, corpus,
        corpus.local if corpus is not None else False)
    V = dt.vocab_size
    hint = corpus.pair_hint
    table = PairTable(dev, hint or 0)
    code, length, held = 0, 0, None
    for sub, batch, index, dp, best_l in _viterbi_groups(
            dt, corpus, backend, None, 0.0, None, torch.float32, timer):
        if index.n == 0:
            continue
        flat, ntok, incl, dead = lat.walk_ids_device(dt, batch, dp, best_l,
                                                     index, timer=timer)
        with lat.phase(timer, "readback"):
            (pairs, any_dead, first, distinct, overflow, bad, spilled, *_
             ) = table.read(incl[-1] - (ntok > 0).sum(), dead.any(),
                            dead.to(torch.int32).argmax())
        if overflow:
            code = _PAIRS_OVERFLOW
        elif any_dead and code < _PAIRS_NOPATH:
            code, length = _PAIRS_NOPATH, len(samples[sub.spans[first][3]])
        elif bad and code < _PAIRS_MISMATCH:
            code = _PAIRS_MISMATCH
        if code:
            continue  # the pass raises: no more inserts
        new = (max(hint - distinct, 0) if hint is not None
               else pairs if held is None else distinct - held)
        with lat.phase(timer, "pairs"):
            table.reserve(min(new, pairs), distinct, spilled)
            table.insert_ids(flat, incl, V)
        held = distinct
    with lat.phase(timer, "readback"):
        distinct, overflow, bad, spilled, *_ = table.read()
    code = max(code, _PAIRS_OVERFLOW if overflow else
               _PAIRS_MISMATCH if bad else 0)
    gather = pmesh.process_count() > 1 and not corpus.local
    if gather:
        code, length = pmesh.allgather_fail(code, length)
    _raise_pairs_failure(code, length)
    corpus.pair_hint = distinct + spilled
    known = (distinct, spilled)  # the state the compaction finds, if read

    if gather:
        with lat.phase(timer, "pairs"):
            keys, counts = table.compact(*known)
        with lat.phase(timer, "readback"):
            rows = torch.cat([keys, counts]).cpu().numpy().view(np.int32)
        parts = [p.view(np.int64).reshape(2, -1)
                 for p in pmesh.allgather_ragged(rows)]
        with lat.phase(timer, "pairs"):
            table = PairTable(dev, sum(p.shape[1] for p in parts))
            both = torch.from_numpy(np.concatenate(parts, axis=1)).to(dev)
            table.insert_weighted(both[0].contiguous(), both[1].contiguous())
        known = ()
    if corpus.long_idx:
        chained = _encode_chained(
            model, dt, [(si, samples[si]) for si in corpus.long_idx],
            corpus.cap, backend=backend, dropout=0.0, seed=0x5151,
            probe=None, device=dev, timer=timer)
        with lat.phase(timer, "pairs"):
            keys = torch.from_numpy(_chained_pair_keys(chained)).to(dev)
            table.reserve(keys.numel())
            table.insert_weighted(keys, torch.ones_like(keys))
        known = ()
    if task is not None:
        task.record(sum(len(s) for s in samples), len(samples))
    with lat.phase(timer, "pairs"):
        keys, counts = table.compact(*known)
        keys, order = torch.sort(keys)
        counts, order2 = torch.sort(counts[order], descending=True,
                                    stable=True)
        keys = keys[order2]
    with lat.phase(timer, "readback"):
        return keys.cpu().numpy(), counts.cpu().numpy()


def count_pairs_device(model: Model, samples: Sequence[bytes],
                       task: Optional[Task] = None,
                       table_hints: Optional[Tuple[int, int]] = None,
                       corpus: Optional[DeviceCorpus] = None,
                       device=None, timer: Optional[lat.PhaseTimer] = None
                       ) -> List[Tuple[Tuple[int, int], int]]:
    """Adjacent id pair counts of the device encode (reference:
    src/merge.rs:53-84), [((a, b), count)] by descending count, equal
    counts in ascending (a, b) order: `count_pairs_arrays`, then the list
    built once (`timer`: its phases and list)."""
    keys, counts = count_pairs_arrays(model, samples, task, table_hints,
                                      corpus, device, timer)
    with lat.phase(timer, "list"):
        return list(zip(zip((keys >> 32).tolist(),
                            (keys & 0xFFFFFFFF).tolist()), counts.tolist()))


# Chain length of the alternatives' Viterbi scan: every token of the
# vocabulary is a sample of at most L bytes, so each row is cut into a
# chain every ALT_SEGMENT positions (at the next token's start) and a
# chain runs at most ALT_SEGMENT + L steps, where one chain per row
# (SCAN_SEGMENT >= the width) would run 512.
ALT_SEGMENT = 64


def _pack_tokens(values: Sequence[bytes]) -> PackedBatch:
    """Every non-empty token as one sample of a PackedBatch `_pick_width`
    would give them (CHUNK columns, the probe's chunk and the least width
    there is, for tokens of up to CHUNK bytes): the tokens of length n
    fill rows of width // n, in id order, rows of shorter tokens first.
    Unlike `pack_samples`' best-fit search, Python per sample, the layout
    needs no search and is built with numpy."""
    lens = np.fromiter(map(len, values), np.int64, len(values))
    width = max(CHUNK, -(-int(lens.max(initial=1)) // CHUNK) * CHUNK)
    live = np.nonzero(lens > 0)[0]
    order = live[np.argsort(lens[live], kind="stable")]
    n = lens[order]
    uniq, first, count = np.unique(n, return_index=True, return_counts=True)
    g = np.repeat(np.arange(uniq.size), count)
    per_row = width // uniq
    row_base = np.concatenate([[0], np.cumsum(-(-count // per_row))])
    rank = np.arange(order.size) - first[g]
    row = row_base[g] + rank // per_row[g]
    start = (rank % per_row[g]) * n
    rows = -(-max(int(row_base[-1]), 1) // 8) * 8  # pack_samples' multiple
    nbytes = int(n.sum())
    # Every byte's flat cell: its token's first cell, then its offset.
    first_byte = np.cumsum(n) - n
    cell = (np.repeat(row * width + start, n)
            + np.arange(nbytes) - np.repeat(first_byte, n))
    bytes_arr = np.zeros((rows, width), np.uint8)
    sample_id = np.full((rows, width), -1, np.int32)
    end_index = np.zeros((rows, width), np.int32)
    is_start = np.zeros((rows, width + 1), bool)
    bytes_arr.flat[cell] = np.frombuffer(
        b"".join([values[i] for i in order.tolist()]), np.uint8)
    sample_id.flat[cell] = np.repeat(np.arange(order.size, dtype=np.int32), n)
    end_index.flat[cell] = np.repeat(start + n, n)
    is_start[row, start] = True
    spans = list(zip(row.tolist(), start.tolist(), (start + n).tolist(),
                     order.tolist(), [0] * order.size))
    return PackedBatch(bytes_arr, sample_id, is_start, end_index, spans)


def alternative_groups(model: Model, dt: lat.DeviceTables,
                       timer: Optional[lat.PhaseTimer] = None):
    """The inputs of the alternatives' masked Viterbi pass, per row group
    of the vocabulary's own bytes (`_pack_tokens`): (sub, batch, cache,
    chains, index, whole), the group's packed rows, its DeviceBatch on
    dt's device, the exact probe's start-indexed (W, L, B) cache at dt's
    float type with every token's whole-span entry (column = its start,
    row = its length - 1, lane = its row) set to the probe's miss value
    -inf, its chain bounds cut every ALT_SEGMENT positions, its walk index
    and the whole-span entries' scores before the mask, one a span: the
    score of the id the whole token resolves to. Every group holds the
    whole group's rows (no collective)."""
    dev = dt.scores.device
    with lat.phase(timer, "pack"):
        packed = _pack_tokens([t.value for t in model.vocab])
    for _, _, _, sub in rank_groups(packed, packed.width, local=True):
        with lat.phase(timer, "prep"):
            batch = lat.prepare_batch(sub, dt.max_len, dev)
            chains = lat.chain_bounds(batch, ALT_SEGMENT)
            index = lat.walk_index(sub.spans, sub.rows, packed.width, dev)
        with lat.phase(timer, "probe"):
            cache = lat.match_cache(dt, batch, C=CHUNK, probe="exact",
                                    slots=False, dtype=dt.scores.dtype)[0]
            entry = (index.starts.long(),
                     (index.ends - index.starts - 1).long(),
                     index.rows.long())
            whole = cache[entry]
            cache.index_put_(entry, torch.tensor(
                lat.NEG_INF, dtype=cache.dtype, device=dev))
        yield sub, batch, cache, chains, index, whole


def prune_alternatives_device(model: Model,
                              table: Optional[TokenTable] = None,
                              device=None,
                              timer: Optional[lat.PhaseTimer] = None
                              ) -> Tuple[np.ndarray, List[List[int]]]:
    """(always_keep (V,) bool, alternatives: list[list[int]]) of every
    token (reference: src/prune.rs:179-203), the counterpart of the JAX
    package's native `NativeModel.prune_alternatives`, in one masked f64
    Viterbi pass over the vocabulary's own bytes on the device: each token
    is a sample whose whole-token entry is masked (`alternative_groups`),
    so the double `viterbi_scan` finds M, the best segmentation without
    the whole token W, and `walk_ids` walks it (-1 tokens: no M). Then,
    with s_W the whole-token entry's score (that of the id the token
    resolves to, the last duplicate's) and s_M M's f64 sum, in the
    oracle's forward order: no M keeps the token with no alternatives;
    s_W >= s_M keeps it with M's ids; s_W < s_M neither keeps it nor
    gives alternatives. This is `nbest(2)`'s rule: on an exact tie of s_W
    and s_M the A* pops W first, and the scan's ties go to the longest
    token, W. Where two multi-token paths tie for M, the A* and the scan
    may pick either (the reference breaks such ties arbitrarily).

    `table` is a TokenTable bound to `model` (the pruner's session's), or
    one is built. device: a CUDA device by default, "cpu" for the
    kernels' plain versions. Under a process group every rank computes
    the whole answer. `timer` collects the seconds per phase (tables,
    pack, prep, probe, kernel, walk, readback, decide)."""
    dev = resolve_device(device)
    with lat.phase(timer, "tables"):
        if table is None:
            table = TokenTable.build(model.vocab)
        dt = lat.DeviceTables.from_table(table, dev, torch.float64)
    sids, ntoks, flats, s_m, s_w = [], [], [], [], []
    for sub, batch, cache, chains, index, whole in alternative_groups(
            model, dt, timer):
        dp, best_l = lat._scan_viterbi(dt, batch, cache=cache, chains=chains,
                                       timer=timer)
        flat, ntok = lat.walk_ids(dt, batch, dp, best_l, index, timer=timer)
        with lat.phase(timer, "readback"):
            s_m.append(index.dp_ends(dp).cpu().numpy())
            s_w.append(whole.cpu().numpy())
        sids.append(np.asarray([sp[3] for sp in sub.spans], np.int64))
        ntoks.append(ntok)
        flats.append(flat)
    with lat.phase(timer, "decide"):
        V = model.vocab_size()
        sid, nt = _cat(sids, np.int64), _cat(ntoks, np.int64)
        s_m, s_w = _cat(s_m, np.float64), _cat(s_w, np.float64)
        live = nt >= 0
        always_keep = np.ones(V, dtype=bool)
        always_keep[sid[live & (s_w < s_m)]] = False
        # Each token's slice of the flat ids: M's where it is kept with M,
        # empty otherwise.
        with_m = live & (s_w >= s_m)
        ends = np.cumsum(np.maximum(nt, 0))
        lo, hi = np.zeros(V, np.int64), np.zeros(V, np.int64)
        lo[sid[with_m]] = (ends - nt)[with_m]
        hi[sid[with_m]] = ends[with_m]
        ids = _cat(flats, np.int32).tolist()
        alternatives = [ids[a:b] for a, b in zip(lo.tolist(), hi.tolist())]
    return always_keep, alternatives
