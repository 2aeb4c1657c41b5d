"""Device-backed corpus passes: batched Viterbi encode, merge's pair
counts and the prune round's nbest(2) alternatives, with the row-group
machinery (packing widths, row groups, dropout words) that the training
session (train/device_session.py), the one E-step and frequency pass,
shares with them.

Counterpart of tokengeex_tpu/train/estep_device.py: samples are packed
into fixed-shape (rows x width) byte batches
(utils/packing.py) and processed in row groups on the device
(ops/lattice.py). Encode walks the backpointers and resolves the token
ids on the device (`lattice.walk_ids`) and reads back one flat id buffer
per group; samples longer than MAX_ENCODE_WIDTH chain fixed-width windows
with a carried dp tail, their backpointers kept on the device, and are
walked across their windows there once the last is scanned
(_encode_chained, `lattice.chained_walk`). The merge loop
re-encodes one DeviceCorpus, packed and uploaded once, and counts
adjacent id pairs on the device, the walk's ids never leaving it
(count_pairs_arrays: a hash table, ops/pair_count.py). The pruner's
alternatives are one Viterbi pass over the vocabulary's own bytes with
each token's whole-token entry masked (prune_alternatives_device).

Under a process group (parallel/mesh.py, one rank a GPU) the corpus is
replicated: every rank packs every sample the same way and runs its block
of each row group's rows (`rank_groups`); encode's ids are all_gathered
and the pair tables' rows gathered, so every rank returns the whole
corpus's result.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import NoPathError
from ..models.unigram import Model
from ..ops import lattice as lat
from ..ops.match_table import TokenTable
from ..parallel import mesh as pmesh
from ..utils import trace
from ..utils.device import resolve_device, upload
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


def count_packing(packed: PackedBatch, samples) -> PackedBatch:
    """`packed`, the packing of `samples`, counted while a trace records:
    `pack.positions` its rows x width, `pack.bytes` the samples' bytes."""
    if trace.on():
        trace.count("pack.positions", packed.bytes_arr.size)
        trace.count("pack.bytes", sum(map(len, samples)))
    return packed


def _pick_width(samples: Sequence[bytes], max_snippet: Optional[int]) -> int:
    longest = max((len(s) for s in samples), default=1)
    if max_snippet is not None:
        longest = min(longest, max_snippet)
    width = max(CHUNK, -(-longest // CHUNK) * CHUNK)
    return width


def chained_width(max_width: Optional[int] = None) -> int:
    """The pack cap of an encode pass (`max_width`, default
    MAX_ENCODE_WIDTH, rounded up to CHUNK): longer samples take the
    chained encode in windows of this width."""
    cap = max_width or MAX_ENCODE_WIDTH
    return max(CHUNK, -(-cap // CHUNK) * CHUNK)


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
        self.cap = chained_width(max_width)
        self.long_idx = [si for si, s in enumerate(samples)
                         if len(s) > self.cap]
        short = [s if len(s) <= self.cap else b"" for s in samples]
        self.width = _pick_width(short, None)
        self.packed = count_packing(
            pack_samples(short, width=self.width, max_snippet=None), short)
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


def _tables_on(model: Model, table: Optional[lat.DeviceTables],
               dev: torch.device, dtype: torch.dtype,
               table_hints: Optional[Tuple[int, int]] = None
               ) -> lat.DeviceTables:
    """`table` (a training session's binding of `model`), which must hold
    its per-id scores at `dtype` on `dev`, or else the tables of one built
    from `model` (with `table_hints`) and uploaded."""
    if table is None:
        hb, hl = table_hints or (None, None)
        return lat.DeviceTables.from_table(
            TokenTable.build(model.vocab, min_bits=hb, min_len=hl), dev,
            dtype)
    # A bare "cuda" names the current card, which a tensor names by index.
    want = torch.empty(0, device=dev).device
    if table.scores.dtype != dtype or table.scores.device != want:
        raise ValueError(
            f"tables with {table.scores.dtype} scores on "
            f"{table.scores.device}, wanted {dtype} on {want}")
    return table


def _encode_setup(model: Model, samples: Sequence[bytes],
                  table_hints: Optional[Tuple[int, int]],
                  probe: Optional[str], max_width: Optional[int],
                  dtype: torch.dtype, dev: torch.device,
                  timer: Optional[lat.PhaseTimer],
                  table: Optional[lat.DeviceTables],
                  corpus: Optional["DeviceCorpus"], local: bool):
    """An encode pass's (DeviceTables, Viterbi route, DeviceCorpus): the
    tables of `table` (`_tables_on`), and `corpus` unless it was packed
    from other samples, at another width or for other rows (its spans
    would be misassigned), else one packed now."""
    with lat.phase(timer, "tables"):
        dt = _tables_on(model, table, dev, dtype, table_hints)
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
    table: Optional[lat.DeviceTables] = None,
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
    kernel, walk, readback, split (with the ids' gather and the chained
    samples' ids); the chained samples' walk runs on the device too).
    `table` is the DeviceTables of `model` on `device`
    with scores at `dtype` (a training session's binding), used instead of
    building one. `corpus` is a DeviceCorpus packed from these very
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
        false = _place_ids(out, samples, sids, ntoks, flats, dt.vocab_size,
                           gather=not corpus.local)

    if corpus.long_idx:
        long_idx = corpus.long_idx
        chained = _encode_chained(
            dt, [(si, samples[si]) for si in long_idx], corpus.cap,
            backend=backend, dropout=dropout, seed=seed + 0x5151,
            probe=probe, device=dev, timer=timer, dtype=dtype)
        with lat.phase(timer, "split"):
            chained = chained.lists()
        for si, ids in zip(long_idx, chained):
            out[si] = ids
            if ids is None:
                false.append(si)
    for si, ids in zip(false, _redo_false(model, dt, samples, false, probe,
                                          dtype, dev, timer, dropout, seed)):
        out[si] = ids

    # Zero-length samples produce no packed span; they encode to [].
    return [ids if ids is not None else [] for ids in out]


def _raise_mismatch() -> None:
    raise KeyError("walk: a matched span is not a vocabulary token "
                   "(model/table mismatch)")


def _redo_false(model: Model, dt: lat.DeviceTables, samples, idx: List[int],
                probe: Optional[str], dtype: torch.dtype, dev,
                timer: Optional[lat.PhaseTimer] = None, dropout: float = 0.0,
                seed: int = 0) -> List[List[int]]:
    """The ids of samples[i] for i in idx, the samples whose walk met a
    span that is no token, packed or chained, redone with the exact probe
    (`_redo_exact`). On the exact route (probe "exact" or float64) no
    probe matches falsely, so such a span is a model/table mismatch:
    KeyError."""
    if not idx:
        return []
    if probe == "exact" or dtype == torch.float64:
        _raise_mismatch()
    return _redo_exact(model, dt, samples, idx, dev, timer, dropout, seed)


def _redo_exact(model: Model, dt: lat.DeviceTables, samples, idx: List[int],
                dev, timer: Optional[lat.PhaseTimer] = None,
                dropout: float = 0.0, seed: int = 0) -> List[List[int]]:
    """The ids of samples[i] for i in idx, encoded again with the exact
    probe over `dt` (on this rank alone, through the short or the chained
    route as each sample's length takes it): the fallback for a sample
    whose best path took a span that is no token. The bucket and fast
    probes match a span on a 32-bit check word within its row, so a span
    that is no token can collide with an entry and score as it; the walk,
    which resolves ids with the exact tables, then finds no token there
    (id V). A path that takes no such span is the exact probe's path too,
    so only these samples are redone. Raises KeyError if the exact route
    also finds a span that is no token (a model/table mismatch). Runs in
    the span `redo` and counts `probe.redone` (samples) and
    `probe.redone_bytes`. At dropout > 0 a redone sample draws its coins
    anew."""
    with trace.span("redo"):
        if trace.on():
            trace.count("probe.redone", len(idx))
            trace.count("probe.redone_bytes",
                        sum(len(samples[i]) for i in idx))
        return encode_corpus_device(
            model, [samples[i] for i in idx], dropout=dropout, seed=seed,
            probe="exact", device=dev, timer=timer, table=dt, local=True)


def _cat(parts, dtype) -> np.ndarray:
    return (np.concatenate(parts).astype(dtype) if parts
            else np.zeros(0, dtype))


def _place_ids(out: list, samples, sids, ntoks, flats, V: int,
               gather: bool) -> List[int]:
    """Split the walked ids into `out[sample]` once: this rank's groups'
    (sample ids, tokens per span (-1: no path), flat ids), and with
    `gather` every rank's, all_gathered as one int32 tensor a rank. Every
    rank then raises the same NoPath. Returns the samples whose path took
    a span that is no token (an id >= V), whose `out` stays None, the
    same on every rank."""
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
    ends = np.cumsum(nt)
    false_at = np.nonzero(ids >= V)[0]
    false_span = np.zeros(nt.size, bool)
    false_span[np.searchsorted(ends, false_at, side="right")] = True
    parts = np.split(ids.astype(np.int64), ends[:-1])
    for k, part, bad in zip(si.tolist(), parts, false_span.tolist()):
        if not bad:
            out[k] = part.tolist()
    return si[false_span].tolist()


@dataclasses.dataclass(frozen=True)
class ChainedIds:
    """The ids of the samples of one chained encode (`_encode_chained`),
    walked on the device: `flat` (>= ntok.sum(),) int32 on the device,
    sample after sample in the call's order, each in position order;
    `ntok_d` (R,) int64 and `bad_d` (R,) bool, on the device, each
    sample's tokens and whether its path took a span that is no token (the
    probe's false match: an id V); `ntok` and `false`, the same read back,
    the latter as the samples' indices in the call's order."""

    flat: torch.Tensor
    ntok_d: torch.Tensor
    bad_d: torch.Tensor
    ntok: np.ndarray
    false: List[int]

    @property
    def total(self) -> int:
        return int(self.ntok.sum())

    @staticmethod
    def cat(parts: List["ChainedIds"]) -> "ChainedIds":
        if len(parts) == 1:
            return parts[0]
        offsets = np.cumsum([0] + [p.ntok.size for p in parts])
        return ChainedIds(
            torch.cat([p.flat[: p.total] for p in parts]),
            torch.cat([p.ntok_d for p in parts]),
            torch.cat([p.bad_d for p in parts]),
            np.concatenate([p.ntok for p in parts]),
            [i + int(o) for p, o in zip(parts, offsets) for i in p.false])

    def lists(self) -> List[Optional[List[int]]]:
        """Each sample's ids, read back at once; None for a sample in
        `false`."""
        ids = self.flat[: self.total].cpu().numpy().astype(np.int64)
        out = [part.tolist()
               for part in np.split(ids, np.cumsum(self.ntok)[:-1])]
        for i in self.false:
            out[i] = None
        return out

    def _ids(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, sample): the int64 ids and each one's sample."""
        total = self.total
        sample = torch.repeat_interleave(
            torch.arange(self.ntok.size, device=self.flat.device),
            self.ntok_d, output_size=total)
        return self.flat[:total].to(torch.int64), sample

    def pair_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(keys, counts), int64 on the device, for
        `PairTable.insert_weighted`: the key (a << 32) | b of every two
        adjacent ids of a sample not in `false`, EMPTY (skipped) at the
        samples' boundaries and in `false`, each counted once."""
        from ..ops.pair_count import EMPTY
        ids, sample = self._ids()
        same = (sample[:-1] == sample[1:]) & ~self.bad_d[sample[:-1]]
        keys = torch.where(same, (ids[:-1] << 32) | ids[1:], EMPTY)
        return keys, torch.ones_like(keys)

    def pairs(self) -> int:
        """The pairs `pair_rows` holds that are not EMPTY."""
        nt = self.ntok.copy()
        nt[self.false] = 0
        return int(np.maximum(nt - 1, 0).sum())

    def counts(self, V: int) -> torch.Tensor:
        """(V,) int32 counts of the ids of the samples not in `false`, on
        the device."""
        ids, sample = self._ids()
        ids = torch.where(self.bad_d[sample], V, ids)
        return torch.zeros(V + 1, dtype=torch.int32,
                           device=ids.device).index_add_(
            0, ids, torch.ones_like(ids, dtype=torch.int32))[:V]


def _encode_chained(
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
) -> ChainedIds:
    """Encode samples longer than the pack width by chaining fixed-width
    windows. Window k covers bytes [k*W, (k+1)*W); its device row is
    [last L bytes of window k-1 | body] with an origin-shifted hash
    stream (lat.prepare_chained_batch) so boundary-crossing tokens
    match, and the scan starts from the previous window's last L dp
    values passed through bit-exactly as the initial history. Every
    window's backpointers (one byte a position) and row stay on the
    device; once the last window is scanned, `lattice.chained_walk` walks
    each sample across its windows and resolves its ids there (phase
    `walk`), and one readback (phase `readback`) gives each sample's
    tokens and flags. Byte-exact against the reference's unchunked encode
    (src/model.rs:59-129): the dp depends only on the last L positions.
    Raises NoPathError (the first such sample's length) where a sample's
    end is unreachable; a sample whose path took a span that is no token
    is listed in `false` (the caller redoes it, `_redo_false`). Counts
    `chained.samples`, `chained.windows` and `chained.false` once a
    call."""
    W = width
    R = len(long_samples)
    # Bound the row batch: every chained row costs transient device
    # memory for its hash streams and scores, and every window kept for
    # the walk about 2 W + 10 KB (its backpointers, row and exit tables)
    # on the device and 2 W on the host: at most 16 groups' bytes of
    # windows a batch, a sample longer than that alone in its own.
    max_rows = max(ROW_MULT, ((4 * GROUP_BYTES) // W // ROW_MULT) * ROW_MULT)
    max_windows = max(1, 16 * GROUP_BYTES // W)
    cuts, start, held = [], 0, 0
    for i, (_, s) in enumerate(long_samples):
        n = -(-len(s) // W)
        if i > start and (i - start == max_rows or held + n > max_windows):
            cuts.append((start, i))
            start, held = i, 0
        held += n
    cuts.append((start, R))
    out = ChainedIds.cat([
        _chained_batch(dt, long_samples[g0:g1], W, backend, dropout,
                       seed + g0, probe, device, timer, dtype)
        for g0, g1 in cuts])
    trace.count("chained.samples", R)
    trace.count("chained.windows",
                sum(-(-len(s) // W) for _, s in long_samples))
    trace.count("chained.false", len(out.false))
    return out


def _chained_batch(dt: lat.DeviceTables,
                   long_samples: List[Tuple[int, bytes]], W: int,
                   backend: str, dropout: float, seed: int,
                   probe: Optional[str], device,
                   timer: Optional[lat.PhaseTimer],
                   dtype: torch.dtype) -> ChainedIds:
    """One batch of `_encode_chained`. Its samples' windows are kept as
    one flat list, the windows of sample after sample
    (`lattice.chained_walk`'s layout), and one zero window after them;
    step k scans a row a sample (padded to ROW_MULT): the sample's window
    k, gathered from the list (the zero window where it has none), whose
    backpointers go back to the window's place."""
    t1, t2 = lat.exact_tables(dt)
    L = dt.max_len
    R = len(long_samples)
    Rp = -(-R // ROW_MULT) * ROW_MULT
    lens = np.array([len(s) for _, s in long_samples], np.int64)
    nwin = -(-lens // W)
    K, NW = int(nwin.max()), int(nwin.sum())
    win0 = np.cumsum(nwin) - nwin
    last_n = (lens - (nwin - 1) * W).astype(np.int32)
    gen = (torch.Generator(device=device).manual_seed(seed)
           if dropout > 0.0 else None)

    def rows_of(a: np.ndarray, fill) -> torch.Tensor:
        """A value a sample, padded to the Rp scan rows, on the device."""
        return upload(np.concatenate([a, np.full(Rp - R, fill, a.dtype)]),
                      device)

    with lat.phase(timer, "prep"):
        body = np.zeros((NW + 1, W), np.uint8)
        flat_body = body.reshape(-1)
        for r, (_, s) in enumerate(long_samples):
            flat_body[win0[r] * W : win0[r] * W + len(s)] = np.frombuffer(
                s, np.uint8)
        rows = np.zeros((NW + 1, L + W), np.uint8)
        rows[:, L:] = body
        rows[1:, :L] = body[:-1, W - L :]
        rows[win0, :L] = 0  # a sample's first window has no tail
        rows[NW, :L] = 0
        rows_d = upload(rows, device)
        lens_d = rows_of(lens, 0)
        nwin_d = rows_of(nwin.astype(np.int32), 0)
        win0_d = rows_of(win0, NW)
        end_col = rows_of(last_n.astype(np.int64) - 1, 0)[:, None]
        bl = torch.empty((NW + 1, W), dtype=torch.uint8, device=device)
        step = torch.empty((Rp, W), dtype=torch.uint8, device=device)
        end_dp = torch.full((Rp,), lat.NEG_INF, dtype=dtype, device=device)
    carry_hist = torch.full((Rp, L), lat.NEG_INF, dtype=dtype,
                            device=device)
    mask = torch.zeros(Rp, dtype=torch.bool, device=device)

    for k in range(K):
        with lat.phase(timer, "prep"):
            live = nwin_d > k
            win = torch.where(live, win0_d + k, NW)
            batch = lat.prepare_chained_batch_from(
                rows_d[win], (lens_d - k * W).clamp(0, W).to(torch.int32),
                live & (k > 0), L, W)
            drop_u = (_drop_words(gen, Rp, batch.sid.shape[1], device)
                      if gen is not None else None)
        dp, best_l = lat.viterbi(dt, batch, C=CHUNK, dtype=dtype,
                                 backend=backend, drop_u=drop_u,
                                 dropout=dropout, probe=probe,
                                 carry=(mask, carry_hist), timer=timer)
        with lat.phase(timer, "prep"):
            # The rows past their sample's windows land on the zero
            # window, which nothing reads.
            lat.backpointer_bytes(best_l, step)
            bl[win] = step
            end_dp = torch.where(nwin_d == k + 1, dp.gather(1, end_col)[:, 0],
                                 end_dp)
            # Next carry: hist0[:, j] = dp[W - j] — the reversed dp tail,
            # bit-exact (dp[:, p-1] holds dp index p).
            mask = lens_d > (k + 1) * W
            carry_hist = torch.where(mask[:, None], dp[:, W - L : W].flip(1),
                                     lat.NEG_INF)

    with lat.phase(timer, "walk"):
        ok = torch.isfinite(end_dp[:R])
        flat, ntok, bad = lat.chained_walk(
            bl[:NW], rows_d[:NW], nwin_d[:R], upload(last_n, device), ok, t1,
            t2, bits=dt.bits, vocab_size=dt.vocab_size, cap=int(lens.sum()))
        # A sample's tokens: its windows', read off the windows' cumsum.
        ends = torch.cumsum(ntok, 0, dtype=torch.int64)[
            upload(win0 + nwin - 1, device)]
        ntok = torch.diff(ends, prepend=ends.new_zeros(1))
    with lat.phase(timer, "readback"):
        dead_h, bad_h, ntok_h = torch.stack(
            [(~ok).long(), bad.long(), ntok]).cpu().numpy()
    dead = np.nonzero(dead_h)[0]
    if dead.size:
        n = int(lens[dead[0]])
        raise NoPathError(n, n)
    return ChainedIds(flat, ntok, bad, ntok_h, np.nonzero(bad_h)[0].tolist())


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
        _raise_mismatch()


def false_spans(flat: torch.Tensor, ntok: torch.Tensor, V: int):
    """A group's walked ids (`lattice.walk_ids_device`), read back: (ids,
    tokens per span, each id's span, the spans that hold an id >= V: a
    probe's false match). Only a pass that met a false match reads them."""
    nt = ntok.cpu().numpy().astype(np.int64)
    ids = flat[: int(nt.sum())].cpu().numpy()
    span_of = np.repeat(np.arange(nt.size), nt)
    false = np.zeros(nt.size, bool)
    false[span_of[ids >= V]] = True
    return ids, nt, span_of, false


def _drop_false_spans(flat: torch.Tensor, ntok: torch.Tensor, V: int,
                      spans) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """A group's walked ids without the spans that hold a false match:
    (flat, incl) in the layout `PairTable.insert_ids` takes, those spans
    left empty, and the samples they belong to (`spans`, the group's
    packed spans in the walk index's order)."""
    ids, nt, span_of, false = false_spans(flat, ntok, V)
    nt[false] = 0
    dev = flat.device
    return (upload(np.ascontiguousarray(ids[~false[span_of]]), dev),
            upload(np.cumsum(nt).astype(np.int32), dev),
            [spans[k][3] for k in np.nonzero(false)[0].tolist()])


@trace.traced("count")
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
    pairs, its dead spans, its largest id, the table's distinct keys,
    spilled rows and flags) grows it and drains the rows that found no
    slot. Samples past the pack cap take the chained encode (span
    `chained`), whose ids stay on the device too, and their pairs are
    inserted as rows (`ChainedIds.pair_rows`). A sample whose path
    took a span that is no token (an id >= V: the probe's false match)
    is left out of its group's insert and encoded again with the exact
    probe (`_redo_exact`, span `redo`), its pairs inserted as rows, so
    the counts are those of an all-exact pass; a pass with no false match
    does nothing more. The table is compacted and sorted on the device;
    only the sorted arrays are read back. A span with no path raises
    NoPathError (the first such sample's length), an id that is no
    vocabulary token on the exact route too KeyError. Counts
    `pairs.distinct`.

    Under a process group each rank counts its block of every row group,
    and the ranks' compacted tables are all_gathered and inserted into a
    fresh table on every rank, after every rank has learnt of any rank's
    failure; each rank redoes its own blocks' samples first; a local
    corpus counts its own samples with no collective. `timer` collects
    the encode's phases and the count's (pairs: inserts, compaction and
    sort; readback)."""
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
    false: List[int] = []
    for sub, batch, index, dp, best_l in _viterbi_groups(
            dt, corpus, backend, None, 0.0, None, torch.float32, timer):
        if index.n == 0:
            continue
        flat, ntok, incl, dead = lat.walk_ids_device(dt, batch, dp, best_l,
                                                     index, timer=timer)
        with lat.phase(timer, "readback"):
            (pairs, any_dead, first, top, distinct, overflow, bad, spilled,
             *_) = table.read(incl[-1] - (ntok > 0).sum(), dead.any(),
                              dead.to(torch.int32).argmax(),
                              flat.amax() if flat.numel() else ntok.sum())
        if overflow:
            code = _PAIRS_OVERFLOW
        elif any_dead and code < _PAIRS_NOPATH:
            code, length = _PAIRS_NOPATH, len(samples[sub.spans[first][3]])
        elif bad and code < _PAIRS_MISMATCH:
            code = _PAIRS_MISMATCH
        if code:
            continue  # the pass raises: no more inserts
        if top >= V:
            with lat.phase(timer, "readback"):
                flat, incl, more = _drop_false_spans(flat, ntok, V,
                                                     sub.spans)
            false.extend(more)
        new = (max(hint - distinct, 0) if hint is not None
               else pairs if held is None else distinct - held)
        with lat.phase(timer, "pairs"):
            table.reserve(min(new, pairs), distinct, spilled)
            table.insert_ids(flat, incl, V)
        held = distinct
    if false and not code:
        try:
            _insert_pairs(table, _redo_exact(model, dt, samples, false, dev,
                                             timer), dev, timer)
        except KeyError:
            code = _PAIRS_MISMATCH
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
        long_idx = corpus.long_idx
        with trace.span("chained"):
            chained = _encode_chained(
                dt, [(si, samples[si]) for si in long_idx], corpus.cap,
                backend=backend, dropout=0.0, seed=0x5151, probe=None,
                device=dev, timer=timer)
        # The walk's ids stay on the device: their pairs go in as rows.
        with lat.phase(timer, "pairs"):
            table.reserve(chained.pairs())
            table.insert_weighted(*chained.pair_rows())
        if chained.false:
            _insert_pairs(table, _redo_false(
                model, dt, samples, [long_idx[i] for i in chained.false],
                None, torch.float32, dev, timer), dev, timer)
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
        keys, counts = keys.cpu().numpy(), counts.cpu().numpy()
    trace.count("pairs.distinct", keys.size)
    return keys, counts


def _insert_pairs(table, ids: Sequence[List[int]], dev,
                  timer: Optional[lat.PhaseTimer]) -> None:
    """Inserts the adjacent pairs of each id list into `table` as rows."""
    with lat.phase(timer, "pairs"):
        keys = torch.from_numpy(_chained_pair_keys(ids)).to(dev)
        table.reserve(keys.numel())
        table.insert_weighted(keys, torch.ones_like(keys))


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
    return count_packing(PackedBatch(bytes_arr, sample_id, is_start,
                                     end_index, spans), values)


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
            cache.index_put_(entry, upload(lat.NEG_INF, dev, cache.dtype))
        yield sub, batch, cache, chains, index, whole


def prune_alternatives_device(model: Model,
                              table: Optional[lat.DeviceTables] = None,
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

    `table` is the DeviceTables of `model` with float64 scores (the
    pruner's session's binding), or one is built. device: a CUDA device
    by default, "cpu" for the kernels' plain versions. Under a process group every rank computes
    the whole answer. `timer` collects the seconds per phase (tables,
    pack, prep, probe, kernel, walk, readback, decide)."""
    dev = resolve_device(device)
    with lat.phase(timer, "tables"):
        dt = _tables_on(model, table, dev, torch.float64)
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
