"""Device training session: probe the corpus once, train many passes.

Counterpart of tokengeex_tpu/train/device_session.py. During pruning the
vocabulary only shrinks and gets rescored
(reference: src/prune.rs:23-57), so with a stable-slot table
(TokenTable.rebind) the (position, length) -> slot matching of the whole
corpus never changes across EM sub-iterations, frequency passes and prune
rounds. The session therefore:

  - builds the token table once from the initial vocabulary and keeps
    its layout on the device; a later model binds to it by an id map made
    on the host, every table word gathered on the device (slots never
    move; ops/lattice.py ResidentLayout);
  - packs the corpus once and keeps each group's compact inputs on the
    device under a budget;
  - probes each row group once (dropout-free), remaps the probe slots to
    the dense rank space (ops/lattice.py RankSpace) and keeps them under
    a budget, with one SegStruct per group;
  - on later passes re-gathers the current score per cached rank
    (`estep_cached`: one whole-width forward and betas scan per group,
    each row cut into chains at the group's sample boundaries, whose
    bounds are cached beside its inputs), or, for tables small enough,
    re-probes inside the fused kernels (`estep_fused`), applies fresh
    dropout coins per pass, and turns the betas into counts through the
    scatter-free segsum.

A group whose slots do not fit the budget takes the per-pass route of
train/estep_device.py (probe, forward, marginals scattered into bins).

Multi-GPU (parallel/mesh.py, one rank a GPU): every rank holds the whole
corpus and keeps its block of each group's rows (the caches hold blocks),
or with local_shard only its own samples and all of their rows. Each pass
adds the rank's groups locally, agrees on failures, then sums the (V,)
counts with one all_reduce; the routes (budgets, over-budget groups)
may differ between ranks, the collectives never do.

The f64 / exact conformance mode (dtype=torch.float64, or probe="exact")
follows the JAX session's f64 branches: no rank space and no slot
cache (exact probes yield token ids, which change on every rebind), so
every pass probes each group afresh with the exact probe, runs the
double scans (at f64) and scatters the marginals into token-id bins; its
tables bind per model as the default mode's do. Its frequency pass walks
on the card too, over the exact probe's double Viterbi scan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

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
from . import estep_device as ed

# Pack width of a session over a corpus that fills at least 128 such rows:
# several snippets pack per row, so a wide row costs only its end padding
# and gives the kernels long rows (the JAX package's TGX_PACK_WIDTH).
PACK_WIDTH = 8192
# Budgets on the CPU, where there is no device memory to size them from
# (the JAX package's defaults). On a GPU the slot cache (slots and
# SegStructs) may take half of the memory free at construction and the
# input cache an eighth, leaving the rest for each group's transient
# buffers (the probe, the forward and backward slabs, the sort).
CPU_SLOT_CACHE_BYTES = 6 << 30
CPU_INPUT_CACHE_BYTES = 4 << 30


def _group_seed(seed: int, gi: int) -> int:
    """Seed of group gi's dropout words in pass `seed`."""
    return int(np.random.SeedSequence([seed, gi]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class DeviceTrainSession:
    def __init__(self, model: Model, samples: Sequence[bytes],
                 max_snippet: Optional[int], kernel: Optional[str] = None,
                 dtype=None, probe: Optional[str] = None,
                 cache_budget: Optional[int] = None,
                 local_shard: bool = False, device=None,
                 timer: Optional[lat.PhaseTimer] = None):
        """`samples` is the whole corpus, or with local_shard under a
        process group of several ranks this rank's shard of it. kernel=None
        lets tables small enough (has_vscan) take the fused probe kernels;
        "slab" keeps every group on the probed-slab kernels. device: a CUDA
        device by default, "cpu" for the kernels' plain versions; without a
        GPU and without `device` this raises. `timer` collects the
        construction's phases (tables, pack); each pass takes its own.
        dtype=torch.float64 or probe="exact" takes the f64 / exact
        conformance mode (see the module docstring); snippets then keep the
        caller's cap at f64."""
        if kernel not in (None, "slab"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {dtype}")
        self.dev = resolve_device(device)
        self.samples = samples
        # At world size 1 a shard is the corpus: the plain session.
        self.local_shard = bool(local_shard) and pmesh.process_count() > 1
        self.dtype = dtype or torch.float32
        self.exact = self.dtype == torch.float64 or probe == "exact"
        self.max_snippet = ed._em_snippet_cap(max_snippet, self.dtype)
        self.kernel = kernel
        self.probe = probe
        self.chunk = ed.CHUNK
        with lat.phase(timer, "tables"):
            self.base_tbl = TokenTable.build(model.vocab)
            self.L = self.base_tbl.max_token_len
            # Cached slots live in the dense rank space of the bucket
            # probe, so the score regather reads a vocabulary-sized column
            # and count bins stay vocabulary-sized.
            self.rank = (None if self.exact
                         else lat.build_rank_space(self.base_tbl))
            self._lut_dev = None
            # The table's layout stays on the device for the session; its
            # own binding is `model`'s, and later models bind from it.
            self.layout = lat.ResidentLayout.of(self.base_tbl, self.dev,
                                                self.dtype)
            if not self.exact:
                self._rank_base_ids = lat.rank_to_ids(self.rank,
                                                      self.base_tbl)
            self._set_binding(model, self.layout.base,
                              self.base_tbl.scores_f64, None)
        # The count structures are sized for the probe the table resolves
        # by default; another slot space would misattribute counts.
        default_mode = lat._probe_mode(self.dt, self.dtype)
        requested = {"em": "fast"}.get(probe, probe)
        if requested not in (None, "exact") and requested != default_mode:
            raise ValueError(
                f"DeviceTrainSession count structures are sized for the "
                f"'{default_mode}' probe this table resolves to; "
                f"probe={probe!r} would use a different slot space. Pass "
                f"probe=None (per-probe overrides are supported by "
                f"encode_corpus_device only).")
        with lat.phase(timer, "pack"):
            self.width = ed._pick_width(samples, self.max_snippet)
            if PACK_WIDTH > self.width and \
                    sum(len(s) for s in samples) >= PACK_WIDTH * 128:
                self.width = PACK_WIDTH
            self.packed = ed.count_packing(
                pack_samples(samples, width=self.width,
                             max_snippet=self.max_snippet), samples)
            self._long_set = {si for si, s in enumerate(samples)
                              if self.max_snippet is not None
                              and len(s) > self.max_snippet}
        if self.dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.dev)
            default_cache, self.input_budget = free // 2, free // 8
        else:
            default_cache = CPU_SLOT_CACHE_BYTES
            self.input_budget = CPU_INPUT_CACHE_BYTES
        self.cache_budget = (default_cache if cache_budget is None
                             else int(cache_budget))
        self.cache_used = 0
        self.input_used = 0
        self.slot_cache: Dict[int, torch.Tensor] = {}
        # One SegStruct per slot-cached group (None: over budget), sharing
        # the slot cache's budget.
        self.seg_cache: Dict[int, Optional[lat.SegStruct]] = {}
        # Compact batch inputs on the device: the corpus crosses to the
        # device once per session.
        self.input_cache: Dict[object, tuple] = {}
        # Each group's scan chain bounds (ops/lattice.py chain_bounds),
        # keyed as the input cache: pass-invariant, 2 (W / SCAN_SEGMENT +
        # 1) ints per row.
        self.chain_cache: Dict[object, tuple] = {}
        # Each frequency group's walk index of its countable spans
        # (lattice.walk_index), keyed as the input cache.
        self.walk_spans: Dict[object, lat.WalkIndex] = {}
        self._group_list = None
        self._blocks: Dict[int, tuple] = {}
        self._span_idx: Dict[int, dict] = {}
        self._freq_group_list = None

    def close(self) -> None:
        """Release the session's device memory (the slot, seg and input
        caches hold up to their budgets for the whole prune loop), so the
        next stage starts with a clean device heap. The session is
        unusable afterwards."""
        self.slot_cache.clear()
        self.seg_cache.clear()
        self.input_cache.clear()
        self.chain_cache.clear()
        self.walk_spans.clear()
        self.dt = None
        self.layout = None
        self.slot_rows = None
        self._scores64 = None
        self._lut_dev = None
        self._model = None
        self.cache_used = 0
        self.input_used = 0

    # -- Model binding ------------------------------------------------------

    def _set_binding(self, model: Model, dt: lat.DeviceTables,
                     scores64: np.ndarray, lut: Optional[np.ndarray]) -> None:
        """Make `dt` the session's tables, bound to `model` by the id map
        `lut` (None: the base table's own binding)."""
        self.dt = dt
        if not self.exact:
            # Rank-indexed scores and the rank -> id map of this binding;
            # the rank space itself is fixed for the session.
            self.slot_rows = lat.rank_score_rows(self.rank, dt)
            self.rank_ids = (self._rank_base_ids if lut is None
                             else lut[self._rank_base_ids])
        self._scores64 = scores64
        self._model = model

    def _rebind(self, model: Model,
                timer: Optional[lat.PhaseTimer] = None) -> None:
        """Bind `model` (a subset of the session's first vocabulary,
        rescored) to the resident layout: its id map on the host, every
        table word gathered on the device (`ResidentLayout.bind`). Counts
        `tables.bound`."""
        with lat.phase(timer, "rebind"):
            if model is self._model:
                return
            vocab = model.vocab
            lut = self.layout.id_map([t.value for t in vocab])
            scores64 = np.array([t.score for t in vocab], dtype=np.float64)
            # The previous binding's tensors go before the new ones are
            # made (a caller still holding them keeps them).
            self.dt = self.slot_rows = None
            self._set_binding(model, self.layout.bind(lut, scores64,
                                                      self.dtype),
                              scores64, lut)
            trace.count("tables.bound", 1)

    def tables_f64(self, model: Model) -> lat.DeviceTables:
        """The session's tables bound to `model` with float64 per-id
        scores, as the pruner's alternatives take them: bound once a model
        (the frequency pass after them shares the binding); the exact
        mode's binding is itself float64."""
        self._rebind(model)
        if self.dt.scores.dtype == torch.float64:
            return self.dt
        return dataclasses.replace(
            self.dt, scores=upload(self._scores64, self.dev, torch.float64))

    def _nbins(self) -> int:
        """Count-bin space of the cached slot arrays: the dense ranks."""
        return self.rank.n_pad

    def _remap(self, slots: torch.Tensor) -> torch.Tensor:
        """Probe slots -> dense ranks, once per cached group."""
        if self._lut_dev is None:
            self._lut_dev = upload(self.rank.lut, self.dev)
        return lat.remap_slots(self._lut_dev, slots)

    def _fold(self, acc: Optional[torch.Tensor]) -> np.ndarray:
        """Count accumulator -> per-token expected counts (V,)."""
        if acc is None:
            return np.zeros(self.dt.vocab_size, dtype=np.float64)
        return lat.fold_expected_rank(acc, self.rank_ids, self.dt.vocab_size)

    # -- Group machinery ----------------------------------------------------

    def _groups(self):
        """(gi, block) of each EM row group: this rank's block of its rows
        (ed.rank_groups), which every cache below keys by gi; `_blocks`
        keeps each group's row count and first row for the dropout
        words."""
        if self._group_list is None:
            self._group_list = []
            for gi, rows, lo, block in ed.rank_groups(
                    self.packed, self.width, self.local_shard):
                self._group_list.append((gi, block))
                self._blocks[gi] = (rows, lo)
        return self._group_list

    def _span_arrays(self, gi: int, sub: PackedBatch, cache=None,
                     long_set=None) -> dict:
        """Per-group span bookkeeping, made once: the normaliser indices,
        byte and sample tallies, and the whole-sample spans the frequency
        pass counts."""
        if cache is None:
            cache = self._span_idx
        if long_set is None:
            long_set = self._long_set
        if gi not in cache:
            spans = sub.spans
            whole = [sp for sp in spans if sp[3] not in long_set]
            cache[gi] = {
                "spans": spans,
                "z": ([r for (r, _, _, _, _) in spans],
                      [e for (_, _, e, _, _) in spans]),
                "nbytes": sum(e - s for (_, s, e, _, _) in spans),
                "nsamples": len({si for (_, _, _, si, _) in spans}),
                "whole": whole,
                # The spans the frequency pass walks: whole and non-empty.
                "countable": [sp for sp in whole if sp[2] > sp[1]],
            }
        return cache[gi]

    def _freq_groups(self):
        """Row groups of the frequency pass. Where every sample fits one
        EM snippet they are the EM groups (and their cached slots apply);
        otherwise the corpus packs again at the encode width, so samples up
        to MAX_ENCODE_WIDTH count whole and only longer ones take the
        chained encode."""
        if self._freq_group_list is None:
            longest = max((len(s) for s in self.samples), default=1)
            if self.max_snippet is None or longest <= self.max_snippet:
                self._freq_group_list = self._groups()
                self._freq_span_idx = self._span_idx
                self._freq_long = self._long_set
                self._freq_shared = True
                return self._freq_group_list
            cap = ed.MAX_ENCODE_WIDTH
            width = ed._pick_width(self.samples, cap)
            packed = ed.count_packing(pack_samples(
                self.samples, width=width, max_snippet=cap), self.samples)
            self._freq_group_list = [
                (gi, block) for gi, _, _, block in
                ed.rank_groups(packed, width, self.local_shard)]
            self._freq_span_idx = {}
            self._freq_long = {si for si, s in enumerate(self.samples)
                               if len(s) > cap}
            self._freq_shared = False
        return self._freq_group_list

    def _freq_info(self, gi: int, sub: PackedBatch) -> dict:
        return self._span_arrays(gi, sub, cache=self._freq_span_idx,
                                 long_set=self._freq_long)

    def _walk_spans_for(self, key, info: dict, sub: PackedBatch,
                        width: int) -> lat.WalkIndex:
        """The walk index of a frequency group's countable spans, made
        once."""
        if key not in self.walk_spans:
            self.walk_spans[key] = lat.walk_index(
                info["countable"], sub.rows, width, self.dev)
        return self.walk_spans[key]

    def _batch_for(self, gi, sub: PackedBatch, timer=None) -> lat.DeviceBatch:
        """The group's DeviceBatch, from compact inputs cached on the
        device under the input budget."""
        with lat.phase(timer, "prep"):
            if gi in self.input_cache:
                gbytes, gflags = self.input_cache[gi]
            else:
                gbytes, gflags = lat.prepare_batch_inputs(sub, self.dev)
                size = gbytes.numel() + gflags.numel()
                if self.input_used + size <= self.input_budget:
                    self.input_cache[gi] = (gbytes, gflags)
                    self.input_used += size
            return lat.prepare_batch_from_inputs(gbytes, gflags, self.L)

    def _chains_for(self, key, batch: lat.DeviceBatch, timer=None):
        """The scan chain bounds of the group under `key` (a group index,
        or `_freq_key`'s), made once."""
        if key not in self.chain_cache:
            with lat.phase(timer, "prep"):
                self.chain_cache[key] = lat.chain_bounds(batch)
        return self.chain_cache[key]

    def _freq_key(self, gi: int):
        """A frequency group's cache key: the EM group's where the
        frequency packing is the EM packing, one of its own otherwise."""
        return gi if self._freq_shared else ("freq", gi)

    def _freq_batch(self, gi: int, sub: PackedBatch, timer=None):
        """Like _batch_for, under the frequency group's key."""
        return self._batch_for(self._freq_key(gi), sub, timer)

    def _probe_group(self, gi: int, batch: lat.DeviceBatch, timer=None):
        """(score, slots) of a group: the cached ranks with their scores
        re-gathered, or a dropout-free probe whose ranks are cached under
        the budget."""
        if gi in self.slot_cache:
            slots = self.slot_cache[gi]
            with lat.phase(timer, "regather"):
                score = lat.score_from_slots(self.slot_rows, slots)
            return score, slots
        with lat.phase(timer, "probe"):
            score, slots = lat.match_cache(self.dt, batch, C=self.chunk)
        with lat.phase(timer, "remap"):
            slots = self._remap(slots)
        size = slots.numel() * 4
        if self.cache_used + size <= self.cache_budget:
            self.slot_cache[gi] = slots
            self.cache_used += size
        return score, slots

    def _fused(self) -> bool:
        """Whether this binding takes the fused probe kernels (never in
        the f64 / exact mode)."""
        return (self.kernel is None and not self.exact
                and lat.has_vscan(self.dt))

    def _fused_seg(self, gi: int, batch: lat.DeviceBatch, timer=None):
        """SegStruct for the fused E-step (probing the group once to build
        it); None when over budget."""
        if gi in self.seg_cache:
            return self.seg_cache[gi]
        _, slots = self._probe_group(gi, batch, timer)
        if gi not in self.slot_cache:
            return None  # over budget: the caller probes every pass
        seg = self._seg_for(gi, slots, timer)
        if seg is not None:
            # The fused kernels re-probe in-kernel: once the SegStruct
            # exists the slots have no further reader.
            del self.slot_cache[gi]
            self.cache_used -= slots.numel() * 4
        return seg

    def _seg_for(self, gi: int, slots: torch.Tensor, timer=None):
        """SegStruct of a slot-cached group, built once and reused by every
        later pass (slots are static across rebinds); None when over
        budget, remembered so that no pass rebuilds it."""
        if gi in self.seg_cache:
            return self.seg_cache[gi]
        if gi not in self.slot_cache:
            return None
        W, L, B = slots.shape
        # Optimistic pre-check (compaction shrinks the hit lists >= 4x);
        # the actual size gates caching after the build.
        if self.cache_used + lat.SegStruct.est_bytes(B, L, W) // 4 \
                > self.cache_budget:
            return None
        with lat.phase(timer, "seg_build"):
            seg = lat.build_seg_struct(slots, self._nbins())
        if self.cache_used + seg.nbytes() > self.cache_budget:
            self.seg_cache[gi] = None
            return None
        self.seg_cache[gi] = seg
        self.cache_used += seg.nbytes()
        return seg

    # -- Passes -------------------------------------------------------------

    def e_step(self, model: Model, dropout: float, seed: int, task=None,
               timer: Optional[lat.PhaseTimer] = None) -> np.ndarray:
        """Expected token counts (reference: src/prune.rs:64-120), (V,)
        float64, reusing the cached slots across calls. dropout > 0 draws
        each group's coins from a torch.Generator seeded with (seed,
        group), so a seed gives the same counts on every call. `timer`
        collects the seconds per phase (rebind, prep, probe, remap,
        seg_build, regather, forward, backward, segsum, fold). Counts
        `groups.cached` (a group served from the slot or seg cache) and
        `groups.probed` (probed afresh) once a pass."""
        self._rebind(model, timer)
        acc = None
        z_parts, z_spans = [], []
        cached = 0
        for gi, sub in self._groups():
            cached += not self.exact and (
                gi in self.slot_cache or self.seg_cache.get(gi) is not None)
            batch = self._batch_for(gi, sub, timer)
            drop_u = None
            if dropout > 0.0:
                gen = torch.Generator(device=self.dev).manual_seed(
                    _group_seed(seed, gi))
                drop_u = ed.block_drop_words(gen, *self._blocks[gi], sub,
                                             batch.sid.shape[1], self.dev)
            if self.exact:
                # Conformance mode: a fresh exact probe each pass, the
                # marginals scattered into token-id bins.
                with lat.phase(timer, "probe"):
                    cache = lat.match_cache(self.dt, batch, C=self.chunk,
                                            probe="exact", dtype=self.dtype)
                chains = self._chains_for(gi, batch, timer)
                A = lat.forward(self.dt, batch, cache, self.chunk, drop_u,
                                dropout, timer, chains=chains)
                exp_g = lat.backward_expected(
                    self.dt, batch, A, cache, self.chunk, drop_u, dropout,
                    probe="exact", timer=timer, chains=chains)
                del cache
            elif self._fused() and \
                    (seg := self._fused_seg(gi, batch, timer)) is not None:
                # Steady state of small tables: both scans re-probe in
                # their kernels, the SegStruct turns betas into counts.
                A, exp_g = lat.estep_fused(
                    self.dt, batch, seg, self.slot_rows, drop_u, dropout,
                    timer, chains=self._chains_for(gi, batch, timer))
            elif gi in self.slot_cache:
                # Steady state: scores re-gathered per cached rank.
                slots = self.slot_cache[gi]
                A, exp_g = lat.estep_cached(
                    self.dt, batch, slots, self.slot_rows,
                    self._seg_for(gi, slots, timer), self.chunk, drop_u,
                    dropout, timer, chains=self._chains_for(gi, batch, timer))
            else:
                # First pass (the probe is cached under the budget), or a
                # group over budget, which probes on every pass.
                score, slots = self._probe_group(gi, batch, timer)
                cache = (score, slots)
                chains = self._chains_for(gi, batch, timer)
                A = lat.forward(self.dt, batch, cache, self.chunk, drop_u,
                                dropout, timer, chains=chains)
                seg = self._seg_for(gi, slots, timer)
                if seg is not None:
                    Bt = lat.backward_betas(self.dt, batch, cache,
                                            self.chunk, drop_u, dropout,
                                            timer, chains=chains)
                    exp_g = lat.segsum_expected(self.dt, batch, A, Bt, seg,
                                                self.slot_rows, drop_u,
                                                dropout, timer)
                else:
                    exp_g = lat.backward_expected(
                        self.dt, batch, A, cache, self.chunk, drop_u,
                        dropout, nbins=self._nbins(), timer=timer,
                        chains=chains)
                del score, cache
            acc = exp_g if acc is None else acc.add_(exp_g)
            info = self._span_arrays(gi, sub)
            if info["spans"]:
                z_parts.append(lat.pick_span_values_device(A, *info["z"]))
                z_spans.extend(info["spans"])
            if task is not None:
                task.record(info["nbytes"], info["nsamples"])
        trace.count("groups.cached", cached)
        trace.count("groups.probed", len(self._groups()) - cached)
        with lat.phase(timer, "fold"):
            expected = (lat.fold_expected(self.dt, acc, "exact")
                        if self.exact and acc is not None
                        else self._fold(acc))
            z = (torch.cat(z_parts).cpu().numpy() if z_parts
                 else np.zeros(0, np.float32))
        # Per-snippet normaliser check (reference: src/prune.rs:90-96),
        # read back once for the whole pass and agreed by every rank before
        # any raises; then one all_reduce of the counts.
        bad = np.nonzero(~np.isfinite(z))[0]
        si, zk = ((z_spans[int(bad[0])][3], float(z[bad[0]])) if bad.size
                  else (-1, 0.0))
        si, zk = pmesh.allgather_fail(si, zk)
        if si >= 0:
            where = "shard sample" if self.local_shard else "sample"
            raise ValueError(f"normalization constant is not finite "
                             f"(z={zk}, {where}={si})")
        return pmesh.all_reduce_counts(expected)

    def _freq_viterbi(self, gi: int, sub: PackedBatch, timer=None):
        """A frequency group's Viterbi pass on the session's route: (batch,
        key, dp, best_l, whether its cached ranks served it)."""
        batch = self._freq_batch(gi, sub, timer)
        key = self._freq_key(gi)
        chains = self._chains_for(key, batch, timer)
        hit = False
        if self.exact:
            dp, best_l = lat.viterbi(
                self.dt, batch, C=self.chunk, dtype=self.dtype,
                probe="exact", timer=timer, chains=chains)
        elif self._freq_shared and not self._fused() \
                and gi in self.slot_cache:
            hit = True
            dp, best_l = lat.viterbi_cached(
                self.dt, batch, self.slot_cache[gi], self.slot_rows,
                timer=timer, chains=chains)
        else:
            dp, best_l = lat.viterbi(
                self.dt, batch, C=self.chunk,
                backend="fused" if self._fused() else "slab",
                timer=timer, chains=chains)
        return batch, key, dp, best_l, hit

    def _redo_false(self, model: Model, walked: list, bins: list,
                    counts_h: np.ndarray, timer=None) -> np.ndarray:
        """`counts_h`, a pass's (V + 1,) walked counts with tokens in bin
        V (spans that are no token: the probe's false matches), without
        the samples whose paths took them, which are encoded again with
        the exact probe (`estep_device._redo_exact`) and counted. Only the
        groups whose bin is not 0 are walked again, in ids mode, to find
        those samples. Raises KeyError if the exact route also meets a
        span that is no token."""
        V = counts_h.size - 1
        per = torch.cat(bins).cpu().numpy()
        per[0] -= per[1:].sum()
        counts_h = counts_h.copy()
        redo = []
        for g in np.nonzero(per)[0].tolist():
            gi, sub = walked[g]
            batch, key, dp, best_l, _ = self._freq_viterbi(gi, sub, timer)
            info = self._freq_info(gi, sub)
            index = self._walk_spans_for(key, info, sub, best_l.shape[1])
            flat, ntok, _, _ = lat.walk_ids_device(self.dt, batch, dp,
                                                   best_l, index)
            ids, _, span_of, false = ed.false_spans(flat, ntok, V)
            counts_h -= np.bincount(ids[false[span_of]], minlength=V + 1)
            redo += [info["countable"][k][3]
                     for k in np.nonzero(false)[0].tolist()]
        for ids in ed._redo_exact(model, self.dt, self.samples, redo,
                                  self.dev, timer):
            counts_h[:V] += np.bincount(np.asarray(ids, np.int64),
                                        minlength=V)
        if counts_h[V]:
            ed._raise_mismatch()
        return counts_h

    def count_frequencies(self, model: Model, task=None,
                          timer: Optional[lat.PhaseTimer] = None
                          ) -> np.ndarray:
        """Viterbi token frequencies (reference: src/prune.rs:205-246),
        (V,) int64. Whole samples count through the session's groups (the
        cached ranks where the frequency packing is the EM packing and the
        table takes the slab route, the fused kernel on small tables, a
        probed cache otherwise; each group's chain bounds made once per
        session); their backpointers are walked and their ids counted on
        the device (`lattice.walk_counts`), and only the (V,) counts and
        the span-end dp values are read back, once per pass. Samples longer
        than the frequency packing's cap take the chained encode over the
        session's table (`estep_device._encode_chained`): walked across
        their windows on the device, their ids counted there and read back
        with the groups' counts; a chained sample whose walk met a false
        match is redone (`estep_device._redo_false`). `timer` collects the
        seconds per phase (rebind, pack: the frequency packing, made on the
        first pass, prep, probe, regather, kernel, walk, readback, and the
        chained encode's).
        A pass whose counts hold tokens that are no vocabulary token (the
        bucket or fast probe's false match: bin V) redoes the samples
        whose paths took them with the exact probe (`_redo_false`); it
        raises only where the exact route meets one too. Counts
        `groups.cached` (a group walked over its cached ranks) and
        `groups.probed` once a pass; the chained encode runs in the span
        `chained`."""
        self._rebind(model, timer)
        V = model.vocab_size()
        freqs = np.zeros(V, dtype=np.int64)
        counts = None
        dp_ends, spans_checked = [], []
        # Each walked group and its bin V (a view: the first group's counts
        # are the running sum, so its bin is the pass's).
        walked, bins = [], []
        with lat.phase(timer, "pack"):
            groups = self._freq_groups()
        cached = 0
        for gi, sub in groups:
            batch, key, dp, best_l, hit = self._freq_viterbi(gi, sub, timer)
            cached += hit
            info = self._freq_info(gi, sub)
            if info["countable"]:
                with lat.phase(timer, "walk"):
                    index = self._walk_spans_for(key, info, sub,
                                                 best_l.shape[1])
                    # An unreachable end walks a garbage chain: it is not
                    # walked, and the pass raises NoPath after the readback.
                    dpe = index.dp_ends(dp)
                    cnt = lat.walk_counts(self.dt, batch, best_l, index,
                                          ok=torch.isfinite(dpe))
                    counts = cnt if counts is None else counts.add_(cnt)
                dp_ends.append(dpe)
                spans_checked.extend(info["countable"])
                walked.append((gi, sub))
                bins.append(cnt[V:])
            if task is not None:
                task.record(sum(e - s for (_, s, e, _, _) in info["whole"]),
                            len({sp[3] for sp in info["whole"]}))
        trace.count("groups.cached", cached)
        trace.count("groups.probed", len(groups) - cached)
        # Samples past the frequency packing's cap: this rank's own chained
        # encode (every rank encodes all of them under a replicated
        # corpus), counted on the device and read back with the groups'.
        long_idx = sorted(self._freq_long)
        long_counts, long_freqs, long_fail = None, np.zeros(V, np.int64), None
        if long_idx:
            long = [self.samples[si] for si in long_idx]
            probe = "exact" if self.exact else None
            try:
                with trace.span("chained"):
                    chained = ed._encode_chained(
                        self.dt, list(enumerate(long)), ed.chained_width(),
                        backend=ed._eff_backend(self.dt, probe, self.dtype),
                        dropout=0.0, seed=0x5151, probe=probe,
                        device=self.dev, timer=timer, dtype=self.dtype)
                    long_counts = chained.counts(V)
                    for ids in ed._redo_false(model, self.dt, long,
                                              chained.false, probe,
                                              self.dtype, self.dev, timer):
                        long_freqs += np.bincount(np.asarray(ids, np.int64),
                                                  minlength=V)
            except NoPathError as err:
                long_fail = (0, err.length)
            except KeyError:
                long_fail = (1, 1)
            if task is not None:
                task.record(sum(len(self.samples[si]) for si in long_idx),
                            len(long_idx))
        fail, value = -1, 0.0
        if counts is not None or long_counts is not None:
            with lat.phase(timer, "readback"):
                both = torch.cat([c for c in (counts, long_counts)
                                  if c is not None]).cpu().numpy()
                dpe_h = (torch.cat(dp_ends).cpu().numpy() if dp_ends
                         else None)
            if long_counts is not None:
                long_freqs += both[-V:]
        if counts is not None:
            counts_h = both[: V + 1].astype(np.int64)
            bad = np.nonzero(~np.isfinite(dpe_h))[0]
            if bad.size:
                _, s, e, _, _ = spans_checked[int(bad[0])]
                fail, value = 0, e - s
            elif counts_h[V] and self.exact:
                fail, value = 1, int(counts_h[V])
            elif counts_h[V]:
                try:
                    counts_h = self._redo_false(model, walked, bins,
                                                counts_h, timer)
                except KeyError:
                    fail, value = 1, int(counts_h[V])
            freqs += counts_h[:V]
        if fail < 0 and long_fail is not None:
            fail, value = long_fail
        # A failure on any rank raises on every rank, before the sum.
        fail, value = pmesh.allgather_fail(fail, value)
        if fail == 0:
            raise NoPathError(int(value), int(value))
        if fail == 1:
            raise RuntimeError(
                f"walk: {int(value)} matched spans are not vocabulary "
                "tokens (model/table mismatch)")
        if self.local_shard:
            return pmesh.all_reduce_counts(freqs + long_freqs)
        return pmesh.all_reduce_counts(freqs) + long_freqs
