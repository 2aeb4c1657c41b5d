"""Adjacent-id pair counts, merge's pair count: the Hopper kernel and its
plain twin.

Counterpart of the JAX package's native `count_pairs`
(tokengeex_tpu/utils/nativelib.py over native/tokengeex_native.cpp
`tg_count_pairs`, a threaded hash count of (a << 32) | b keys) and of the
np.unique count of its device route (tokengeex_tpu/train/estep_device.py),
as the port's `count_pairs_arrays` runs it (train/estep_device.py). The
kernel is csrc/pair_count.cu, an open-addressing
hash table of 16-byte {key, count - 1} slots in device memory with three
entries: insert a row group's walked ids (each block folds its range's
pairs in a table in shared memory first and sends each distinct row once),
insert weighted (key, count) rows, compact the used slots. `PairTable`
holds one table and launches them; `table_slots` sizes it from the
distinct keys; `pair_count_plain` is the twin of one group's count, its
keys formed with torch ops and counted by `torch.unique`.

Layout: flat (>= incl[-1],) int32, the walk's ids span after span; incl
(n,) int32, the inclusive offsets of the spans' ids in flat (span k's at
[incl[k] - ntok[k], incl[k])). Spans are whole samples, so a pair never
straddles two. Keys are int64, (a << 32) | b with a, b < 2^31.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .lattice_cuda import _check, _launch

EMPTY = -1  # a free slot's key (~0 as uint64)
MIN_SLOTS = 1 << 12  # the least table (a power of two)
MAX_PROBE = 64  # slots an insert probes before its row spills
# Slots the rehash and the spill's drain probe (into a table at most half
# full) before they flag an overflow.
DRAIN_PROBE = 1 << 12
# The state's words: distinct keys claimed, overflow and mismatch flags,
# rows spilled since the last drain, rows sent to the table, the
# compaction's cursor.
DISTINCT, OVERFLOW, MISMATCH, SPILLED, SENT, CURSOR = range(6)


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def table_slots(held: int, hint: int, spilled: int = 0) -> int:
    """The slots of a table that holds `held` distinct keys and is to take
    `hint` more and `spilled` rows: the least power of two at least twice
    their sum, and at least MIN_SLOTS. At most half full, a probe stays
    short; a hint that falls short costs a spill and a regrow, not a
    count."""
    return max(MIN_SLOTS, _pow2_at_least(2 * (held + hint + spilled)))


def pair_keys(flat: torch.Tensor, incl: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, ids): the key of every two adjacent ids of one span, in
    flat's order, and the (incl[-1],) int64 ids they are formed from (as
    the kernel reads them: unsigned 32-bit)."""
    total = int(incl[-1]) if incl.numel() else 0
    ids = flat[:total].to(torch.int64) & 0xFFFFFFFF
    last = torch.zeros(total, dtype=torch.bool, device=flat.device)
    last[incl[incl > 0].long() - 1] = True
    keys = (ids[:-1] << 32) | ids[1:]
    return keys[~last[:-1]], ids


def pair_count_plain(flat: torch.Tensor, incl: torch.Tensor, vocab_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(keys, counts, mismatch) of the spans' adjacent pairs: the distinct
    int64 keys in ascending order, their int64 counts, and a 0-d bool, True
    where an id is >= vocab_size (the walk's value for a token no table row
    holds)."""
    keys, ids = pair_keys(flat, incl)
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    return uniq, counts, (ids >= vocab_size).any()


class PairTable:
    """(key, count) rows of adjacent id pairs, key = (a << 32) | b.

    On the card, an open-addressing hash table (csrc/pair_count.cu): int64
    `table` (slots, 2), a slot's key and its count - 1 side by side (a
    free slot all EMPTY, one fill), a spill buffer `spill` (rows, 2) of
    (key, count) that the inserts append to when a probe runs past
    MAX_PROBE slots (allocated at the rows the launches since the last
    drain can send, never filled), and a (6,) int64 `state` on the
    device: the distinct keys claimed, an overflow flag, a mismatch flag
    (an id >= V), the rows spilled, the rows sent to the table and the
    compaction's cursor. A table is sized from a hint of the distinct keys it
    will hold (`table_slots`); after a readback, `reserve` grows it and
    drains the spilled rows, and `compact` does so itself, so no row is
    lost; `compact` raises if a row found neither a slot nor room in the
    spill buffer. On the CPU, the rows of every insert are kept as they
    come (a group's from `pair_count_plain`) and summed by key in
    `compact`; `state` is kept alike (distinct and sent: the rows held).
    `PairTable.launches` counts every kernel launch of the three
    entries."""

    launches = 0

    def __init__(self, device, hint: int = 0):
        self.dev = torch.device(device)
        if self.dev.type not in ("cpu", "cuda"):
            _check(False, f"unsupported device {self.dev}")
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.state = torch.zeros(6, dtype=torch.int64, device=self.dev)
        self.parts: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.slots = 0
        self.spill = None
        self.pending = 0  # rows the launches since the last drain can spill
        self.compacted = False  # the state's cursor is no longer 0
        if self.dev.type == "cuda":
            self._alloc(table_slots(0, hint))

    def _alloc(self, slots: int) -> None:
        self.slots = slots
        self.table = torch.full((slots, 2), EMPTY, dtype=torch.int64,
                                device=self.dev)

    def read(self, *scalars: torch.Tensor) -> List[int]:
        """The 0-d device scalars given, then the state (distinct keys,
        overflow, mismatch, spilled, sent, cursor), read back at once."""
        if not scalars:
            return self.state.tolist()
        head = torch.stack([s.to(torch.int64) for s in scalars])
        return torch.cat([head, self.state]).tolist()

    def reserve(self, hint: int, distinct: Optional[int] = None,
                spilled: Optional[int] = None) -> None:
        """Room for `hint` more distinct keys. `distinct` and `spilled`
        are the state's words as a readback after the last launch gave
        them (read back here when either is not given). The table grows to
        `table_slots(distinct, hint, spilled)` when that is more than it
        has, its slots rehashed through the weighted entry; then the
        spilled rows go in through the weighted entry and the spill buffer
        is free again."""
        if self.dev.type != "cuda":
            return
        if distinct is None or spilled is None:
            state = self.read()
            distinct, spilled = state[DISTINCT], state[SPILLED]
        need = table_slots(distinct, hint, spilled)
        if need > self.slots:
            old, old_slots = self.table, self.slots
            self._alloc(need)
            self.state[DISTINCT] = 0
            if distinct:
                self._drain(old, old_slots, 1)
        if spilled:
            self._drain(self.spill, spilled, 0)
            self.state[SPILLED] = 0
        self.pending = 0

    def _check_rows(self, named: dict, dtype: torch.dtype) -> None:
        # The messages are formatted only on a failure: a merge pass calls
        # this once a group, on its critical path.
        for name, t in named.items():
            if t.dim() != 1 or t.dtype != dtype:
                _check(False, f"{name} must be 1-D {dtype}")
            if t.device != self.dev:
                _check(False, f"{name} is on {t.device}, the table on "
                       f"{self.dev}")
            if self.dev.type != "cpu" and not t.is_contiguous():
                _check(False, f"{name} must be contiguous")

    def _spill_room(self, rows: int) -> torch.Tensor:
        """The spill buffer, with room for `rows` more beside those the
        launches since the last drain may have put there (kept)."""
        need = self.pending + rows
        if self.spill is None or self.spill.shape[0] < need:
            spill = torch.empty((need, 2), dtype=torch.int64,
                                device=self.dev)
            if self.pending:
                spill[: self.pending] = self.spill[: self.pending]
            self.spill = spill
        self.pending = need
        return self.spill

    def insert_ids(self, flat: torch.Tensor, incl: torch.Tensor,
                   vocab_size: int) -> None:
        """Adds the adjacent pairs of the spans' ids (the module's layout)
        and flags an id >= vocab_size. CUDA tensors launch
        `tgx_pair_insert_ids` on the current stream with nothing read back;
        CPU tensors run `pair_count_plain`."""
        self._check_rows({"flat": flat, "incl": incl}, torch.int32)
        n = incl.numel()
        if n == 0:
            return
        if self.dev.type == "cpu":
            keys, counts, bad = pair_count_plain(flat, incl, vocab_size)
            self._hold(keys, counts)
            self.state[MISMATCH] |= bad
            return
        rows = flat.numel()
        spill = self._spill_room(rows)
        _launch("pair_insert_ids", flat, incl, n, vocab_size, self.table,
                self.slots, self.state, spill, spill.shape[0], MAX_PROBE,
                rows)
        PairTable.launches += 1

    def insert_weighted(self, keys: torch.Tensor,
                        counts: torch.Tensor) -> None:
        """Adds (key, count) rows, int64 (m,) each; EMPTY keys are
        skipped. CUDA tensors launch `tgx_pair_insert_weighted`."""
        self._check_rows({"keys": keys, "counts": counts}, torch.int64)
        _check(keys.shape == counts.shape, "keys and counts differ in shape")
        if self.dev.type == "cpu":
            live = keys != EMPTY
            self._hold(keys[live], counts[live])
            return
        if keys.numel():
            spill = self._spill_room(keys.numel())
            self._launch_weighted(keys, counts, keys.numel(), 1, 0,
                                  MAX_PROBE, spill)

    def _drain(self, rows: torch.Tensor, m: int, bias: int) -> None:
        """Adds the first m rows of a (rows, 2) buffer, an old table's
        slots (bias 1: they hold count - 1) or the spill buffer's (key,
        count) rows, with no spill (the table is at most half full: a row
        that finds no slot flags an overflow)."""
        self._launch_weighted(rows[:, 0], rows[:, 1], m, 2, bias,
                              DRAIN_PROBE, None)

    def _launch_weighted(self, keys, counts, m: int, stride: int, bias: int,
                         max_probe: int, spill) -> None:
        _launch("pair_insert_weighted", keys, counts, m, stride, bias,
                self.table, self.slots, self.state, spill,
                0 if spill is None else spill.shape[0], max_probe)
        PairTable.launches += 1

    def _hold(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        self.parts.append((keys, counts))
        self.state[DISTINCT] += keys.numel()
        self.state[SENT] += keys.numel()

    def compact(self, distinct: Optional[int] = None,
                spilled: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The held (keys, counts), int64, each key once: on the card in
        slot order (spilled rows drained by `reserve` when there are any,
        `tgx_pair_compact` into a buffer of the distinct keys, then one
        readback of its cursor and the flags), on the CPU in key order.
        `distinct` and `spilled` are the state's words as a readback after
        the last launch gave them (read back here when either is not
        given). Raises RuntimeError if a row found neither a slot nor room
        to spill."""
        if self.dev.type == "cpu":
            if not self.parts:
                empty = torch.zeros(0, dtype=torch.int64)
                return empty, empty.clone()
            keys = torch.cat([k for k, _ in self.parts])
            counts = torch.cat([c for _, c in self.parts])
            uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
            return uniq, torch.zeros_like(uniq).index_add_(0, inv, counts)
        overflow = 0
        if distinct is None or spilled is None:
            distinct, overflow, _, spilled, _, _ = self.read()
        if spilled and not overflow:
            self.reserve(0, distinct, spilled)
            distinct, overflow = self.read()[:2]
        n = -1
        if not overflow:
            out = self._compact_launch(distinct)
            state = self.read()
            overflow, n = state[OVERFLOW], state[CURSOR]
        if overflow or n != distinct:
            raise RuntimeError(
                f"pair table of {self.slots} slots overflowed ({n} keys, "
                f"{distinct} expected): a row found no slot and no room in "
                "the spill buffer")
        return out[0], out[1]

    def _compact_launch(self, rows: int) -> torch.Tensor:
        """`tgx_pair_compact` into a (2, rows) buffer (keys, counts), with
        nothing read back; the state's cursor counts the used slots, of
        which the first `rows` are written."""
        out = torch.empty((2, rows), dtype=torch.int64, device=self.dev)
        if self.compacted:
            self.state[CURSOR] = 0
        _launch("pair_compact", self.table, self.slots, out[0], out[1],
                rows, self.state)
        PairTable.launches += 1
        self.compacted = True
        return out
