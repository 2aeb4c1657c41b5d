"""Adjacent-id pair counts, merge's pair count: the Hopper kernel and its
plain twin.

Counterpart of the JAX package's native `count_pairs`
(tokengeex_tpu/utils/nativelib.py over native/tokengeex_native.cpp
`tg_count_pairs`, a threaded hash count of (a << 32) | b keys) and of the
np.unique count of its device route (tokengeex_tpu/train/estep_device.py
`count_pairs_device`). The kernel is csrc/pair_count.cu, an open-addressing
hash table in device memory with three entries: insert a row group's walked
ids, insert weighted (key, count) rows, compact the used slots.
`PairTable` holds one table and launches them; `pair_count_plain` is the
twin of one group's count, its keys formed with torch ops and counted by
`torch.unique`.

Layout: flat (>= incl[-1],) int32, the walk's ids span after span; incl
(n,) int32, the inclusive offsets of the spans' ids in flat (span k's at
[incl[k] - ntok[k], incl[k])). Spans are whole samples, so a pair never
straddles two. Keys are int64, (a << 32) | b with a, b < 2^31.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .lattice_cuda import _check, _launch

EMPTY = -1  # a free slot's key (~0 as uint64)
MIN_SLOTS = 1 << 12  # a new table's slots (a power of two)


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


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
    `keys` (slots,), EMPTY for a free slot, and `counts` (slots,), and a
    (3,) int64 `state` on the device: the distinct keys claimed, an
    overflow flag and a mismatch flag (an id >= V). The caller keeps slots
    >= 2 x the keys the table may hold (`reserve`, before every insert), so
    a probe stays short and never overflows; `compact` raises if one did.
    On the CPU, the rows of every insert are kept as they come (a group's
    from `pair_count_plain`) and summed by key in `compact`; `state` is
    kept alike (distinct: the rows held). `PairTable.launches` counts every
    kernel launch of the three entries."""

    launches = 0

    def __init__(self, device):
        self.dev = torch.device(device)
        _check(self.dev.type in ("cpu", "cuda"),
               f"unsupported device {self.dev}")
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.state = torch.zeros(3, dtype=torch.int64, device=self.dev)
        self.held = 0  # a bound of the distinct keys held
        self.parts: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.slots = 0
        if self.dev.type == "cuda":
            self._alloc(MIN_SLOTS)

    def _alloc(self, slots: int) -> None:
        self.slots = slots
        self.keys = torch.full((slots,), EMPTY, dtype=torch.int64,
                               device=self.dev)
        self.counts = torch.zeros(slots, dtype=torch.int64, device=self.dev)

    def read(self, *scalars: torch.Tensor) -> List[int]:
        """The 0-d device scalars given, then the state (distinct keys,
        overflow, mismatch), read back at once."""
        head = [torch.stack([s.to(torch.int64) for s in scalars])] \
            if scalars else []
        return torch.cat(head + [self.state]).tolist()

    def reserve(self, pairs: int, distinct=None) -> None:
        """Room for `pairs` more keys beside `distinct` held (a count read
        back, or by default the bound `held`): slots >= 2 (distinct +
        pairs), a grown table taking the old one's slots as they lie (a
        rehash through the weighted entry)."""
        rehash = self.held > 0
        self.held = (self.held if distinct is None else distinct) + pairs
        need = 2 * self.held
        if self.dev.type != "cuda" or need <= self.slots:
            return
        old = (self.keys, self.counts, self.slots)
        self._alloc(_pow2_at_least(need))
        self.state[0] = 0
        if rehash:
            self._insert_weighted(*old)

    def _check_rows(self, named: dict, dtype: torch.dtype) -> None:
        for name, t in named.items():
            _check(t.dim() == 1 and t.dtype == dtype,
                   f"{name} must be 1-D {dtype}")
            _check(t.device == self.dev, f"{name} is on {t.device}, the "
                   f"table on {self.dev}")
            _check(self.dev.type == "cpu" or t.is_contiguous(),
                   f"{name} must be contiguous")

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
            self.state[2] |= bad
            return
        _launch("pair_insert_ids", flat, incl, n, vocab_size, self.keys,
                self.counts, self.slots, self.state, flat.numel())
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
        self._insert_weighted(keys, counts, keys.numel())

    def _insert_weighted(self, keys, counts, m: int) -> None:
        if m:
            _launch("pair_insert_weighted", keys, counts, m, self.keys,
                    self.counts, self.slots, self.state)
            PairTable.launches += 1

    def _hold(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        self.parts.append((keys, counts))
        self.state[0] += keys.numel()

    def compact(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The held (keys, counts), int64, each key once: on the card in
        slot order (`tgx_pair_compact`, then one readback of the row count
        and the flags), on the CPU in key order. Raises RuntimeError if an
        insert found the table full."""
        if self.dev.type == "cpu":
            if not self.parts:
                empty = torch.zeros(0, dtype=torch.int64)
                return empty, empty.clone()
            keys = torch.cat([k for k, _ in self.parts])
            counts = torch.cat([c for _, c in self.parts])
            uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
            return uniq, torch.zeros_like(uniq).index_add_(0, inv, counts)
        out_k, out_c, cursor = self._compact_launch()
        n, _, overflow, _ = self.read(cursor[0])
        if overflow or n > out_k.numel():
            raise RuntimeError(
                f"pair table of {self.slots} slots overflowed ({n} keys, "
                f"{out_k.numel()} expected): it was not reserved for its "
                "inserts")
        return out_k[:n], out_c[:n]

    def _compact_launch(self):
        """`tgx_pair_compact` into buffers of the `held` bound, with nothing
        read back: (out_keys, out_counts, cursor), cursor[0] the used
        slots."""
        cap = min(self.held, self.slots)
        out_k = torch.empty(cap, dtype=torch.int64, device=self.dev)
        out_c = torch.empty(cap, dtype=torch.int64, device=self.dev)
        cursor = torch.zeros(1, dtype=torch.int64, device=self.dev)
        _launch("pair_compact", self.keys, self.counts, self.slots, out_k,
                out_c, cap, cursor)
        PairTable.launches += 1
        return out_k, out_c, cursor
