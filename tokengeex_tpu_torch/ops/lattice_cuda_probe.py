"""The slab route's vocabulary probe: the Hopper kernel.

Counterpart of tokengeex_tpu/ops/lattice_jax.py `_match_slab` as
`_match_cache_impl` drives it (an XLA program): csrc/match_probe.cu probes
a whole row group in one launch and writes the start-indexed (lead + W, L,
B) score cache, and the slot cache when asked, in the layout the scans
read. Its plain twin is ops/lattice.py `match_cache_plain` (`_match_slab`
chunk by chunk); ops/lattice.py `match_cache` checks the arguments here
(`check_probe`), then runs the twin for CPU tensors and `match_probe` for
CUDA ones.

Modes, as in `_match_slab`: "bucket" (the single-probe buckets), "fast"
("em" is an alias: the cuckoo rows with the port's check word) and
"exact" (both fingerprints and the length checked, the slot the token id,
the score gathered by id at the tables' type). Scores are float32 or
float64; `match_probe.launches` counts the float32 launches and
`match_probe.launches_f64` the float64 ones.

The bucket mode's miss filter: one byte a bucket row
(`bucket_filter_plain`). For a table of FILTER_MIN_BITS..FILTER_MAX_BITS
bucket bits (`has_filter`) it is derived from the table's own rows when
DeviceTables are made (`BucketFilter.of`) and refused for any other
table; the kernel keeps it in shared memory and a valid point whose tag
bit is clear gathers nothing ("filtered"). Other tables have none, and
every valid point gathers its row ("gather", `probe_branch`).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from .lattice_cuda import MAX_LEN, _check, _launch

MODES = {"bucket": 0, "fast": 1, "em": 1, "exact": 2}
# The bucket tables (log2 rows) that take the filtered branch: the
# kernel copies the filter, one byte a row, into shared memory 16 bytes at
# a time, and up to 2^17 bytes fit beside its stage buffers.
FILTER_MIN_BITS = 4
FILTER_MAX_BITS = 17
# A bucket entry that was never placed: check 0, the f32 -3e38 score.
_EMPTY_SCORE_BITS = int(np.array([-3.0e38], np.float32).view(np.int32)[0])


def bucket_filter_plain(t_bucket: torch.Tensor) -> torch.Tensor:
    """The (Hb,) uint8 miss filter of (Hb, 16) bucket rows: bit t < 7 set
    when an entry that differs from the empty pattern has tag t =
    (check * 7) >> 32 (its check as uint32), bit 7 when any of entries 4-7
    differs from it. An empty-pattern entry never hits (its score fails
    the probe's test), so a probe whose tag bit is clear is a miss."""
    chk = t_bucket[:, 0::2]
    placed = (chk != 0) | (t_bucket[:, 1::2] != _EMPTY_SCORE_BITS)
    tag = filter_tag(chk)
    byte = placed[:, 4:].any(dim=1).to(torch.int32) << 7
    for t in range(7):
        byte |= (placed & (tag == t)).any(dim=1).to(torch.int32) << t
    return byte.to(torch.uint8)


def filter_tag(check: torch.Tensor) -> torch.Tensor:
    """The filter's tag, 0..6, of int32 check words: umulhi(check, 7)."""
    return ((check.to(torch.int64) & 0xFFFFFFFF) * 7) >> 32


@dataclasses.dataclass(frozen=True, eq=False)
class BucketFilter:
    """A bucket table's miss filter and the t_bucket tensor it was derived
    from (held weakly, with its in-place version): a filter belongs only
    to that tensor as it was."""

    tags: torch.Tensor  # (Hb,) uint8
    source: weakref.ref
    version: int

    @staticmethod
    def of(t_bucket: torch.Tensor) -> "BucketFilter":
        return BucketFilter(bucket_filter_plain(t_bucket),
                            weakref.ref(t_bucket), t_bucket._version)

    def belongs_to(self, t_bucket: Optional[torch.Tensor]) -> bool:
        return (t_bucket is not None and self.source() is t_bucket
                and self.version == t_bucket._version)


def has_filter(bk_bits: int) -> bool:
    """Whether a bucket table of `bk_bits` takes the filtered branch."""
    return FILTER_MIN_BITS <= bk_bits <= FILTER_MAX_BITS


def probe_branch(tbl, mode: str) -> str:
    """The kernel's branch for `mode` on `tbl`: "filtered" (the bucket
    filter in shared memory, one sector a gather) or "gather" (every valid
    point gathers its rows)."""
    return ("filtered" if mode == "bucket" and has_filter(tbl.bk_bits)
            else "gather")


def _tables(tbl, mode: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The mode's (first, second) table rows; raises where the tables
    lack them."""
    if mode == "bucket":
        _check(tbl.t_bucket is not None and tbl.t_bucket.numel() > 0,
               "the bucket probe needs the tables' buckets (t_bucket)")
        _check(1 <= tbl.bk_bits <= 31, f"bk_bits {tbl.bk_bits} outside 1..31")
        _check(probe_branch(tbl, mode) == "gather"
               or (tbl.bk_filter is not None
                   and tbl.bk_filter.belongs_to(tbl.t_bucket)),
               "the bucket filter was not derived from these buckets "
               "(DeviceTables.from_numpy derives it)")
        return tbl.t_bucket, None
    if mode == "exact":
        _check(tbl.t1_exact is not None and tbl.t2_exact is not None,
               "the exact probe needs the tables' exact rows "
               "(DeviceTables.from_table makes them)")
        return tbl.t1_exact, tbl.t2_exact
    return tbl.t1_fast, tbl.t2_fast


def check_probe(tbl, batch, mode: str, lead: int,
                dtype: torch.dtype) -> bool:
    """Validate a probe of `batch` against `tbl` (a DeviceTables and a
    DeviceBatch of ops/lattice.py). Returns True when the caller is to
    launch the kernel, False for CPU tensors (the twin)."""
    _check(mode in MODES, f"unknown probe mode {mode!r}")
    _check(dtype in (torch.float32, torch.float64),
           f"scores must be float32 or float64, got {dtype}")
    _check(0 <= lead <= batch.pad, f"lead {lead} outside 0..{batch.pad}")
    first, second = _tables(tbl, mode)
    B = batch.p1.shape[0]
    W, L, pad = batch.width, tbl.max_len, batch.pad
    streams = {"p1": (batch.p1, 2, pad + W + L),
               "p2": (batch.p2, 2, pad + W + L),
               "sid": (batch.sid, 2, pad + W + L - 1),
               "rinv1": (batch.rinv1, 1, pad + W),
               "rinv2": (batch.rinv2, 1, pad + W)}
    dev = batch.p1.device
    for name, (t, dim, least) in streams.items():
        _check(t.dim() == dim and t.shape[-1] >= least
               and (dim == 1 or t.shape[0] == B),
               f"{name} must reach {least} positions"
               f"{f' in {B} rows' if dim == 2 else ''}, "
               f"got {tuple(t.shape)}")
        _check(t.dtype == torch.int32, f"{name} must be int32")
        _check(t.device == dev, f"{name} is on {t.device}")
    tables = {"table": first, "second table": second}
    if mode == "exact":
        tables["scores"] = tbl.scores
        _check(tbl.scores.dtype in (torch.float32, torch.float64),
               f"scores must be float32 or float64, got {tbl.scores.dtype}")
    for name, t in tables.items():
        if t is not None:
            _check(t.device == dev, f"the {name} is on {t.device}")
    if dev.type == "cpu":
        return False
    if probe_branch(tbl, mode) == "filtered":
        tags = tbl.bk_filter.tags
        _check(tags.device == dev and tags.dtype == torch.uint8
               and tags.is_contiguous()
               and tags.shape == (tbl.t_bucket.shape[0],)
               and tbl.t_bucket.shape[0] == 1 << tbl.bk_bits
               and tags.data_ptr() % 16 == 0,
               "the bucket filter must be (2^bk_bits,) uint8, contiguous "
               "and 16-byte aligned on the tables' device")
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(1 <= L <= MAX_LEN, f"token length {L} outside 1..{MAX_LEN}")
    width = {"bucket": 16, "fast": 2, "exact": 4}[
        "fast" if mode == "em" else mode]
    for name, t in tables.items():
        if t is None:
            continue
        if name != "scores":
            _check(t.dtype == torch.int32 and t.dim() == 2
                   and t.shape[1] == width,
                   f"the {name} must be (rows, {width}) int32")
            # The kernel reads rows as int2 / int4.
            _check(t.data_ptr() % 16 == 0, f"the {name} is not 16-byte "
                   "aligned")
        _check(t.is_contiguous(), f"the {name} must be contiguous")
    for name, (t, _, _) in streams.items():
        _check(t.is_contiguous(), f"{name} must be contiguous")
    return True


def match_probe(tbl, batch, mode: str, lead: int = 0, slots: bool = True,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch csrc/match_probe.cu on the current stream: the start-indexed
    (score, slot) caches of ops/lattice.py `match_cache`, each (lead + W,
    L, B), score at `dtype` (-inf for a miss), slot int32 (the miss index
    num_slots / bk_num_slots, or in exact mode the token id, -1 for a
    miss), None when slots=False. CUDA tensors only: CPU tensors take
    `match_cache_plain` in `match_cache`."""
    _check(check_probe(tbl, batch, mode, lead, dtype),
           "match_probe launches on CUDA tensors only")
    B = batch.p1.shape[0]
    W, L, pad = batch.width, tbl.max_len, batch.pad
    Q = lead + W
    dev = batch.p1.device
    score = torch.empty((Q, L, B), dtype=dtype, device=dev)
    slot = (torch.empty((Q, L, B), dtype=torch.int32, device=dev)
            if slots else None)
    if Q == 0 or B == 0:
        return score, slot
    first, second = _tables(tbl, mode)
    code = MODES[mode]
    if mode == "bucket":
        shift, miss, t2_off = 32 - tbl.bk_bits, tbl.bk_num_slots, 0
    else:
        _check(1 <= tbl.bits <= 31, f"bits {tbl.bits} outside 1..31")
        shift = 32 - tbl.bits
        miss = -1 if mode == "exact" else tbl.num_slots
        t2_off = 1 << tbl.bits
    exact = mode == "exact"
    f64 = dtype == torch.float64
    filt = (tbl.bk_filter.tags if probe_branch(tbl, mode) == "filtered"
            else None)
    _launch("match_probe_f64" if f64 else "match_probe",
            batch.p1, batch.p2, batch.sid, batch.rinv1, batch.rinv2, first,
            second, tbl.scores if exact else None, filt, score, slot,
            batch.p1.shape[1], batch.sid.shape[1], batch.rinv1.shape[0], B,
            L, Q, pad - lead, code, shift, tbl.bk_salt % (1 << 32), miss,
            t2_off, int(exact and tbl.scores.dtype == torch.float64))
    if f64:
        match_probe.launches_f64 += 1
    else:
        match_probe.launches += 1
    return score, slot


match_probe.launches = 0
match_probe.launches_f64 = 0

