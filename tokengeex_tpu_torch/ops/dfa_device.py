"""Device byte-DFA: the generate stage's allow-regex on the GPU.

Counterpart of tokengeex_tpu/ops/dfa_device.py. The reference tests every
substring of every sample against the allow regex with a host regex
engine (reference: src/generate.rs:80-111); the byte-DFA table
(core/redfa.py) turns that into up to L table steps per start position,
which the device takes as a byte-class table (`DeviceDFA`: bytes with
equal transition columns share a class).

`packed_candidate_mask` computes the full (sample, pos, len) candidate
mask -- allow-match AND insert-probability coin AND char boundaries --
bit-packed along the row: on CUDA tensors csrc/dfa_mask.cu, on CPU
tensors its plain PyTorch version. `feed_counts` then drains the mask on
the same device (exact byte keys, per-sample dedup, counts folded over
the row groups) and reads back only the distinct candidates and their
document frequencies, once per call.

The insert coin is counter-based (`coin_u32`), keyed on (seed, global
sample index, pos, len), so the counts do not depend on how the samples
are grouped. It cannot reproduce `jax.random.uniform`: against the JAX
package the coins agree in distribution only (every candidate is kept at
p >= 1, where the two agree exactly).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.redfa import ByteDFA
from . import _build
from .lattice import phase

log = logging.getLogger(__name__)

MAX_LEN = 64  # longest candidate the kernel takes
GROUP_BYTES = 1 << 23  # bytes of packed rows per mask group
# The kernel's shared memory a block may use (H100: 227 KB), and its tile:
# 1,024 positions with an L-byte halo (csrc/dfa_mask.cu).
SMEM_LIMIT = 232448
_TILE = 1024
# Drain this many set mask bytes (up to 8 candidates each) at a time, so
# that a chunk's (candidates, 8 ceil(L / 8)) int64 byte gathers stay
# near 0.5 GB at L = 16 even at p = 1.
DRAIN_BYTES = 1 << 19
_M32 = 0xFFFFFFFF
_ROUTES = {None: 0, "shared": 1, "global": 2}


@dataclasses.dataclass(frozen=True)
class DeviceDFA:
    """A byte DFA as a byte-class table: bytes whose columns of the
    transition table are equal across every state share a class, and
    next(state, byte) = table[state * num_classes + byte_class[byte]]."""

    byte_class: torch.Tensor  # (256,) uint8 on the device
    # (num_states * num_classes,) next states: uint8 when num_states <=
    # 256, else int16 holding the uint16 bits
    table: torch.Tensor
    accept: torch.Tensor  # (num_states,) bool on the device
    start: int
    num_states: int
    num_classes: int

    @property
    def entry_bytes(self) -> int:
        return self.table.element_size()

    @staticmethod
    def from_byte_dfa(dfa: ByteDFA, device) -> "DeviceDFA":
        nxt = np.asarray(dfa.next, dtype=np.int64)
        S = nxt.shape[0]
        if S > 1 << 16:
            raise ValueError(f"{S} DFA states: the class table holds at "
                             "most 65,536")
        cols, cls = np.unique(nxt.T, axis=0, return_inverse=True)
        tab = np.ascontiguousarray(cols.T).reshape(-1)
        tab = (tab.astype(np.uint8) if S <= 256
               else tab.astype(np.uint16).view(np.int16))
        return DeviceDFA(
            byte_class=torch.as_tensor(
                cls.reshape(-1).astype(np.uint8)).to(device),
            table=torch.as_tensor(tab).to(device),
            accept=torch.as_tensor(np.asarray(dfa.accept, dtype=bool)).to(
                device),
            start=int(dfa.start), num_states=S, num_classes=cols.shape[0],
        )

    def next_states(self) -> torch.Tensor:
        """The class table as int64 next states, (num_states,
        num_classes)."""
        return (self.table.to(torch.int64) & 0xFFFF).reshape(
            self.num_states, self.num_classes)


def _device_dfa_for(dfa: ByteDFA, device) -> DeviceDFA:
    """Upload the DFA tables once per ByteDFA and device (cached on the
    object)."""
    cache: Dict[str, DeviceDFA] = dfa.__dict__.setdefault(
        "_tgx_torch_device_dfa", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = DeviceDFA.from_byte_dfa(dfa, device)
    return cache[key]


# ---------------------------------------------------------------------------
# The insert coin: uint32 arithmetic in int64 tensors
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32) (int64) and a uint32 constant c,
    in halves so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's `tgx_mix32` (a bijection of 32 bits) on int64 values
    in [0, 2^32); `>>` on non-negative int64 is a logical shift."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """k0 of the coin: mix(seed ^ 0x9E3779B9) as a Python int (`mix32`
    in Python integers: no tensor work on the launch path)."""
    x = (int(seed) & _M32) ^ 0x9E3779B9
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def coin_u32(seed: int, sample: torch.Tensor, pos: torch.Tensor,
             length: torch.Tensor) -> torch.Tensor:
    """The insert coin of (seed, sample, pos, len) as int64 in [0, 2^32),
    broadcast over the three index tensors."""
    k1 = mix32((sample.to(torch.int64) & _M32) ^ seed_key(seed))
    k2 = mix32(k1 ^ (pos.to(torch.int64) & _M32))
    return mix32(k2 ^ (length.to(torch.int64) & _M32))


def coin_threshold(insert_probability: float) -> int:
    """A candidate is kept when its coin is below this: floor(p 2^32), and
    2^32 (every candidate) when p >= 1."""
    if insert_probability >= 1.0:
        return 1 << 32
    return max(0, math.floor(insert_probability * (1 << 32)))


# ---------------------------------------------------------------------------
# Plain PyTorch versions, in the JAX package's (B, L, W) layout
# ---------------------------------------------------------------------------


def match_lengths(ddfa: DeviceDFA, bytes_arr: torch.Tensor,
                  max_len: int) -> torch.Tensor:
    """allowed[b, l-1, p]: whether bytes_arr[b, p:p+l] full-matches
    (the twin of `match_lengths_device`): all start positions walk in
    lockstep, padding bytes included; positions with p + l > W never
    match."""
    B, W = bytes_arr.shape
    dev = bytes_arr.device
    cls = ddfa.byte_class.to(torch.int64)[bytes_arr.to(torch.int64)]
    states = torch.full((B, W), ddfa.start, dtype=torch.int64, device=dev)
    tab = ddfa.next_states().reshape(-1)
    C = ddfa.num_classes
    pos = torch.arange(W, device=dev)[None, :]
    outs = []
    for l in range(1, max_len + 1):
        if l <= W:
            stepped = torch.nn.functional.pad(cls[:, l - 1:], (0, l - 1))
            states = tab[states * C + stepped]
            outs.append(ddfa.accept[states] & (pos + l <= W))
        else:
            outs.append(torch.zeros((B, W), dtype=torch.bool, device=dev))
    return torch.stack(outs, dim=1)


def _end_ok(is_char_start: torch.Tensor, valid_len: torch.Tensor,
            l: int) -> torch.Tensor:
    """(B, W): a candidate of length l starting at p ends at the sample's
    end or just before a char start inside it."""
    B, W = is_char_start.shape
    pos = torch.arange(W, device=is_char_start.device)[None, :]
    end = pos + l
    if l <= W:
        nxt = torch.nn.functional.pad(is_char_start[:, l:], (0, l))
    else:
        nxt = torch.zeros_like(is_char_start)
    return ((end < valid_len[:, None]) & nxt) | (end == valid_len[:, None])


def candidate_mask(ddfa: Optional[DeviceDFA], bytes_arr: torch.Tensor,
                   valid_len: torch.Tensor, max_len: int,
                   insert_probability: float, seed: int,
                   sample_base: int = 0) -> torch.Tensor:
    """(B, L, W) bool candidate mask (the twin of
    `candidate_mask_device`): allow-match, both ends on char boundaries,
    inside the sample, and the insert coin of (seed, sample_base + b,
    pos, len). `ddfa` None allows every substring."""
    B, W = bytes_arr.shape
    dev = bytes_arr.device
    valid_len = valid_len.to(torch.int64)
    if ddfa is None:
        allowed = torch.ones((B, max_len, W), dtype=torch.bool, device=dev)
    else:
        allowed = match_lengths(ddfa, bytes_arr, max_len)
    is_char_start = (bytes_arr.to(torch.int64) & 0xC0) != 0x80
    pos = torch.arange(W, device=dev)
    inside_start = (pos[None, :] < valid_len[:, None]) & is_char_start
    thr = coin_threshold(insert_probability)
    sample = torch.arange(B, device=dev)[:, None] + sample_base
    out = torch.empty((B, max_len, W), dtype=torch.bool, device=dev)
    for l in range(1, max_len + 1):
        ok = allowed[:, l - 1] & inside_start & _end_ok(
            is_char_start, valid_len, l)
        if thr <= _M32:
            ok &= coin_u32(seed, sample, pos[None, :],
                           torch.tensor(l, device=dev)) < thr
        out[:, l - 1] = ok
    return out


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., W / 8) uint8, little-endian along W: bit i
    of byte j is position 8 j + i (the JAX package's reshape-and-weight
    pack)."""
    *lead, W = mask.shape
    m = mask.reshape(*lead, W // 8, 8).to(torch.uint8)
    weights = (1 << torch.arange(8, device=mask.device)).to(torch.uint8)
    return (m * weights).sum(dim=-1, dtype=torch.uint8)


def packed_candidate_mask_plain(ddfa: Optional[DeviceDFA],
                                bytes_arr: torch.Tensor,
                                valid_len: torch.Tensor, max_len: int,
                                insert_probability: float, seed: int,
                                sample_base: int = 0) -> torch.Tensor:
    return pack_bits(candidate_mask(ddfa, bytes_arr, valid_len, max_len,
                                    insert_probability, seed, sample_base))


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def shared_table_bytes(ddfa: DeviceDFA) -> int:
    """Shared memory a block of the kernel's shared route takes at the
    longest candidate length (csrc/dfa_mask.cu `layout`): the class table
    and the accept flags, the byte -> class map, the tile's class
    halfwords with their halo, the tile's mask words, each warp's two
    lists of live walks and the row length."""
    return (_pad16(ddfa.num_states * ddfa.num_classes * ddfa.entry_bytes)
            + _pad16(ddfa.num_states) + 256 + 2 * (_TILE + MAX_LEN)
            + 128 * MAX_LEN + 8 * _TILE + 16)


def pick_route(ddfa: Optional[DeviceDFA]) -> Optional[str]:
    """The kernel's table route: None without a DFA, "shared" when the
    class table fits a block's shared memory, else "global"."""
    if ddfa is None:
        return None
    return "shared" if shared_table_bytes(ddfa) <= SMEM_LIMIT else "global"


def packed_candidate_mask(ddfa: Optional[DeviceDFA], bytes_arr: torch.Tensor,
                          valid_len: torch.Tensor, max_len: int,
                          insert_probability: float, seed: int,
                          sample_base: int = 0,
                          table: Optional[str] = None) -> torch.Tensor:
    """(B, L, W / 8) uint8 bit-packed candidate mask of a (B, W) uint8
    group (W a multiple of 32, `valid_len` (B,) int32 the sample lengths,
    row b holding sample `sample_base + b`).

    CUDA tensors launch csrc/dfa_mask.cu on the current stream; `table`
    ("shared" or "global") forces the class table's route, which by
    default `pick_route` takes by size. CPU tensors run
    `packed_candidate_mask_plain`."""
    B, W = bytes_arr.shape
    if not 1 <= max_len <= MAX_LEN:
        raise ValueError(f"max_len {max_len} outside 1..{MAX_LEN}")
    if W % 32:
        raise ValueError(f"row width {W} is not a multiple of 32")
    if bytes_arr.dtype != torch.uint8 or valid_len.shape != (B,):
        raise ValueError("bytes_arr must be (B, W) uint8, valid_len (B,)")
    if bytes_arr.device.type == "cpu":
        return packed_candidate_mask_plain(ddfa, bytes_arr, valid_len,
                                           max_len, insert_probability,
                                           seed, sample_base)
    if bytes_arr.device.type != "cuda":
        raise ValueError(f"unsupported device {bytes_arr.device}")
    if ddfa is None:
        if table is not None:
            raise ValueError("a table route needs a DFA")
        route = None
    else:
        route = table or pick_route(ddfa)
        if route not in ("shared", "global"):
            raise ValueError(f"unknown table route {table!r}")
        if route == "shared" and shared_table_bytes(ddfa) > SMEM_LIMIT:
            raise ValueError(f"a {ddfa.num_states}-state class table does "
                             "not fit shared memory")
    dev = bytes_arr.device
    out = torch.empty((B, max_len, W // 8), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    if B * W >= 1 << 31:
        raise ValueError(f"a ({B}, {W}) group is over 2^31 bytes")
    lens = valid_len.to(device=dev, dtype=torch.int32).contiguous()
    arr = bytes_arr.contiguous()
    if arr.data_ptr() % 16:
        arr = arr.clone()  # the kernel loads 16 bytes at a time
    if ddfa is None:
        cls = tab = acc = None
        start, S, C, esize = 0, 1, 1, 1
    else:
        cls, tab, acc = ddfa.byte_class, ddfa.table, ddfa.accept
        start, S, C = ddfa.start, ddfa.num_states, ddfa.num_classes
        esize = ddfa.entry_bytes
        if any(t.device != dev for t in (cls, tab, acc)):
            raise ValueError(f"the DFA tables are not on {dev}")
    fn = _build.load("dfa_mask")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(arr.data_ptr(), lens.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (cls, tab, acc)), out.data_ptr(),
                B, W, max_len, S, C, start, _ROUTES[route], esize,
                seed_key(seed), int(sample_base),
                coin_threshold(insert_probability), stream)
    if rc != 0:
        raise RuntimeError(f"dfa_mask launch failed: CUDA error {rc}")
    packed_candidate_mask.launches += 1
    return out


packed_candidate_mask.launches = 0


# ---------------------------------------------------------------------------
# Row groups and the feed
# ---------------------------------------------------------------------------


def group_shape(samples: Sequence[bytes], group_bytes: int):
    """(W8, B): the row width, max(512, the power of two >= the longest
    sample), and the rows a group, `group_bytes // W8` rounded down to a
    power of two and capped at the power of two >= len(samples) (the
    JAX package's `_mask_groups`)."""
    W = max((len(s) for s in samples), default=1)
    W8 = max(512, 1 << (max(W, 1) - 1).bit_length())
    rows = max(1, group_bytes // W8)
    rows = 1 << (rows.bit_length() - 1)
    B = min(rows, 1 << max(0, len(samples) - 1).bit_length())
    return W8, B


def pack_group(chunk: Sequence[bytes], B: int, W8: int):
    """(B, W8) uint8 rows holding the samples of `chunk`, zero-padded, and
    their (B,) int32 lengths."""
    arr = np.zeros((B, W8), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(chunk):
        arr[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    return arr, lens


def _mask_groups(dfa: Optional[ByteDFA], samples: Sequence[bytes],
                 max_len: int, insert_probability: float, seed: int,
                 group_bytes: int, device, timer=None):
    """Yield (g0, n, rows, packed) per row group, on `device`: the group's
    (B, W8) uint8 rows and its (B, L, W8 / 8) packed mask, samples g0 ..
    g0 + n - 1 in rows 0 .. n - 1."""
    ddfa = _device_dfa_for(dfa, device) if dfa is not None else None
    W8, B = group_shape(samples, group_bytes)
    if ddfa is not None and torch.device(device).type == "cuda":
        log.info("dfa_mask: %d-state DFA, %s table route", ddfa.num_states,
                 pick_route(ddfa))
    for g0 in range(0, len(samples), B):
        chunk = samples[g0 : g0 + B]
        with phase(timer, "pack"):
            arr, lens = pack_group(chunk, B, W8)
            rows = torch.from_numpy(arr).to(device)
            lens = torch.from_numpy(lens).to(device)
        with phase(timer, "mask"):
            packed = packed_candidate_mask(ddfa, rows, lens, max_len,
                                           insert_probability, seed, g0)
        yield g0, len(chunk), rows, packed


def feed_candidates(dfa: Optional[ByteDFA], samples: Sequence[bytes],
                    max_len: int, insert_probability: float, seed: int,
                    group_bytes: int = GROUP_BYTES,
                    device=None) -> List[set]:
    """Per-sample sets of passing candidate substrings, extracted on the
    host from each group's packed mask (the JAX package's
    `feed_candidates_device`)."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    out: List[set] = [set() for _ in samples]
    for g0, n, rows, packed in _mask_groups(
            dfa, samples, max_len, insert_probability, seed, group_bytes,
            device):
        B, W8 = rows.shape
        bits = np.unpackbits(packed.cpu().numpy(), axis=-1,
                             bitorder="little").reshape(B, max_len, W8)
        for b, l, p in zip(*np.nonzero(bits)):
            if b < n:
                out[g0 + b].add(samples[g0 + b][p : p + l + 1])
    return out


def _key_words(max_len: int) -> int:
    return -(-max_len // 8)


def candidate_keys(rows: torch.Tensor, packed: torch.Tensor, g0: int,
                   max_len: int) -> torch.Tensor:
    """(n, 2 + ceil(L / 8)) int64 rows (global sample, byte words...,
    length), one per set bit of the group's packed mask, with duplicates
    within a sample removed. A candidate's bytes are packed little-endian
    into ceil(L / 8) int64 words (zeros past its length), so the key is
    exact: two candidates share it only when their bytes are equal."""
    B, W8 = rows.shape
    dev = rows.device
    per_l = W8 // 8
    flat = packed.reshape(-1)
    nz = torch.nonzero(flat).squeeze(1)
    nw = _key_words(max_len)
    k = torch.arange(nw * 8, device=dev)
    # Byte i of a word weighs 256^i; byte 7 enters as a signed byte, so
    # that every product and sum stays inside int64.
    weights = torch.tensor([1 << (8 * i) for i in range(8)],
                           dtype=torch.int64, device=dev)
    bit8 = torch.arange(8, device=dev)
    parts = []
    for c0 in range(0, nz.numel(), DRAIN_BYTES):
        idx = nz[c0 : c0 + DRAIN_BYTES]
        vals = flat[idx].to(torch.int64)
        hit = ((vals[:, None] >> bit8) & 1).nonzero()
        f = idx[hit[:, 0]]
        b = f // (max_len * per_l)
        rem = f - b * (max_len * per_l)
        length = rem // per_l + 1
        p = (rem % per_l) * 8 + hit[:, 1]
        at = (p[:, None] + k).clamp_(max=W8 - 1)
        byts = rows[b[:, None], at].to(torch.int64)
        byts = torch.where(k < length[:, None], byts, 0).reshape(-1, nw, 8)
        byts[..., 7] -= (byts[..., 7] >= 128).to(torch.int64) * 256
        words = (byts * weights).sum(dim=-1)
        keys = torch.cat([(b + g0)[:, None], words, length[:, None]], dim=1)
        parts.append(keys)
    if not parts:
        return torch.empty((0, nw + 2), dtype=torch.int64, device=dev)
    return torch.unique(torch.cat(parts), dim=0)


def _fold(keys: torch.Tensor, counts: torch.Tensor):
    """Distinct keys and their summed counts."""
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.int64, device=keys.device)
    total.index_add_(0, inv, counts)
    return uniq, total


def decode_keys(keys: np.ndarray) -> List[str]:
    """The candidates of (K, ceil(L / 8) + 1) int64 keys (byte words,
    length) as str: one UTF-8 decode of all their bytes, then a split by
    each key's count of chars (candidates are char-aligned)."""
    if keys.shape[0] == 0:
        return []
    lengths = keys[:, -1]
    byts = np.ascontiguousarray(keys[:, :-1].astype("<i8")).view(np.uint8)
    inside = np.arange(byts.shape[1])[None, :] < lengths[:, None]
    text = byts[inside].tobytes().decode("utf-8")
    chars = (((byts & 0xC0) != 0x80) & inside).sum(axis=1)
    ends = np.cumsum(chars).tolist()
    starts = [0] + ends[:-1]
    return [text[a:b] for a, b in zip(starts, ends)]


def feed_counts(dfa: Optional[ByteDFA], samples: Sequence[bytes],
                max_len: int, insert_probability: float, seed: int,
                group_bytes: int = GROUP_BYTES, device=None,
                timer=None) -> Counter:
    """Document-frequency Counter over passing candidates (str keys;
    candidates are char-aligned). Each group's mask is drained on its
    device: exact keys per set bit, deduplicated per sample, counted per
    key and folded into the running counts; the distinct keys and counts
    are read back once, at the end, and decoded on the host. `timer` (an
    ops.lattice.PhaseTimer) collects the phases pack, mask, drain,
    readback and decode."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    keys = counts = None
    for g0, _, rows, packed in _mask_groups(
            dfa, samples, max_len, insert_probability, seed, group_bytes,
            device, timer):
        with phase(timer, "drain"):
            uniq, c = torch.unique(candidate_keys(rows, packed, g0,
                                                  max_len)[:, 1:],
                                   dim=0, return_counts=True)
            if keys is None:
                keys, counts = uniq, c
            else:
                keys, counts = _fold(torch.cat([keys, uniq]),
                                     torch.cat([counts, c]))
    if keys is None:
        return Counter()
    with phase(timer, "readback"):
        keys_h = keys.cpu().numpy()
        counts_h = counts.cpu().tolist()
    with phase(timer, "decode"):
        return Counter(dict(zip(decode_keys(keys_h), counts_h)))
