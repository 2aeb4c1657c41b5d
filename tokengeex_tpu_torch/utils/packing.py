"""Pack ragged byte samples into dense (rows, width) device batches.

TPU kernels need static shapes; the reference processes ragged samples
one at a time on CPU threads (reference: src/prune.rs:72-100). Here we
pack many samples per lane row back-to-back, carrying boundary masks so
the DP scans reset at sample starts — zero ragged shapes, near-100%
density, and the reference's independent-snippet semantics fall out of
the boundary resets.

Samples longer than `max_snippet` are chopped into independent snippets,
matching the E-step's MAX_SAMPLE_LENGTH = 81920 chunking
(reference: src/prune.rs:75-83). Pass max_snippet=None for unchopped
packing (Viterbi encode of whole samples).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    """Dense packed corpus view.

    bytes_arr:  (R, W) uint8 — sample bytes, 0-padded
    sample_id:  (R, W) int32 — per-position snippet index, -1 in padding
    is_start:   (R, W+1) bool — True where a snippet's first byte begins
                (in dp index space: position p is a segmentation boundary
                with empty prefix)
    end_index:  (R, W) int32 — for each position, the dp index of the end
                of its snippet (for per-sample normalizer gathers);
                0 in padding
    spans:      list of (row, start, end, sample_idx, snippet_idx) host
                records for reassembly
    """

    bytes_arr: np.ndarray
    sample_id: np.ndarray
    is_start: np.ndarray
    end_index: np.ndarray
    spans: List[Tuple[int, int, int, int, int]]

    @property
    def rows(self) -> int:
        return self.bytes_arr.shape[0]

    @property
    def width(self) -> int:
        return self.bytes_arr.shape[1]


def pack_samples(
    samples: Sequence[bytes],
    width: int,
    max_snippet: Optional[int] = None,
    row_multiple: int = 8,
) -> PackedBatch:
    """Greedy first-fit-decreasing packing of snippets into rows."""
    # Chop into snippets.
    snippets: List[Tuple[int, int, bytes]] = []  # (sample_idx, snippet_idx, data)
    for si, s in enumerate(samples):
        if max_snippet is not None and len(s) > max_snippet:
            for ci, off in enumerate(range(0, len(s), max_snippet)):
                snippets.append((si, ci, s[off : off + max_snippet]))
        else:
            snippets.append((si, 0, s))

    too_long = [len(d) for _, _, d in snippets if len(d) > width]
    if too_long:
        raise ValueError(
            f"snippet of {max(too_long)} bytes exceeds pack width {width}; "
            "raise width or set max_snippet"
        )

    # Best-fit-decreasing over a Fenwick-indexed capacity table: pick
    # the row with the SMALLEST free capacity that still fits,
    # O(log width) per snippet. (The previous first-fit linear row
    # scan was O(snippets x rows) of pure Python — minutes per 100 MB
    # and quadratic beyond; layout differences do not affect results,
    # every snippet stays independent.)
    order = sorted(range(len(snippets)), key=lambda i: -len(snippets[i][2]))
    row_items: List[List[int]] = []
    fen = [0] * (width + 2)  # Fenwick over capacities 1..width
    rows_at: List[List[int]] = [[] for _ in range(width + 1)]

    def _fen_add(c: int, d: int) -> None:
        c += 1  # capacities are 0-based; tree is 1-based
        while c < len(fen):
            fen[c] += d
            c += c & (-c)

    def _fen_prefix(c: int) -> int:  # count of rows with capacity <= c
        c += 1
        s = 0
        while c > 0:
            s += fen[c]
            c -= c & (-c)
        return s

    def _fen_kth(k: int) -> int:
        """Smallest capacity with cumulative count >= k (1-based k)."""
        pos = 0
        bit = 1 << (len(fen).bit_length() - 1)
        while bit:
            nxt = pos + bit
            if nxt < len(fen) and fen[nxt] < k:
                pos = nxt
                k -= fen[nxt]
            bit >>= 1
        return pos  # 0-based capacity

    for i in order:
        n = len(snippets[i][2])
        if n == 0:
            continue
        below = _fen_prefix(n - 1)
        total = _fen_prefix(width)
        if total > below:  # a row with capacity >= n exists
            cap = _fen_kth(below + 1)
            r = rows_at[cap].pop()
            _fen_add(cap, -1)
        else:
            r = len(row_items)
            row_items.append([])
            cap = width
        row_items[r].append(i)
        new_cap = cap - n
        rows_at[new_cap].append(r)
        _fen_add(new_cap, 1)

    nrows = max(len(row_items), 1)
    nrows = -(-nrows // row_multiple) * row_multiple

    bytes_arr = np.zeros((nrows, width), dtype=np.uint8)
    sample_id = np.full((nrows, width), -1, dtype=np.int32)
    is_start = np.zeros((nrows, width + 1), dtype=bool)
    end_index = np.zeros((nrows, width), dtype=np.int32)
    spans: List[Tuple[int, int, int, int, int]] = []

    sid = 0
    for r, items in enumerate(row_items):
        pos = 0
        for i in items:
            si, ci, data = snippets[i]
            n = len(data)
            bytes_arr[r, pos : pos + n] = np.frombuffer(data, dtype=np.uint8)
            sample_id[r, pos : pos + n] = sid
            is_start[r, pos] = True
            end_index[r, pos : pos + n] = pos + n
            spans.append((r, pos, pos + n, si, ci))
            sid += 1
            pos += n

    return PackedBatch(bytes_arr, sample_id, is_start, end_index, spans)
