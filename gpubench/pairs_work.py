"""The least time merge's pair insert (csrc/pair_count.cu
`insert_ids_kernel`) could take on the chip, beside kernels_work.py: its
bytes over the memory bandwidth or its operations over the f32 rate, the
larger, counted from what a pass hands it, never from padded buffers or
from what the kernel re-reads.

A pass's insert reads the walked ids of the samples the program packs
(up to PACK_CAP bytes; longer ones take the chained encode and their
pairs go in as weighted rows, another kernel), and the span offsets,
and writes each distinct pair once: 4 bytes an id, 4 an offset, 16 a
distinct row ({key, count}); one hash a pair, a pair being two adjacent
ids of one span.
"""

from __future__ import annotations

from gpubench.kernels_work import bound_s

# The program's pack cap (train/estep_device.py MAX_ENCODE_WIDTH): the
# samples whose ids the insert reads.
PACK_CAP = 1 << 15


def pair_insert(tokens: int, spans: int, distinct: int) -> float:
    """A pass's insert over `tokens` ids in `spans` spans holding
    `distinct` distinct pairs."""
    nbytes = 4 * tokens + 4 * spans + 16 * distinct
    return bound_s(nbytes, max(tokens - spans, 0))
