"""Idiom miner: top-N frequent regex matches from a corpus.

Reference: src/mine.rs; counterpart of tokengeex_tpu/train/mine.py without
its native scanner (the port has no native runtime). Counts every match
of `pattern` across all samples and returns the num_idioms most frequent
matched strings.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import List, Sequence, Tuple

from .patterns import rust_to_python


@dataclasses.dataclass
class IdiomMiner:
    """reference: src/mine.rs:8-19."""

    num_idioms: int
    pattern: str  # rust-syntax regex

    def mine(self, samples: Sequence[str]) -> List[Tuple[str, int]]:
        """reference: src/mine.rs:21-48 (rayon find_iter + DashMap).

        The serial re.finditer loop: the JAX package's own route when its
        native library is absent."""
        regex = re.compile(rust_to_python(self.pattern))
        frequencies: Counter = Counter()
        for sample in samples:
            for m in regex.finditer(sample):
                frequencies[m.group(0)] += 1
        return frequencies.most_common(self.num_idioms)
