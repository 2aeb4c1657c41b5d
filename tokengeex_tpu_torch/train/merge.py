"""BPE-style vocabulary extension: merge frequent adjacent token pairs.

Reference: src/merge.rs; counterpart of tokengeex_tpu/train/merge.py. Each
round Viterbi-encodes the corpus, counts adjacent id pairs, and appends up
to `step` new tokens formed by concatenating the most frequent pairs —
subject to max_token_length and a full-match allow-regex. New token score
= (a.score + b.score) * scale_factor, keep=False. Stops early if a full
pass adds nothing.

Pair counting backends:
  - device: the batched Viterbi encode on the GPU over a corpus packed and
    uploaded once per merge run (train/estep_device.py DeviceCorpus), the
    ids walked and their pairs counted in a hash table on the device
    (count_pairs_arrays); only the sorted (keys, counts) arrays come back,
    and the loop makes tuples of the pairs it visits alone. Under a
    process group each rank counts its block of every group's rows and
    the ranks' tables are gathered, so every rank makes the same merges;
  - oracle: the host f64 model, sample by sample (tests only).
"""

from __future__ import annotations

import dataclasses
import logging
import re
from collections import Counter
from typing import Sequence, Set, Tuple

import numpy as np

from ..core.types import ScoredToken
from ..models.unigram import Model
from ..utils import trace
from ..utils.task import Task
from .patterns import rust_to_python

log = logging.getLogger(__name__)


def merge_table_hints(vocab_size: int, num_merges: int,
                      max_token_length: int) -> Tuple[int, int]:
    """The token table's (min_bits, min_len) for the FINAL merge state,
    computed once: recomputing them from the grown vocabulary each round
    would let the table's bits change mid-loop."""
    final_v = vocab_size + max(num_merges, 0)
    return (max(8, int(np.ceil(np.log2(max(final_v, 2)))) + 1),
            max_token_length)


@dataclasses.dataclass
class VocabularyMerger:
    """reference: src/merge.rs:8-31 (defaults src/cli.rs:720-723)."""

    allow: str  # rust-syntax regex (required, reference: src/cli.rs:120)
    num_merges: int = 1000
    step: int = 50
    scale_factor: float = 0.9
    max_token_length: int = 24
    backend: str = "device"  # device | oracle
    device: object = None  # where the device backend runs; None = the
    # current CUDA device (raises without one), "cpu" = the kernels'
    # plain PyTorch versions

    def __post_init__(self):
        if self.backend in ("auto", "native"):
            raise NotImplementedError(
                f"backend={self.backend!r}: the port has the 'device' and "
                "'oracle' backends; the native runtime and the 'auto' "
                "crossover are not part of the port (ROADMAP.md)")
        if self.backend not in ("device", "oracle"):
            raise ValueError(f"unknown backend {self.backend!r}")
        self._corpus = None  # device-resident corpus, one per samples

    @trace.traced("merge")
    def merge(self, model: Model, samples: Sequence[bytes]) -> Model:
        """reference: src/merge.rs:33-136. Runs in the span `merge`: each
        pass's pair count in `merge.count` (the device backend), the
        selection over the ordered pairs in `merge.select`, which counts
        `merge.merged` and `merge.refused` (pairs refused by length or
        allow)."""
        # Allow checks go through the same byte-DFA as the generate
        # stage (search semantics = Regex::is_match); patterns outside
        # the DFA subset fall back to a host regex search.
        try:
            from ..core.redfa import compile_is_match_dfa

            dfa = compile_is_match_dfa(self.allow)
            allow_ok = lambda text: dfa.fullmatch_bytes(  # noqa: E731
                text.encode("utf-8"))
        except Exception:
            allow_re = re.compile(rust_to_python(self.allow))
            allow_ok = lambda text: bool(allow_re.search(text))  # noqa: E731
        ignore: Set[Tuple[int, int]] = set()
        start_vocab_size = model.vocab_size()
        hints = merge_table_hints(start_vocab_size, self.num_merges,
                                  self.max_token_length)

        while model.vocab_size() < start_vocab_size + self.num_merges:
            done = model.vocab_size() - start_vocab_size
            task = Task(f"BPE Merge {done}/{self.num_merges}", len(samples))
            task.start()
            try:
                pairs = self._count_pairs(model, samples, task, hints)
            finally:
                task.finish()

            merges = min(self.step, self.num_merges - done)
            made = refused = 0
            with trace.span("select"):
                for (a, b), freq in pairs:
                    if merges == 0:
                        break
                    ta = model.vocab[a]
                    tb = model.vocab[b]
                    value = ta.value + tb.value
                    score = (ta.score + tb.score) * self.scale_factor
                    token = ScoredToken(value, score, False)
                    text = value.decode("utf-8", errors="replace")
                    # Unanchored substring search: the reference's
                    # Regex::is_match (src/merge.rs:105-106). CLI-generated
                    # patterns are ^...$-anchored so behave identically,
                    # but a user-supplied unanchored allow must match
                    # anywhere.
                    if len(value) > self.max_token_length or \
                            not allow_ok(text):
                        refused += 1
                        if (a, b) not in ignore:
                            log.debug(
                                "Ignoring merge of a=%s b=%s freq=%d "
                                "into=%s", ta, tb, freq, token,
                            )
                            ignore.add((a, b))
                        continue
                    model.add_tokens([token])
                    merges -= 1
                    made += 1
                    log.info("Merged a=%s b=%s freq=%d into=%s", ta, tb,
                             freq, token)
                trace.count("merge.merged", made)
                trace.count("merge.refused", refused)

            if made == 0:
                log.warning(
                    "No more merges possible after %d merges, consider "
                    "increasing the number of merges",
                    model.vocab_size() - start_vocab_size,
                )
                break
        return model

    def _count_pairs(self, model: Model, samples, task, hints=None):
        """(pair, freq) by freq desc (reference: src/merge.rs:53-84): a
        list on the oracle backend, an iterator over the device's arrays
        on the device backend."""
        if self.backend == "device":
            from . import estep_device as ed

            if self._corpus is None or self._corpus.samples is not samples:
                # Pack + upload the corpus once for the whole merge loop;
                # every batch re-encodes the same bytes.
                self._corpus = ed.DeviceCorpus(samples, device=self.device)
            return _pairs_in_order(*ed.count_pairs_arrays(
                model, samples, task, table_hints=hints,
                corpus=self._corpus))
        counts: Counter = Counter()
        for s in samples:
            ids = model.oracle.encode(s.decode("utf-8"))
            for a, b in zip(ids, ids[1:]):
                counts[(a, b)] += 1
            task.record(len(s), 1)
        return sorted(counts.items(), key=lambda kv: -kv[1])


def _pairs_in_order(keys: np.ndarray, counts: np.ndarray):
    """((a, b), freq) of each key (a << 32) | b, made as it is visited."""
    for k, c in zip(keys, counts):
        k = int(k)
        yield (k >> 32, k & 0xFFFFFFFF), int(c)
