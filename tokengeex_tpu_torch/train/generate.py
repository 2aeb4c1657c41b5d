"""Initial vocabulary generation from corpus substring statistics.

Reference: src/generate.rs; counterpart of tokengeex_tpu/train/generate.py.
For every sample, every substring of up to max_token_length chars (at
char boundaries) that fully matches the allow-regex is counted with
probability insert_probability, deduplicated per sample (document
frequency). The reference does this with one Rust regex is_match per
candidate; here the allow-regex compiles once to a byte DFA
(core/redfa.py) and, without a split regex, the whole candidate mask of
every sample is computed on the GPU by csrc/dfa_mask.cu and drained there
(ops/dfa_device.py). With a split regex the samples are cut on the host
and each part takes the host `_feed_part` loop, as the JAX package does:
that is the reference's own route, not a fallback.

Scoring (reference: src/generate.rs:148-234): byte tokens seeded at the
highest observed frequency, added/suggested tokens and frequent
substrings scored freq * len, sorted by score, converted to log-probs.
"""

from __future__ import annotations

import dataclasses
import math
import re as _re
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from ..core.redfa import ByteDFA, compile_dfa
from ..core.types import ScoredToken
from ..parallel import mesh as pmesh
from ..utils.device import resolve_device
from ..utils.task import Task
from .patterns import rust_to_python


def logprobs(vocab: List[ScoredToken]) -> None:
    """Convert raw scores to log probabilities in place
    (reference: src/generate.rs:237-243)."""
    total = sum(t.score for t in vocab)
    logsum = math.log(total)
    for t in vocab:
        t.score = math.log(t.score) - logsum


@dataclasses.dataclass
class VocabularyGenerator:
    """reference: src/generate.rs:12-50 (defaults src/cli.rs:674-675)."""

    max_token_length: int = 24
    insert_probability: float = 0.1
    split: Optional[str] = None  # fancy-regex pattern (host-side re)
    allow: Optional[str] = None  # rust-syntax regex
    added_tokens: Sequence[str] = ()
    suggested_tokens: Sequence[str] = ()
    # Reference quirk: the byte seed loop is `0..255_u8`, EXCLUDING byte
    # 0xFF (src/generate.rs:164) — while new_default_vocab has all 256.
    # UTF-8 text never contains 0xFF, so NoPath never triggers; set
    # full_byte_seed=True to include it anyway.
    full_byte_seed: bool = False
    seed: Optional[int] = None
    device: object = None  # where the feed runs; None = the current CUDA
    # device (raises without one), "cpu" = the kernel's plain PyTorch
    # version

    def __post_init__(self):
        self.frequencies: Counter = Counter()
        # The reference constructor seeds +1 per added/suggested list
        # ENTRY (duplicates accumulate), so every special token has a
        # frequency even if never observed during feed and its score is
        # (observed+len(list occurrences)) * len (src/generate.rs:31-39).
        for token in list(self.added_tokens) + list(self.suggested_tokens):
            self.frequencies[token] += 1
        self._dfa: Optional[ByteDFA] = None
        if self.allow:
            self._dfa = compile_dfa(self.allow)
        self._split_re = _re.compile(rust_to_python(self.split)) if self.split else None
        self._rng = np.random.default_rng(self.seed)

    def current_size(self) -> int:
        return len(self.frequencies)

    # -- Feeding -----------------------------------------------------------

    def feed(self, samples: Sequence[str], timer=None) -> None:
        """Count allowed substrings per sample (document frequency)
        (reference: src/generate.rs:54-139). Without a split regex the
        candidates are counted on `self.device` (ops/dfa_device.py
        `feed_counts`; `timer`, an ops.lattice.PhaseTimer, collects its
        phases); with one, each part takes the host `_feed_part` loop."""
        task = Task("Generate feed", len(samples))
        task.start()
        try:
            nbytes = sum(len(s.encode("utf-8", "ignore")) for s in samples)
            if self._split_re is None:
                counts = self._feed_device(samples, timer)
                # The device counter already flipped the substring-path
                # coins for any special token that qualifies as a
                # candidate; replace their counts with the exact
                # per-sample union of both paths (see
                # _feed_special_native).
                for token in self._special_tokens():
                    counts.pop(token, None)
                self.frequencies.update(counts)
                self._feed_special_native(samples)
            else:
                freqs: Counter = Counter()
                for sample in samples:
                    tokens: set = set()
                    for m in self._split_re.finditer(sample):
                        self._feed_part(m.group(0), tokens)
                    self._feed_special_sample(sample, tokens)
                    freqs.update(tokens)
                self.frequencies.update(freqs)
            task.record(nbytes, len(samples))
        finally:
            task.finish()

    def _special_tokens(self) -> List[str]:
        return list(self.added_tokens) + list(self.suggested_tokens)

    def allreduce_frequencies(self) -> None:
        """Multi-GPU generate: each rank fed only its corpus shard; sum
        the document frequencies over the ranks (parallel/mesh.py, one
        all_gather of each rank's counter: they are sparse string maps,
        not dense tensors). The constructor's +1 per special entry
        (reference: src/generate.rs:31-39) counts once. Every rank ends
        with the same counter, so generate() gives the same vocabulary on
        every rank. A no-op at world size 1."""
        if pmesh.process_count() == 1:
            return
        seed: Counter = Counter(self._special_tokens())
        local = Counter(self.frequencies)
        local.subtract(seed)  # keeps zero entries (Counter - drops them)
        merged: Counter = Counter()
        for part in pmesh.allgather_pickled(dict(local)):
            merged.update(part)
        merged.update(seed)
        # A key exists only once counted or seeded (current_size()).
        self.frequencies = Counter({t: n for t, n in merged.items() if n})

    def _feed_special_sample(self, sample: str, tokens: set) -> None:
        """Added/suggested tokens: one coin per occurrence, break on the
        first success, inserted into the SAME per-sample set as substring
        candidates — so a sample contributes at most 1 to the document
        frequency and P(count) = 1-(1-p)^occurrences
        (reference: src/generate.rs:117-126)."""
        for token in self._special_tokens():
            start = 0
            while True:
                idx = sample.find(token, start)
                if idx < 0:
                    break
                if self._rng.random() < self.insert_probability:
                    tokens.add(token)
                    break
                start = idx + len(token)

    def _substring_eligible(self, token: str) -> bool:
        """Whether the substring-candidate scan would also enumerate the
        token's occurrences (length <= max and full allow match)."""
        raw = token.encode("utf-8")
        if not raw or len(raw) > self.max_token_length:
            return False
        return self._dfa is None or self._dfa.fullmatch_bytes(raw)

    def _feed_special_native(self, samples: Sequence[str]) -> None:
        """Per-sample special-token counting for the device path (the JAX
        package's native path, whose name it keeps).

        The reference flips one coin per NON-OVERLAPPING occurrence on
        the special-token path (find/advance-past-token loop) and,
        independently, one per enumerated substring occurrence on the
        candidate path when the token qualifies — the substring scan
        visits every start position, so those occurrences OVERLAP. With
        set-dedup across both paths, P(count) = 1-(1-p)^(k_sub+k_spec).
        The device counter's contribution was dropped by the caller;
        reproduce the exact distribution here with that many independent
        coins and break-on-success."""
        extra: Counter = Counter()
        for token in dict.fromkeys(self._special_tokens()):
            eligible = self._substring_eligible(token)
            for sample in samples:
                occ_spec = sample.count(token)  # non-overlapping
                flips = occ_spec
                if eligible and occ_spec:
                    start = 0  # overlapping substring-path occurrences
                    while True:
                        idx = sample.find(token, start)
                        if idx < 0:
                            break
                        flips += 1
                        start = idx + 1
                for _ in range(flips):
                    if self._rng.random() < self.insert_probability:
                        extra[token] += 1
                        break
        self.frequencies.update(extra)

    def _feed_device(self, samples: Sequence[str], timer=None) -> Counter:
        """Candidate counting on the GPU (ops/dfa_device.py): the device
        computes the bit-packed candidate mask (csrc/dfa_mask.cu) and
        drains it, so no Python object is made per substring; only the
        distinct candidates and their counts come back."""
        from ..ops.dfa_device import feed_counts

        seed = int(self._rng.integers(0, 2**31 - 1))
        return feed_counts(
            self._dfa, [s.encode("utf-8") for s in samples],
            self.max_token_length, self.insert_probability, seed,
            device=resolve_device(self.device), timer=timer)

    def _feed_part(self, part: str, tokens: set) -> None:
        # The reference's candidate loop measures length in BYTES
        # (len += c.len_utf8(), break when > max_token_length) but only
        # at char boundaries (src/generate.rs:69-115).
        data = part.encode("utf-8")
        n = len(data)
        if n == 0:
            return
        arr = np.frombuffer(data, dtype=np.uint8)
        is_char_start = (arr & 0xC0) != 0x80
        max_bytes = min(self.max_token_length, n)

        if self._dfa is not None:
            allowed = self._dfa.match_lengths(arr, max_bytes)
        else:
            allowed = np.ones((n, max_bytes), dtype=bool)

        coin = self._rng.random(allowed.shape) < self.insert_probability
        cand = allowed & coin & is_char_start[:, None]
        # End must be a char boundary too: end position p+l is either n
        # or a char start.
        end_ok = np.zeros((n, max_bytes), dtype=bool)
        for j in range(max_bytes):
            ends = np.arange(n) + j + 1
            valid = ends <= n
            eo = np.zeros(n, dtype=bool)
            inside = ends < n
            eo[inside] = is_char_start[ends[inside]]
            eo[ends == n] = True
            end_ok[:, j] = eo & valid
        cand &= end_ok
        for p, j in zip(*np.nonzero(cand)):
            tokens.add(data[p : p + j + 1].decode("utf-8"))

    # -- Generation --------------------------------------------------------

    def generate(self, size: int) -> List[ScoredToken]:
        """reference: src/generate.rs:148-234."""
        # Tie-break equal frequencies on token text: the reference sorts a
        # HashMap iteration (unspecified tie order, generate.rs:150-151);
        # a total order keeps our output stable across feed backends.
        frequent = sorted(
            self.frequencies.items(), key=lambda kv: (-kv[1], kv[0])
        )
        seen = set()
        highest_freq = frequent[0][1] if frequent else 1

        byte_hi = 256 if self.full_byte_seed else 255
        vocab: List[ScoredToken] = []
        for b in range(byte_hi):
            seen.add(bytes([b]))
            vocab.append(ScoredToken(bytes([b]), float(highest_freq), True))

        # Added (keep=True) then suggested (keep=False) tokens
        # (reference: src/generate.rs:171-193).
        for token, keep in [(t, True) for t in self.added_tokens] + [
            (t, False) for t in self.suggested_tokens
        ]:
            if len(vocab) >= size:
                break
            raw = token.encode("utf-8")
            if raw not in seen and len(raw) > 1:
                seen.add(raw)
                if token not in self.frequencies:
                    # Unreachable: __post_init__ seeds every special token
                    # (+1 each), mirroring the reference where the
                    # .expect at src/generate.rs:186 can never fire.
                    raise ValueError(
                        "suggested/added token score should be present: "
                        f"{token!r} never counted during feed"
                    )
                freq = self.frequencies[token]
                score = float(freq * len(raw))
                vocab.append(ScoredToken(raw, score, keep))

        # Frequent substrings (reference: src/generate.rs:196-209).
        for token, freq in frequent:
            if len(vocab) >= size:
                break
            raw = token.encode("utf-8")
            if raw not in seen and len(raw) > 1:
                seen.add(raw)
                vocab.append(ScoredToken(raw, float(freq * len(raw)), False))

        vocab.sort(key=lambda t: -t.score)
        logprobs(vocab)

        for t in vocab:
            if not math.isfinite(t.score) or t.score == 0.0:
                raise ValueError(
                    f"Vocabulary generation: invalid frequency for token "
                    f"{t.value!r}: {t.score}"
                )
        return vocab
