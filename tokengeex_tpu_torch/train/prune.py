"""Vocabulary pruner: EM + loss-ranked token removal.

Reference: src/prune.rs; counterpart of tokengeex_tpu/train/prune.py. The
outer loop runs `em_subiters` EM rounds (E-step expected counts -> M-step
Bayesian rescoring) and then removes the lowest-loss tokens until the
target vocabulary size is reached.

E-step, frequency and alternatives backends:
  - device: the packed-batch forward/backward DPs and the Viterbi encode
    on the GPU through one DeviceTrainSession per prune run
    (train/device_session.py), which probes the corpus once; each round's
    nbest(2) alternatives as one masked f64 Viterbi pass over the
    vocabulary's bytes (estep_device.prune_alternatives_device);
  - oracle: pure Python f64 lattices (tests only).
The M-step and loss ranking are host-side steps.

Multi-GPU (parallel/mesh.py): under a process group the session splits
each row group's rows over the ranks (every rank holds the corpus), or
with corpus_sharded each rank holds its shard (the loss normaliser is the
whole corpus's sample count); the counts are summed over the ranks, so
every rank prunes to the same vocabulary.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import List, Sequence

import numpy as np
import torch

from ..core.types import ScoredToken
from ..models.unigram import Model
from ..utils.task import Task
from ..parallel import mesh as pmesh
from .device_session import DeviceTrainSession
from .estep_device import prune_alternatives_device

log = logging.getLogger(__name__)

# reference: src/prune.rs:75
MAX_SAMPLE_LENGTH = 8192 * 10
# reference: src/prune.rs:127
EXPECTED_FREQUENCY_THRESHOLD = 0.5


def digamma(x: float) -> float:
    """Reference digamma (src/prune.rs:322-334), kept identical for
    score parity."""
    result = 0.0
    while x < 7.0:
        result -= 1.0 / x
        x += 1.0
    x -= 0.5
    xx = 1.0 / x
    xx2 = xx * xx
    xx4 = xx2 * xx2
    result += (
        math.log(x)
        + (1.0 / 24.0) * xx2
        - (7.0 / 960.0) * xx4
        + (31.0 / 8064.0) * xx4 * xx2
        - (127.0 / 30720.0) * xx4 * xx4
    )
    return result


def digamma_np(x: np.ndarray) -> np.ndarray:
    """Vectorized reference digamma."""
    x = x.astype(np.float64).copy()
    result = np.zeros_like(x)
    for _ in range(7):  # x >= 0.5 initially: at most 7 shifts
        mask = x < 7.0
        if not mask.any():
            break
        result[mask] -= 1.0 / x[mask]
        x[mask] += 1.0
    x -= 0.5
    xx = 1.0 / x
    xx2 = xx * xx
    xx4 = xx2 * xx2
    result += (
        np.log(x)
        + (1.0 / 24.0) * xx2
        - (7.0 / 960.0) * xx4
        + (31.0 / 8064.0) * xx4 * xx2
        - (127.0 / 30720.0) * xx4 * xx4
    )
    return result


@dataclasses.dataclass
class VocabularyPruner:
    """reference: src/prune.rs:6-21 (defaults from src/cli.rs:687-689)."""

    vocab_size: int
    shrink_factor: float = 0.8
    em_subiters: int = 1
    dropout: float = 0.01
    backend: str = "device"  # device | oracle
    exact_loss: bool = False  # False replicates the reference's
    # alternatives.len()-1 normalizer quirk (src/prune.rs:279); True uses
    # the per-token alternative count.
    seed: int = 0  # dropout RNG base; each E-step call advances the
    # stream so EM sub-iterations sample fresh masks (the reference uses
    # thread_rng, fresh every pass but non-reproducible).
    corpus_sharded: bool = False  # True: `samples` is this rank's shard
    # of a multi-process corpus (parallel/mesh.py; device backend only); at
    # world size 1 the shard is the corpus
    device_dtype: object = None  # None / torch.float32: the f32 E-step;
    # torch.float64: the session's f64 / exact conformance mode
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
        if self.corpus_sharded and self.backend != "device":
            raise ValueError("corpus_sharded pruning needs the device "
                             "backend")
        if self.device_dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"unsupported device_dtype {self.device_dtype}")

    def prune(self, model: Model, samples: Sequence[bytes],
              checkpoint_cb=None) -> Model:
        """reference: src/prune.rs:23-57."""
        # The loss normalizer is the sample count of the whole corpus
        # (reference: src/prune.rs:283), over every shard when sharded.
        self._n_samples = len(samples)
        if self.corpus_sharded:
            self._n_samples = int(pmesh.allgather_ints([len(samples)]).sum())
        # The device backend probes the corpus once per prune run and
        # reuses the session's caches across EM sub-iterations, frequency
        # passes and rounds (the vocabulary only shrinks while pruning).
        self._session = (self._new_session(model, samples)
                         if self.backend == "device" else None)
        try:
            return self._prune_loop(model, samples, checkpoint_cb)
        finally:
            # Free the session's device caches for the next stage.
            if self._session is not None:
                self._session.close()
                self._session = None

    def _new_session(self, model: Model, samples) -> DeviceTrainSession:
        return DeviceTrainSession(model, samples, MAX_SAMPLE_LENGTH,
                                  dtype=self.device_dtype,
                                  local_shard=self.corpus_sharded,
                                  device=self.device)

    def _with_session(self, model: Model, samples, fn):
        """fn(session): prune()'s session, or, for a call outside
        prune(), one built for this call."""
        session = getattr(self, "_session", None)
        if session is not None:
            return fn(session)
        session = self._new_session(model, samples)
        try:
            return fn(session)
        finally:
            session.close()

    def _prune_loop(self, model: Model, samples: Sequence[bytes],
                    checkpoint_cb=None) -> Model:
        rounds = 0
        while model.vocab_size() > self.vocab_size:
            for subiter in range(self.em_subiters):
                log.info("EM subiter %d/%d", subiter + 1, self.em_subiters)
                expected = self.run_e_step(model, samples)
                log.info(
                    "E-step completed subiter=%d vocab_size=%d",
                    subiter, model.vocab_size(),
                )
                vocab = self.run_m_step(model, expected)
                log.info(
                    "M-step completed subiter=%d vocab_size=%d "
                    "alternative_vocab_size=%d",
                    subiter, model.vocab_size(), len(vocab),
                )
                model = Model(vocab)

            before = model.vocab_size()
            vocab = self.prune_vocab(model, samples)
            model = Model(vocab)
            if model.vocab_size() >= before:
                # Every surviving token is always-keep (sole cover for
                # some corpus position): no round can shrink further.
                # The reference spins forever here (src/prune.rs:24 —
                # the while loop re-runs an identity prune); stop with
                # the best achievable vocabulary instead.
                log.warning(
                    "pruning stalled at vocab_size=%d (target %d): all "
                    "remaining tokens are always-keep; stopping",
                    model.vocab_size(), self.vocab_size,
                )
                break
            rounds += 1
            if checkpoint_cb is not None:
                checkpoint_cb(model, rounds)
        return model

    # -- E-step ------------------------------------------------------------

    def run_e_step(self, model: Model, samples: Sequence[bytes]) -> np.ndarray:
        """Expected token counts over all segmentations
        (reference: src/prune.rs:64-120)."""
        # Fresh dropout mask per E-step call (subiters and rounds).
        call_idx = getattr(self, "_estep_calls", 0)
        self._estep_calls = call_idx + 1
        seed = self.seed + call_idx
        task = Task("E-step", len(samples))
        task.start()
        try:
            if self.backend == "device":
                expected = self._with_session(
                    model, samples,
                    lambda s: s.e_step(model, self.dropout, seed, task))
            else:
                expected = self._estep_oracle(model, samples, task, seed)
        finally:
            task.finish()
        return np.asarray(expected, dtype=np.float64)

    def _estep_oracle(self, model: Model, samples, task,
                      seed: int = 0) -> np.ndarray:
        from ..models.oracle import Lattice
        import random as _random

        rng = _random.Random(seed)
        expected = [0.0] * model.vocab_size()
        for s in samples:
            for off in range(0, len(s), MAX_SAMPLE_LENGTH):
                lat = Lattice(s[off : off + MAX_SAMPLE_LENGTH])
                model.oracle.populate_nodes(lat, self.dropout, rng)
                z = lat.populate_marginal(expected)
                if not math.isfinite(z):
                    raise ValueError(
                        f"normalization constant is not finite (z={z}, "
                        f"len={len(s)})"
                    )
            task.record(len(s), 1)
        return np.asarray(expected)

    # -- M-step ------------------------------------------------------------

    def run_m_step(self, model: Model, expected: np.ndarray) -> List[ScoredToken]:
        """Bayesian logprob rescoring via digamma
        (reference: src/prune.rs:124-170)."""
        assert model.vocab_size() == len(expected)
        vocab = model.vocab
        keep_mask = np.array([t.keep for t in vocab], dtype=bool)
        alive = (expected >= EXPECTED_FREQUENCY_THRESHOLD) | keep_mask
        freqs = np.maximum(expected[alive], EXPECTED_FREQUENCY_THRESHOLD)

        logsum = digamma(float(freqs.sum()))
        scores = digamma_np(freqs) - logsum

        if not np.isfinite(scores).all():
            # A single non-finite expected count poisons logsum and
            # every score; report the actual offender, not merely the
            # first alive index.
            bad_exp = np.nonzero(~np.isfinite(expected))[0]
            if bad_exp.size:
                i = int(bad_exp[0])
                raise ValueError(
                    f"M-step: non-finite expected count for token "
                    f"{vocab[i].value!r}: {expected[i]}")
            bad = int(np.nonzero(~np.isfinite(scores))[0][0])
            tok = [t for t, a in zip(vocab, alive) if a][bad]
            i = int(np.nonzero(alive)[0][bad])
            raise ValueError(
                f"M-step: invalid frequency for token {tok.value!r}: "
                f"expected={expected[i]} score={scores[bad]}")

        out = []
        idx = 0
        for token, a in zip(vocab, alive):
            if a:
                out.append(token.clone_with_score(float(scores[idx])))
                idx += 1
        return out

    # -- Pruning -----------------------------------------------------------

    def prune_vocab(self, model: Model, samples: Sequence[bytes]) -> List[ScoredToken]:
        """Loss-ranked removal (reference: src/prune.rs:173-319)."""
        pruned_size = int(model.vocab_size() * self.shrink_factor)
        pruned_size = max(pruned_size, self.vocab_size)
        vocab = model.vocab
        V = model.vocab_size()

        always_keep, alternatives = self._alternatives(model)

        task = Task("Computing frequencies", len(samples))
        task.start()
        try:
            token_frequencies = self._count_frequencies(model, samples, task)
        finally:
            task.finish()

        sum_freq = float(token_frequencies.sum())
        logsum_freq = math.log(sum_freq)

        candidates: List[tuple] = []
        pruned_vocab: List[ScoredToken] = []

        log.info("Compute model loss based on the frequencies")

        for tid in range(V):
            token = vocab[tid]
            freq_i = int(token_frequencies[tid])
            if token.keep:
                pruned_vocab.append(token)
                continue
            if freq_i == 0 and not always_keep[tid]:
                continue  # never occurs
            elif not alternatives[tid]:
                pruned_vocab.append(token)  # no alternatives: keep
            elif freq_i != 0:
                freq = float(freq_i)
                logprob = math.log(freq) - logsum_freq
                # Reference quirk: the normalizer scales by
                # len(alternatives) - 1 == vocab_size - 1 regardless of
                # the token's own alternative count (src/prune.rs:279).
                nalt = len(alternatives[tid]) if self.exact_loss else (V - 1)
                alt_logsum = math.log(sum_freq + freq * nalt)
                alt_logprob = 0.0
                for alt_id in alternatives[tid]:
                    alt_logprob += (
                        math.log(float(token_frequencies[alt_id]) + freq)
                        - alt_logsum
                    )
                loss = (freq / getattr(self, "_n_samples", len(samples))) \
                    * (logprob - alt_logprob)
                # The reference panics on any non-normal loss, which
                # includes exact 0.0 (src/prune.rs:291-297); we only
                # reject non-finite values and let a zero loss rank last.
                if not math.isfinite(loss):
                    raise ValueError(
                        f"loss is not finite (loss={loss}, freq={freq}, "
                        f"logprob={logprob}, alt_logprob={alt_logprob})"
                    )
                candidates.append((tid, loss))

        log.info(
            "Pruning vocabulary from=%d to=%d", model.vocab_size(), pruned_size
        )

        candidates.sort(key=lambda x: -x[1])
        for tid, _loss in candidates:
            if len(pruned_vocab) == pruned_size:
                break
            pruned_vocab.append(vocab[tid])

        pruned_vocab.sort(key=lambda t: -t.score)
        return pruned_vocab

    def _alternatives(self, model: Model):
        """nbest(2) per token (reference: src/prune.rs:179-203): on the
        device backend one masked f64 Viterbi pass over the vocabulary's
        bytes (`prune_alternatives_device`, over the session's table),
        on the oracle backend a Python lattice per token."""
        if self.backend == "device":
            session = getattr(self, "_session", None)
            if session is None:
                return prune_alternatives_device(model, device=self.device)
            return prune_alternatives_device(
                model, table=session.table_for(model), device=session.dev)
        from ..models.oracle import Lattice

        V = model.vocab_size()
        always_keep = np.ones(V, dtype=bool)
        alternatives: List[List[int]] = [[] for _ in range(V)]
        for tid, token in enumerate(model.vocab):
            lat = Lattice(token.value)
            model.oracle.populate_nodes(lat, 0.0)
            nbests = lat.nbest(2)
            if len(nbests) > 1 and len(nbests[0]) > 1:
                always_keep[tid] = False
            if len(nbests) > 1 and len(nbests[0]) == 1:
                alternatives[tid] = [n.token_id for n in nbests[1]]
        return always_keep, alternatives

    def _count_frequencies(self, model: Model, samples, task) -> np.ndarray:
        if self.backend == "device":
            return self._with_session(
                model, samples, lambda s: s.count_frequencies(model, task))
        freqs = np.zeros(model.vocab_size(), dtype=np.int64)
        for s in samples:
            for tid in model.oracle.encode(s.decode("utf-8", errors="strict")):
                freqs[tid] += 1
            task.record(len(s), 1)
        return freqs
