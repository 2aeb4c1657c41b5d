"""Public unigram Model.

Facade over the host float64 oracle (models/oracle.py), the executable
spec mirroring reference src/model.rs. Batched device encode lives in
train/estep_device.py and reads the vocabulary through this class; the
port has no native C++ backend.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence, Tuple

from ..core.types import ScoredToken
from .oracle import Lattice, OracleModel


class Model:
    """Unigram tokenization model (reference: src/model.rs:7-200)."""

    def __init__(self, vocab: List[ScoredToken]):
        self._oracle = OracleModel(vocab)

    @staticmethod
    def from_vocab(vocab: List[ScoredToken]) -> "Model":
        return Model(vocab)

    @property
    def vocab(self) -> List[ScoredToken]:
        return self._oracle.vocab

    @property
    def oracle(self) -> OracleModel:
        return self._oracle

    def vocab_size(self) -> int:
        return self._oracle.vocab_size()

    def add_tokens(self, tokens: List[ScoredToken]) -> None:
        self._oracle.add_tokens(tokens)

    def encode(self, text: str, dropout: float = 0.0,
               rng: Optional[random.Random] = None) -> List[int]:
        """Viterbi-encode a single string (reference: src/model.rs:59-129)."""
        return self._oracle.encode(text, dropout, rng)

    def encode_batch(self, texts: Sequence[str],
                     dropout: float = 0.0) -> List[List[int]]:
        return [self.encode(t, dropout) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        return self._oracle.decode(ids)

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return self._oracle.decode_bytes(ids)

    def token_to_id(self, token: bytes) -> Optional[int]:
        return self._oracle.token_to_id(token)

    def id_to_token(self, tid: int) -> Optional[ScoredToken]:
        return self._oracle.id_to_token(tid)

    def common_prefix_search(self, s: bytes) -> Iterator[Tuple[int, int]]:
        return self._oracle.common_prefix_search(s)

    def make_lattice(self, sentence: bytes) -> Lattice:
        lattice = Lattice(sentence)
        self._oracle.populate_nodes(lattice, 0.0)
        return lattice
