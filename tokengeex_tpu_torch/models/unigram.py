"""Public unigram Model.

Facade over the host float64 oracle (models/oracle.py), the executable
spec mirroring reference src/model.rs. Batched device encode lives in
train/estep_device.py and reads the vocabulary through this class; the
port has no native C++ backend.

The oracle's byte trie is built on first use (`oracle`, `encode`,
`make_lattice`, `common_prefix_search`, `token_to_id`): the device routes
read only the vocabulary list and `token_to_ids`, and a prune round makes
a Model three times.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.types import ScoredToken, TokenIdOutOfBoundsError
from .oracle import Lattice, OracleModel


class Model:
    """Unigram tokenization model (reference: src/model.rs:7-200)."""

    def __init__(self, vocab: List[ScoredToken]):
        self._vocab: List[ScoredToken] = list(vocab)
        self._oracle: Optional[OracleModel] = None
        self._token_to_ids: Optional[Dict[bytes, int]] = None

    @staticmethod
    def from_vocab(vocab: List[ScoredToken]) -> "Model":
        return Model(vocab)

    @property
    def vocab(self) -> List[ScoredToken]:
        return self._vocab

    @property
    def oracle(self) -> OracleModel:
        """The host oracle, its trie built on the first call."""
        if self._oracle is None:
            self._oracle = OracleModel(self._vocab)
            # One list: tokens added later reach both.
            self._vocab = self._oracle.vocab
            self._token_to_ids = self._oracle.token_to_ids
        return self._oracle

    @property
    def token_to_ids(self) -> Dict[bytes, int]:
        """Token bytes -> id, later duplicates winning (the oracle's map),
        without the trie."""
        if self._token_to_ids is None:
            self._token_to_ids = {t.value: i
                                  for i, t in enumerate(self._vocab)}
        return self._token_to_ids

    def vocab_size(self) -> int:
        return len(self._vocab)

    def add_tokens(self, tokens: List[ScoredToken]) -> None:
        if self._oracle is not None:
            self._oracle.add_tokens(tokens)
            return
        for token in tokens:
            if self._token_to_ids is not None:
                self._token_to_ids[token.value] = len(self._vocab)
            self._vocab.append(token)

    def encode(self, text: str, dropout: float = 0.0,
               rng: Optional[random.Random] = None) -> List[int]:
        """Viterbi-encode a single string (reference: src/model.rs:59-129)."""
        return self.oracle.encode(text, dropout, rng)

    def encode_batch(self, texts: Sequence[str],
                     dropout: float = 0.0) -> List[List[int]]:
        return [self.encode(t, dropout) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        """Concatenate token bytes; lossy UTF-8 (reference:
        src/model.rs:146-160)."""
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        out = bytearray()
        for tid in ids:
            if tid >= len(self._vocab):
                raise TokenIdOutOfBoundsError(tid)
            out += self._vocab[tid].value
        return bytes(out)

    def token_to_id(self, token: bytes) -> Optional[int]:
        return self.oracle.token_to_id(token)

    def id_to_token(self, tid: int) -> Optional[ScoredToken]:
        if tid >= len(self._vocab):
            return None
        return self._vocab[tid]

    def common_prefix_search(self, s: bytes) -> Iterator[Tuple[int, int]]:
        return self.oracle.common_prefix_search(s)

    def make_lattice(self, sentence: bytes) -> Lattice:
        lattice = Lattice(sentence)
        self.oracle.populate_nodes(lattice, 0.0)
        return lattice
