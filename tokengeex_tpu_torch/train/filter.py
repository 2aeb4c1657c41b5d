"""Vocabulary filter: drop low-score tokens.

Reference: src/filter.rs. Sorts ascending by score, removes tokens with
score <= min_score unless (keep and not force), never removing below
`vocab_size`; re-sorts descending and rebuilds the model.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

from ..models.unigram import Model

log = logging.getLogger(__name__)


@dataclasses.dataclass
class VocabularyFilter:
    """reference: src/filter.rs:3-16 (defaults from src/cli.rs:697-700)."""

    vocab_size: int = 0
    min_score: Optional[float] = None
    force: bool = False

    def filter(self, model: Model) -> Model:
        """reference: src/filter.rs:20-49."""
        if model.vocab_size() <= self.vocab_size:
            return model

        num_to_remove = model.vocab_size() - self.vocab_size
        num_removed = 0
        vocab = sorted(model.vocab, key=lambda t: t.score)
        min_score = self.min_score if self.min_score is not None else -math.inf

        new_vocab = []
        for token in vocab:
            should_keep = (
                num_removed >= num_to_remove
                or (token.keep and not self.force)
                or token.score > min_score
            )
            if should_keep:
                new_vocab.append(token)
            else:
                num_removed += 1
                log.debug("Removing token: %r", token)

        new_vocab.sort(key=lambda t: -t.score)
        return Model(new_vocab)
