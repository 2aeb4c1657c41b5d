"""Core types for tokengeex_tpu.

TPU-native re-implementation of the reference's core types
(reference: src/lib.rs:18-31). A token is an arbitrary byte sequence
(almost always valid UTF-8, not guaranteed); a ScoredToken carries a
float64 score (log probability after training) and a `keep` flag that
protects it from pruning/filtering.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import List, Tuple

# TokenID is a plain int <= 2**32-1 (reference: src/lib.rs:19).
TokenID = int

# Sentinel ids used by the lattice (reference: src/lattice.rs:96-99).
BOS_TOKEN_ID = 2**32 - 2
EOS_TOKEN_ID = 2**32 - 1


class TokenGeeXError(Exception):
    """Base error (reference: bindings/python/src/lib.rs:9)."""


class NoPathError(TokenGeeXError):
    """Raised when no segmentation path reaches a position
    (reference: src/lib.rs:223, src/model.rs:119)."""

    def __init__(self, pos: int, length: int):
        super().__init__(f"no path to position {pos}/{length}")
        self.pos = pos
        self.length = length


class TokenIdOutOfBoundsError(TokenGeeXError):
    """Raised on decode of an invalid token id (reference: src/lib.rs:222)."""

    def __init__(self, token_id: int):
        super().__init__(f"token id {token_id} is out of bounds")
        self.token_id = token_id


@dataclass
class ScoredToken:
    """A token (bytes) with a score and keep flag (reference: src/lib.rs:26-31)."""

    value: bytes
    score: float
    keep: bool = False

    @staticmethod
    def from_str(value: str, score: float, keep: bool = False) -> "ScoredToken":
        return ScoredToken(value.encode("utf-8"), score, keep)

    @staticmethod
    def from_u8(value: int, score: float, keep: bool = False) -> "ScoredToken":
        return ScoredToken(bytes([value]), score, keep)

    def clone_with_score(self, score: float) -> "ScoredToken":
        return ScoredToken(self.value, score, self.keep)

    def clone_with_keep(self, keep: bool) -> "ScoredToken":
        return ScoredToken(self.value, self.score, keep)

    def __len__(self) -> int:
        return len(self.value)

    def to_json_obj(self) -> dict:
        """Serialize with base64 for non-UTF-8 bytes and sparse flags
        (reference: src/lib.rs:109-134). Key order: value, score,
        [encoded], [keep]."""
        obj: dict = {}
        try:
            obj["value"] = self.value.decode("utf-8")
            encoded = False
        except UnicodeDecodeError:
            # STANDARD_NO_PAD base64 engine (reference: src/lib.rs:8).
            obj["value"] = base64.b64encode(self.value).decode("ascii").rstrip("=")
            encoded = True
        obj["score"] = self.score
        if encoded:
            obj["encoded"] = True
        if self.keep:
            obj["keep"] = True
        return obj

    @staticmethod
    def from_json_obj(obj: dict) -> "ScoredToken":
        """Deserialize (reference: src/lib.rs:136-204)."""
        for key in obj:
            if key not in ("value", "score", "encoded", "keep"):
                raise TokenGeeXError(f"unknown field {key!r} in ScoredToken")
        if "value" not in obj:
            raise TokenGeeXError("missing field 'value' in ScoredToken")
        if "score" not in obj:
            raise TokenGeeXError("missing field 'score' in ScoredToken")
        raw = obj["value"]
        if obj.get("encoded", False):
            # Accept both padded and unpadded base64.
            pad = "=" * (-len(raw) % 4)
            value = base64.b64decode(raw + pad)
        else:
            value = raw.encode("utf-8")
        return ScoredToken(value, float(obj["score"]), bool(obj.get("keep", False)))


def new_default_vocab() -> List[ScoredToken]:
    """256 single-byte tokens at score 1/256 (reference: src/lib.rs:206-210)."""
    return [ScoredToken(bytes([b]), 1.0 / 256.0, False) for b in range(256)]


def make_vocab(tokens: List[Tuple[bytes, float]]) -> List[ScoredToken]:
    """Test helper (reference: src/lib.rs:212-217)."""
    return [ScoredToken(bytes(v), s, False) for v, s in tokens]
