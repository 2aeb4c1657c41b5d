"""Tokenizer pipeline: special tokens -> processors -> model.

Counterpart of tokengeex_tpu/core/tokenizer.py with the device backend
on the PyTorch port (train/estep_device.py).

Reference: src/tokenizer.rs. Special token ids live AFTER the base
vocabulary: id = base_vocab_size + index (reference:
src/tokenizer.rs:70-77,203-207,219-226). The JSON checkpoint schema is
version "2.0": {version, special_tokens, processors, vocab}
(reference: src/tokenizer.rs:349-366) with a strict version check
(reference: src/tokenizer.rs:423-429).
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence

from ..models.unigram import Model
from .processors import Processor, processor_from_json_obj
from .splitter import split_special_tokens
from .types import ScoredToken, TokenGeeXError, TokenIdOutOfBoundsError

SERIALIZATION_VERSION = "2.0"


class Tokenizer:
    def __init__(
        self,
        model: Model,
        processors: Sequence[Processor] = (),
        special_tokens: Sequence[str] = (),
        device=None,
    ):
        """device: where backend="device" encodes run; None means the
        current CUDA device (raising without a GPU), "cpu" the kernels'
        plain PyTorch versions."""
        self.model = model
        self.device = device
        self.processors: List[Processor] = list(processors)
        self._special_tokens: List[str] = []
        self.special_tokens_map: Dict[str, int] = {}
        self.add_special_tokens(special_tokens)

    # -- Special tokens ----------------------------------------------------

    def add_special_tokens(self, tokens: Sequence[str]) -> None:
        """Duplicates are ignored (reference: src/tokenizer.rs:39-53)."""
        for token in tokens:
            if token in self.special_tokens_map:
                continue
            self.special_tokens_map[token] = len(self._special_tokens)
            self._special_tokens.append(token)

    def add_base_tokens(self, tokens: List[ScoredToken]) -> None:
        self.model.add_tokens(tokens)

    # -- Encode ------------------------------------------------------------

    def encode(self, text: str, dropout: float = 0.0,
               rng: Optional[random.Random] = None) -> List[int]:
        """Reference: src/tokenizer.rs:65-89."""
        ids: List[int] = []
        base = self.model.vocab_size()
        for substr, is_special in split_special_tokens(text, self._special_tokens):
            if is_special:
                ids.append(base + self.special_tokens_map[substr])
            else:
                processed = substr
                for p in self.processors:
                    processed = p.preprocess(processed)
                ids.extend(self.model.encode(processed, dropout, rng))
        return ids

    def encode_ordinary(self, text: str, dropout: float = 0.0,
                        rng: Optional[random.Random] = None) -> List[int]:
        """Skip special-token handling (reference: src/tokenizer.rs:92-99)."""
        processed = text
        for p in self.processors:
            processed = p.preprocess(processed)
        return self.model.encode(processed, dropout, rng)

    def encode_batch(self, texts: Sequence[str], dropout: float = 0.0,
                     backend: str = "device", seed: int = 0,
                     timer=None) -> List[List[int]]:
        """Batch encode (reference: src/tokenizer.rs:102-111).

        backend="device" runs the Viterbi segmentation of all ordinary
        spans as one packed batch on `self.device`; "oracle" encodes
        span by span with the host float64 oracle. `timer` (an
        ops.lattice.PhaseTimer) collects the device pass's phases. Under a
        process group (parallel/mesh.py) the device backend splits each
        row group's rows over the ranks and returns every text's ids on
        every rank, so every rank must call it with the same texts.
        """
        return self._encode_batch_any(texts, ordinary=False, dropout=dropout,
                                      backend=backend, seed=seed, timer=timer)

    def encode_ordinary_batch(self, texts: Sequence[str], dropout: float = 0.0,
                              backend: str = "device", seed: int = 0,
                              timer=None) -> List[List[int]]:
        return self._encode_batch_any(texts, ordinary=True, dropout=dropout,
                                      backend=backend, seed=seed, timer=timer)

    def _layout_spans(self, texts: Sequence[str], ordinary: bool):
        """Per text, a list of ("special", id) | ("span", span_index)
        parts plus the flat list of preprocessed ordinary spans."""
        base = self.model.vocab_size()
        layout: List[List] = []
        spans: List[str] = []
        for text in texts:
            parts = []
            pieces = (
                [(text, False)] if ordinary
                else split_special_tokens(text, self._special_tokens)
            )
            for substr, is_special in pieces:
                if is_special:
                    parts.append(("special", base + self.special_tokens_map[substr]))
                else:
                    processed = substr
                    for p in self.processors:
                        processed = p.preprocess(processed)
                    parts.append(("span", len(spans)))
                    spans.append(processed)
            layout.append(parts)
        return layout, spans

    @staticmethod
    def _stitch(layout: List[List], encoded: List[List[int]]) -> List[List[int]]:
        out: List[List[int]] = []
        for parts in layout:
            ids: List[int] = []
            for kind, val in parts:
                if kind == "special":
                    ids.append(val)
                else:
                    ids.extend(encoded[val])
            out.append(ids)
        return out

    def _encode_batch_any(self, texts: Sequence[str], ordinary: bool,
                          dropout: float, backend: str, seed: int,
                          timer) -> List[List[int]]:
        layout, spans = self._layout_spans(texts, ordinary)
        if backend == "device":
            from ..train.estep_device import encode_corpus_device

            encoded = encode_corpus_device(
                self.model, [s.encode("utf-8") for s in spans],
                dropout=dropout, seed=seed, device=self.device, timer=timer)
        elif backend == "oracle":
            encoded = self.model.encode_batch(spans, dropout)
        else:
            raise NotImplementedError(
                f"backend={backend!r}: the port has the 'device' and "
                "'oracle' backends; the native runtime and the 'auto' "
                "crossover are not part of the port (ROADMAP.md)")
        return self._stitch(layout, encoded)

    # -- Decode ------------------------------------------------------------

    def decode(self, ids: Sequence[int], include_special_tokens: bool = False) -> str:
        """Split at special ids; postprocess in REVERSE processor order
        (reference: src/tokenizer.rs:126-176)."""
        base = self.model.vocab_size()
        out: List[str] = []
        span: List[int] = []

        def flush(span_ids: Sequence[int]) -> None:
            decoded = self.model.decode(span_ids)
            for p in reversed(self.processors):
                decoded = p.postprocess(decoded)
            out.append(decoded)

        for tid in ids:
            if tid >= base:
                flush(span)
                span = []
                special_idx = tid - base
                if special_idx >= len(self._special_tokens):
                    raise TokenIdOutOfBoundsError(tid)
                if include_special_tokens:
                    out.append(self._special_tokens[special_idx])
            else:
                span.append(tid)
        flush(span)
        return "".join(out)

    def decode_batch(self, idss: Sequence[Sequence[int]],
                     include_special_tokens: bool = False) -> List[str]:
        return [self.decode(ids, include_special_tokens) for ids in idss]

    # -- Vocabulary lookups (reference: src/tokenizer.rs:189-259) ----------

    def token_to_id(self, token: bytes) -> Optional[int]:
        tid = self.base_token_to_id(token)
        if tid is not None:
            return tid
        try:
            return self.special_token_to_id(token.decode("utf-8"))
        except UnicodeDecodeError:
            return None

    def base_token_to_id(self, token: bytes) -> Optional[int]:
        return self.model.token_to_id(token)

    def special_token_to_id(self, token: str) -> Optional[int]:
        idx = self.special_tokens_map.get(token)
        if idx is None:
            return None
        return idx + self.model.vocab_size()

    def id_to_token(self, tid: int) -> Optional[bytes]:
        special = self.id_to_special_token(tid)
        if special is not None:
            return special.encode("utf-8")
        token = self.id_to_base_token(tid)
        if token is not None:
            return token.value
        return None

    def id_to_special_token(self, tid: int) -> Optional[str]:
        base = self.model.vocab_size()
        if tid < base:
            return None
        idx = tid - base
        if idx < len(self._special_tokens):
            return self._special_tokens[idx]
        return None

    def id_to_base_token(self, tid: int) -> Optional[ScoredToken]:
        return self.model.id_to_token(tid)

    def is_special(self, tid: int) -> bool:
        base = self.model.vocab_size()
        return tid >= base and (tid - base) < len(self._special_tokens)

    def is_base(self, tid: int) -> bool:
        return tid < self.model.vocab_size()

    def special_tokens(self) -> List[str]:
        """Reference: src/tokenizer.rs:245-247 (returns a copy)."""
        return list(self._special_tokens)

    def vocab_size(self) -> int:
        return self.model.vocab_size() + len(self._special_tokens)

    def base_vocab_size(self) -> int:
        return self.model.vocab_size()

    def special_vocab_size(self) -> int:
        return len(self._special_tokens)

    def common_prefix_search(self, text: str):
        return self.model.common_prefix_search(text.encode("utf-8"))

    # -- Serialization (JSON v2.0) ----------------------------------------

    def to_json_obj(self) -> dict:
        return {
            "version": SERIALIZATION_VERSION,
            "special_tokens": list(self._special_tokens),
            "processors": [p.to_json_obj() for p in self.processors],
            "vocab": [t.to_json_obj() for t in self.model.vocab],
        }

    def to_string(self, pretty: bool = False) -> str:
        if pretty:
            return json.dumps(self.to_json_obj(), ensure_ascii=False, indent=2)
        return json.dumps(self.to_json_obj(), ensure_ascii=False,
                          separators=(",", ":"))

    def save(self, filepath: str) -> None:
        """Pretty JSON, like serde_json::to_string_pretty
        (reference: src/tokenizer.rs:261-265)."""
        with open(filepath, "w", encoding="utf-8") as f:
            f.write(self.to_string(pretty=True))

    @staticmethod
    def from_json_obj(obj: dict, device=None) -> "Tokenizer":
        for key in obj:
            if key not in ("version", "special_tokens", "processors", "vocab"):
                raise TokenGeeXError(f"unknown field {key!r} in Tokenizer")
        version = obj.get("version")
        if version is None:
            raise TokenGeeXError("missing field 'version'")
        if version != SERIALIZATION_VERSION:
            raise TokenGeeXError(f"unsupported version: {version}")
        vocab = [ScoredToken.from_json_obj(t) for t in obj.get("vocab", [])]
        processors = [processor_from_json_obj(p) for p in obj.get("processors", [])]
        special_tokens = obj.get("special_tokens", [])
        return Tokenizer(Model(vocab), processors, special_tokens, device)

    @staticmethod
    def from_str(s: str, device=None) -> "Tokenizer":
        return Tokenizer.from_json_obj(json.loads(s), device)

    @staticmethod
    def from_file(filepath: str, device=None) -> "Tokenizer":
        """Load a v2.0 JSON checkpoint, such as one written by
        tokengeex_tpu.Tokenizer.save."""
        with open(filepath, "r", encoding="utf-8") as f:
            return Tokenizer.from_str(f.read(), device)

    # -- Pickle via JSON (reference: bindings/python/src/lib.rs:196-223) ---

    def __getstate__(self):
        return self.to_string()

    def __setstate__(self, state):
        other = Tokenizer.from_str(state)
        self.model = other.model
        self.processors = other.processors
        self._special_tokens = other._special_tokens
        self.special_tokens_map = other.special_tokens_map
        self.device = None

    def __reduce__(self):
        return (Tokenizer.from_str, (self.to_string(),))
