"""Input processors (normalizers).

Reference: src/processor.rs. A processor has `preprocess` (applied before
the model on encode) and `postprocess` (applied after decode, in reverse
processor order). Both CRLF and Unicode processors have identity
postprocess — normalization is NOT reversed on decode
(reference: src/processor.rs:46-54, 134-136).
"""

from __future__ import annotations

import unicodedata
from typing import List

from .types import TokenGeeXError


class Processor:
    def preprocess(self, s: str) -> str:
        raise NotImplementedError

    def postprocess(self, s: str) -> str:
        raise NotImplementedError

    def to_json_obj(self) -> dict:
        raise NotImplementedError


class CrlfProcessor(Processor):
    """Replaces \r\n by \n (reference: src/processor.rs:46-54)."""

    def preprocess(self, s: str) -> str:
        return s.replace("\r\n", "\n")

    def postprocess(self, s: str) -> str:
        return s

    def to_json_obj(self) -> dict:
        return {"type": "crlf"}

    def __eq__(self, other) -> bool:
        return isinstance(other, CrlfProcessor)


class UnicodeProcessor(Processor):
    """Unicode normalizer: nfc/nfd/nfkc/nfkd (reference: src/processor.rs:111-136)."""

    FORMS = ("nfc", "nfd", "nfkc", "nfkd")

    def __init__(self, form: str):
        form = form.lower()
        if form not in self.FORMS:
            raise TokenGeeXError(f"unknown unicode form {form!r}")
        self.form = form

    def preprocess(self, s: str) -> str:
        return unicodedata.normalize(self.form.upper(), s)

    def postprocess(self, s: str) -> str:
        return s

    def to_json_obj(self) -> dict:
        return {"type": "unicode", "form": self.form}

    def __eq__(self, other) -> bool:
        return isinstance(other, UnicodeProcessor) and other.form == self.form


def processor_from_json_obj(obj: dict) -> Processor:
    """Deserialize a processor from its JSON form.

    The reference uses an untagged enum (src/processor.rs:13-18); crlf
    serializes as {"type": "crlf"} and unicode as
    {"type": "unicode", "form": ...} (src/processor.rs:56-107, 139-215).
    """
    ptype = obj.get("type")
    if ptype == "crlf":
        return CrlfProcessor()
    if ptype == "unicode":
        if "form" not in obj:
            raise TokenGeeXError("missing field 'form' in unicode processor")
        return UnicodeProcessor(obj["form"])
    # Untagged enum semantics: a map with a "form" key parses as unicode
    # even without a type tag.
    if "form" in obj:
        return UnicodeProcessor(obj["form"])
    raise TokenGeeXError(f"unknown processor {obj!r}")


def load_processors(names: List[str]) -> List[Processor]:
    """CLI-style processor loading (reference: src/cli.rs:217-235)."""
    out: List[Processor] = []
    for name in names:
        if name == "crlf":
            out.append(CrlfProcessor())
        elif name in UnicodeProcessor.FORMS:
            out.append(UnicodeProcessor(name))
        else:
            raise TokenGeeXError(f"Processor {name!r} is not supported.")
    return out
