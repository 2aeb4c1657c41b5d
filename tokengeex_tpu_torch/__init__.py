"""tokengeex_tpu_torch — the PyTorch / CUDA port of tokengeex_tpu.

Unigram-LM tokenization with batched Viterbi encode on an NVIDIA Hopper
GPU: the vocabulary probe and the Viterbi DP run as hand-written CUDA
kernels (csrc/), everything around them as PyTorch tensor code. The JAX
package `tokengeex_tpu` is the reference this port is held against; the
port imports none of it.

Entry points run on the current CUDA device unless the caller passes
`device="cpu"`, which runs the kernels' plain PyTorch versions.
"""

from .core.processors import (
    CrlfProcessor,
    Processor,
    UnicodeProcessor,
    load_processors,
)
from .core.splitter import split_special_tokens
from .core.tokenizer import Tokenizer
from .core.types import (
    BOS_TOKEN_ID,
    EOS_TOKEN_ID,
    NoPathError,
    ScoredToken,
    TokenGeeXError,
    TokenIdOutOfBoundsError,
    make_vocab,
    new_default_vocab,
)
from .models.oracle import Lattice, OracleModel, Trie
from .models.unigram import Model

__version__ = "0.1.0"

__all__ = [
    "BOS_TOKEN_ID",
    "EOS_TOKEN_ID",
    "CrlfProcessor",
    "Lattice",
    "Model",
    "NoPathError",
    "OracleModel",
    "Processor",
    "ScoredToken",
    "TokenGeeXError",
    "TokenIdOutOfBoundsError",
    "Tokenizer",
    "Trie",
    "UnicodeProcessor",
    "load_processors",
    "make_vocab",
    "new_default_vocab",
    "split_special_tokens",
]


def load(filepath: str, device=None) -> Tokenizer:
    """Load a tokenizer from a v2.0 JSON file."""
    return Tokenizer.from_file(filepath, device)
