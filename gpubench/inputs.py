"""A cell's inputs, made from the seed: corpus files and vocabularies."""

from __future__ import annotations

from typing import List

import numpy as np

from . import corpus, vocab


def subseed(seed: int, k: int) -> int:
    """The k-th seed drawn from a run's seed, for one use of it."""
    return int(np.random.SeedSequence([int(seed), k]).generate_state(
        1, np.uint32)[0])


# Uses of the run's seed.
CORPUS, VOCAB, PRUNER, REF_COINS, SAMPLE = range(5)


def recipe_sizes(config: dict) -> List[int]:
    """The vocabulary sizes of the recipe's prune rounds, from the initial
    vocabulary down to the target: max(int(V x shrink), target)."""
    sizes = [int(config["init_vocab_size"])]
    target = int(config["vocab_size"])
    shrink = float(config["prune"]["shrink_factor"])
    while sizes[-1] > target:
        sizes.append(max(int(sizes[-1] * shrink), target))
    return sizes


def prune_sizes(config: dict, traffic: dict) -> tuple:
    """(start vocabulary size, target) of the traffic's rounds."""
    sizes = recipe_sizes(config)
    n = int(traffic["n_rounds"])
    if traffic["rounds"] == "first":
        return sizes[0], sizes[n]
    if traffic["rounds"] == "last":
        return sizes[-1 - n], sizes[-1]
    raise ValueError(f"unknown rounds {traffic['rounds']!r}")


def build_vocab(config: dict, use: str, files, size: int,
                seed: int) -> List[vocab.Token]:
    rule = config["vocab"][use]
    L = int(config["max_token_length"])
    if rule["rule"] == "words":
        return vocab.words_vocab(files, size, L, bool(rule["prefixes"]))
    if rule["rule"] == "sampled":
        return vocab.sampled_vocab(files, size, L,
                                   float(config["insert_probability"]),
                                   subseed(seed, VOCAB))
    raise ValueError(f"unknown vocabulary rule {rule['rule']!r}")


def build_files(nbytes: int, traffic: dict, seed: int):
    return corpus.build_corpus(int(nbytes), subseed(seed, CORPUS),
                               traffic["corpus"])
