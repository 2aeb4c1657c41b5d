"""Command-line interface of the PyTorch / CUDA port.

Reference: src/cli.rs; counterpart of tokengeex_tpu/cli.py. Eight
subcommands with the same flags and defaults: generate, prune, filter,
merge, regex, mine, encode, decode. (The reference leaves encode/decode
as todo!(), src/cli.rs:737-742; here they are implemented.)

    python -m tokengeex_tpu_torch.cli <subcommand> ...

The subcommands that use the card (generate, prune, merge, encode) run on
the current CUDA device, or where `--device` says (`--device cpu`: the
kernels' plain PyTorch versions); without a GPU and without `--device cpu`
they exit non-zero. regex, filter, mine and decode touch no device.
`--backend` of prune and merge takes `device` (the default) or `oracle`.

Multi-GPU: with WORLD_SIZE in the environment (torchrun sets it, with
RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; or set them by hand for each
rank's own command line) the card's subcommands join a process group
(parallel/mesh.py: NCCL on the card, gloo with `--device cpu`), one rank
per GPU:

    torchrun --nproc-per-node 8 -m tokengeex_tpu_torch.cli prune ...

Every rank loads the same --train files and shuffles them alike (a
replicated corpus: each row group's rows split over the ranks), or with
`--corpus-sharded` (generate, prune) each rank's --train files are its own
shard. Only rank 0 writes -o, checkpoints and encode's output.

Train sources are `{name}:{path}[:proportion]` NUL-separated .bin files,
loaded in parallel, UTF-8 validated, preprocessed at load time
(reference: src/cli.rs:237-314).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

from .core.processors import Processor, load_processors
from .core.tokenizer import Tokenizer
from .models.unigram import Model
from .train.filter import VocabularyFilter
from .train.mine import IdiomMiner
from .train.patterns import (
    PATTERNS,
    build_allow_regex,
    build_mine_regex,
    load_patterns,
)

# The subcommands that use the card import torch (and the modules that
# need it) when they run: regex, filter, mine and decode start without it.

log = logging.getLogger("tokengeex")


@dataclasses.dataclass
class Source:
    """reference: src/cli.rs:204-215."""

    name: str
    processed_samples: List[str]
    total_bytes: int
    processed_total_bytes: int


def format_bytes_as_mb(n: int) -> str:
    return f"{n / 1_000_000:.2f}MB"


def load_sources(specs: Sequence[str], processors: Sequence[Processor],
                 mode: str) -> List[Source]:
    """reference: src/cli.rs:237-314."""

    def load_one(spec: str) -> Source:
        pieces = spec.split(":")
        if len(pieces) < 2 or len(pieces) > 3:
            raise SystemExit(
                f"Invalid source format: {spec!r}. Expected to be formatted "
                "as {name}:{path}[:proportion]"
            )
        name, filepath = pieces[0], pieces[1]
        proportion = float(pieces[2]) if len(pieces) == 3 else 1.0
        with open(filepath, "rb") as f:
            contents = f.read()
        raw_samples = [s for s in contents.split(b"\x00") if s]
        samples = [s.decode("utf-8") for s in raw_samples]  # panics like ref
        total_bytes = sum(len(s) for s in raw_samples)
        take = int(len(samples) * proportion)
        processed = []
        for s in samples[:take]:
            for p in processors:
                s = p.preprocess(s)
            if s:
                processed.append(s)
        processed_bytes = sum(len(s.encode("utf-8")) for s in processed)
        log.info(
            "Loaded %d/%d samples from %r %s source (%s)",
            len(processed), len(samples), name, mode,
            format_bytes_as_mb(processed_bytes),
        )
        return Source(name, processed, total_bytes, processed_bytes)

    with ThreadPoolExecutor(max_workers=min(16, max(1, len(specs)))) as pool:
        return list(pool.map(load_one, specs))


def load_regex_file(path: str) -> str:
    """reference: src/cli.rs:316-334."""
    with open(path) as f:
        return f.read().replace("\n", "").replace("\r", "").strip()


def load_tokens(paths: Sequence[str], mode: str) -> List[str]:
    """reference: src/cli.rs:353-368."""
    out: List[str] = []
    for path in paths:
        with open(path) as f:
            tokens = json.load(f)
        log.info("Loaded %d %s tokens from %r", len(tokens), mode, path)
        out.extend(tokens)
    return out


def shuffled_train_samples(sources: Sequence[Source],
                           rng=random) -> List[str]:
    """reference: src/cli.rs:370-379."""
    samples = [s for src in sources for s in src.processed_samples]
    rng.shuffle(samples)
    return samples


def train_rng(sharded: bool = False):
    """The shuffle's generator in a card's subcommand: ranks that hold a
    replicated corpus (a process group, not `sharded`) shuffle it alike,
    from rank 0's seed."""
    from .parallel import mesh as pmesh

    if pmesh.process_count() > 1 and not sharded:
        return random.Random(pmesh.allgather_pickled(
            random.getrandbits(63))[0])
    return random


def is_writer() -> bool:
    """Whether this process writes the outputs: rank 0."""
    from .parallel import mesh as pmesh

    return pmesh.process_index() == 0


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------


def cmd_generate(args) -> None:
    """reference: src/cli.rs:386-452."""
    from .train.generate import VocabularyGenerator

    log.info(
        "Generating vocabulary output=%r vocab_size=%d split=%r allow=%r "
        "insert_probability=%s max_token_length=%d",
        args.output, args.vocab_size, args.split, args.allow,
        args.insert_probability, args.max_token_length,
    )
    processors = load_processors(args.processor)
    train = load_sources(args.train, processors, "train")
    allow = load_regex_file(args.allow) if args.allow else None
    split = load_regex_file(args.split) if args.split else None
    added = load_tokens(args.added, "added")
    suggested = load_tokens(args.suggested, "suggested")

    generator = VocabularyGenerator(
        max_token_length=args.max_token_length,
        insert_probability=args.insert_probability,
        split=split,
        allow=allow,
        added_tokens=added,
        suggested_tokens=suggested,
        device=args.device,
    )
    for source in train:
        generator.feed(source.processed_samples)
        log.info(
            "Collected frequent tokens from %r. Total: %d",
            source.name, generator.current_size(),
        )
    if args.corpus_sharded:
        # This rank fed its shard only: sum the document frequencies over
        # the ranks (every rank then generates the same vocabulary).
        generator.allreduce_frequencies()
        log.info("Merged frequencies across ranks. Total: %d",
                 generator.current_size())
    vocab = generator.generate(args.vocab_size)
    log.info(
        "Generated initial vocabulary vocab_size=%d mem=%s",
        len(vocab), format_bytes_as_mb(sum(len(t) for t in vocab)),
    )
    if is_writer():
        Tokenizer(Model(vocab), processors, args.special).save(args.output)
        log.info("Saved vocabulary to %r", args.output)


def cmd_prune(args) -> None:
    """reference: src/cli.rs:455-494."""
    from .train.prune import VocabularyPruner

    log.info(
        "Pruning vocabulary input=%r output=%r vocab_size=%d dropout=%s "
        "shrink_factor=%s em_subiters=%d",
        args.input, args.output, args.vocab_size, args.dropout,
        args.shrink_factor, args.em_subiters,
    )
    tokenizer = Tokenizer.from_file(args.input)
    model, processors, specials = (
        tokenizer.model, tokenizer.processors, tokenizer.special_tokens()
    )
    initial = model.vocab_size()
    train = load_sources(args.train, processors, "train")
    samples = [s.encode("utf-8") for s in shuffled_train_samples(
        train, train_rng(args.corpus_sharded))]

    pruner = VocabularyPruner(
        vocab_size=args.vocab_size,
        shrink_factor=args.shrink_factor,
        em_subiters=args.em_subiters,
        dropout=args.dropout,
        backend=args.backend,
        corpus_sharded=args.corpus_sharded,
        device=args.device,
    )

    checkpoint_cb = None
    if args.checkpoint_every and is_writer():
        def checkpoint_cb(m, rounds):
            if rounds % args.checkpoint_every == 0:
                path = f"{args.output}.round{rounds}"
                Tokenizer(m, processors, specials).save(path)
                log.info("Checkpointed round %d to %r", rounds, path)

    model = pruner.prune(model, samples, checkpoint_cb=checkpoint_cb)
    log.info(
        "Pruned vocabulary from=%d to=%d mem=%s",
        initial, args.vocab_size,
        format_bytes_as_mb(sum(len(t) for t in model.vocab)),
    )
    if is_writer():
        Tokenizer(model, processors, specials).save(args.output)
        log.info("Saved pruned vocabulary to %r", args.output)


def cmd_filter(args) -> None:
    """reference: src/cli.rs:497-524."""
    log.info(
        "Filtering vocabulary input=%r output=%r vocab_size=%d min_score=%s "
        "force=%s",
        args.input, args.output, args.vocab_size, args.min_score, args.force,
    )
    tokenizer = Tokenizer.from_file(args.input)
    initial = tokenizer.model.vocab_size()
    vf = VocabularyFilter(vocab_size=args.vocab_size, min_score=args.min_score,
                          force=args.force)
    model = vf.filter(tokenizer.model)
    log.info(
        "Filtered vocabulary from=%d to=%d mem=%s",
        initial, model.vocab_size(),
        format_bytes_as_mb(sum(len(t) for t in model.vocab)),
    )
    Tokenizer(model, tokenizer.processors, tokenizer.special_tokens()).save(
        args.output
    )
    log.info("Saved filtered vocabulary to %r", args.output)


def cmd_merge(args) -> None:
    """reference: src/cli.rs:554-606."""
    from .train.merge import VocabularyMerger

    if not args.train:
        raise SystemExit("At least one train source must be provided.")
    log.info(
        "Merging vocabulary input=%r output=%r num_merges=%d step=%d "
        "scale_factor=%s max_token_length=%d",
        args.input, args.output, args.num_merges, args.step,
        args.scale_factor, args.max_token_length,
    )
    tokenizer = Tokenizer.from_file(args.input)
    train = load_sources(args.train, tokenizer.processors, "train")
    samples = [s.encode("utf-8") for s in
               shuffled_train_samples(train, train_rng())]
    initial = tokenizer.model.vocab_size()
    allow = load_regex_file(args.allow)

    merger = VocabularyMerger(
        allow=allow,
        num_merges=args.num_merges,
        step=args.step,
        scale_factor=args.scale_factor,
        max_token_length=args.max_token_length,
        backend=args.backend,
        device=args.device,
    )
    model = merger.merge(tokenizer.model, samples)
    log.info(
        "Merged vocabulary from=%d to=%d mem=%s",
        initial, model.vocab_size(),
        format_bytes_as_mb(sum(len(t) for t in model.vocab)),
    )
    if is_writer():
        Tokenizer(model, tokenizer.processors,
                  tokenizer.special_tokens()).save(args.output)
        log.info("Saved merged vocabulary to %r", args.output)


def cmd_regex(args) -> None:
    """reference: src/cli.rs:527-551."""
    if not args.output:
        for name, pattern, _, _ in PATTERNS:
            print(f"{name}: {pattern}")
        return
    log.info("Generating regex output=%r patterns=%d", args.output,
             len(args.pattern))
    patterns = load_patterns(args.pattern)
    regex = build_allow_regex(patterns)
    with open(args.output, "w") as f:
        f.write(regex)
    log.info("Saved regex to %r", args.output)


def cmd_mine(args) -> None:
    """reference: src/cli.rs:609-652."""
    if not args.train:
        raise SystemExit("At least one train source must be provided.")
    if not args.pattern:
        raise SystemExit("At least one pattern must be provided.")
    log.info(
        "Mining idioms output=%r num_idioms=%d patterns=%r",
        args.output, args.num_idioms, args.pattern,
    )
    train = load_sources(args.train, [], "train")
    samples = shuffled_train_samples(train)
    patterns = load_patterns(args.pattern)
    regex = build_mine_regex(patterns)

    miner = IdiomMiner(args.num_idioms, regex)
    idioms = miner.mine(samples)
    log.info("Found %d idioms.", len(idioms))
    for idiom, count in idioms:
        log.debug("%r: %d (~%.2f per sample)", idiom, count,
                  count / max(1, len(samples)))
    with open(args.output, "w") as f:
        json.dump([idiom for idiom, _ in idioms], f, indent=2,
                  ensure_ascii=False)


def cmd_encode(args) -> None:
    """Implemented (reference leaves this todo!(), src/cli.rs:737-739):
    the device backend's batched Viterbi encode, one text, on
    `--device`."""
    tokenizer = Tokenizer.from_file(args.vocab, args.device)
    text = args.input if args.input is not None else sys.stdin.read()
    ids = tokenizer.encode_batch([text], args.dropout, backend="device",
                                 seed=random.randrange(1 << 31))[0]
    if is_writer():
        print(json.dumps(ids))


def cmd_decode(args) -> None:
    """Implemented (reference leaves this todo!(), src/cli.rs:740-742)."""
    tokenizer = Tokenizer.from_file(args.vocab)
    raw = args.input if args.input is not None else sys.stdin.read()
    # Accept `encode`'s own JSON list output as well as bare
    # space/comma-separated ids; reject anything else (a nested list
    # would otherwise silently flatten).
    try:
        ids = json.loads(raw)
    except ValueError:
        ids = [int(x) for x in raw.replace(",", " ").split()]
    if isinstance(ids, int) and not isinstance(ids, bool):
        ids = [ids]  # a single bare id, e.g. `decode -i 5`
    if not isinstance(ids, list) or not all(
            isinstance(x, int) and not isinstance(x, bool) for x in ids):
        sys.exit("decode: input must be a flat list of token ids")
    print(tokenizer.decode(ids, include_special_tokens=True))


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tokengeex-torch",
        description="Tokenizer training & inference on an NVIDIA GPU "
                    "(the PyTorch / CUDA port)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    # generate (reference: src/cli.rs:26-61, defaults :674-675)
    g = sub.add_parser("generate")
    g.add_argument("-v", "--vocab-size", type=int, required=True)
    g.add_argument("-o", "--output", required=True)
    g.add_argument("--processor", action="append", default=[])
    g.add_argument("--train", action="append", default=[])
    g.add_argument("--special", action="append", default=[])
    g.add_argument("--suggested", action="append", default=[])
    g.add_argument("--added", action="append", default=[])
    g.add_argument("--allow")
    g.add_argument("--split")
    g.add_argument("--insert-probability", type=float, default=0.1)
    g.add_argument("--max-token-length", type=int, default=24)
    g.add_argument("--corpus-sharded", action="store_true",
                   help="--train files are this rank's shard of a "
                        "multi-process corpus")
    g.set_defaults(fn=cmd_generate, device_stage=True)

    # prune (reference: src/cli.rs:65-86, defaults :687-689)
    pr = sub.add_parser("prune")
    pr.add_argument("-i", "--input", required=True)
    pr.add_argument("-o", "--output", required=True)
    pr.add_argument("-v", "--vocab-size", type=int, required=True)
    pr.add_argument("--train", action="append", default=[])
    pr.add_argument("--dropout", type=float, default=0.01)
    pr.add_argument("--shrink-factor", type=float, default=0.8)
    pr.add_argument("--em-subiters", type=int, default=1)
    pr.add_argument("--backend", default="device",
                    help="device (default) or oracle")
    pr.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a checkpoint every N prune rounds")
    pr.add_argument("--corpus-sharded", action="store_true",
                    help="--train files are this rank's shard of a "
                         "multi-process corpus")
    pr.set_defaults(fn=cmd_prune, device_stage=True)

    # filter (reference: src/cli.rs:90-103, defaults :697-700)
    f = sub.add_parser("filter")
    f.add_argument("-i", "--input", required=True)
    f.add_argument("-o", "--output", required=True)
    f.add_argument("-v", "--vocab-size", type=int, default=0)
    f.add_argument("--min-score", type=float)
    f.add_argument("--force", action="store_true")
    f.set_defaults(fn=cmd_filter)

    # merge (reference: src/cli.rs:106-131, defaults :720-723)
    m = sub.add_parser("merge")
    m.add_argument("-i", "--input", required=True)
    m.add_argument("-o", "--output", required=True)
    m.add_argument("--train", action="append", default=[])
    m.add_argument("--allow", required=True)
    m.add_argument("--num-merges", type=int, default=1000)
    m.add_argument("--step", type=int, default=50)
    m.add_argument("--scale-factor", type=float, default=0.9)
    m.add_argument("--max-token-length", type=int, default=24)
    m.add_argument("--backend", default="device",
                   help="device (default) or oracle")
    m.set_defaults(fn=cmd_merge, device_stage=True)

    # regex (reference: src/cli.rs:134-140)
    r = sub.add_parser("regex")
    r.add_argument("-o", "--output")
    r.add_argument("-p", "--pattern", action="append", default=[])
    r.set_defaults(fn=cmd_regex)

    # mine (reference: src/cli.rs:143-159)
    mi = sub.add_parser("mine")
    mi.add_argument("-n", "--num-idioms", type=int, required=True)
    mi.add_argument("-o", "--output", required=True)
    mi.add_argument("--train", action="append", default=[])
    mi.add_argument("-p", "--pattern", action="append", default=[])
    mi.set_defaults(fn=cmd_mine)

    # encode / decode (reference: src/cli.rs:162-175)
    e = sub.add_parser("encode")
    e.add_argument("-v", "--vocab", required=True)
    e.add_argument("-i", "--input")
    e.add_argument("--dropout", type=float, default=0.0)
    e.set_defaults(fn=cmd_encode, device_stage=True)

    d = sub.add_parser("decode")
    d.add_argument("-v", "--vocab", required=True)
    d.add_argument("-i", "--input")
    d.set_defaults(fn=cmd_decode)

    for parser in sub.choices.values():
        parser.add_argument(
            "--device", default=None,
            help="torch device of generate, prune, merge and encode "
                 "(default: the current CUDA device, or under torchrun the "
                 "rank's; cpu: the kernels' plain PyTorch versions)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(
        level=os.environ.get("TOKENGEEX_LOG", os.environ.get("RUST_LOG", "info")).upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    args = build_parser().parse_args(argv)
    if not getattr(args, "device_stage", False):
        # regex, filter, mine and decode: no torch, no CUDA context.
        args.fn(args)
        return
    from .parallel import mesh as pmesh
    from .utils.device import resolve_device

    try:
        if "WORLD_SIZE" in os.environ:
            args.device = pmesh.distributed_initialize(args.device)
        else:
            args.device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"tokengeex-torch: {e}")
    try:
        args.fn(args)
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
