"""Exact-semantics CPU oracle for the unigram model.

This module is the conformance reference for the TPU path: a pure-Python
float64 implementation that mirrors the reference's iteration orders and
tie-breaking bit-for-bit:

- Trie prefix search yields matches in increasing token length
  (reference: src/trie.rs:22-64).
- Viterbi DP relaxes on STRICTLY greater score; candidates for a dp cell
  arrive in ascending start position (= descending token length), so on
  exact ties the longer token wins (reference: src/model.rs:83-110).
- The lattice forward-backward uses pairwise log_sum_exp accumulated in
  node-list order with a 50-nat cutoff (reference: src/lattice.rs:245-333).

A faster C++ implementation with identical semantics lives in native/;
this file is the executable specification.
"""

from __future__ import annotations

import heapq
import math
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.types import BOS_TOKEN_ID, EOS_TOKEN_ID, NoPathError, ScoredToken


class Trie:
    """Byte trie mapping token bytes -> (id, len).

    Node layout mirrors reference src/trie.rs:74-87 (children map keyed
    by byte); `push` overwrites data for duplicate keys so the LAST
    inserted id wins, matching HashMap::insert semantics in
    Model::from (reference: src/model.rs:16-30).
    """

    __slots__ = ("root",)

    def __init__(self):
        # node = (children: dict[int, node], data: [Optional[(id, len)]])
        self.root = ({}, [None])

    def push(self, element: bytes, data: Tuple[int, int]) -> None:
        node = self.root
        for b in element:
            child = node[0].get(b)
            if child is None:
                child = ({}, [None])
                node[0][b] = child
            node = child
        node[1][0] = data

    def common_prefix_search(self, s: Sequence[int]) -> Iterator[Tuple[int, int]]:
        """Yield (id, len) for every vocab token that is a prefix of s,
        in increasing length order (reference: src/trie.rs:44-64)."""
        node = self.root
        for b in s:
            node = node[0].get(b)
            if node is None:
                return
            if node[1][0] is not None:
                yield node[1][0]


class LatticeNode:
    """Reference: src/lattice.rs:12-26."""

    __slots__ = ("pos", "token_id", "token_len", "score", "prev", "backtrack_score")

    def __init__(self, pos: int, token_id: int, token_len: int, score: float):
        self.pos = pos
        self.token_id = token_id
        self.token_len = token_len
        self.score = score
        self.prev: Optional[int] = None
        self.backtrack_score = 0.0


def _log_sum_exp(x: float, y: float, init_mode: bool) -> float:
    """Pairwise accumulator with 50-nat cutoff (reference: src/lattice.rs:321-333)."""
    if init_mode:
        return y
    if x > y:
        vmin, vmax = y, x
    else:
        vmin, vmax = x, y
    if vmax > vmin + 50.0:
        return vmax
    return vmax + math.log(math.exp(vmin - vmax) + 1.0)


class Lattice:
    """Segmentation lattice over a byte sentence (reference: src/lattice.rs:49-103)."""

    def __init__(self, sentence: bytes):
        self.sentence = sentence
        n = len(sentence)
        self.nodes: List[LatticeNode] = []
        self.begin_nodes: List[List[int]] = [[] for _ in range(n + 1)]
        self.end_nodes: List[List[int]] = [[] for _ in range(n + 1)]
        # BOS at index 0, EOS at index 1 (reference: src/lattice.rs:96-102).
        self.nodes.append(LatticeNode(0, BOS_TOKEN_ID, 0, 0.0))
        self.bos_idx = 0
        self.nodes.append(LatticeNode(n, EOS_TOKEN_ID, 0, 0.0))
        self.eos_idx = 1
        self.end_nodes[0].append(self.bos_idx)
        self.begin_nodes[n].append(self.eos_idx)

    def insert(self, pos: int, token_id: int, token_len: int, score: float) -> None:
        node_idx = len(self.nodes)
        self.begin_nodes[pos].append(node_idx)
        self.end_nodes[pos + token_len].append(node_idx)
        self.nodes.append(LatticeNode(pos, token_id, token_len, score))

    def viterbi(self) -> List[LatticeNode]:
        """Reference: src/lattice.rs:112-150."""
        n = len(self.sentence)
        for pos in range(n + 1):
            for rid in self.begin_nodes[pos]:
                rnode = self.nodes[rid]
                rnode.prev = None
                best_score = 0.0
                best_node: Optional[int] = None
                for lid in self.end_nodes[pos]:
                    score = self.nodes[lid].backtrack_score + rnode.score
                    if best_node is None or score > best_score:
                        best_node = lid
                        best_score = score
                if best_node is None:
                    return []
                rnode.prev = best_node
                rnode.backtrack_score = best_score
        results: List[LatticeNode] = []
        node_idx = self.begin_nodes[n][0]
        while self.nodes[node_idx].prev is not None:
            results.append(self.nodes[node_idx])
            node_idx = self.nodes[node_idx].prev
        results.reverse()
        return results

    def nbest(self, n: int) -> List[List[LatticeNode]]:
        """A*-style n-best hypothesis search (reference: src/lattice.rs:152-238)."""
        if n == 0:
            return []
        if n == 1:
            return [self.viterbi()]

        # Hypothesis = (-fx, seq, node_idx, parent_hypothesis, gx); heapq
        # is a min-heap so we negate fx. The Rust BinaryHeap breaks ties
        # arbitrarily; we break by insertion sequence.
        counter = 0
        agenda: List[tuple] = []
        hypotheses: List[List[int]] = []

        eos_id = 1
        score = self.nodes[eos_id].score
        heapq.heappush(agenda, (-score, counter, eos_id, None, score))
        counter += 1

        self.viterbi()

        bos_token_id = self.nodes[self.bos_idx].token_id

        while agenda:
            top = heapq.heappop(agenda)
            _, _, node_idx, parent, top_gx = top
            node = self.nodes[node_idx]
            if node.token_id == bos_token_id:
                # Walk the chain, skipping the leading node after BOS's
                # parent and the trailing EOS (reference: src/lattice.rs:188-199).
                hypothesis = []
                nxt = parent
                while nxt is not None and nxt[3] is not None:
                    hypothesis.append(nxt[2])
                    nxt = nxt[3]
                hypotheses.append(hypothesis)
                if len(hypotheses) == n:
                    return [[self.nodes[i] for i in h] for h in hypotheses]
            else:
                for lnode in self.end_nodes[node.pos]:
                    fx = self.nodes[lnode].backtrack_score + top_gx
                    gx = self.nodes[lnode].score + top_gx
                    heapq.heappush(agenda, (-fx, counter, lnode, top, gx))
                    counter += 1
                # Agenda shrink (reference: src/lattice.rs:216-228).
                if len(agenda) > 100_000:
                    keep = min(512, n * 10)
                    agenda = heapq.nsmallest(keep, agenda)
                    heapq.heapify(agenda)

        return [[self.nodes[i] for i in h] for h in hypotheses]

    def populate_marginal(self, expected: List[float]) -> float:
        """Forward-backward in log space; scatter-adds marginals into
        `expected` indexed by token id; returns the normalizer z
        (reference: src/lattice.rs:245-312)."""
        n = len(self.sentence)
        num_nodes = len(self.nodes)
        alpha = [0.0] * num_nodes
        beta = [0.0] * num_nodes
        nodes = self.nodes

        for pos in range(n + 1):
            begin = self.begin_nodes[pos]
            end = self.end_nodes[pos]
            for rid in begin:
                first = True
                a = alpha[rid]
                for lid in end:
                    a = _log_sum_exp(a, nodes[lid].score + alpha[lid], first)
                    first = False
                alpha[rid] = a

        for pos in range(n, -1, -1):
            begin = self.begin_nodes[pos]
            end = self.end_nodes[pos]
            for lid in end:
                first = True
                b = beta[lid]
                for rid in begin:
                    b = _log_sum_exp(b, nodes[rid].score + beta[rid], first)
                    first = False
                beta[lid] = b

        z = alpha[self.eos_idx]

        for pos in range(n):
            for node_idx in self.begin_nodes[pos]:
                node = nodes[node_idx]
                total = alpha[node_idx] + node.score + beta[node_idx] - z
                expected[node.token_id] += math.exp(total)

        return z


class OracleModel:
    """Exact unigram model (reference: src/model.rs:7-200)."""

    def __init__(self, vocab: List[ScoredToken]):
        self.vocab: List[ScoredToken] = list(vocab)
        self.token_to_ids: Dict[bytes, int] = {}
        self.trie = Trie()
        for i, token in enumerate(self.vocab):
            # Later duplicates overwrite earlier ids, matching
            # HashMap::insert / Trie::push (reference: src/model.rs:20-23).
            self.token_to_ids[token.value] = i
            self.trie.push(token.value, (i, len(token.value)))

    def vocab_size(self) -> int:
        return len(self.vocab)

    def populate_nodes(self, lattice: Lattice, dropout: float = 0.0,
                       rng: Optional[random.Random] = None) -> None:
        """Insert all trie matches at every position; dropout skips
        len>1 tokens with probability `dropout`
        (reference: src/model.rs:34-55)."""
        rng = rng or random
        sentence = lattice.sentence
        n = len(sentence)
        trie = self.trie
        vocab = self.vocab
        for pos in range(n):
            suffix = memoryview(sentence)[pos:]
            for tid, tlen in trie.common_prefix_search(suffix):
                if tlen > 1 and dropout > 0.0 and rng.random() < dropout:
                    continue
                lattice.insert(pos, tid, tlen, vocab[tid].score)

    def encode(self, text: str, dropout: float = 0.0,
               rng: Optional[random.Random] = None) -> List[int]:
        """Linear DP Viterbi over byte positions (reference: src/model.rs:59-129).

        dp relaxation uses strict >; candidates stream in ascending
        start pos then ascending length, so dp cells keep the earliest
        (longest-token) path on exact ties.
        """
        rng = rng or random
        data = (bytes(text) if isinstance(text, (bytes, bytearray, memoryview))
                else text.encode("utf-8"))
        n = len(data)
        # dp[i] = (id, score, start) ; start None = unreachable.
        dp_id = [0] * (n + 1)
        dp_score = [0.0] * (n + 1)
        dp_start: List[Optional[int]] = [None] * (n + 1)
        dp_start[0] = 0

        trie = self.trie
        vocab = self.vocab
        use_dropout = dropout > 0.0
        mv = memoryview(data)
        for pos in range(n):
            if dp_start[pos] is None:
                continue
            base = dp_score[pos]
            for tid, tlen in trie.common_prefix_search(mv[pos:]):
                end = pos + tlen
                score = base + vocab[tid].score
                # Condition order mirrors reference src/model.rs:100-108.
                if (not use_dropout or tlen <= 1 or dropout < rng.random()) and (
                    dp_start[end] is None or score > dp_score[end]
                ):
                    dp_id[end] = tid
                    dp_score[end] = score
                    dp_start[end] = pos

        pos = n
        ids: List[int] = []
        while pos > 0:
            start = dp_start[pos]
            if start is None:
                raise NoPathError(pos, n)
            ids.append(dp_id[pos])
            pos = start
        ids.reverse()
        return ids

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        from ..core.types import TokenIdOutOfBoundsError

        out = bytearray()
        for tid in ids:
            if tid >= len(self.vocab):
                raise TokenIdOutOfBoundsError(tid)
            out += self.vocab[tid].value
        return bytes(out)

    def decode(self, ids: Sequence[int]) -> str:
        """Concatenate token bytes; lossy UTF-8 (reference: src/model.rs:146-160)."""
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def token_to_id(self, token: bytes) -> Optional[int]:
        return self.token_to_ids.get(token)

    def id_to_token(self, tid: int) -> Optional[ScoredToken]:
        if tid >= len(self.vocab):
            return None
        return self.vocab[tid]

    def add_tokens(self, tokens: List[ScoredToken]) -> None:
        """Append tokens; ids grow at the end (reference: src/model.rs:184-194)."""
        for token in tokens:
            tid = len(self.vocab)
            self.trie.push(token.value, (tid, len(token.value)))
            self.token_to_ids[token.value] = tid
            self.vocab.append(token)

    def common_prefix_search(self, s: bytes) -> Iterator[Tuple[int, int]]:
        return self.trie.common_prefix_search(s)
