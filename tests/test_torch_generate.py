"""The port's generate stage against the JAX package's, on the CPU.

The same samples go through both packages: the device DFA walk, the
candidate mask and its bit-pack (the JAX package's XLA programs, run on
the CPU), the feed's counts and the generated vocabulary. The candidate
mask's plain PyTorch version stands in for csrc/dfa_mask.cu here (the
kernel is held against it on the card, tests/test_torch_cuda.py).

The insert coins differ by design: the JAX package draws them with
`jax.random.uniform`, the port with a counter-based hash of (seed,
sample, pos, len). At p = 1 every candidate is kept and the two agree
exactly; at p < 1 the port is held to the coin's distribution.
"""

import math
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokengeex_tpu.core.redfa import compile_dfa as jcompile_dfa
from tokengeex_tpu.ops import dfa_device as jdd
from tokengeex_tpu.train import generate as jgenerate
from tokengeex_tpu.utils import nativelib

from tokengeex_tpu_torch.core.redfa import compile_dfa
from tokengeex_tpu_torch.ops import dfa_device as dd
from tokengeex_tpu_torch.train import generate
from tokengeex_tpu_torch.train.patterns import (PATTERNS, build_allow_regex,
                                                load_patterns)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TEXTS = ["ababab", "abc de 12", " xyz", "héllo wörld", "mixed 中文 ascii",
         "", "a", "abc de 12", "😀 emoji 😀x", "tab\tand\nnew line  end "]
ALLOWS = [r"^ ?[a-z]+$", r"^(?: ?[a-z]+)$|^(?:.)$", None]


def _rows(samples, W=None):
    W = W or max(1, max(len(s) for s in samples))
    arr = np.zeros((len(samples), W), dtype=np.uint8)
    lens = np.zeros(len(samples), dtype=np.int32)
    for i, s in enumerate(samples):
        arr[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    return arr, lens


def _dfas(allow):
    if allow is None:
        return None, None
    return jcompile_dfa(allow), compile_dfa(allow)


def _texts(seed, n=40):
    """Seeded samples over ASCII words, punctuation and multi-byte chars,
    with repeats, empty samples and one-byte samples."""
    rng = np.random.default_rng(seed)
    pieces = ["ab", "abc", " de", "12", "é", "中文", "😀", " ", "x", "ww",
              "ab ab", "\n", "q"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 12))
        out.append("".join(pieces[int(i)]
                           for i in rng.integers(0, len(pieces), k)))
    return out + ["", "a", "ababababab"]


def test_match_lengths_matches_jax():
    samples = [t.encode() for t in TEXTS]
    arr, _ = _rows(samples)
    for allow in ALLOWS[:2]:
        jdfa, dfa = _dfas(allow)
        # L > W: the longest sample is shorter than the walk.
        for L in (5, arr.shape[1] + 3):
            want = np.asarray(jdd.match_lengths_device(
                jdd.DeviceDFA.from_byte_dfa(jdfa), jnp.asarray(arr), L))
            got = dd.match_lengths(dd.DeviceDFA.from_byte_dfa(dfa, CPU),
                                   torch.from_numpy(arr), L)
            assert got.dtype == torch.bool and got.shape == want.shape
            assert np.array_equal(got.numpy(), want), (allow, L)


@pytest.mark.parametrize("allow", ALLOWS)
@pytest.mark.parametrize("L", [4, 8, 24])
def test_candidate_mask_and_pack_match_jax(allow, L):
    samples = [t.encode() for t in TEXTS + _texts(1)]
    arr, lens = _rows(samples, 64)
    jdfa, dfa = _dfas(allow)
    jd = jdd.DeviceDFA.from_byte_dfa(jdfa) if jdfa is not None else None
    pd = dd.DeviceDFA.from_byte_dfa(dfa, CPU) if dfa is not None else None
    want = np.asarray(jdd.candidate_mask_device(
        jd, jnp.asarray(arr), jnp.asarray(lens), L, 1.0, 0))
    args = (pd, torch.from_numpy(arr), torch.from_numpy(lens), L)
    got = dd.candidate_mask(*args, 1.0, 7)
    assert np.array_equal(got.numpy(), want)
    assert want.any()
    # The bit-pack: the JAX package's jitted mask program at p = 1.
    fn = jdd._packed_mask_fn(L, 1.0, 64, jd is not None)
    if jd is None:
        nf, ac, start, S = (jnp.zeros((256,), jnp.int32),
                            jnp.zeros((1,), bool), 0, 1)
    else:
        nf, ac, start, S = jd.next_flat, jd.accept, jd.start, jd.num_states
    want_packed = np.asarray(fn(nf, ac, jnp.asarray(arr), jnp.asarray(lens),
                                start, S, jnp.uint32(0)))
    packed = dd.packed_candidate_mask(*args, 1.0, 7)
    assert packed.dtype == torch.uint8 and packed.shape == (len(samples), L, 8)
    assert np.array_equal(packed.numpy(), want_packed)
    assert not dd.packed_candidate_mask(*args, 0.0, 7).any()


def test_coin_keeps_its_bit_contract():
    """The coin in uint32 Python arithmetic, as csrc/dfa_mask.cu computes
    it: wrapping products and logical shifts."""
    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    rng = np.random.default_rng(3)
    for seed in (0, 1, 2**31 - 2, int(rng.integers(0, 2**31))):
        s = rng.integers(0, 2**31, 64)
        p = rng.integers(0, 2**20, 64)
        ln = rng.integers(1, 65, 64)
        got = dd.coin_u32(seed, torch.from_numpy(s), torch.from_numpy(p),
                          torch.from_numpy(ln)).tolist()
        k0 = mix((seed & 0xFFFFFFFF) ^ 0x9E3779B9)
        assert dd.seed_key(seed) == k0
        want = [mix(mix(mix(k0 ^ int(a)) ^ int(b)) ^ int(c))
                for a, b, c in zip(s, p, ln)]
        assert got == want
    assert dd.coin_threshold(1.0) == dd.coin_threshold(2.0) == 1 << 32
    assert dd.coin_threshold(0.5) == 1 << 31
    assert dd.coin_threshold(0.0) == 0


def test_coin_share_matches_p():
    n = 1 << 20
    idx = torch.arange(n)
    coin = dd.coin_u32(11, idx // 4096, idx % 4096, (idx % 16) + 1)
    for p in (0.01, 0.3):
        share = float((coin < dd.coin_threshold(p)).double().mean())
        sigma = math.sqrt(p * (1 - p) / n)
        assert abs(share - p) < 5 * sigma, (p, share)


def test_group_shape_follows_jax():
    # W8 = max(512, pow2 >= longest sample); rows rounded down to a power
    # of two from group_bytes, capped at pow2 >= the sample count.
    assert dd.group_shape([b"a"] * 3, 1 << 23) == (512, 4)
    assert dd.group_shape([b"x" * 600] * 5000, 1 << 23) == (1024, 8192)
    assert dd.group_shape([b"x" * (1 << 20)] * 20, 1 << 23) == (1 << 20, 8)
    assert dd.group_shape([b"x" * 700] * 5000, 3 << 20) == (1024, 2048)
    assert dd.group_shape([], 1 << 23) == (512, 1)


def _host_sets(texts, allow, L):
    g = generate.VocabularyGenerator(max_token_length=L, insert_probability=1.0,
                                     allow=allow, seed=0, device="cpu")
    out = []
    for t in texts:
        s: set = set()
        g._feed_part(t, s)
        out.append(s)
    return out


@pytest.mark.parametrize("allow", ALLOWS)
def test_feed_counts_match_jax_and_host_sets(allow, monkeypatch):
    texts = TEXTS + _texts(2)
    samples = [t.encode() for t in texts]
    jdfa, dfa = _dfas(allow)
    L = 6
    got = dd.feed_counts(dfa, samples, L, 1.0, seed=5, device="cpu")
    sets = _host_sets(texts, allow, L)
    want = Counter()
    for s in sets:
        want.update(s)
    assert got == want and got["ab"] >= 1
    assert got["ab"] == sum("ab" in s for s in sets)  # once per sample
    # The JAX package's set drain and its candidate sets.
    monkeypatch.setattr(nativelib, "get_lib", lambda: None)
    assert got == jdd.feed_counts_device(jdfa, samples, L, 1.0, seed=0)
    jsets = jdd.feed_candidates_device(jdfa, samples, L, 1.0, seed=0)
    assert dd.feed_candidates(dfa, samples, L, 1.0, seed=5,
                              device="cpu") == jsets


def test_feed_counts_keys_are_exact():
    """Keys that differ only past a word boundary, in a NUL byte, or in
    the length (trailing NULs) stay apart; multi-byte chars cross the
    8-byte words."""
    texts = ["abcdefgh1", "abcdefgh2", "a\x00", "a\x00\x00", "a",
             "ééééé", "éééé", "中文中文中文"]
    samples = [t.encode() for t in texts]
    got = dd.feed_counts(None, samples, 16, 1.0, seed=0, device="cpu")
    want = Counter()
    for s in _host_sets(texts, None, 16):
        want.update(s)
    assert got == want
    assert got["a"] == 5 and got["a\x00"] == 2 and got["a\x00\x00"] == 1


def test_feed_counts_drain_in_chunks_and_empty(monkeypatch):
    texts = _texts(8, n=60)
    samples = [t.encode() for t in texts]
    dfa = compile_dfa(ALLOWS[1])
    want = dd.feed_counts(dfa, samples, 8, 1.0, seed=0, device="cpu")
    monkeypatch.setattr(dd, "DRAIN_BYTES", 5)  # many chunks a group
    assert dd.feed_counts(dfa, samples, 8, 1.0, seed=0, device="cpu") == want
    assert dd.feed_counts(dfa, samples, 8, 0.0, seed=0, device="cpu") == {}
    assert dd.feed_counts(dfa, [], 8, 1.0, seed=0, device="cpu") == {}
    assert dd.feed_counts(dfa, [b""], 8, 1.0, seed=0, device="cpu") == {}


def test_decode_keys_round_trip():
    words = ["a", "ab\x00", "é中😀", "x" * 16, "\x7f\x80é", "😀" * 4]
    nw = 2
    keys = np.zeros((len(words), nw + 1), dtype=np.int64)
    for i, w in enumerate(words):
        raw = w.encode().ljust(8 * nw, b"\x00")
        keys[i, :nw] = np.frombuffer(raw, dtype="<i8")
        keys[i, nw] = len(w.encode())
    assert dd.decode_keys(keys) == words
    assert dd.decode_keys(keys[:0]) == []


def test_counts_do_not_depend_on_grouping():
    texts = _texts(4, n=300)
    samples = [t.encode() for t in texts]
    dfa = compile_dfa(ALLOWS[1])
    runs = [dd.feed_counts(dfa, samples, 8, 0.3, seed=9, group_bytes=gb,
                           device="cpu")
            for gb in (1 << 23, 1 << 15, 4096, 512)]
    assert sum(runs[0].values()) > 0
    assert all(r == runs[0] for r in runs[1:])


@pytest.mark.parametrize("p", [0.05, 0.3])
def test_feed_counts_in_distribution(p):
    """At p < 1 a (sample, candidate) with k passing occurrences counts
    with probability 1 - (1 - p)^k: the total is within 5 sigma of the
    sum of those, summed over independent coins."""
    texts = _texts(6, n=400)
    samples = [t.encode() for t in texts]
    dfa = compile_dfa(ALLOWS[1])
    L = 6
    arr, lens = _rows(samples)
    full = dd.candidate_mask(dd.DeviceDFA.from_byte_dfa(dfa, CPU),
                             torch.from_numpy(arr), torch.from_numpy(lens),
                             L, 1.0, 0).numpy()
    mean = var = 0.0
    for b, s in enumerate(samples):
        occ = Counter(s[pp : pp + l + 1] for l, pp in zip(*np.nonzero(full[b])))
        for k in occ.values():
            q = 1 - (1 - p) ** k
            mean += q
            var += q * (1 - q)
    total = sum(dd.feed_counts(dfa, samples, L, p, seed=21,
                               device="cpu").values())
    assert abs(total - mean) < 5 * math.sqrt(var), (total, mean, var)


GEN_KW = dict(max_token_length=6, insert_probability=1.0,
              added_tokens=["<|eos|>", "ab"], suggested_tokens=["de", "xyz"])


@pytest.mark.parametrize("allow", ALLOWS)
@pytest.mark.parametrize("split", [None, r"\s+|\S+"])
def test_generator_matches_jax(allow, split, monkeypatch):
    # The JAX generator's pure-Python route (no native library).
    monkeypatch.setattr(nativelib, "get_lib", lambda: None)
    texts = TEXTS + _texts(7) + ["x <|eos|> ab ab"]
    want = jgenerate.VocabularyGenerator(allow=allow, split=split, seed=0,
                                         **GEN_KW)
    got = generate.VocabularyGenerator(allow=allow, split=split, seed=0,
                                       device="cpu", **GEN_KW)
    for half in (texts[: len(texts) // 2], texts[len(texts) // 2 :]):
        want.feed(half)
        got.feed(half)
    assert got.frequencies == want.frequencies
    assert got.current_size() == want.current_size()
    for size in (300, 270):
        w = want.generate(size)
        g = got.generate(size)
        assert [(t.value, t.score, t.keep) for t in g] == \
            [(t.value, t.score, t.keep) for t in w]


def test_generator_feeds_through_the_mask(monkeypatch):
    calls = []
    real = dd.feed_counts

    def spy(*a, **k):
        calls.append(k["device"])
        return real(*a, **k)

    monkeypatch.setattr(dd, "feed_counts", spy)
    g = generate.VocabularyGenerator(max_token_length=4, device="cpu")
    g.feed(["abc", "def"])
    assert calls == [CPU]


def test_all_named_patterns_compile_to_one_dfa():
    dfa = compile_dfa(build_allow_regex(load_patterns([p[0] for p in
                                                       PATTERNS])))
    ddfa = dd.DeviceDFA.from_byte_dfa(dfa, CPU)
    # 245 states in 68 byte classes: a uint8 class table of 16,660 bytes.
    assert (ddfa.num_states, ddfa.num_classes, ddfa.entry_bytes) == \
        (245, 68, 1)
    assert ddfa.table.numel() * ddfa.entry_bytes == 16660
    # Several blocks of the shared route fit an SM.
    assert dd.shared_table_bytes(ddfa) < dd.SMEM_LIMIT // 4
    assert dd.pick_route(ddfa) == "shared"
    assert dd.pick_route(None) is None
    # 600 states whose 256 byte columns all differ: 307,200 bytes of
    # uint16 entries do not fit a block.
    big = _random_dfa(type(dfa), 600, 256, seed=4)
    dbig = dd.DeviceDFA.from_byte_dfa(big, CPU)
    assert dbig.num_classes == 256 and dbig.entry_bytes == 2
    assert dd.pick_route(dbig) == "global"


def _random_dfa(cls, states, groups, seed):
    """A ByteDFA of `states` states over `groups` random byte groups (the
    bytes of a group share their columns), state 0 dead, a third of the
    other transitions into it."""
    rng = np.random.default_rng(seed)
    group = rng.permutation(np.arange(256) % groups)
    cols = rng.integers(1, states, (states, groups))
    cols[rng.random((states, groups)) < 0.3] = 0
    cols[0] = 0
    accept = rng.random(states) < 0.4
    accept[0] = False
    return cls(np.ascontiguousarray(cols[:, group]).astype(np.int32),
               accept, 1)


def _class_table_dfas():
    """(name, ByteDFA) of both packages: the named patterns' allow DFA,
    the merge allow regex's, and a random DFA of 300 states (uint16
    entries)."""
    from tokengeex_tpu.core.redfa import ByteDFA as JByteDFA
    from tokengeex_tpu_torch.core.redfa import ByteDFA

    allow = build_allow_regex(load_patterns([p[0] for p in PATTERNS]))
    merge = r"^(?: ?[A-Za-z_][A-Za-z0-9_]*|[[:punct:]]+)$"
    big = _random_dfa(ByteDFA, 300, 40, seed=9)
    return {"named_patterns": (jcompile_dfa(allow), compile_dfa(allow)),
            "merge_allow": (jcompile_dfa(merge), compile_dfa(merge)),
            "random_300": (JByteDFA(big.next, big.accept, big.start), big)}


@pytest.mark.parametrize("name", ["named_patterns", "merge_allow",
                                  "random_300"])
def test_class_table_agrees_with_the_full_table(name):
    _, dfa = _class_table_dfas()[name]
    ddfa = dd.DeviceDFA.from_byte_dfa(dfa, CPU)
    S = dfa.next.shape[0]
    assert ddfa.num_states == S and ddfa.entry_bytes == (1 if S <= 256
                                                         else 2)
    assert ddfa.num_classes == len({tuple(c) for c in dfa.next.T})
    tab = ddfa.next_states()
    got = tab[:, ddfa.byte_class.to(torch.int64)]  # (S, 256)
    assert np.array_equal(got.numpy(), dfa.next)


@pytest.mark.parametrize("name", ["named_patterns", "merge_allow",
                                  "random_300"])
def test_class_table_twin_matches_jax(name):
    """The twin walks the class table; the JAX package's XLA program the
    full table: the same mask at p = 1."""
    jdfa, dfa = _class_table_dfas()[name]
    samples = [t.encode() for t in TEXTS + _texts(11, 60)]
    samples += [b"def f(x):\n    return x + 1", b"  value_1 = 0x1F;"]
    arr, lens = _rows(samples, 64)
    L = 16
    want = np.asarray(jdd.candidate_mask_device(
        jdd.DeviceDFA.from_byte_dfa(jdfa), jnp.asarray(arr),
        jnp.asarray(lens), L, 1.0, 0))
    got = dd.candidate_mask(dd.DeviceDFA.from_byte_dfa(dfa, CPU),
                            torch.from_numpy(arr), torch.from_numpy(lens),
                            L, 1.0, 5)
    assert np.array_equal(got.numpy(), want)
    assert want.any()


def test_device_dfa_is_uploaded_once():
    dfa = compile_dfa(ALLOWS[0])
    assert dd._device_dfa_for(dfa, "cpu") is dd._device_dfa_for(dfa, CPU)


def test_allreduce_frequencies_is_not_ported(tmp_path):
    """allreduce_frequencies, refused until multi-GPU was ported, is a
    no-op at world size 1, with or without a process group of one rank
    (tests/test_torch_multigpu.py sums two ranks' shards)."""
    from tokengeex_tpu_torch.parallel import mesh

    g = generate.VocabularyGenerator(max_token_length=4,
                                     insert_probability=1.0,
                                     added_tokens=["absent"], device="cpu")
    g.feed(["abc abd", "abd"])
    want = dict(g.frequencies)
    assert want["absent"] == 1 and want["ab"] == 2
    g.allreduce_frequencies()
    assert dict(g.frequencies) == want
    mesh.distributed_initialize("cpu", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0, timeout=60)
    try:
        g.allreduce_frequencies()
    finally:
        mesh.shutdown()
    assert dict(g.frequencies) == want


def test_generator_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = generate.VocabularyGenerator(max_token_length=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.feed(["abc"])


def test_mask_wrapper_checks_its_inputs():
    arr = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 32"):
        dd.packed_candidate_mask(None, arr[:, :40], lens, 4, 1.0, 0)
    with pytest.raises(ValueError, match="max_len"):
        dd.packed_candidate_mask(None, arr, lens, 65, 1.0, 0)
    with pytest.raises(ValueError, match="uint8"):
        dd.packed_candidate_mask(None, arr.int(), lens, 4, 1.0, 0)
