"""The merge entry's check (entries/merge.py `check`) on a run the
reference itself makes, with planted faults, and the eight *.merge
readers from fake records and contexts."""

import random
import time

import numpy as np
import pytest
import torch

from gpubench import harness, pairs_work
from gpubench.reference import merge as rm

CPU = torch.device("cpu")
FINE = ["any-char", "space-lowercase-word", "space-uppercase-word",
        "english-contraction", "indent", "space-punct-space"]
CONFIG = {"num_merges": 6, "allow": FINE,
          "merge": {"step": 3, "max_token_length": 20, "scale_factor": 0.9}}
TRAFFIC = {"top_pairs": 10}


class _Tok:
    def __init__(self, value, score, keep):
        self.value, self.score, self.keep = value, score, keep


class _Model:
    def __init__(self, vocab):
        self.vocab = [_Tok(*t) for t in vocab]


def _run():
    """Files, a start vocabulary and a run the reference makes: its passes
    (size, keys, counts) and the merged vocabulary."""
    rng = random.Random(3)
    words = ["value", "return", "data", "self", "in", "for"]
    files = [" ".join(rng.choice(words) for _ in range(rng.randint(3, 30))
                      ).encode() for _ in range(30)]
    start = [(bytes([b]), rng.uniform(-12, -10), True)
             for b in sorted(set(b"".join(files)))]
    start += [(w, rng.uniform(-9, -5), False)
              for w in (b"va", b"lue", b"re", b"turn", b" d", b"ata", b"se")]
    cur, passes = [t[:2] for t in start], []
    refused, allow = set(), rm.allow_fn(FINE)
    while len(cur) < len(start) + CONFIG["num_merges"]:
        r = rm.pair_counts([cur], files, CPU)[0]
        passes.append((len(cur), r["keys"], r["counts"]))
        new = rm.select(cur, r["keys"], r["counts"], 3, 20, 0.9, allow,
                        refused)
        cur = cur + new
    out = start + [(v, s, False) for v, s in cur[len(start):]]
    return files, start, passes, out


@pytest.fixture(scope="module")
def run():
    return _run()


def _check(files, start, passes, out):
    return harness.entry("merge").check(CONFIG, TRAFFIC, start, files,
                                        passes, _Model(out), CPU)


def test_check_reads_zero_on_the_references_own_run(run):
    files, start, passes, out = run
    assert len(passes) == 2
    values = _check(files, start, passes, out)
    assert values["pairs_l1"] == 0 and values["top_pairs_l1"] == 0
    assert values["merges_wrong"] == 0
    work = values["work"]
    assert len(work) == 2 and work[0]["short_spans"] == len(files)
    assert work[0]["short_tokens"] > work[0]["short_distinct"] > 0


def test_check_counts_planted_faults(run):
    files, start, passes, out = run
    n = len(start)
    # The last merged token's score off by more than 1e-9: one wrong.
    bad = list(out)
    v, s, k = bad[-1]
    bad[-1] = (v, s * (1 + 1e-7), k)
    assert _check(files, start, passes, bad)["merges_wrong"] == 1
    # Two merges of the first pass swapped: two wrong, and the second
    # pass's merges of their ids with them.
    bad = list(out)
    bad[n], bad[n + 1] = bad[n + 1], bad[n]
    assert _check(files, start, passes, bad)["merges_wrong"] >= 2
    # The last pass left undone: its three merges.
    assert _check(files, start, passes[:1], out[:n + 3])["merges_wrong"] == 3
    # Counts scaled: the l1 numbers read the scale.
    scaled = [(m, k, c + c // 10) for m, k, c in passes]
    values = _check(files, start, scaled, out)
    assert values["pairs_l1"] > 0.05 and values["top_pairs_l1"] > 0.05
    # No run at all.
    assert _check(files, start, [], [])["merges_wrong"] == 6


def test_pair_insert_work():
    t = pairs_work.pair_insert(1000, 10, 100)
    assert t == pytest.approx((4000 + 40 + 1600) / 3.35e12)


@pytest.fixture
def fresh_record():
    from tokengeex_tpu_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


SPAN_READERS = [("count_s.merge", "merge.count"),
                ("tables_s.merge", "merge.count.tables"),
                ("chained_s.merge", "merge.count.chained"),
                ("select_s.merge", "merge.select")]


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "merge_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,path", SPAN_READERS)
def test_span_readers(fresh_record, name, path):
    mod = _reader(name)
    ctx = {"runs": 2}
    assert mod.read(ctx) is None
    rec = fresh_record.reset()
    for _ in range(8):
        rec._add_span(path, 0.5, 0.0)
    assert mod.read(ctx) == pytest.approx(2.0)
    assert mod.read({"runs": 0}) is None


def test_redone_reader(fresh_record):
    mod = _reader("redone_pct.merge")
    ctx = {"runs": 2, "corpus_bytes": 1000}
    assert mod.read(ctx) is None  # a program without merge.count
    rec = fresh_record.reset()
    for _ in range(8):
        rec._add_span("merge.count", 0.5, 0.0)
    assert mod.read(ctx) == 0.0
    rec._add_count("merge.count.redo", "probe.redone_bytes", 40)
    rec._add_count("prune.frequencies.redo", "probe.redone_bytes", 999)
    assert mod.read(ctx) == pytest.approx(0.5)


def test_device_readers():
    kernels = {"void viterbi_scan_kernel<float, 32, 32, false>(float const*)":
               0.4, "void viterbi_scan_kernel<double, 32, 32, false>()": 9.0,
               "(anonymous namespace)::insert_ids_kernel(int const*, int)":
               0.02}
    ctx = {"runs": 2, "kernels": kernels, "busy_s": 3.0, "window_s": 50.0,
           "bound_s": {"viterbi_scan": 0.1, "pair_insert": 0.001}}
    assert _reader("viterbi_scan_roofline.merge").read(ctx) == \
        pytest.approx(25.0)
    assert _reader("pair_count_roofline.merge").read(ctx) == \
        pytest.approx(5.0)
    assert _reader("idle_pct.merge").read(ctx) == pytest.approx(94.0)
    for name in ("viterbi_scan_roofline.merge", "pair_count_roofline.merge",
                 "idle_pct.merge"):
        assert _reader(name).read({"runs": 0}) is None
    assert _reader("pair_count_roofline.merge").read(
        dict(ctx, kernels={})) is None
    assert np.isfinite(_reader("idle_pct.merge").read(ctx))


@pytest.mark.parametrize("raises,trace", [("warm-up", False),
                                          ("always", False),
                                          ("always", True)])
def test_a_program_that_raises_gives_a_whole_failed_line(
        monkeypatch, small_cell, raises, trace):
    """A stage run that raises, in the warm-up alone or in every run (as a
    program without the exact redo of false matches does on some seeds),
    is a failed run of a whole result, never a traceback."""
    mod = harness.entry("merge")
    calls = []

    def stage_run(config, data):
        calls.append(time.perf_counter())
        if raises == "always" or len(calls) == 1:
            raise KeyError("walk: a matched span is not a vocabulary token")
        time.sleep(0.1)
        return [], _Model(data["vocab"])

    monkeypatch.setattr(mod, "build", lambda c, t, s: {
        "files": [b"ab"], "vocab": [(b"a", -1.0, True), (b"b", -1.0, True)]})
    monkeypatch.setattr(mod, "allow_regex", lambda c: "")
    monkeypatch.setattr(mod, "stage_run", stage_run)
    monkeypatch.setattr(mod, "check", lambda *a: {
        "pairs_l1": 0.0, "top_pairs_l1": 0.0, "merges_wrong": 0})
    monkeypatch.setattr(harness, "entry", lambda n: mod)
    # The trace on the CPU: its window closes without a card to wait for,
    # and holds no device work.
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    run_cell = harness.load_module(harness.HERE / "run.py", "gprun").run_cell
    r = run_cell(small_cell("exact-32k-merged", "merge-first"), 2**31 + 9,
                 0.25, trace, CPU, start=time.perf_counter())
    assert not r["correct"]
    if raises == "always":
        assert r["failed"] == r["attempted"] == 2 and len(calls) == 2
        assert "train_stage_s" not in r["metrics"]
    else:
        assert r["failed"] == 1 and r["attempted"] == len(calls) >= 3
        assert r["metrics"]["train_stage_s"]["value"] > 0.05
