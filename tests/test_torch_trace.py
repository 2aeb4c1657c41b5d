"""The port's tracer (tokengeex_tpu_torch/utils/trace.py): phase() with and
without a PhaseTimer, the ambient spans a torch.profiler session or
`recording()` turns on, their paths, self times and profiler marks, and
the counters of the prune round."""

import contextlib
import random
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.ops import lattice as lat
from tokengeex_tpu_torch.ops.match_table import TokenTable
from tokengeex_tpu_torch.train import device_session as ds
from tokengeex_tpu_torch.train import estep_device as ed
from tokengeex_tpu_torch.train import prune
from tokengeex_tpu_torch.utils import trace

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
# The spans the benchmark's readers read (gpubench/metrics/*.train.py).
READ_PATHS = ("prune", "prune.session.tables", "prune.session.pack",
              "prune.m_step", "prune.loss", "prune.alternatives.pack",
              "prune.alternatives.decide", "prune.frequencies.chained")
PRUNE_CHILDREN = {"prune.session", "prune.e_step", "prune.m_step",
                  "prune.alternatives", "prune.frequencies", "prune.loss"}


@pytest.fixture(autouse=True)
def fresh_record():
    trace.reset()
    yield
    trace.reset()


def _corpus():
    """A small code-like corpus with two samples past the encode width
    the tests set (1,024 bytes), so that the frequency pass re-packs and
    chains, and a vocabulary of 120 tokens, the bytes kept."""
    rng = random.Random(5)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "value", "return"]
    samples = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 20))
                        ).encode() for _ in range(40)]
    samples += [" ".join(rng.choice(words) for _ in range(n)).encode()
                for n in (300, 420)]
    vocab = [(bytes([b]), rng.uniform(-11.0, -9.0))
             for b in sorted(set(b"".join(samples)))]
    seen = {v for v, _ in vocab}
    while len(vocab) < 120:
        s = rng.choice(samples)
        a = rng.randrange(len(s))
        w = s[a : a + rng.randint(2, 8)]
        if w not in seen:
            seen.add(w)
            vocab.append((w, rng.uniform(-9.0, -1.0)))
    return vocab, samples


def _prune(monkeypatch, rounds_target=76, em_subiters=1):
    """A two-round CPU prune (120 -> 96 -> 76 tokens) of the corpus."""
    monkeypatch.setattr(ed, "MAX_ENCODE_WIDTH", 1024)
    vocab, samples = _corpus()
    assert max(map(len, samples)) > 1024
    model = tg.Model([tg.ScoredToken(v, s, len(v) == 1) for v, s in vocab])
    pruner = prune.VocabularyPruner(rounds_target, shrink_factor=0.8,
                                    em_subiters=em_subiters, dropout=0.05,
                                    device="cpu")
    return pruner.prune(model, samples)


def test_spans_are_off_without_a_profiler(monkeypatch):
    """Off, a span is the shared null context: no profiler mark is made
    and nothing is recorded, through a whole prune."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler mark was entered while off")

    monkeypatch.setattr(trace, "_mark", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled and not trace.on()
    assert trace.phase(None, "x") is trace._OFF
    assert trace.span("x") is trace._OFF
    trace.count("n", 1)
    _prune(monkeypatch, rounds_target=96)
    assert trace.record().spans == {} and not trace.record().counters


def test_profiler_flag_follows_profile():
    """The tracer's gate is the profiler's own flag: set on entering
    torch.profiler.profile, cleared on leaving it."""
    assert not autograd_profiler._is_profiler_enabled and not trace.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled and trace.on()
        assert isinstance(trace.span("x"), trace._Span)
    assert not autograd_profiler._is_profiler_enabled and not trace.on()


def test_profiled_prune_records_the_read_paths_nested(monkeypatch):
    """Under the profiler a two-round prune records every path the
    benchmark reads; the `tgx.` marks on the profiler's clock nest as
    their paths say; self <= total; prune's children fit in prune."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        _prune(monkeypatch)
    rec = trace.record()
    assert rec.calls("prune.loss") == 2 and rec.calls("prune") == 1
    for path in READ_PATHS:
        assert rec.seconds(path) > 0, path
    for path in rec.spans:
        assert 0 <= rec.self_seconds(path) <= rec.seconds(path), path
    children = {p for p in rec.spans if p.count(".") == 1}
    assert PRUNE_CHILDREN <= children
    assert rec.child_seconds("prune") == pytest.approx(
        sum(rec.seconds(c) for c in children))
    assert rec.child_seconds("prune") <= rec.seconds("prune")

    marks = [(e.start_ns(), e.end_ns(), e.name()[4:])
             for e in p.profiler.kineto_results.events()
             if e.name().startswith("tgx.")]
    assert sorted({n for _, _, n in marks}) == sorted(rec.spans)
    assert len(marks) == sum(rec.calls(n) for n in rec.spans)
    for a, b, name in marks:
        if "." not in name:
            continue
        parent = name.rsplit(".", 1)[0]
        assert any(pa <= a and b <= pb for pa, pb, pn in marks
                   if pn == parent), name


def test_counters_equal_hand_counts(monkeypatch):
    """pack.positions / pack.bytes are the packings' rows x width and real
    bytes; an E-step's groups.cached / groups.probed count its groups
    (the second E-step of a round finds every group cached)."""
    packed = []

    def keep(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            packed.append(out)
            return out
        return wrapped

    monkeypatch.setattr(ds, "pack_samples", keep(ds.pack_samples))
    monkeypatch.setattr(ed, "pack_samples", keep(ed.pack_samples))
    monkeypatch.setattr(ed, "_pack_tokens", keep(ed._pack_tokens))
    per_step = []
    e_step = ds.DeviceTrainSession.e_step

    def counted(self, *args, **kwargs):
        rec = trace.record()
        before = [rec.counter(k) or 0 for k in ("groups.cached",
                                                 "groups.probed")]
        out = e_step(self, *args, **kwargs)
        after = [rec.counter(k) or 0 for k in ("groups.cached",
                                                "groups.probed")]
        per_step.append((after[0] - before[0], after[1] - before[1],
                         len(self._groups())))
        return out

    monkeypatch.setattr(ds.DeviceTrainSession, "e_step", counted)
    with trace.recording() as rec:
        _prune(monkeypatch, em_subiters=2)
    assert len(per_step) == 2 * rec.calls("prune.loss")
    groups = per_step[0][2]
    assert per_step[0] == (0, groups, groups)
    assert per_step[1] == (groups, 0, groups)
    assert all(c + p == g for c, p, g in per_step)
    assert packed
    assert rec.counter("pack.positions", "prune") == sum(
        b.rows * b.width for b in packed)
    assert rec.counter("pack.bytes", "prune") == sum(
        int((b.sample_id >= 0).sum()) for b in packed)
    cached = rec.counter("groups.cached", "prune.e_step")
    assert cached == sum(c for c, _, _ in per_step)


def test_upload_counts_each_copy():
    """h2d.copies / h2d.bytes: one a tensor made from host data, its
    bytes as uploaded."""
    vocab, _ = _corpus()
    tbl = TokenTable.build([tg.ScoredToken(v, s) for v, s in vocab])
    with trace.recording() as rec:
        dt = lat.DeviceTables.from_table(tbl, CPU)
    tensors = [dt.t1_fast, dt.t2_fast, dt.scores, dt.t_bucket,
               dt.t1_exact, dt.t2_exact]
    assert rec.counter("h2d.copies") == len(tensors)
    assert rec.counter("h2d.bytes") == sum(t.numel() * t.element_size()
                                           for t in tensors)
    # The walk index: spans, order, row_ptr, rows_l, last, nonempty.
    with trace.recording() as rec:
        lat.walk_index([(0, 0, 5, 0, 0), (1, 2, 9, 1, 0)], 2, 16, CPU)
    assert rec.counter("h2d.copies") == 6


def test_phase_timer_wins_and_keeps_flat_seconds():
    """An explicit PhaseTimer gets the phases, keyed flat, and the
    ambient record gets none of them, also while recording; a subclass
    that wraps `__call__` (as a benchmark's annotating timer does) still
    works through encode_batch."""
    vocab, samples = _corpus()
    model = tg.Model([tg.ScoredToken(v, s, len(v) == 1) for v, s in vocab])
    session = ds.DeviceTrainSession(model, samples, 1024, kernel="slab",
                                    device="cpu")
    timer = lat.PhaseTimer(CPU)
    with trace.recording() as rec:
        session.e_step(model, 0.05, 1, timer=timer)
    assert {"rebind", "prep", "probe", "forward", "fold"} <= set(
        timer.seconds)
    assert all("." not in k for k in timer.seconds)
    assert rec.spans == {}

    entered = []

    class Annotating(lat.PhaseTimer):
        @contextlib.contextmanager
        def __call__(self, name):
            entered.append(name)
            with torch.profiler.record_function("phase." + name), \
                    super().__call__(name):
                yield

    tok = tg.Tokenizer(model, [], [], device="cpu")
    sub_timer = Annotating(CPU)
    texts = [s.decode() for s in samples[:12]]
    with trace.recording() as rec:
        ids = tok.encode_batch(texts, backend="device", timer=sub_timer)
    assert ids == tok.encode_batch(texts, backend="oracle")
    assert {"tables", "pack", "prep", "split"} <= set(sub_timer.seconds)
    assert set(entered) == set(sub_timer.seconds)
    assert set(rec.spans) == {"encode"}


def test_span_paths_self_time_counters_and_threads():
    """Paths join the open spans' names; a span's child seconds are its
    direct children's; counters land under the innermost span; each
    thread has its own stack; `traced` wraps a call in a span."""
    @trace.traced("outer")
    def outer():
        with trace.span("a"):
            with trace.phase(None, "b"):
                trace.count("n", 2)
        with trace.span("a"):
            trace.count("n", 3)
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            trace.span("alone").__enter__().path))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        return seen

    with trace.recording() as rec:
        assert outer() == ["alone"]
    assert rec.calls("outer") == 1 and rec.calls("outer.a") == 2
    assert rec.calls("outer.a.b") == 1
    assert rec.child_seconds("outer") == pytest.approx(
        rec.seconds("outer.a"))
    assert rec.child_seconds("outer.a") == pytest.approx(
        rec.seconds("outer.a.b"))
    assert rec.counter("n", "outer.a") == 5
    assert rec.counter("n", "outer.a.b") == 2
    assert rec.counter("n", "outer.ab") is None
    assert not trace.on()


# What each of the benchmark's readers (gpubench/metrics/<name>.py) takes
# from the record: spans by path and counters by name.
READS = {
    "session_tables_s.train": (["prune.session.tables"], []),
    "session_pack_s.train": (["prune.session.pack"], []),
    "mstep_s.train": (["prune.m_step"], []),
    "loss_s.train": (["prune.loss"], []),
    "alternatives_pack_s.train": (["prune.alternatives.pack"], []),
    "alternatives_decide_s.train": (["prune.alternatives.decide"], []),
    "freq_chained_s.train": (["prune.frequencies.chained"], []),
    "unspanned_s.train": (["prune"], []),
    "slot_hit_pct.train": ([], ["groups.cached", "groups.probed"]),
    "pad_pct.train": ([], ["pack.positions", "pack.bytes"]),
    "h2d_MB.train": ([], ["h2d.copies", "h2d.bytes"]),
    "rebind_s.train": (["prune.e_step.rebind", "prune.alternatives.rebind"],
                       ["tables.bound", "tables.uploaded"]),
}


@pytest.fixture(scope="module")
def recorded_prune():
    """The record of one two-round CPU prune, two E-steps a round."""
    with pytest.MonkeyPatch.context() as mp, trace.recording() as rec:
        _prune(mp, em_subiters=2)
    return rec


@pytest.mark.parametrize("reader", sorted(READS))
def test_prune_records_what_each_reader_reads(recorded_prune, reader):
    """A prune round records, under `prune`, every span and counter that
    the reader takes, with the values its metric needs: seconds within
    the root's, counts positive, shares in [0, 100]."""
    rec = recorded_prune
    paths, counters = READS[reader]
    for path in paths:
        assert rec.calls(path) >= 1, path
        assert 0 < rec.seconds(path) <= rec.seconds("prune"), path
    for name in counters:
        assert rec.counter(name, "prune") > 0, name
        assert rec.counter(name) == rec.counter(name, "prune"), name
    if reader == "unspanned_s.train":
        assert 0 <= rec.child_seconds("prune") <= rec.seconds("prune")
    elif reader == "slot_hit_pct.train":
        cached = rec.counter("groups.cached", "prune")
        assert 0 < cached < cached + rec.counter("groups.probed", "prune")
    elif reader == "pad_pct.train":
        assert rec.counter("pack.bytes") <= rec.counter("pack.positions")
    elif reader == "h2d_MB.train":
        assert rec.counter("h2d.bytes") >= rec.counter("h2d.copies")


def test_port_imports_without_the_profilers_fast_event():
    """On a torch without `_RecordFunctionFast` the package imports and
    a span under the profiler records, with no mark on its clock."""
    code = textwrap.dedent("""
        import torch
        del torch._C._profiler._RecordFunctionFast
        import tokengeex_tpu_torch
        from tokengeex_tpu_torch.utils import trace
        assert trace._mark is None
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with trace.span("a"):
                trace.count("n", 1)
        assert trace.record().calls("a") == 1
        assert trace.record().counter("n") == 1
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_off_path_is_one_gate():
    """Off, phase() with no timer hands back the shared null context,
    traced() calls straight through and count() keeps nothing."""
    assert not trace.on()
    assert all(trace.phase(None, f"p{k}") is trace._OFF for k in range(3))
    assert trace.traced("x")(lambda a, b=1: a + b)(2, b=3) == 5
    trace.count("n", 1)
    assert trace.record().spans == {} and not trace.record().counters


def test_binding_counters_equal_hand_counts(monkeypatch):
    """tables.uploaded counts the whole uploads and tables.bound the
    bindings on the resident layout. A two-round prune, two E-steps a
    round, uploads one table, the session's, and binds five models: each
    round's second E-step after an M-step, each round's alternatives
    after the second (the frequency pass shares that binding), and round
    two's first E-step, on the pruned vocabulary. The alternatives bind
    under their own span."""
    made = {"uploaded": 0, "bound": 0}

    def tally(key, fn):
        def wrapped(*args, **kwargs):
            made[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(lat.DeviceTables, "from_table", staticmethod(
        tally("uploaded", lat.DeviceTables.from_table)))
    monkeypatch.setattr(lat.ResidentLayout, "bind",
                        tally("bound", lat.ResidentLayout.bind))
    with trace.recording() as rec:
        _prune(monkeypatch, rounds_target=60, em_subiters=2)
    assert rec.calls("prune.loss") == 2
    assert made == {"uploaded": 1, "bound": 5}
    assert rec.counter("tables.uploaded") == 1
    assert rec.counter("tables.uploaded", "prune.session.tables") == 1
    assert rec.counter("tables.bound") == 5
    assert rec.counter("tables.bound", "prune.e_step.rebind") == 3
    assert rec.counter("tables.bound", "prune.alternatives.rebind") == 2
    assert rec.calls("prune.alternatives.rebind") == 2
    assert rec.counter("tables.bound", "prune.frequencies") is None
