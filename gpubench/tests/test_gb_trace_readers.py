"""The readers of the program's spans and counters (metrics/*.train.py),
each from a fake record, and the encode entry's annotating PhaseTimer
through the program's encode_batch."""

import random

import pytest
import torch

from gpubench import harness

CPU = torch.device("cpu")

# (reader, spans {path: (calls, seconds, child seconds)}, counters
# {(path, name): n}, the reading for 2 runs of 10 s in all)
READERS = [
    ("session_tables_s.train", {"prune.session.tables": (2, 3.0, 0.0)},
     {}, 1.5),
    ("session_pack_s.train", {"prune.session.pack": (2, 1.0, 0.0)}, {}, 0.5),
    ("mstep_s.train", {"prune.m_step": (4, 0.8, 0.0)}, {}, 0.4),
    ("loss_s.train", {"prune.loss": (2, 0.6, 0.0)}, {}, 0.3),
    ("alternatives_pack_s.train", {"prune.alternatives.pack": (2, 1.2, 0.0)},
     {}, 0.6),
    ("alternatives_decide_s.train",
     {"prune.alternatives.decide": (2, 1.4, 0.0)}, {}, 0.7),
    ("freq_chained_s.train", {"prune.frequencies.chained": (2, 0.9, 0.2)},
     {}, 0.45),
    ("unspanned_s.train", {"prune": (2, 9.5, 8.5)}, {}, 0.75),
    ("slot_hit_pct.train", {}, {("prune.e_step", "groups.cached"): 3,
                                ("prune.e_step", "groups.probed"): 1,
                                ("prune.frequencies", "groups.probed"): 4},
     37.5),
    ("pad_pct.train", {}, {("prune.session.pack", "pack.positions"): 800,
                           ("prune.session.pack", "pack.bytes"): 700,
                           ("prune.alternatives.pack", "pack.positions"):
                           200, ("prune.alternatives.pack", "pack.bytes"):
                           100, ("", "pack.positions"): 1000}, 20.0),
    ("h2d_MB.train", {}, {("prune.session.tables", "h2d.bytes"): 3e6,
                          ("prune.e_step", "h2d.bytes"): 1e6,
                          ("", "h2d.bytes"): 5e6}, 2.0),
]


@pytest.fixture
def fresh_record():
    from tokengeex_tpu_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


@pytest.mark.parametrize("name,spans,counters,want", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_returns_its_number_from_a_fake_record(fresh_record, name,
                                                      spans, counters, want):
    trace = fresh_record
    mod = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                              "trace_reader_" + name.replace(".", "_"))
    ctx = {"runs": 2, "run_s": 10.0}
    assert mod.read(ctx) is None  # an empty record
    rec = trace.reset()
    for path, (calls, seconds, child) in spans.items():
        for _ in range(calls):
            rec._add_span(path, seconds / calls, child / calls)
    for (path, key), n in counters.items():
        rec._add_count(path, key, n)
    assert mod.read(ctx) == pytest.approx(want)
    assert mod.read({"phases": {}}) is None
    assert mod.read({"runs": 0, "run_s": 0.0}) is None


def test_encode_entry_timer_through_encode_batch(fresh_record):
    """The encode entry's PhaseTimer subclass gets the encode pass's
    phases, keyed flat, and wins over the program's ambient spans."""
    import tokengeex_tpu_torch as tg

    trace = fresh_record
    rng = random.Random(5)
    words = ["an", "er", "ti", "on", "ra", "lo", "de", "value", "return"]
    texts = [" ".join(rng.choice(words) for _ in range(rng.randint(2, 20)))
             for _ in range(12)]
    vocab = sorted({bytes([b]) for b in "".join(texts).encode()}) + \
        [w.encode() for w in words if len(w) > 1]
    model = tg.Model([tg.ScoredToken(v, -1.0 - 0.1 * i, len(v) == 1)
                      for i, v in enumerate(vocab)])
    tok = tg.Tokenizer(model, [], [], device="cpu")
    timer = harness.entry("encode").phase_timer(CPU)
    with trace.recording() as rec:
        ids = tok.encode_batch(texts, backend="device", timer=timer)
    assert ids == tok.encode_batch(texts, backend="oracle")
    assert {"tables", "pack", "prep", "split"} <= set(timer.seconds)
    assert all("." not in k for k in timer.seconds)
    assert set(rec.spans) == {"encode"}
