"""The reader of the session's bindings (metrics/rebind_s.train.py), from a
fake record."""

import pytest

from gpubench import harness


@pytest.fixture
def fresh_record():
    from tokengeex_tpu_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


def test_rebind_reader_sums_every_rebind_span_under_prune(fresh_record):
    trace = fresh_record
    mod = harness.load_module(harness.HERE / "metrics" / "rebind_s.train.py",
                              "trace_reader_rebind_s_train")
    ctx = {"runs": 2, "run_s": 10.0}
    assert mod.read(ctx) is None  # an empty record
    rec = trace.reset()
    for path, seconds in [("prune.e_step.rebind", 0.5),
                          ("prune.e_step.rebind", 0.25),
                          ("prune.alternatives.rebind", 0.5),
                          ("prune.frequencies.rebind", 0.125),
                          # Neither a rebind span nor under prune.
                          ("prune.e_step.prep", 4.0), ("encode.rebind", 8.0),
                          ("prune.rebinding", 16.0)]:
        rec._add_span(path, seconds, 0.0)
    assert mod.read(ctx) == pytest.approx(0.6875)
    assert mod.read({"phases": {}}) is None
    assert mod.read({"runs": 0, "run_s": 0.0}) is None
