"""The windows' arithmetic, with fake entries in place of the program."""

import time

import torch

from gpubench import harness, inputs

CPU = torch.device("cpu")


def _run_cell():
    return harness.load_module(harness.HERE / "run.py", "gprun").run_cell


def _entry(monkeypatch, name, **patches):
    mod = harness.entry(name)
    for k, v in patches.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(harness, "entry", lambda n: mod)
    return mod


def test_stage_loop_window(monkeypatch, small_cell):
    calls = []

    def stage_run(cls, config, data, seed, spans=None, sync=None):
        calls.append(time.perf_counter())
        time.sleep(0.2)
        return [("output", [], None)]

    _entry(monkeypatch, "prune",
           build=lambda c, t, s: {"files": [b"x"], "vocab": [], "target": 1},
           scored=lambda v: [], pruner_class=lambda: None,
           stage_run=stage_run)
    monkeypatch.setattr("gpubench.compare.prune", lambda *a: {
        "estep_l1": 0.0, "estep_len_l1": 0.0, "freq_l1": 0.0, "alternatives_wrong": 0,
        "vocab_wrong": 0, "hits": None})
    r = _run_cell()(small_cell("exact-32k", "prune-last"), 1, 0.5, False, CPU,
                    start=time.perf_counter())
    # The warm-up, then runs begun at 0, 0.2 and 0.4 s of a 0.5 s window:
    # 3 runs, and the window closes at the third's end.
    assert len(calls) == 4 and r["attempted"] == 3 and r["failed"] == 0
    assert abs(r["metrics"]["train_stage_s"]["value"] - 0.2) < 0.03
    assert r["metrics"]["setup_s"]["value"] >= 0.2
    assert r["correct"]


def test_request_loop_window(monkeypatch, small_cell):
    files = [b"ab" * (k + 1) for k in range(10)]

    class Tok:
        def encode_batch(self, texts, dropout=0.0, backend="device",
                         timer=None):
            time.sleep(0.1)
            return [[0] * len(t) for t in texts]

    mod = _entry(monkeypatch, "encode",
                 build=lambda c, t, s: {
                     "files": files, "vocab": [(b"ab", -1.0, False)],
                     "texts": [f.decode() for f in files]},
                 tokenizer=lambda c, v, d: Tok())
    monkeypatch.setattr("gpubench.compare.encode",
                        lambda *a: {"ids_wrong": 0, "score_gap": 0.0})
    cell = small_cell("exact-32k", "encode-files")
    cell["traffic"]["request_files"] = 4
    ctx = {"config": cell["config"], "traffic": cell["traffic"], "seed": 1,
           "seconds": 0.35, "trace": False, "device": CPU,
           "sync": lambda: None, "setup_done": lambda: None,
           "window_closed": lambda: None, "log": lambda msg: None}
    out = mod.run(ctx)
    # Requests begun at 0, 0.1, 0.2 and 0.3 s: 4 of 4 files, wrapping the
    # pool of 10 files, in about 0.4 s.
    assert out["attempted"] == 4 and out["failed"] == 0
    nbytes = sum(len(files[i % 10]) for i in range(16))
    mbps = out["end_to_end"]["encode_MBps"]
    assert abs(mbps - nbytes / 0.4 / 1e6) / mbps < 0.1
    assert abs(out["end_to_end"]["encode_p95_ms"] - 100) < 15


def test_subseeds_differ_and_repeat():
    s = 2**31 + 12345
    got = [inputs.subseed(s, k) for k in range(5)]
    assert len(set(got)) == 5
    assert got == [inputs.subseed(s, k) for k in range(5)]
