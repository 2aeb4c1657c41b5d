"""The comparison that decides `correct`: the control (the reference in
bfloat16 in the program's place) is refused, and so is a run of the
program with the timed path broken underneath, at sizes a test run
holds. The runs skip the look for a chip and drive the program on the
CPU."""

import time

import numpy as np
import pytest
import torch

from gpubench import harness

CPU = torch.device("cpu")


def _run(cell):
    run_cell = harness.load_module(harness.HERE / "run.py", "gprun").run_cell
    return run_cell(cell, 2**32 + 77, 0.1, False, CPU,
                    start=time.perf_counter())


def _control():
    return harness.load_module(harness.HERE / "control.py", "gpcontrol")


def _refused(values, limits):
    return any(values[k] is not None and values[k] > limits[k]
               for k in limits)


@pytest.mark.parametrize("cell,fn", [
    (("exact-32k", "encode-files"), "encode_control"),
    (("exact-32k", "prune-last"), "prune_control")])
def test_control_is_refused(small_cell, cell, fn):
    files = small_cell(*cell)
    limits = files["traffic"]["limits"]
    f = getattr(_control(), fn)
    assert not _refused(f(files, 5, CPU, torch.float64), limits)
    assert _refused(f(files, 5, CPU, torch.bfloat16), limits)


def test_sound_runs_pass(small_cell):
    for cell in (("exact-32k", "encode-files"), ("exact-32k", "prune-last")):
        r = _run(small_cell(*cell))
        assert r["correct"], r["checks"]


def _altered(fn):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        return [[(ids[0] + 1) % 256] + ids[1:] if ids else ids
                for ids in out]
    return wrapped


def _half(fn):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        return [ids if i % 2 == 0 else [] for i, ids in enumerate(out)]
    return wrapped


@pytest.mark.parametrize("fault", [_altered, _half])
def test_encode_faults_are_refused(monkeypatch, small_cell, fault):
    from tokengeex_tpu_torch.train import estep_device

    monkeypatch.setattr(estep_device, "encode_corpus_device",
                        fault(estep_device.encode_corpus_device))
    r = _run(small_cell("exact-32k", "encode-files"))
    assert not r["correct"] and r["checks"]["ids_wrong"][0] > 0


def test_prune_state_unchanged_is_refused(monkeypatch, small_cell):
    from tokengeex_tpu_torch.train.prune import VocabularyPruner

    monkeypatch.setattr(VocabularyPruner, "prune_vocab",
                        lambda self, model, samples: list(model.vocab))
    r = _run(small_cell("exact-32k", "prune-last"))
    assert not r["correct"] and r["checks"]["vocab_wrong"][0] > 0


def test_prune_half_the_batch_is_refused(monkeypatch, small_cell):
    from tokengeex_tpu_torch.train import device_session

    S = device_session.DeviceTrainSession
    init, e_step, freq = S.__init__, S.e_step, S.count_frequencies

    def half_init(self, model, samples, *a, **kw):
        init(self, model, samples[: len(samples) // 2], *a, **kw)

    monkeypatch.setattr(S, "__init__", half_init)
    monkeypatch.setattr(S, "e_step", lambda self, *a, **kw:
                        2.0 * e_step(self, *a, **kw))
    monkeypatch.setattr(S, "count_frequencies", lambda self, *a, **kw:
                        2 * freq(self, *a, **kw))
    r = _run(small_cell("exact-32k", "prune-last"))
    assert not r["correct"]
    assert r["checks"]["freq_l1"][0] > r["checks"]["freq_l1"][1]


def test_prune_estep_without_dropout_is_refused(monkeypatch, small_cell):
    """An E-step that drops the configuration's dropout moves the counts'
    split over token lengths by percents, far past the coins' noise."""
    from tokengeex_tpu_torch.train import device_session

    S = device_session.DeviceTrainSession
    e_step = S.e_step
    monkeypatch.setattr(S, "e_step", lambda self, model, dropout, seed, *a,
                        **kw: e_step(self, model, 0.0, seed, *a, **kw))
    r = _run(small_cell("exact-32k", "prune-last"))
    assert not r["correct"]
    assert r["checks"]["estep_len_l1"][0] > r["checks"]["estep_len_l1"][1]


def test_prune_altered_alternative_is_refused(monkeypatch, small_cell):
    from tokengeex_tpu_torch.train import prune

    real = prune.prune_alternatives_device

    def altered(*a, **kw):
        keep, alts = real(*a, **kw)
        i = next(i for i, alt in enumerate(alts) if len(alt) > 1)
        alts[i] = alts[i][::-1] if alts[i] != alts[i][::-1] else alts[i][:1]
        return keep, alts

    monkeypatch.setattr(prune, "prune_alternatives_device", altered)
    r = _run(small_cell("exact-32k", "prune-last"))
    assert not r["correct"] and r["checks"]["alternatives_wrong"][0] > 0
