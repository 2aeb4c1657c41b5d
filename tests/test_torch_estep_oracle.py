"""How far the f32 E-step's total count lies from the f64 oracle.

chip_smoke.py holds the card's E-step total on its configuration (b), a
4,096-token vocabulary over its seeded corpus, to 2e-3 of the f64 oracle
(`Lattice.populate_marginal`) over the same 1024-byte snippets of the
first 64 samples. This test is the second witness for that bound, on the
CPU: the JAX package's f32 E-step lies as far from the oracle as the
port's, and its f64 E-step does not, so the gap belongs to the f32
recurrence and not to the port. The port's E-step is the session's
(`DeviceTrainSession.e_step`): with no cache budget it probes, scans and
scatters as the JAX E-step does, and its default route (the fused
kernels and the segsum, which this table takes) keeps the same bound. `pytest -s` prints the gaps.
"""

import importlib.util
from pathlib import Path

import numpy as np
import torch

import jax.numpy as jnp

import tokengeex_tpu as jtg
from tokengeex_tpu.train import estep_device as jed

import tokengeex_tpu_torch as tg
from tokengeex_tpu_torch.train import estep_device as ed

from test_torch_estep import e_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_f32_estep_gap_to_oracle_is_the_jax_packages():
    cs = _chip_smoke()
    samples = cs.build_corpus(cs.CORPUS_BYTES)
    vocab = cs.build_vocab(samples, 4096)
    head = samples[:64]
    model = tg.Model(vocab)
    jmodel = jtg.Model([jtg.ScoredToken(t.value, t.score) for t in vocab])
    snip = ed.DEVICE_EM_SNIPPET

    want = cs.oracle_total(model, head, snip)
    port = e_step(model, head, snip, cache_budget=0).sum()
    totals = {"port f32": port,
              "port f32 default": e_step(model, head, snip).sum()}
    for name, dtype in (("jax f32", jnp.float32), ("jax f64", jnp.float64)):
        totals[name] = jed.run_e_step_device(
            jmodel, head, dropout=0.0, max_snippet=snip, dtype=dtype).sum()
    gaps = {k: (v - want) / want for k, v in totals.items()}
    print(f"\nf64 oracle total {want!r}; totals {totals}; relative gaps "
          f"{gaps}")

    assert np.isfinite(list(totals.values())).all()
    assert abs(gaps["jax f64"]) < 1e-9
    # The port runs the JAX package's f32 recurrence: the same total.
    assert abs(port - totals["jax f32"]) / totals["jax f32"] < 1e-6
    # The f32 drift is real (well above the ports' 1e-6 agreement) and
    # within chip_smoke.py's bound.
    assert 1e-4 < abs(gaps["jax f32"]) <= 2e-3
    assert abs(gaps["port f32"]) <= 2e-3
    assert abs(gaps["port f32 default"]) <= 2e-3

    # Shorter snippets: the gap is not a random walk's, it changes sign
    # with the length. A likely cause: each frequent token's score rounds
    # the same way against the ulp grid of a forward value of slowly
    # changing size, so its errors add up in one direction.
    for n in (256, 512):
        want_n = cs.oracle_total(model, head, n)
        got_n = e_step(model, head, n, cache_budget=0).sum()
        gap = (got_n - want_n) / want_n
        print(f"{n}-byte snippets: oracle {want_n!r}, port f32 {got_n!r}, "
              f"relative gap {gap!r}")
        assert abs(gap) <= 2e-3
