"""BENCHMARK.json, the files it names, the result line, and no JAX."""

import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stdout

from gpubench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_file():
    m = harness.manifest()
    assert m["paths"] == ["gpubench"]
    for c in m["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("gpubench/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert set(c["reduced"]) <= set(cfg)  # each cut key is in the file
    for w in m["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        files = harness.cell_files(w["name"])
        assert files["traffic"]["entry"] in ("encode", "prune")
        harness.entry(files["traffic"]["entry"])
    for metric in m["per_layer"] + m["end_to_end"]:
        assert NAME.match(metric["name"])
    for metric in m["per_layer"]:
        assert (harness.HERE / "metrics" / f"{metric['name']}.py").exists()
        assert metric["moves"] in {e["name"] for e in m["end_to_end"]}
        for w in metric["workloads"]:
            assert metric["moves"] in [
                e["name"] for e in harness.cell_metrics(m, w, False)]


def test_every_cell_reports_setup_and_two_more():
    m = harness.manifest()
    for w in m["workloads"]:
        e2e = [e["name"] for e in harness.cell_metrics(m, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(m, w["name"], True)


def test_metric_readers_find_nothing_without_their_layer():
    m = harness.manifest()
    assert harness.read_per_layer(m["per_layer"], {"phases": {}}) == {}


def test_result_line_holds_the_contract_keys_checks_last():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.finish(True, 3, 0, {"setup_s": {"value": 1.5,
                                                     "unit": "s"}},
                            {"platform": "gpu", "count": 1},
                            {"ids_wrong": (0, 0)},
                            {"device_ops": [], "idle_gaps": []})
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"] == {"ids_wrong": {"value": 0, "limit": 0}}


def test_kernel_names_compare_whole():
    k = {"void forward_scan_kernel<float, 16, 2, true>(float const*)": 1.0,
         "void fused_forward_scan_kernel<16, 2, true>(int2 const*)": 2.0,
         "void forward_scan_kernel<double, 16, 2, true>(double const*)": 4.0,
         "void seg_gather_kernel<true>(GatherArgs)": 8.0}
    assert harness.kernel_seconds(k, "forward_scan_kernel") == 1.0
    assert harness.kernel_seconds(k, "forward_scan_kernel", "double") == 4.0
    assert harness.kernel_seconds(k, "seg_gather_kernel") == 8.0


LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
from gpubench import harness, compare, corpus, inputs, kernels_work, vocab
from gpubench.reference import lattice, prune
m = harness.manifest()
for e in ("encode", "prune"):
    harness.entry(e)
for metric in m["per_layer"]:
    harness.load_module(harness.HERE / "metrics" / (metric["name"] + ".py"),
                        "x_" + metric["name"].replace(".", "_"))
harness.load_module(harness.HERE / "run.py", "gprun")
harness.load_module(harness.HERE / "control.py", "gpcontrol")
import tokengeex_tpu_torch
from tokengeex_tpu_torch.train import prune, estep_device, device_session
from tokengeex_tpu_torch.ops import lattice as lat
print(sorted({{n.split(".", 1)[0] for n in sys.modules}}))
"""

LOAD_REFERENCE = """
import sys
sys.path.insert(0, {root!r})
from gpubench.reference import lattice, prune
from gpubench import compare
print(sorted({{n.split(".", 1)[0] for n in sys.modules}}))
"""


def _top_level(script: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          script.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))


def test_no_jax_in_the_benchmark_and_the_port():
    names = _top_level(LOAD_ALL)
    assert "tokengeex_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "tokengeex_tpu"}
    assert harness.forbidden_modules(["tokengeex_tpu_torch.ops"]) == []
    assert harness.forbidden_modules(["jax.numpy"]) == ["jax"]
    assert harness.forbidden_modules(["tokengeex_tpu.core"]) == \
        ["tokengeex_tpu"]


def test_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "tokengeex_tpu",
                        "tokengeex_tpu_torch"}
