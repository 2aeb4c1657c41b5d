"""Small cells for the harness's CPU tests: a configuration under a traffic
mix with the corpus and the vocabularies cut to a size a test run holds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import harness  # noqa: E402


def small(config: str, traffic: str) -> dict:
    """What run_cell takes for the configuration under the traffic mix,
    whether or not the manifest has the pair as a cell."""
    m = harness.manifest()
    files = {c["name"]: c["file"] for c in m["configs"]}
    f = {"cell": {"name": f"{config}.{traffic}", "config": config,
                  "traffic": traffic, "chips": 1},
         "config": harness.load_json(harness.ROOT / files[config]),
         "traffic": harness.load_json(harness.HERE / "traffic"
                                      / f"{traffic}.json"),
         "manifest": m}
    t, c = f["traffic"], f["config"]
    t["corpus"]["file_median_bytes"] = 800
    if t["entry"] == "encode":
        t["pool_bytes"] = 150_000
        t["request_files"] = 24
        t["check"] = {"random_files": 8, "longest_files": 3}
        c["vocab_size"] = 2000
    else:
        c["train_corpus_bytes"] = 120_000
        c["init_vocab_size"] = 2500
        c["vocab_size"] = 1800
    return f


@pytest.fixture
def small_cell():
    return small
