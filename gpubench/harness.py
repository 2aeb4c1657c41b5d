"""What every cell shares: the manifest, the files found by name, the
device, the traced window and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules that may not be loaded in a run: JAX and the JAX package. Top
# level names are compared whole: the port's name begins with the last.
FORBIDDEN = ("jax", "jaxlib", "flax", "tokengeex_tpu")


def forbidden_modules(modules=None) -> List[str]:
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, root: Path = ROOT) -> dict:
    """The cell's entry in the manifest with its configuration (from the
    config's `file`) and its traffic mix (`traffic/<name>.json`)."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return {"cell": cell, "config": config, "traffic": traffic,
            "manifest": m}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """The code that runs the traffic's entry point, `entries/<name>.py`."""
    return load_module(HERE / "entries" / f"{name}.py", f"gpubench_entry_{name}")


def cell_metrics(m: dict, cell: str, trace: bool) -> List[dict]:
    """The manifest's metrics this cell reports: its end-to-end metrics,
    or with a trace its per-layer metrics."""
    out = []
    for metric in m["per_layer" if trace else "end_to_end"]:
        if cell in metric.get("workloads", [cell]):
            out.append(metric)
    return out


def read_per_layer(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric from its reader, `metrics/<name>.py`; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for metric in metrics:
        mod = load_module(HERE / "metrics" / f"{metric['name']}.py",
                          "gpubench_metric_" + metric["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def require_devices(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: needs {n} CUDA device(s), found {have}",
              file=sys.stderr)
        raise SystemExit(2)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def device_info(dev, count: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}


@contextlib.contextmanager
def annotate(name: str, enabled: bool):
    """A profiler annotation in traced runs, nothing otherwise."""
    if not enabled:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


@contextlib.contextmanager
def span(name: str, sink: Optional[dict], sync=None):
    """A host span around a call into the program: its seconds added to
    sink[name] (when a sink is given, in traced runs), the device
    synchronised at both ends so that its work is charged to it, and a
    profiler annotation for the trace's idle gaps."""
    if sink is None:
        yield
        return
    from torch.profiler import record_function

    if sync:
        sync()
    t = time.perf_counter()
    try:
        with record_function(name):
            yield
            if sync:
                sync()
    finally:
        sink[name] += time.perf_counter() - t


class Trace:
    """torch.profiler over the measured window: device busy seconds,
    seconds per kernel name, and the idle gaps between device work
    attributed to the innermost host span open at the time."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._rf = __import__("torch").profiler.record_function(
                "gpubench.window")
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import torch

            torch.cuda.synchronize()
            self._rf.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    def summary(self, prefixes: tuple = ()) -> dict:
        """busy_s, window_s, kernel seconds by name, and the breakdown."""
        from torch.autograd import DeviceType

        dev, cpu = [], []
        window = None
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith(prefixes + ("gpubench.window",)):
                # Host spans; their copies on the device's timeline
                # (gpu_user_annotation) are not device work.
                if e.device_type == DeviceType.CUDA:
                    continue
                if e.name == "gpubench.window":
                    window = (tr.start, tr.end)
                else:
                    cpu.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
        if window is None or not dev:
            raise RuntimeError("the trace holds no window or no device work")
        w0, w1 = window
        dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                     if b > w0 and a < w1)
        kernels: Dict[str, float] = defaultdict(float)
        busy, gaps = 0.0, []
        cur_a, cur_b = None, None
        last = w0
        for a, b, n in dev:
            kernels[n] += (b - a) / 1e6
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                if a > last:
                    gaps.append((last, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
            last = max(last, cur_b)
        busy += cur_b - cur_a
        if w1 > last:
            gaps.append((last, w1))
        idle: Dict[str, float] = defaultdict(float)
        cpu.sort()
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(s, n) for s, e, n in cpu if s <= mid <= e]
            name = max(inner)[1] if inner else "outside the spans"
            idle[name] += (b - a) / 1e6
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
        top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
                "kernels": dict(kernels),
                "breakdown": {"device_ops": [[n, s] for n, s in top],
                              "idle_gaps": [[n, s] for n, s in top_idle]}}


def kernel_seconds(kernels: Dict[str, float], name: str,
                   dtype: str = "float") -> float:
    """Device seconds of the kernel function `name` (its demangled name
    compared whole), of its `dtype` instantiation where a template
    argument names float or double."""
    total = 0.0
    for k, s in kernels.items():
        m = re.search(r"(\w+)(?:<([^()]*)>)?\(", k) or \
            re.fullmatch(r"(\w+)(?:<([^()]*)>)?", k)
        if not m or m.group(1) != name:
            continue
        args = {a.strip() for a in (m.group(2) or "").split(",")}
        types = {"float", "double"} & args
        if types and dtype not in types:
            continue
        total += s
    return total


def finish(correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, checks: Dict[str, tuple],
           breakdown: Optional[dict] = None) -> int:
    """Print the checks (on stderr, last) and the result line (stdout,
    last), after making sure no JAX module is loaded. Returns the exit
    code."""
    found = forbidden_modules()
    if found:
        print(f"gpubench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
