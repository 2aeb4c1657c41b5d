"""Split the port's CLI start-up on the card: interpreter, imports, CUDA
context, kernel loads.

    python3 experiments/torch_cli_startup.py [out.json]

from the root of a checkout whose kernels are built (`python3
chip_smoke.py` builds them). Prints one JSON line:

  - `process_s`: wall seconds of whole processes: `python -c pass`,
    `import torch`, `import tokengeex_tpu_torch.cli`, and the CLI's
    `regex` (no device) and `encode` of one short text (the card);
  - `importtime_ms`: `python -X importtime`'s cumulative milliseconds of
    the heaviest modules under `import tokengeex_tpu_torch.cli`;
  - `in_process_s`: inside one process, in order: `import torch`, the CLI
    module, the CUDA context (`torch.cuda.init` and a first allocation),
    the kernels' ctypes loads (every entry point of ops/_build.KERNELS)
    and the first launch of a small encode.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def wall(args, **kw) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, *args], check=True, capture_output=True,
                   cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                   **kw)
    return time.perf_counter() - t0


def importtime() -> dict:
    r = subprocess.run([sys.executable, "-X", "importtime", "-c",
                        "import tokengeex_tpu_torch.cli"], check=True,
                       capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    cum = {}
    for line in r.stderr.splitlines():
        parts = line.split("|")
        if len(parts) == 3 and parts[1].strip().isdigit():
            name = parts[2].strip()
            if name.count(".") <= 1:
                cum[name] = int(parts[1]) / 1e3
    top = sorted(cum.items(), key=lambda kv: -kv[1])[:12]
    return dict(top)


def in_process() -> dict:
    out = {}
    t0 = time.perf_counter()
    import torch

    out["import_torch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from tokengeex_tpu_torch import Model, ScoredToken, Tokenizer, cli  # noqa
    from tokengeex_tpu_torch.ops import _build

    out["import_cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out["cuda_context"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in _build.KERNELS:
        _build.load(name)
    out["kernel_loads"] = time.perf_counter() - t0
    vocab = [ScoredToken(bytes([b]), -5.0) for b in range(256)]
    tok = Tokenizer(Model(vocab), device="cuda")
    t0 = time.perf_counter()
    tok.encode_batch(["def f(): return 1"])
    torch.cuda.synchronize()
    out["first_encode"] = time.perf_counter() - t0
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build = ROOT / "build" / "startup"
    build.mkdir(parents=True, exist_ok=True)
    vocab = build / "v.json"
    cli = ["-m", "tokengeex_tpu_torch.cli"]
    wall([*cli, "regex", "-o", str(build / "allow.regex")])  # warm caches
    process = {
        "python_pass": wall(["-c", "pass"]),
        "import_torch": wall(["-c", "import torch"]),
        "import_cli": wall(["-c", "import tokengeex_tpu_torch.cli"]),
        "cli_regex": wall([*cli, "regex", "-o", str(build / "allow.regex")]),
    }
    (build / "train.bin").write_bytes(b"def f(): return 1\x00x = 2")
    wall([*cli, "generate", "-v", "300", "-o", str(vocab), "--train",
          f"code:{build / 'train.bin'}"])
    process["cli_encode"] = wall([*cli, "encode", "-v", str(vocab), "-i",
                                  "def f(): return 1"])
    line = {"card": smi, "process_s": process,
            "importtime_ms": importtime(), "in_process_s": in_process()}
    print(json.dumps(line), flush=True)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(line, indent=1))


if __name__ == "__main__":
    main()
