"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under `tokengeex_tpu_torch/csrc/` compiles on first use into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries land in `build/tokengeex_tpu_torch/` at
the root of the checkout (override with TGX_TORCH_BUILD_DIR), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. Only sources in the repository are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
# C signatures: name -> (source file, symbol, argtypes).
KERNELS: Dict[str, Tuple[str, str, tuple]] = {
    "viterbi_chunk": ("viterbi_chunk.cu", "tgx_viterbi_chunk",
                      (P, P, P, P, P, P, I, I, I, P)),
    "fused_forward": ("fused_forward.cu", "tgx_fused_forward_viterbi",
                      (P,) * 15 + (I, I, I, I, I, I, U, P)),
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("TGX_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parent / "build" / "tokengeex_tpu_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _target(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one kernel; returns (process, tmp, target) or None
    when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    target.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {KERNELS[name][0]} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile the named kernels in parallel (one nvcc per source, all
    started together). Returns each kernel's nvcc log (-Xptxas -v:
    registers, spills, shared memory); empty for a cached build."""
    names = list(names)
    started = {n: _start(n) for n in names}
    for n, st in started.items():
        if st is not None:
            _finish(n, st)
    logs = {}
    for n in names:
        log = _target(n).with_suffix(".log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str):
    """The C entry point of one kernel, building it on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LOADED[name] = lib
    fn = getattr(lib, KERNELS[name][1])
    fn.argtypes = list(KERNELS[name][2])
    fn.restype = ctypes.c_int
    return fn
