"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under `tokengeex_tpu_torch/csrc/` compiles on first use into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds); a source may export several entry points and
include the shared headers `csrc/*.cuh`. Libraries land in
`build/tokengeex_tpu_torch/` at the root of the checkout (override with
TGX_TORCH_BUILD_DIR), named by a hash of the source, the headers and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Only sources in the repository are compiled.
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
LL = ctypes.c_longlong
# C signatures: name -> (source file, symbol, argtypes).
KERNELS: Dict[str, Tuple[str, str, tuple]] = {
    "viterbi_chunk": ("viterbi_chunk.cu", "tgx_viterbi_chunk",
                      (P, P, P, P, P, P, I, I, I, P)),
    "viterbi_scan": ("viterbi_chunk.cu", "tgx_viterbi_scan",
                     (P,) * 8 + (I,) * 7 + (U, I, P)),
    "viterbi_scan_f64": ("viterbi_chunk.cu", "tgx_viterbi_scan_f64",
                         (P,) * 8 + (I,) * 7 + (U, I, P)),
    "fused_forward": ("fused_forward.cu", "tgx_fused_forward",
                      (P,) * 15 + (I,) * 7 + (U, P)),
    "fused_forward_lse": ("fused_forward.cu", "tgx_fused_forward_lse",
                          (P,) * 14 + (I,) * 7 + (U, P)),
    "fused_backward": ("fused_backward.cu", "tgx_fused_backward",
                       (P,) * 12 + (I,) * 7 + (U, P)),
    "forward_scan": ("forward_chunk.cu", "tgx_forward_scan",
                     (P,) * 7 + (I,) * 6 + (U, I, P)),
    "forward_scan_f64": ("forward_chunk.cu", "tgx_forward_scan_f64",
                         (P,) * 7 + (I,) * 6 + (U, I, P)),
    "backward_chunk": ("backward_chunk.cu", "tgx_backward_chunk",
                       (P, P, P, P, P, P, P, I, I, I, P)),
    "backward_marginal_scan": ("backward_chunk.cu",
                               "tgx_backward_marginal_scan",
                               (P,) * 10 + (I,) * 5 + (U, I, P)),
    "backward_marginal_scan_f64": ("backward_chunk.cu",
                                   "tgx_backward_marginal_scan_f64",
                                   (P,) * 10 + (I,) * 5 + (U, I, P)),
    "backward_betas_scan": ("backward_chunk.cu", "tgx_backward_betas_scan",
                            (P,) * 7 + (I,) * 5 + (U, I, P)),
    "seg_weights": ("seg_weights.cu", "tgx_seg_weights",
                    (P, P, P, P, P, I, I, P)),
    "seg_weights_gather": ("seg_weights.cu", "tgx_seg_weights_gather",
                           (P,) * 18 + (I,) * 9 + (U, I, P)),
    "seg_sums": ("seg_weights.cu", "tgx_seg_sums", (P,) * 9 + (I,) * 3 + (P,)),
    "viterbi_walk": ("viterbi_walk.cu", "tgx_viterbi_walk",
                     (P,) * 17 + (LL, LL) + (I,) * 10 + (P,)),
    "walk_rows": ("viterbi_walk.cu", "tgx_walk_rows",
                  (P, P, LL, LL, I, I, I, P)),
    "dfa_mask": ("dfa_mask.cu", "tgx_dfa_mask",
                 (P,) * 6 + (I,) * 8 + (U, I, LL, P)),
    "pair_insert_ids": ("pair_count.cu", "tgx_pair_insert_ids",
                        (P, P, I, U, P, LL, P, P, LL, LL, LL, P)),
    "pair_insert_weighted": ("pair_count.cu", "tgx_pair_insert_weighted",
                             (P, P, LL, LL, LL, P, LL, P, P, LL, LL, P)),
    "pair_compact": ("pair_count.cu", "tgx_pair_compact",
                     (P, LL, P, P, LL, P, P)),
    "match_probe": ("match_probe.cu", "tgx_match_probe",
                    (P,) * 11 + (I,) * 9 + (U, I, I, I, P)),
    "match_probe_f64": ("match_probe.cu", "tgx_match_probe_f64",
                        (P,) * 11 + (I,) * 9 + (U, I, I, I, P)),
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}  # by source file
_ENTRIES: Dict[str, object] = {}  # by kernel name, argtypes set


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


def _target(source: str) -> Path:
    src = CSRC / source
    # The shared headers (csrc/*.cuh) are part of every source's build.
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{src.stem}-{digest}.so"


def _start(source: str):
    """Start nvcc for one source; returns (process, tmp, target) or None
    when the library is already built."""
    target = _target(source)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(source: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    target.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile the sources of the named kernels in parallel (one nvcc per
    source, all started together). Returns each source's nvcc log
    (-Xptxas -v: registers, spills, shared memory), keyed by file name;
    empty for a cached build."""
    sources = list(dict.fromkeys(KERNELS[n][0] for n in names))
    started = {s: _start(s) for s in sources}
    for s, st in started.items():
        if st is not None:
            _finish(s, st)
    logs = {}
    for s in sources:
        log = _target(s).with_suffix(".log")
        logs[s] = log.read_text() if log.exists() else ""
    return logs


def load(name: str):
    """The C entry point of one kernel, building its source on first use."""
    fn = _ENTRIES.get(name)
    if fn is not None:
        return fn
    source = KERNELS[name][0]
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(source)))
            _LOADED[source] = lib
    fn = getattr(lib, KERNELS[name][1])
    fn.argtypes = list(KERNELS[name][2])
    fn.restype = ctypes.c_int
    _ENTRIES[name] = fn
    return fn
