"""Multi-GPU: the process group as a 1-D data mesh.

Counterpart of tokengeex_tpu/parallel/mesh.py over torch.distributed. The
JAX package builds a 1-D device mesh with shard_map: the vocabulary tables
replicated, each row group's rows sharded over the devices, the dense count
tensors psum-reduced. The port runs one process per GPU (a rank), and the
mesh is the process group itself:

  - every rank builds the tables itself (replicated);
  - under a replicated corpus every rank packs the whole corpus the same
    way and runs the contiguous block [r B / N, (r + 1) B / N) of each row
    group's B rows, padded to a multiple of the N ranks (`local_block`),
    through the single-card routes;
  - under per-process corpus shards (a session's `local_shard`, the
    pruner's `corpus_sharded`) every rank packs only its own samples and
    runs all of their groups;
  - each rank adds its groups' counts locally, and one all_reduce(SUM) of
    the dense count array a pass stands for the psum (`all_reduce_counts`);
    the encode's flat ids are all_gathered as int32 tensors
    (`allgather_ragged`);
  - a failure on one rank is agreed by a MAX reduction before any rank
    raises (`allgather_fail`), or the others would wait in the next
    collective for ever.

Deviation from the JAX package: its mesh also covers one process driving
several local devices; the port has no such mode. One rank drives one card.

Backends: NCCL when the rank's device is CUDA, gloo on the CPU, and gloo on
CUDA tensors only when the caller names it (`backend="gloo"`), which lets
two ranks share one card. The collectives here take host arrays and stage
them on the backend's own device: under NCCL a copy to the rank's card and
back, under gloo the host array itself, so the copy of a rank's results
to the host is explicit (their readback) and gloo never sees a CUDA
tensor. (gloo in torch 2.11.0+cu128 does take CUDA tensors in all_reduce,
broadcast and all_gather: chip_smoke.py phase 3i probes it; the port does
not rely on it.)

Without a process group the world is one rank and every helper is the
identity, as in the JAX package at process_count() == 1. Every rank must
call the same collectives in the same order; the callers keep them at pass
boundaries.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.packing import PackedBatch

# Seconds a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT_S = 600


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def distributed_initialize(device=None, backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: Optional[float] = None) -> torch.device:
    """Join the process group and return this rank's device.

    The rank, the world size and the rendezvous come from the arguments or
    else from the variables torchrun sets (RANK, WORLD_SIZE, and
    MASTER_ADDR / MASTER_PORT through init_method "env://"). device None is
    the card LOCAL_RANK (RuntimeError without CUDA: no silent CPU
    fallback); "cpu" runs the kernels' plain versions. backend None is
    "nccl" for a CUDA device and "gloo" for the CPU. timeout: seconds a
    collective waits (DEFAULT_TIMEOUT_S)."""
    if device is None:
        resolve_device(None)  # raises without CUDA
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        # NCCL and all_gather_object stage on the current card.
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(
            seconds=DEFAULT_TIMEOUT_S if timeout is None else timeout))
    return device


def shutdown() -> None:
    """Leave the process group (nothing without one)."""
    if initialized():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -- Row blocks (replicated corpus) -----------------------------------------


def pad_rows_to(packed: PackedBatch, rows: int) -> PackedBatch:
    """Append empty rows (no spans) up to `rows`."""
    extra = rows - packed.rows
    if extra <= 0:
        return packed
    W = packed.width
    return PackedBatch(
        bytes_arr=np.concatenate(
            [packed.bytes_arr, np.zeros((extra, W), np.uint8)]),
        sample_id=np.concatenate(
            [packed.sample_id, np.full((extra, W), -1, np.int32)]),
        is_start=np.concatenate(
            [packed.is_start, np.zeros((extra, W + 1), bool)]),
        end_index=np.concatenate(
            [packed.end_index, np.zeros((extra, W), np.int32)]),
        spans=list(packed.spans),
    )


def pad_rows_to_multiple(packed: PackedBatch, mult: int) -> PackedBatch:
    return pad_rows_to(packed, -(-packed.rows // mult) * mult)


def slice_rows(packed: PackedBatch, r0: int, r1: int) -> PackedBatch:
    """Rows [r0, r1) of a packed batch, its spans' rows relative to r0."""
    spans = [
        (r - r0, s, e, si, ci) for (r, s, e, si, ci) in packed.spans
        if r0 <= r < r1
    ]
    return PackedBatch(
        bytes_arr=packed.bytes_arr[r0:r1],
        sample_id=packed.sample_id[r0:r1],
        is_start=packed.is_start[r0:r1],
        end_index=packed.end_index[r0:r1],
        spans=spans,
    )


def local_block(group: PackedBatch) -> Tuple[PackedBatch, int]:
    """(block, lo): this rank's contiguous block of a row group's rows,
    padded to a multiple of the world size, and the group row it starts
    at (the JAX package's shard_rows / local_rows). One rank: the group."""
    n = process_count()
    if n == 1:
        return group, 0
    padded = pad_rows_to_multiple(group, n)
    per = padded.rows // n
    lo = process_index() * per
    return slice_rows(padded, lo, lo + per), lo


# -- Collectives -------------------------------------------------------------


def all_reduce_counts(counts: np.ndarray) -> np.ndarray:
    """The sum over the ranks of a dense count array (the psum of the JAX
    package's sharded E-step and Viterbi), one all_reduce(SUM) in the
    array's own dtype: int64 counts stay exact. One rank: `counts`."""
    if not initialized():
        return counts
    t = torch.tensor(counts, device=_comm_device())  # a copy: `counts` stays
    dist.all_reduce(t)
    return t.cpu().numpy()


def allgather_ints(values) -> np.ndarray:
    """(world, k) int64: every rank's k integers, in rank order."""
    row = np.asarray(values, np.int64).reshape(1, -1)
    if not initialized():
        return row
    t = torch.from_numpy(row).to(_comm_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.cat(out).cpu().numpy()


def allgather_fail(fail: int, value: float) -> Tuple[int, float]:
    """Failure agreement: every rank learns of a local failure before any
    rank raises. Returns (the largest `fail` over the ranks, -1 for none;
    the `value` of the first rank reporting it), the same on every rank."""
    row = np.asarray([float(fail), float(value)], np.float64)
    if not initialized():
        return int(fail), float(value)
    t = torch.from_numpy(row).to(_comm_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    arr = torch.stack(out).cpu().numpy()
    k = int(np.argmax(arr[:, 0]))
    return int(arr[k, 0]), float(arr[k, 1])


def allgather_pickled(obj) -> list:
    """Every rank's small host object, in rank order (all_gather_object:
    under NCCL it stages on the current card, which distributed_initialize
    sets)."""
    if not initialized():
        return [obj]
    out: List[object] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def allgather_ragged(x: np.ndarray) -> List[np.ndarray]:
    """Every rank's 1-D int32 array, in rank order: the lengths are
    gathered first, then one all_gather of the arrays padded to the
    longest."""
    x = np.ascontiguousarray(x, dtype=np.int32)
    if not initialized():
        return [x]
    lens = allgather_ints([x.size])[:, 0]
    top = int(lens.max())
    dev = _comm_device()
    buf = torch.zeros(top, dtype=torch.int32, device=dev)
    buf[: x.size] = torch.from_numpy(x).to(dev)
    out = [torch.empty_like(buf) for _ in range(len(lens))]
    dist.all_gather(out, buf)
    return [o[: int(n)].cpu().numpy() for o, n in zip(out, lens)]
