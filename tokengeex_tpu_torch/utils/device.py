"""Where the port's entry points run."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device, and
    under an NCCL process group the rank's card, LOCAL_RANK (made current
    here, as NCCL's collectives stage there).

    Without a GPU the caller must ask for the CPU explicitly (the plain
    PyTorch versions of the kernels): a silent fallback would report CPU
    work as device work."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        if dist.is_available() and dist.is_initialized() \
                and dist.get_backend() == "nccl":
            torch.cuda.set_device(int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
