"""Where the port's entry points run."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from . import trace


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


def upload(data, device, dtype=None) -> torch.Tensor:
    """`data` (a numpy array, a list or a Python number) as a tensor on
    `device`: the port's host-to-device copies go through here, counted as
    `h2d.copies` and `h2d.bytes` while a trace records (on the CPU, the
    copies the card would make; an empty upload copies nothing)."""
    t = torch.as_tensor(data, dtype=dtype, device=device)
    if trace.on() and t.numel():
        trace.count("h2d.copies", 1)
        trace.count("h2d.bytes", t.numel() * t.element_size())
    return t
