"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device.

    Without a GPU the caller must ask for the CPU explicitly (the plain
    PyTorch versions of the kernels): a silent fallback would report CPU
    work as device work."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
