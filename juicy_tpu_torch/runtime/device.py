"""Where the port's entry points put their tensors.

The port runs on the CUDA card unless its caller asks for another device:
``device=None`` means ``torch.device("cuda")`` and raises when PyTorch sees
no CUDA device, rather than carrying on on the CPU. ``device="cpu"`` is the
explicit way to get the plain PyTorch route (the CPU tests pass it).
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a ``torch.device``; None is the card, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for another device; pass device=\"cpu\" for the plain "
            "PyTorch route")
    return torch.device("cuda")


def on_device(device: torch.device):
    """The context that makes `device` current, so that the kernels a
    wrapper launches for tensors on it run there (a no-op off CUDA)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
