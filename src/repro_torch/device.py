"""Device resolution for every entry point of the port.

The port serves on a CUDA card. ``resolve_device(None)`` returns ``cuda`` and
raises where CUDA is missing: it never drops to the CPU on its own, so a run
that reports a time or a rate cannot silently have measured the CPU. The CPU
is an explicit choice (``device="cpu"``), which the tests make.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means CUDA) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
