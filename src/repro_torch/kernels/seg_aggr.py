"""CUDA wrapper: masked segment aggregation (``csrc/seg_aggr.cu``).

The Hopper counterpart of ``repro/kernels/seg_aggr.py:seg_aggr_pallas``:
(N, F, D) f32 neighbour features and an (N, F) bool mask give (N, D) in mode
``sum``, ``mean`` or ``max``. The source file carries the design note.

Inputs are read in place with a row stride, so the strided per-relation
view of the ego layout needs no copy; the F and D axes must be dense. A
layout the kernel does not take raises; it is never copied or sent to the
plain version behind the caller's back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MODES = {"sum": 0, "mean": 1, "max": 2}

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
launches = 0


def seg_aggr_cuda(x: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """(N, F, D) f32, (N, F) bool on one CUDA device -> (N, D) f32."""
    global launches
    if mode not in MODES:
        raise ValueError(f"unknown seg_aggr mode {mode!r}; choose from {tuple(MODES)}")
    if x.dim() != 3 or mask.dim() != 2 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(
            f"seg_aggr wants x (N, F, D) and mask (N, F); got {tuple(x.shape)} "
            f"and {tuple(mask.shape)}"
        )
    if x.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"seg_aggr wants f32 x and bool mask; got {x.dtype}, {mask.dtype}")
    if not (x.is_cuda and mask.device == x.device):
        raise ValueError(f"seg_aggr kernel wants both inputs on one CUDA device; "
                         f"got {x.device} and {mask.device}")
    N, F, D = x.shape
    if N and ((x.stride(2) != 1 and D > 1) or (x.stride(1) != D and F > 1)
              or (mask.stride(1) != 1 and F > 1)):
        raise ValueError(
            f"seg_aggr kernel takes a row stride only; x strides {x.stride()} "
            f"(need (*, {D}, 1)) and mask strides {mask.stride()} (need (*, 1))"
        )
    out = torch.empty((N, D), dtype=torch.float32, device=x.device)
    if N == 0 or D == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.g4r_seg_aggr_f32(
            x.data_ptr(), mask.data_ptr(), out.data_ptr(), N, F, D,
            x.stride(0), mask.stride(0), MODES[mode], stream,
        )
    build.check(err, "seg_aggr")
    launches += 1
    return out
