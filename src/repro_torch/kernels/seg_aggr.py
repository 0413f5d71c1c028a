"""CUDA wrappers: masked segment aggregation and its backward
(``csrc/seg_aggr.cu``).

The Hopper counterpart of ``repro/kernels/seg_aggr.py:seg_aggr_pallas``:
(N, F, D) f32 neighbour features and an (N, F) bool mask give (N, D) in mode
``sum``, ``mean`` or ``max``. ``seg_aggr_bwd_cuda`` is its backward: (N,
D) output gradients and the mask give the dense (N, F, D) input gradient;
``max`` also takes the forward's input ``x``, whose maxima it routes the
gradient to. The source file carries the design note.

Inputs are read in place with a row stride, so the strided per-relation
view of the ego layout needs no copy; the F and D axes must be dense. The
forward reads 16 bytes a lane where D % 4 == 0 and x's base and row stride
are 16-byte aligned, else 4 bytes (the kernel picks by shape). A layout the
kernel does not take raises; it is never copied or sent to the plain
version behind the caller's back.

The backward reads g 16 bytes a lane where D % 4 == 0 and g's base is
16-byte aligned, else 4 bytes; in ``max`` also x, 16 bytes a lane where x's
base and row stride are 16-byte aligned as well.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

MODES = {"sum": 0, "mean": 1, "max": 2}

# Kernel launches since the last reset (chip_smoke.py reads and resets them):
# the forward kernel, and the backward kernel.
launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def kernel_attrs(vec: bool, backward: bool = False, max_mode: bool = False) -> dict:
    """The forward (or ``backward``; with ``max_mode`` the max backward)
    instantiation (``vec``: 16-byte accesses, else 4-byte): registers a
    thread, local memory bytes (spills and stack), static shared bytes,
    resident blocks an SM, and its grid cap on the current card."""
    out = (ctypes.c_int * 5)()
    lib = build.library()
    entry = (lib.g4r_seg_aggr_max_bwd_attrs if max_mode else lib.g4r_seg_aggr_bwd_attrs) \
        if backward else lib.g4r_seg_aggr_attrs
    build.check(entry(int(vec), out), "seg_aggr attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "blocks_per_sm": out[3], "grid_cap": out[4]}


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


def seg_aggr_bwd_cuda(g: torch.Tensor, mask: torch.Tensor, mode: str = "mean",
                      x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, D) f32 output gradient, (N, F) bool mask on one CUDA device ->
    (N, F, D) f32 input gradient. ``max`` needs the forward's input ``x``
    (N, F, D) f32, read in place with a row stride as the forward reads
    it; ``sum`` and ``mean`` take none. ``g`` must be contiguous; the mask
    takes a row stride."""
    global bwd_launches
    if mode not in MODES:
        raise ValueError(f"unknown seg_aggr mode {mode!r}; choose from {tuple(MODES)}")
    if (mode == "max") != (x is not None):
        raise ValueError(f"seg_aggr backward takes the forward's x in 'max' mode and only "
                         f"there; got mode {mode!r} with x {'given' if x is not None else 'None'}")
    if g.dim() != 2 or mask.dim() != 2 or mask.shape[0] != g.shape[0]:
        raise ValueError(f"seg_aggr backward wants g (N, D) and mask (N, F); got "
                         f"{tuple(g.shape)} and {tuple(mask.shape)}")
    if g.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"seg_aggr backward wants f32 g and bool mask; got {g.dtype}, "
                        f"{mask.dtype}")
    if not (g.is_cuda and mask.device == g.device):
        raise ValueError(f"seg_aggr backward kernel wants both inputs on one CUDA "
                         f"device; got {g.device} and {mask.device}")
    N, D = g.shape
    F = mask.shape[1]
    if not g.is_contiguous() or (mask.stride(1) != 1 and F > 1):
        raise ValueError(f"seg_aggr backward kernel wants a contiguous g and a mask "
                         f"with unit column stride; got strides {g.stride()} and "
                         f"{mask.stride()}")
    if x is not None:
        if tuple(x.shape) != (N, F, D) or x.dtype != torch.float32 or x.device != g.device:
            raise ValueError(f"seg_aggr max backward wants x (N, F, D) = {(N, F, D)} f32 on "
                             f"{g.device}; got {tuple(x.shape)} {x.dtype} on {x.device}")
        if N and ((x.stride(2) != 1 and D > 1) or (x.stride(1) != D and F > 1)):
            raise ValueError(f"seg_aggr max backward takes x with a row stride only; "
                             f"x strides {x.stride()} (need (*, {D}, 1))")
    dx = torch.empty((N, F, D), dtype=torch.float32, device=g.device)
    if N == 0 or D == 0 or F == 0:
        return dx
    lib = build.library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if x is None:
            err = lib.g4r_seg_aggr_bwd_f32(
                g.data_ptr(), mask.data_ptr(), dx.data_ptr(), N, F, D, mask.stride(0),
                MODES[mode], stream,
            )
        else:
            err = lib.g4r_seg_aggr_max_bwd_f32(
                g.data_ptr(), x.data_ptr(), mask.data_ptr(), dx.data_ptr(), N, F, D,
                x.stride(0), mask.stride(0), stream,
            )
    build.check(err, "seg_aggr backward")
    bwd_launches += 1
    return dx
