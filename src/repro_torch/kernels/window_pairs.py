"""CUDA wrapper: skip-gram window-pair gather (``csrc/window_pairs.cu``).

The Hopper counterpart of ``repro/kernels/window_pairs.py:window_pair_ids_pallas``:
(B, L) int32 walk paths and an (npos, 2) int32 table of (src_col, dst_col)
positions give (B, npos) src and (B, npos) dst ids, both PAD (-1) wherever
either endpoint is PAD. The pair stage of the fused sampler
(``sampling/fused.py``); the source file carries the design note.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
launches = 0


def window_pair_ids_cuda(paths: torch.Tensor,
                         positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) int32 paths, (npos, 2) int32 positions, both contiguous on one
    CUDA device -> ((B, npos) int32 src, (B, npos) int32 dst)."""
    global launches
    if paths.dim() != 2 or positions.dim() != 2 or positions.shape[1] != 2:
        raise ValueError(f"window_pairs wants (B, L) paths and (npos, 2) positions; got "
                         f"{tuple(paths.shape)} and {tuple(positions.shape)}")
    if paths.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError(f"window_pairs wants int32 paths and positions; got {paths.dtype} "
                        f"and {positions.dtype}")
    if not (paths.is_cuda and positions.device == paths.device):
        raise ValueError(f"window_pairs kernel wants both inputs on one CUDA device; got "
                         f"{paths.device} and {positions.device}")
    if not (paths.is_contiguous() and positions.is_contiguous()):
        raise ValueError("window_pairs kernel wants contiguous paths and positions")
    B, L = paths.shape
    npos = positions.shape[0]
    if L >= 2**31 or npos >= 2**31:
        raise ValueError(f"window_pairs kernel takes L, npos < 2**31; got L={L}, npos={npos}")
    src = torch.empty((B, npos), dtype=torch.int32, device=paths.device)
    dst = torch.empty((B, npos), dtype=torch.int32, device=paths.device)
    if B == 0 or npos == 0:
        return src, dst
    lib = build.library()
    with torch.cuda.device(paths.device):
        stream = torch.cuda.current_stream(paths.device).cuda_stream
        err = lib.g4r_window_pairs_i32(paths.data_ptr(), positions.data_ptr(), src.data_ptr(),
                                       dst.data_ptr(), B, L, npos, stream)
    build.check(err, "window_pairs")
    launches += 1
    return src, dst
