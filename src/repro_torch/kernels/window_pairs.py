"""CUDA wrappers: the skip-gram window-pair gather and the fused sampler's
whole pair stage (``csrc/window_pairs.cu``).

The Hopper counterparts of ``repro/kernels/window_pairs.py:window_pair_ids_pallas``:
``window_pair_ids_cuda`` is the gather alone, (B, L) int32 walk paths and an
(npos, 2) int32 table of (src_col, dst_col) positions to (B, npos) src and
(B, npos) dst ids, both PAD (-1) wherever either endpoint is PAD.
``window_pair_draw_cuda`` is the pair stage of the fused sampler
(``sampling/fused.py``) in one launch: the gather on the walker's int64
paths, then the uniform draw of P valid candidates (``ref.window_pair_draw_ref``).
The source file carries the design note.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

# Kernel launches since the last reset, of the gather and of the draw
# (chip_smoke.py reads and resets them).
launches = 0
draw_launches = 0
# csrc/window_pairs.cu's limits of the draw: kMaxPos positions, and
# kListSmem candidates (B * npos) held in shared memory; past that the
# wrapper gives the kernel a scratch for them.
MAX_POSITIONS = 512
LIST_SMEM = 4096


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


def window_pair_draw_cuda(paths: torch.Tensor, positions: torch.Tensor, spos: torch.Tensor,
                          dpos: torch.Tensor, sel: torch.Tensor,
                          walk_len: int) -> Tuple[torch.Tensor, ...]:
    """(B, L) int64 paths, (npos, 2) int32 positions, (npos,) int64 spos and
    dpos, (P,) int64 draw bits, all contiguous on one CUDA device -> (src,
    dst, src_sel, dst_sel) (P,) int64 and a 0-d bool ``all_dead``, as
    ``ref.window_pair_draw_ref``."""
    global draw_launches
    if (paths.dim() != 2 or positions.dim() != 2 or positions.shape[1] != 2
            or spos.shape != positions.shape[:1] or dpos.shape != positions.shape[:1]
            or sel.dim() != 1):
        raise ValueError(f"window_pair_draw wants (B, L) paths, (npos, 2) positions, (npos,) "
                         f"spos and dpos and (P,) sel; got {tuple(paths.shape)}, "
                         f"{tuple(positions.shape)}, {tuple(spos.shape)}, {tuple(dpos.shape)} "
                         f"and {tuple(sel.shape)}")
    want = (torch.int64, torch.int32, torch.int64, torch.int64, torch.int64)
    got = (paths.dtype, positions.dtype, spos.dtype, dpos.dtype, sel.dtype)
    if got != want:
        raise TypeError(f"window_pair_draw wants int64 paths, int32 positions and int64 spos, "
                        f"dpos and sel; got {[str(d) for d in got]}")
    ts = (paths, positions, spos, dpos, sel)
    if not (paths.is_cuda and all(t.device == paths.device for t in ts)):
        raise ValueError(f"window_pair_draw kernel wants every input on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("window_pair_draw kernel wants contiguous inputs")
    B, L = paths.shape
    npos, P = positions.shape[0], sel.shape[0]
    n = B * npos
    if n == 0 or L == 0:
        raise ValueError(f"window_pair_draw needs at least one candidate; got B={B}, L={L}, "
                         f"npos={npos}")
    if npos > MAX_POSITIONS or n >= 2**30 or P >= 2**31:
        raise ValueError(f"window_pair_draw kernel takes npos <= {MAX_POSITIONS}, B * npos < "
                         f"2**30 and P < 2**31; got npos={npos}, B * npos={n}, P={P}")
    dev = paths.device
    src, dst, src_sel, dst_sel = (torch.empty(P, dtype=torch.int64, device=dev)
                                  for _ in range(4))
    all_dead = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty(n, dtype=torch.int32, device=dev) if n > LIST_SMEM else None
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.g4r_window_pair_draw_i64(
            paths.data_ptr(), positions.data_ptr(), spos.data_ptr(), dpos.data_ptr(),
            sel.data_ptr(), None if scratch is None else scratch.data_ptr(), src.data_ptr(),
            dst.data_ptr(), src_sel.data_ptr(), dst_sel.data_ptr(), all_dead.data_ptr(), B, L,
            npos, P, walk_len, stream)
    build.check(err, "window_pair_draw")
    draw_launches += 1
    return src, dst, src_sel, dst_sel, all_dead
