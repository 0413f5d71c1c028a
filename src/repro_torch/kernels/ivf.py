"""CUDA wrapper: IVF gather-then-score shortlist (``csrc/ivf.cu``).

The Hopper counterpart of ``repro/kernels/ivf.py:ivf_list_topk_pallas``:
(Q, d) f32 queries against the probed lists of an (Ip, d) int8 code table
with (Ip, 1) f32 scales, each list given by its (Q, P) start and length,
give the ``shortlist`` best ((Q, S) f32 approximate scores, (Q, S) int32
packed-row indices), best first, the lower flat (probe, offset) index first
on equal scores, (-inf, -1) where no candidate is left. The source file
carries the design note.

The wrapper allocates the kernel's (2, Q, S) 64-bit workspace (the running
shortlist, double-buffered) beside the outputs and launches on the current
stream; it reads nothing back, so a search that calls it does not sync.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

CHUNK = 2048  # list rows scored and sorted at once (csrc/ivf.cu:kChunk)

# Kernel launches since the last reset (chip_smoke.py reads and resets it):
# one ``ivf_list_topk_kernel`` per call.
launches = 0


def ivf_list_topk_cuda(
    queries: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    lpad: int,
    shortlist: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) f32, (Ip, d) int8, (Ip, 1) f32, (Q, P) int32 starts and
    lengths on one CUDA device -> ((Q, S) f32 scores, (Q, S) int32 rows)."""
    global launches
    if queries.dim() != 2 or codes.dim() != 2 or queries.shape[1] != codes.shape[1]:
        raise ValueError(f"ivf_list_topk wants (Q, d) queries and (Ip, d) codes; got "
                         f"{tuple(queries.shape)} and {tuple(codes.shape)}")
    Q, d = queries.shape
    Ip = codes.shape[0]
    if scales.numel() != Ip:
        raise ValueError(f"scales must hold one value per code row ({Ip}); got "
                         f"{tuple(scales.shape)}")
    if starts.dim() != 2 or starts.shape[0] != Q or lengths.shape != starts.shape:
        raise ValueError(f"starts and lengths must be (Q={Q}, P); got "
                         f"{tuple(starts.shape)} and {tuple(lengths.shape)}")
    P = starts.shape[1]
    if lpad < 1 or P < 1 or not 0 < shortlist <= P * lpad:
        raise ValueError(f"need lpad >= 1, P >= 1 and shortlist in [1, P * lpad]; got "
                         f"lpad={lpad}, P={P}, shortlist={shortlist}")
    if P * lpad >= 2**31:
        raise ValueError(f"flat candidate indices are 32-bit; P * lpad = {P * lpad}")
    want = {"queries": (queries, torch.float32), "codes": (codes, torch.int8),
            "scales": (scales, torch.float32), "starts": (starts, torch.int32),
            "lengths": (lengths, torch.int32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"ivf_list_topk wants {name} as {dtype}; got {t.dtype}")
    dev = queries.device
    if not queries.is_cuda or any(t.device != dev for t, _ in want.values()):
        raise ValueError("ivf_list_topk kernel wants every input on one CUDA device; got "
                         + ", ".join(f"{n} on {t.device}" for n, (t, _) in want.items()))
    if not all(t.is_contiguous() for t, _ in want.values()):
        raise ValueError("ivf_list_topk kernel wants contiguous inputs")
    out_s = torch.empty((Q, shortlist), dtype=torch.float32, device=dev)
    out_r = torch.empty((Q, shortlist), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_r
    ws = torch.empty((2, Q, shortlist), dtype=torch.int64, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.g4r_ivf_list_topk_i8(
            queries.data_ptr(), codes.data_ptr(), scales.data_ptr(), starts.data_ptr(),
            lengths.data_ptr(), ws.data_ptr(), out_s.data_ptr(), out_r.data_ptr(),
            Q, P, d, lpad, shortlist, Ip, stream,
        )
    build.check(err, "ivf_list_topk")
    launches += 1
    return out_s, out_r
