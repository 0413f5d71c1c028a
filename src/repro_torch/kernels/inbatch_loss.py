"""CUDA wrapper: in-batch softmax cross-entropy rows (``csrc/inbatch_loss.cu``).

The Hopper counterpart of ``repro/kernels/inbatch_loss.py:inbatch_loss_rows_pallas``:
(P, d) f32 sources and (P, d) f32 destinations give the (P,) rows
``logsumexp_j(src_i . dst_j / t) - src_i . dst_i / t``. The loss and its
closed-form backward live in ``kernels/ops.py``. The source file carries the
design note.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_DIM = 768  # the staged tiles must fit a block's 227 KB of shared memory

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
launches = 0


def inbatch_loss_rows_cuda(h_src: torch.Tensor, h_dst: torch.Tensor,
                           temperature: float = 1.0) -> torch.Tensor:
    """(P, d) f32, (P, d) f32 on one CUDA device -> (P,) f32 rows."""
    global launches
    if h_src.dim() != 2 or h_src.shape != h_dst.shape:
        raise ValueError(f"inbatch_loss wants (P, d) src and dst of one shape; got "
                         f"{tuple(h_src.shape)} and {tuple(h_dst.shape)}")
    if h_src.dtype != torch.float32 or h_dst.dtype != torch.float32:
        raise TypeError(f"inbatch_loss wants f32 inputs; got {h_src.dtype}, {h_dst.dtype}")
    if not (h_src.is_cuda and h_dst.device == h_src.device):
        raise ValueError(f"inbatch_loss kernel wants both inputs on one CUDA device; "
                         f"got {h_src.device} and {h_dst.device}")
    if not (h_src.is_contiguous() and h_dst.is_contiguous()):
        raise ValueError("inbatch_loss kernel wants contiguous src and dst")
    P, d = h_src.shape
    if d > MAX_DIM or P >= 2**31:
        raise ValueError(f"inbatch_loss kernel takes d <= {MAX_DIM} and P < 2**31; "
                         f"got P={P}, d={d}")
    if not temperature > 0:
        raise ValueError(f"temperature must be positive, got {temperature}")
    out = torch.empty((P,), dtype=torch.float32, device=h_src.device)
    if P == 0:
        return out
    if d == 0:
        raise ValueError("inbatch_loss kernel wants d >= 1")
    lib = build.library()
    with torch.cuda.device(h_src.device):
        stream = torch.cuda.current_stream(h_src.device).cuda_stream
        err = lib.g4r_inbatch_rows_f32(h_src.data_ptr(), h_dst.data_ptr(), out.data_ptr(),
                                       P, d, float(temperature), stream)
    build.check(err, "inbatch_loss")
    launches += 1
    return out
