"""CUDA wrapper: causal / sliding-window GQA flash attention (``csrc/flash_attn.cu``).

The Hopper counterpart of ``repro/kernels/flash_attn.py:flash_attention_pallas``,
forward only: q (B, Sq, H, hd) and k, v (B, Skv, K, hd), in the model's
layout (no transpose copy: the kernel reads through the strides), give
(B, Sq, H, hd) in q's dtype. f32 or bf16, hd in {32, 64, 128}, any Sq and
Skv. The source file carries the design note.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (chip_smoke.py reads and resets it):
# one ``flash_fwd_kernel`` per call.
launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """(B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd) on one CUDA device,
    one dtype, innermost stride 1 -> (B, Sq, H, hd) contiguous, q's dtype."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants 4-d q, k, v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if K == 0 or H % K != 0:
        raise ValueError(f"flash_attention: {H} query heads over {K} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}; got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1 or None; got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16, one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel wants q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel wants the head_dim axis contiguous")
    if Sq >= 2**31 or Skv >= 2**31 or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention kernel takes Sq, Skv < 2**31 and B, H <= 65535; "
                         f"got {tuple(q.shape)}, Skv={Skv}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv == 0)")
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.g4r_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, Sq, Skv, H, K, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 1.0 / math.sqrt(hd), int(bool(causal)),
            0 if window is None else int(window), stream)
    build.check(err, "flash_attention")
    launches += 1
    return out
