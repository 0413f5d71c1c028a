"""CUDA wrapper: causal / sliding-window GQA flash attention (``csrc/flash_attn.cu``).

The Hopper counterpart of ``repro/kernels/flash_attn.py:flash_attention_pallas``,
forward only: q (B, Sq, H, hd) and k, v (B, Skv, K, hd), in the model's
layout (no transpose copy: the kernel reads through the strides), give
(B, Sq, H, hd) in q's dtype. f32 or bf16, hd in {32, 64, 128}, any Sq and
Skv. Two kernels, by dtype: bf16 runs on the tensor cores (``wgmma``, with
K/V tiles brought by TMA; the unnormalised softmax weights p are rounded to
bf16 before the PV product, the row sums kept from the f32 p), f32 on the
CUDA cores (p kept in f32 throughout). TMA takes only strides and base
addresses that are multiples of 16 bytes, so a bf16 view that has others
raises here, before any launch. The source file carries the design note.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 16  # bytes: TMA's stride and base-address granule
BF16_BLOCK_Q = 128  # query rows per block of the bf16 kernel
MAX_GRID_Z = 65535

# Kernel launches since the last reset (chip_smoke.py reads and resets it):
# one ``flash_fwd_kernel`` (f32) or ``flash_fwd_kernel_wgmma`` (bf16) per call.
launches = 0


def _check_tma(name: str, t: torch.Tensor) -> None:
    bad = [s * t.element_size() for s in t.stride()[:3] if s * t.element_size() % TMA_ALIGN]
    if bad or t.data_ptr() % TMA_ALIGN:
        raise ValueError(
            f"flash_attention's bf16 kernel loads {name} by TMA, which takes strides and a "
            f"base address that are multiples of {TMA_ALIGN} bytes; got strides "
            f"{[s * t.element_size() for s in t.stride()]} bytes and base address "
            f"{t.data_ptr():#x}")


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
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel wants the head_dim axis contiguous")
    if Sq >= 2**31 or Skv >= 2**31 or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention kernel takes Sq, Skv < 2**31 and B, H <= 65535; "
                         f"got {tuple(q.shape)}, Skv={Skv}")
    if q.dtype == torch.bfloat16:
        if -(-Sq // BF16_BLOCK_Q) > MAX_GRID_Z:
            raise ValueError(f"flash_attention's bf16 kernel takes Sq <= "
                             f"{BF16_BLOCK_Q * MAX_GRID_Z}; got {Sq}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel wants q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
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


def wgmma_probe(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's building blocks on one tile, for the tests: q (64,
    64), k and v (128, 64) contiguous bf16 on the card -> (q @ k.T, bf16 of
    it @ v), both f32, from one TMA load of each, the Q K^T wgmma and the PV
    wgmma with P in registers. Not counted in ``launches``."""
    if (q.shape != (64, 64) or k.shape != (128, 64) or v.shape != (128, 64)
            or any(t.dtype != torch.bfloat16 or not t.is_cuda or not t.is_contiguous()
                   for t in (q, k, v))):
        raise ValueError("wgmma_probe wants contiguous bf16 q (64, 64), k and v (128, 64) "
                         "on the card")
    s = torch.empty((64, 128), dtype=torch.float32, device=q.device)
    o = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.g4r_flash_wgmma_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
                                        o.data_ptr(),
                                        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention wgmma probe")
    return s, o


def kernel_attrs(dtype: torch.dtype, hd: int) -> dict:
    """Registers a thread, local memory bytes (spills and stack) and dynamic
    shared memory bytes of the flash kernel instantiation for (dtype, hd)."""
    out = (ctypes.c_int * 3)()
    build.check(build.library().g4r_flash_attn_attrs(_DTYPES[dtype], hd, out),
                "flash_attention attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}
