"""CUDA wrappers: causal / sliding-window GQA flash attention, forward
(``csrc/flash_attn.cu``) and backward (``csrc/flash_attn_bwd.cu``).

The forward is the Hopper counterpart of
``repro/kernels/flash_attn.py:flash_attention_pallas``: q (B, Sq, H, hd) and
k, v (B, Skv, K, hd), in the model's layout (no transpose copy: the kernel
reads through the strides), give (B, Sq, H, hd) in q's dtype and, when
asked, each row's log-sum-exp (B, H, Sq) f32. f32 or bf16, hd in {32, 64,
128}, any Sq and Skv. Two kernels, by dtype: bf16 runs on the tensor cores
(``wgmma``, with K/V tiles brought by TMA; the unnormalised softmax weights p
are rounded to bf16 before the PV product, the row sums kept from the f32
p), f32 on the CUDA cores (p kept in f32 throughout, tiles brought by
16-byte ``cp.async`` copies). TMA takes only strides and base addresses
that are multiples of 16 bytes, so a bf16 view that has others raises here,
before any launch; an f32 view that has others is copied first, by the
forward's wrapper and the backward's (counted in ``copies``).

The backward replaces no TPU kernel (``repro``'s Pallas kernel has no VJP):
from q, k, v, the forward's output and LSE and the output's gradient it
gives dq, dk, dv, summing dk and dv over each KV head's G query heads,
deterministically (no atomics), in three launches (two where no partials
are summed, ``bwd_plan``). The source files carry the design notes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 16  # bytes: TMA's stride and base-address granule
BLOCK_Q = 128  # query rows per block of either kernel, on the grid's z axis
MAX_GRID_Z = 65535
# the backward's kernels, in launch order: D, the dK/dV and dQ tiles (one
# launch), and "sum" (each gradient element's f32 partials added in order),
# which runs only where the tile blocks write partials (bwd_plan)
BWD_KERNELS = ("dot", "tiles", "sum")

# Launches since the last reset (chip_smoke.py reads and resets them):
# ``launches``, one ``flash_fwd_kernel`` (f32) or ``flash_fwd_kernel_wgmma``
# (bf16) per forward call; ``bwd_launches``, ``bwd_plan(...)["launches"]``
# per backward call, one for each kernel of BWD_KERNELS it launches.
launches = 0
bwd_launches = 0
# f32 operands the wrappers copied because their base or strides are off 16
# bytes (the model's own calls take none; chip_smoke.py checks that)
copies = 0


def bwd_plan(dtype: torch.dtype, B: int, Sq: int, Skv: int, H: int, K: int, hd: int) -> dict:
    """The backward's plan on the current CUDA card: ``splits``, the blocks
    each tile of its grid takes (more than 1 only where the grid would fill
    under half the card's block slots), ``scratch_floats``, the f32 scratch
    its C entry carves (lse and D rows, the partials), and ``launches``: 3,
    or 2 where G = H / K and splits are both 1 (no sum pass)."""
    out = (ctypes.c_longlong * 3)()
    build.check(build.library().g4r_flash_attn_bwd_plan(_DTYPES[dtype], B, Sq, Skv, H, K, hd,
                                                         out),
                "flash_attention backward plan")
    return {"splits": out[0], "scratch_floats": out[1], "launches": out[2]}


def _aligned16(t: torch.Tensor) -> bool:
    """Base address and (batch, seq, head) strides multiples of 16 bytes."""
    return t.data_ptr() % TMA_ALIGN == 0 and all(
        s * t.element_size() % TMA_ALIGN == 0 for s in t.stride()[:3])


def _check_tma(name: str, t: torch.Tensor) -> None:
    bad = [s * t.element_size() for s in t.stride()[:3] if s * t.element_size() % TMA_ALIGN]
    if bad or t.data_ptr() % TMA_ALIGN:
        raise ValueError(
            f"flash_attention's bf16 kernel loads {name} by TMA, which takes strides and a "
            f"base address that are multiples of {TMA_ALIGN} bytes; got strides "
            f"{[s * t.element_size() for s in t.stride()]} bytes and base address "
            f"{t.data_ptr():#x}")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
               what: str = "flash_attention") -> None:
    """The shape, dtype, layout and device checks the kernels share."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what} wants 4-d q, k, v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if K == 0 or H % K != 0:
        raise ValueError(f"{what}: {H} query heads over {K} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS}; got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1 or None; got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes f32 or bf16, one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what} kernel wants the head_dim axis contiguous")
    if Sq >= 2**31 or Skv >= 2**31 or B > 65535 or H > 65535:
        raise ValueError(f"{what} kernel takes Sq, Skv < 2**31 and B, H <= 65535; "
                         f"got {tuple(q.shape)}, Skv={Skv}")


def _on_one_card(what: str, *ts: torch.Tensor) -> None:
    if not (ts[0].is_cuda and all(t.device == ts[0].device for t in ts)):
        raise ValueError(f"{what} kernel wants its tensors on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")


def _aligned_f32(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The f32 kernels copy 16 bytes at a time: each tensor as it is where
    its base and strides are 16-byte multiples, else a contiguous copy
    (counted in ``copies``)."""
    global copies
    out = tuple(t if _aligned16(t) else t.clone(memory_format=torch.contiguous_format)
                for t in ts)
    copies += sum(a is not t for a, t in zip(out, ts))
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         with_lse: bool = False
                         ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd) on one CUDA device,
    one dtype, innermost stride 1 -> (B, Sq, H, hd) contiguous, q's dtype;
    with ``with_lse`` also each row's log-sum-exp, (B, H, Sq) f32 (the
    kernel stores it only when asked)."""
    global launches
    _check_qkv(q, k, v, window)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if -(-Sq // BLOCK_Q) > MAX_GRID_Z:
        raise ValueError(f"flash_attention's kernels take Sq <= {BLOCK_Q * MAX_GRID_Z}; "
                         f"got {Sq}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    _on_one_card("flash_attention", q, k, v)
    if q.dtype == torch.float32:
        q, k, v = _aligned_f32(q, k, v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if B == 0 or Sq == 0 or H == 0:
        return (out, lse) if with_lse else out
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv == 0)")
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.g4r_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype],
            B, Sq, Skv, H, K, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 1.0 / math.sqrt(hd), int(bool(causal)),
            0 if window is None else int(window), stream)
    build.check(err, "flash_attention")
    launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True, window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention's gradient: q, k, v as the forward took them, its
    output ``o`` and ``lse`` (B, H, Sq) f32, and ``do`` shaped like ``o``
    (innermost stride 1, any other strides) -> (dq, dk, dv), contiguous, in
    q's dtype."""
    global bwd_launches
    _check_qkv(q, k, v, window, "flash_attention backward")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.stride(3) != 1:
            raise ValueError(f"flash_attention backward: {name} {tuple(t.shape)} {t.dtype} "
                             f"(innermost stride {t.stride(3)}) does not fit q "
                             f"{tuple(q.shape)} {q.dtype} with a contiguous head_dim")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward: lse must be a contiguous (B, H, Sq) = "
                         f"{(B, H, Sq)} f32 tensor; got {tuple(lse.shape)} {lse.dtype}")
    _on_one_card("flash_attention backward", q, k, v, o, lse, do)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Skv, K, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if B == 0 or Sq == 0 or H == 0:
        return dq, dk.zero_(), dv.zero_()
    if Skv == 0:
        raise ValueError("flash_attention backward: no keys (Skv == 0)")
    if q.dtype == torch.float32:
        q, k, v, do = _aligned_f32(q, k, v, do)
    strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *o.stride()[:3], *do.stride()[:3])
    lib = build.library()
    with torch.cuda.device(q.device):
        plan = bwd_plan(q.dtype, B, Sq, Skv, H, K, hd)
        dd = torch.empty(plan["scratch_floats"], dtype=torch.float32, device=q.device)
        err = lib.g4r_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, H, K, hd, strides, 1.0 / math.sqrt(hd),
            int(bool(causal)), 0 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention backward")
    bwd_launches += plan["launches"]
    return dq, dk, dv


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


def bwd_kernel_attrs(dtype: torch.dtype, hd: int) -> dict:
    """``kernel_attrs`` of each of the backward's kernels for (dtype, hd),
    by the names of BWD_KERNELS."""
    out = {}
    for which, name in enumerate(BWD_KERNELS):
        a = (ctypes.c_int * 3)()
        build.check(build.library().g4r_flash_attn_bwd_attrs(_DTYPES[dtype], hd, which, a),
                    "flash_attention backward attributes")
        out[name] = {"registers": a[0], "local_bytes": a[1], "shared_bytes": a[2]}
    return out
