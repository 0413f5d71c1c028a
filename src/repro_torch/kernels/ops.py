"""Dispatcher for the port's kernels: the device decides the path.

A CUDA tensor launches the hand-written kernel (``seg_aggr`` and its
backward, ``topk``, ``inbatch_loss``, ``row_adagrad``, ``window_pairs``,
``ivf_list_topk``, ``flash_attention``) or raises: a build or launch failure is never caught to
run the plain version instead. A CPU
tensor runs the plain PyTorch version in ``kernels/ref``, which is what the
CPU tests exercise. Any other device raises.

``seg_aggr``, ``inbatch_loss`` and ``flash_attention`` are
``torch.autograd.Function``s on both devices, so the CPU tests drive the very functions the card runs. The
backwards of ``seg_aggr`` and ``flash_attention`` are kernels (the latter
from the forward's output and row log-sum-exp, which its forward saves on
both devices when an input needs a gradient, and skips otherwise, as in
the prefill); that of ``inbatch_loss`` is the closed
form ``(softmax - I) g / (P t)`` in plain tensor ops, as ``repro`` computes
it in jnp outside its kernel (``repro/kernels/ops.py:_inbatch_bwd``).

``repro``'s opt-in flags (``HeteroGNNConfig.use_kernel_aggr``,
``Graph4RecConfig.use_kernel_loss``, ``TrainerConfig.use_kernel_rowopt``,
``TrainerConfig.fused_use_kernel_pairs``, ``IVFConfig.backend``)
are kept in the port's config classes so configs stay interchangeable, but
they select nothing here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attn import flash_attention_bwd_cuda, flash_attention_cuda
from repro_torch.kernels.inbatch_loss import inbatch_loss_rows_cuda
from repro_torch.kernels.ivf import ivf_list_topk_cuda
from repro_torch.kernels.row_adagrad import row_adagrad_scatter_cuda
from repro_torch.kernels.seg_aggr import seg_aggr_bwd_cuda, seg_aggr_cuda
from repro_torch.kernels.topk import streaming_topk_cuda
from repro_torch.kernels.window_pairs import window_pair_ids_cuda


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


# ------------------------------------------------------------------ seg_aggr
class _SegAggr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, mode):
        ctx.mode = mode
        ctx.save_for_backward(mask)
        if _route(x, "seg_aggr"):
            return seg_aggr_cuda(x, mask, mode)
        return ref.seg_aggr_ref(x, mask, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        # a dense (N, F, D) gradient; autograd scatters it into the base of
        # a strided input view
        return seg_aggr_bwd(g.contiguous(), mask, ctx.mode), None, None


def seg_aggr(x: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """(N, F, D), (N, F) -> (N, D) masked segment aggregation, differentiable
    in ``x`` for ``sum`` and ``mean``."""
    return _SegAggr.apply(x, mask, mode)


def seg_aggr_bwd(g: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """(N, D) output gradient, (N, F) mask -> (N, F, D) input gradient."""
    if mode == "max":
        raise NotImplementedError(
            "seg_aggr 'max' has no backward: nothing calls it in training "
            "(ROADMAP Queue 2, B1 max backward)"
        )
    if _route(g, "seg_aggr backward"):
        return seg_aggr_bwd_cuda(g, mask, mode)
    return ref.seg_aggr_bwd_ref(g, mask, mode)


# -------------------------------------------------------------- inbatch loss
def inbatch_loss_rows(h_src: torch.Tensor, h_dst: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """(P, d), (P, d) -> (P,) in-batch softmax cross-entropy rows."""
    if _route(h_src, "inbatch_loss"):
        return inbatch_loss_rows_cuda(h_src.contiguous(), h_dst.contiguous(), temperature)
    return ref.inbatch_loss_rows_ref(h_src, h_dst, temperature)


class _InbatchLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_src, h_dst, temperature):
        ctx.temperature = temperature
        ctx.save_for_backward(h_src, h_dst)
        return inbatch_loss_rows(h_src, h_dst, temperature).mean()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h_src, h_dst = ctx.saved_tensors
        t = ctx.temperature
        P = h_src.shape[0]
        logits = (h_src @ h_dst.T) / t
        soft = torch.softmax(logits, dim=-1)
        eye = torch.eye(P, dtype=soft.dtype, device=soft.device)
        dlogits = (soft - eye) * (g / (P * t))
        return dlogits @ h_dst, dlogits.T @ h_src, None


def inbatch_loss(h_src: torch.Tensor, h_dst: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """Mean in-batch softmax cross-entropy with diagonal positives -> scalar."""
    return _InbatchLoss.apply(h_src, h_dst, float(temperature))


# ------------------------------------------------------------- row adagrad
def rowwise_adagrad_scatter(
    table: torch.Tensor,
    accum: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    lr: float = 0.1,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise AdaGrad on the rows ``ids`` names, IN PLACE on ``table`` and
    ``accum`` (PAD slots skipped); returns the two, updated."""
    with torch.no_grad():
        if _route(table, "rowwise_adagrad_scatter"):
            row_adagrad_scatter_cuda(table, accum, ids, grads.contiguous(), lr, eps)
        else:
            ref.row_adagrad_scatter_ref(table, accum, ids, grads, lr, eps)
    return table, accum


# ----------------------------------------------------------------- retrieval
def streaming_topk(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    exclude: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k MIPS -> ((Q, k) f32 scores, (Q, k) int32 ids)."""
    if _route(queries, "streaming_topk"):
        return streaming_topk_cuda(queries, items, k, exclude)
    return ref.chunked_topk_ref(queries, items, k, exclude)


def ivf_list_topk(
    queries: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    lpad: int,
    shortlist: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF gather-then-score over CSR inverted lists -> ((Q, S) f32 approx
    scores, (Q, S) int32 packed-row indices, -1 for empty slots); on equal
    scores the lower flat (probe, offset) index wins."""
    if _route(queries, "ivf_list_topk"):
        return ivf_list_topk_cuda(
            queries.contiguous(), codes.contiguous(), scales.contiguous(),
            starts.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous(),
            lpad, shortlist)
    return ref.ivf_list_topk_ref(queries, codes, scales, starts, lengths, lpad=lpad,
                                 shortlist=shortlist)


# -------------------------------------------------------------- window pairs
def window_pair_ids(paths: torch.Tensor,
                    positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) walk paths, (npos, 2) (src_col, dst_col) table on the same
    device -> ((B, npos) int32 src, (B, npos) int32 dst); pairs touching a
    PAD node come back with BOTH sides PAD."""
    if _route(paths, "window_pair_ids"):
        return window_pair_ids_cuda(paths.to(torch.int32).contiguous(),
                                    positions.to(torch.int32).contiguous())
    return ref.window_pair_ids_ref(paths, positions)


# ----------------------------------------------------------------- attention
class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        # the row LSE only where a backward will follow: the prefill stores none
        if not any(ctx.needs_input_grad[:3]):
            if _route(q, "flash_attention"):
                return flash_attention_cuda(q, k, v, causal, window)
            return ref.attention_ref(q, k, v, causal, window)
        if _route(q, "flash_attention"):
            out, lse = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        else:
            out, lse = ref.attention_fwd_ref(q, k, v, causal, window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=None):
    """The attention's gradient from the forward's inputs, output and row
    log-sum-exp -> (dq, dk, dv): the backward kernel on CUDA (``do`` made
    contiguous only where its head_dim is not), ``attention_bwd_ref`` on
    the CPU."""
    if _route(q, "flash_attention backward"):
        if do.stride(-1) != 1:
            do = do.contiguous()
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window)
    return ref.attention_bwd_ref(q, k, v, o, lse, do, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """GQA attention in the model's layout: (B, Sq, H, hd) queries against
    (B, Skv, K, hd) keys and values -> (B, Sq, H, hd), causal and/or with a
    sliding window, f32 softmax. Any Sq, Skv (``repro``'s Pallas kernel
    asserts ``Sq % block_q == 0``; that is a TPU tiling limit)."""
    return _FlashAttention.apply(q, k, v, bool(causal), window)
