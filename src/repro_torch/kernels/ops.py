"""Dispatcher for the port's kernels: the device decides the path.

A CUDA tensor launches the hand-written kernel (``seg_aggr`` and its
backward, ``topk``, ``inbatch_loss``, ``row_adagrad``, ``window_pairs``
and the pair stage's ``window_pair_draw``, ``ivf_list_topk``,
``flash_attention``) or raises: a build or launch failure is never caught to
run the plain version instead. A CPU
tensor runs the plain PyTorch version in ``kernels/ref``, which is what the
CPU tests exercise. Any other device raises.

``seg_aggr`` and ``inbatch_loss`` are ``torch.autograd.Function``s on both
devices, and ``flash_attention`` a custom operator with its autograd
registered, so the CPU tests drive the very functions the card runs. The
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

import sys
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attn import (band_pairs, flash_attention_bwd_cuda,
                                            flash_attention_cuda)
from repro_torch.kernels.inbatch_loss import inbatch_loss_rows_cuda
from repro_torch.kernels.ivf import ivf_list_topk_cuda
from repro_torch.kernels.row_adagrad import row_adagrad_scatter_cuda
from repro_torch.kernels.seg_aggr import seg_aggr_bwd_cuda, seg_aggr_cuda
from repro_torch.kernels.topk import streaming_topk_cuda
from repro_torch.kernels.window_pairs import window_pair_draw_cuda, window_pair_ids_cuda


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
        # max routes the gradient by x's maxima; sum and mean need the mask only
        ctx.save_for_backward(*((mask, x) if mode == "max" else (mask,)))
        if _route(x, "seg_aggr"):
            return seg_aggr_cuda(x, mask, mode)
        return ref.seg_aggr_ref(x, mask, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mask, *x = ctx.saved_tensors
        # a dense (N, F, D) gradient; autograd scatters it into the base of
        # a strided input view
        return seg_aggr_bwd(g.contiguous(), mask, ctx.mode, *x), None, None


def seg_aggr(x: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """(N, F, D), (N, F) -> (N, D) masked segment aggregation, differentiable
    in ``x``."""
    return _SegAggr.apply(x, mask, mode)


def seg_aggr_bwd(g: torch.Tensor, mask: torch.Tensor, mode: str = "mean",
                 x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, D) output gradient, (N, F) mask -> (N, F, D) input gradient;
    ``max`` also takes the forward's input ``x``."""
    if _route(g, "seg_aggr backward"):
        return seg_aggr_bwd_cuda(g, mask, mode, x)
    return ref.seg_aggr_bwd_ref(g, mask, mode, x)


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


def window_pair_draw(paths: torch.Tensor, positions: torch.Tensor, spos: torch.Tensor,
                     dpos: torch.Tensor, sel: torch.Tensor,
                     walk_len: int) -> Tuple[torch.Tensor, ...]:
    """The fused sampler's pair stage: (B, L) int64 walks, the (npos, 2)
    int32 window table and its (npos,) int64 columns, (P,) int64 draw bits
    -> (src, dst, src_sel, dst_sel) (P,) int64 and the 0-d bool
    ``all_dead`` (``ref.window_pair_draw_ref``): one launch on the card."""
    if _route(paths, "window_pair_draw"):
        return window_pair_draw_cuda(paths, positions, spos, dpos, sel, walk_len)
    return ref.window_pair_draw_ref(paths, positions, spos, dpos, sel, walk_len)


# ----------------------------------------------------------------- attention
# The attention's forward (without and with the row LSE) and its backward
# are custom operators of the ``g4r`` namespace. One implementation serves
# real tensors of either device and routes by it, as every kernel here does:
# a CUDA tensor launches the kernel through this module's
# ``flash_attention_cuda`` / ``flash_attention_bwd_cuda``, looked up at the
# call, a CPU tensor runs the plain version. A fake tensor never reaches it:
# it takes the shape function (``register_fake``), which launches nothing,
# so a model traces on fake CUDA tensors (the launch tools' dry run); a
# plain meta tensor raises there, as it did before. The FLOP formulas
# (``register_flop_formula``) count the band's (query, key) pairs, 4 hd
# each forward and 10 hd backward.
@torch.library.custom_op("g4r::flash_attention", mutates_args=())
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    if _route(q, "flash_attention"):
        return flash_attention_cuda(q, k, v, causal, window)
    # contiguous, as the shape function (and so DTensor) lays the output out
    return ref.attention_ref(q, k, v, causal, window).contiguous()


@torch.library.custom_op("g4r::flash_attention_lse", mutates_args=())
def _flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    if _route(q, "flash_attention"):
        return flash_attention_cuda(q, k, v, causal, window, with_lse=True)
    return tuple(t.contiguous() for t in ref.attention_fwd_ref(q, k, v, causal, window))


@torch.library.custom_op("g4r::flash_attention_bwd", mutates_args=())
def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               lse: torch.Tensor, do: torch.Tensor, causal: bool,
               window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if _route(q, "flash_attention backward"):
        if do.stride(-1) != 1:
            do = do.contiguous()
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window)
    return tuple(t.contiguous() for t in ref.attention_bwd_ref(q, k, v, o, lse, do, causal,
                                                               window))


def _one_device(what: str, *ts: torch.Tensor) -> None:
    """The shape function's checks: fake tensors (a plain meta tensor has
    no kernel or plain version, as before) on one device."""
    if not isinstance(ts[0], FakeTensor):
        _route(ts[0], what)
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: tensors on one device, got {[str(t.device) for t in ts]}")


@_flash_fwd.register_fake
def _(q, k, v, causal, window):
    _one_device("flash_attention", q, k, v)
    return q.new_empty(q.shape)


@_flash_fwd_lse.register_fake
def _(q, k, v, causal, window):
    _one_device("flash_attention", q, k, v)
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


@_flash_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window):
    _one_device("flash_attention backward", q, k, v, o, lse, do)
    return q.new_empty(q.shape), k.new_empty(k.shape), k.new_empty(k.shape)


def _flash_save(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.causal, ctx.window = causal, window
    ctx.save_for_backward(q, k, v, *output)


def _flash_grad(ctx, g, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    # through the module attribute, so that a wrapper set on it sees the call
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal, ctx.window)
    return dq, dk, dv, None, None


_flash_fwd_lse.register_autograd(_flash_grad, setup_context=_flash_save)


@register_flop_formula([torch.ops.g4r.flash_attention, torch.ops.g4r.flash_attention_lse])
def _flash_fwd_flops(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return 4 * hd * B * H * band_pairs(Sq, k_shape[1], causal, window)


@register_flop_formula(torch.ops.g4r.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal, window,
                     *args, **kwargs) -> int:
    B, Sq, H, hd = q_shape
    return 10 * hd * B * H * band_pairs(Sq, k_shape[1], causal, window)


# DTensor sharding strategies of the three ops (a mesh of several devices,
# ``models/sharding.py``): each rank runs the op on its local shards, so a
# CUDA shard launches the same kernel through ``flash_attention_cuda`` /
# ``flash_attention_bwd_cuda`` above. Legal on each mesh dim: every tensor
# replicated; the batch (dim 0 of q, k, v, o, dO and the LSE) sharded; the
# heads (dim 2, the LSE's dim 1) sharded where H and K both divide by the
# product of the mesh dims that shard them, so each rank's query heads keep
# their own KV heads. A sequence shard is not legal (the kernel takes the
# whole sequence of each row): DTensor gathers it before the call.
_SHARDING = {"registered": False}


def _heads_divide(q_shape, k_shape, mesh, placements) -> bool:
    n = 1
    for i, p in enumerate(placements):
        if p.is_shard(2):
            n *= mesh.size(i)
    return q_shape[2] % n == 0 and k_shape[2] % n == 0


def register_flash_sharding() -> None:
    """Register the strategies with DTensor (once; at the first DTensor
    that reaches a flash op, so that importing this module does not import
    ``torch.distributed``)."""
    if _SHARDING["registered"]:
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R, B, H, L = Replicate(), Shard(0), Shard(2), Shard(1)

    def heads_ok(q, k) -> bool:
        return all(q.shape[2] % n == 0 and k.shape[2] % n == 0 for n in q.mesh.shape)

    def fwd(q, k, v, causal, window):
        out = [([R], [R, R, R, None, None]), ([B], [B, B, B, None, None])]
        if heads_ok(q, k):
            out.append(([H], [H, H, H, None, None]))
        return out

    def fwd_lse(q, k, v, causal, window):
        out = [([R, R], [R, R, R, None, None]), ([B, B], [B, B, B, None, None])]
        if heads_ok(q, k):
            out.append(([H, L], [H, H, H, None, None]))
        return out

    def bwd(q, k, v, o, lse, do, causal, window):
        out = [([R] * 3, [R] * 6 + [None, None]), ([B] * 3, [B] * 6 + [None, None])]
        if heads_ok(q, k):
            out.append(([H] * 3, [H, H, H, H, L, H, None, None]))
        return out

    ops_ = {torch.ops.g4r.flash_attention.default: fwd,
            torch.ops.g4r.flash_attention_lse.default: fwd_lse,
            torch.ops.g4r.flash_attention_bwd.default: bwd}
    prop = DTensor._op_dispatcher.sharding_propagator
    for op, fn in ops_.items():
        register_sharding(op)(fn)
        # the strategies are expanded over every combination of mesh dims;
        # keep the combinations whose head shards hold whole KV groups
        funcs = getattr(prop, "op_strategy_funcs", None)
        if funcs is None or op not in funcs:
            continue

        def whole_groups(op_schema, expand=funcs[op]):
            st = expand(op_schema)
            q_shape = op_schema.args_schema[0].shape
            k_shape = op_schema.args_schema[1].shape
            st.strategies = [s for s in st.strategies if _heads_divide(
                q_shape, k_shape, s.input_specs[0].mesh, s.input_specs[0].placements)]
            return st

        funcs[op] = whole_groups
    _SHARDING["registered"] = True


def _on_mesh(*ts: torch.Tensor) -> None:
    """Register the sharding strategies where a DTensor reaches a flash op."""
    if not _SHARDING["registered"]:
        mod = sys.modules.get("torch.distributed.tensor")
        if mod is not None and any(isinstance(t, mod.DTensor) for t in ts):
            register_flash_sharding()


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=None):
    """The attention's gradient from the forward's inputs, output and row
    log-sum-exp -> (dq, dk, dv): the backward kernel on CUDA (``do`` made
    contiguous only where its head_dim is not), ``attention_bwd_ref`` on
    the CPU; on DTensors each rank's shards by the sharding strategies."""
    _on_mesh(q)
    return _flash_bwd(q, k, v, o, lse, do, bool(causal), window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """GQA attention in the model's layout: (B, Sq, H, hd) queries against
    (B, Skv, K, hd) keys and values -> (B, Sq, H, hd), causal and/or with a
    sliding window, f32 softmax. Any Sq, Skv (``repro``'s Pallas kernel
    asserts ``Sq % block_q == 0``; that is a TPU tiling limit). The row LSE
    is computed (and saved, with the inputs and output, for the backward)
    only where a gradient will follow: the prefill stores none. On DTensors
    each rank runs it on its shards (the sharding strategies above)."""
    _on_mesh(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _flash_fwd_lse(q, k, v, bool(causal), window)[0]
    return _flash_fwd(q, k, v, bool(causal), window)
