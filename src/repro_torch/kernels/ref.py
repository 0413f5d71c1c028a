"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in plain tensor ops.
The CPU path of ``kernels.ops`` runs them, the CPU tests hold them against
``repro``'s JAX oracles, and ``chip_smoke.py`` holds each kernel against
them on the card. On a card nothing else calls them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


# ------------------------------------------------------------------ seg_aggr
def seg_aggr_ref(
    x: torch.Tensor,  # (N, F, D) neighbor features
    mask: torch.Tensor,  # (N, F) bool validity
    mode: str = "mean",
) -> torch.Tensor:
    """Masked segment aggregation over the neighbor axis -> (N, D).

    Mirrors ``repro/kernels/ref.py:seg_aggr_ref``: ``mean`` divides by
    max(count, 1) and ``max`` gives 0 on rows with no valid entry.
    """
    m = mask[..., None].to(x.dtype)
    if mode == "sum":
        return (x * m).sum(dim=1)
    if mode == "mean":
        s = (x * m).sum(dim=1)
        c = torch.clamp(m.sum(dim=1), min=1.0)
        return s / c
    if mode == "max":
        neg = torch.where(mask[..., None], x, torch.full_like(x, NEG_INF))
        out = neg.amax(dim=1)
        any_valid = mask.any(dim=1, keepdim=True)
        return torch.where(any_valid, out, torch.zeros_like(out))
    raise ValueError(mode)


def seg_aggr_bwd_ref(
    g: torch.Tensor,  # (N, D) gradient of the output
    mask: torch.Tensor,  # (N, F) bool validity
    mode: str = "mean",
) -> torch.Tensor:
    """The input gradient of ``seg_aggr_ref`` -> dense (N, F, D).

    ``sum``: mask * g; ``mean``: (g / max(count, 1)) * mask, in the order
    autodiff of the forward multiplies. No gradient reaches the mask.
    ``max`` has no backward (it has no caller; ROADMAP Queue 2, B1).
    """
    m = mask[..., None].to(g.dtype)
    if mode == "sum":
        return g[:, None, :] * m
    if mode == "mean":
        c = torch.clamp(m.sum(dim=1), min=1.0)  # (N, 1)
        return (g / c)[:, None, :] * m
    if mode == "max":
        raise NotImplementedError(
            "seg_aggr 'max' has no backward: nothing calls it in training "
            "(ROADMAP Queue 2, B1 max backward)"
        )
    raise ValueError(mode)


# -------------------------------------------------------------- inbatch loss
def inbatch_loss_rows_ref(
    h_src: torch.Tensor, h_dst: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """Per-row in-batch softmax CE with diagonal positives -> (P,).

    Mirrors ``repro/kernels/ref.py:inbatch_loss_rows_ref``.
    """
    logits = (h_src @ h_dst.T).to(torch.float32) / temperature
    labels = torch.arange(h_src.shape[0], device=h_src.device)
    return torch.logsumexp(logits, dim=-1) - logits[labels, labels]


# ------------------------------------------------------------- row adagrad
def row_adagrad_scatter_ref(
    table: torch.Tensor,  # (N, D), updated in place
    accum: torch.Tensor,  # (N, 1), updated in place
    ids: torch.Tensor,  # (B,) int; PADs (-1) allowed, real ids distinct
    grads: torch.Tensor,  # (B, D)
    lr: float = 0.1,
    eps: float = 1e-8,
) -> None:
    """Gather -> row-wise AdaGrad -> scatter, in place; PAD slots dropped.

    The rule of ``repro/kernels/ref.py:row_adagrad_scatter_ref``; ids at or
    past N are dropped too, as its ``mode="drop"`` scatter drops them.
    """
    keep = torch.nonzero((ids >= 0) & (ids < table.shape[0])).squeeze(1)
    rows, g = ids[keep], grads[keep]
    acc = accum[rows] + (g * g).mean(dim=-1, keepdim=True)
    table[rows] = table[rows] - lr * g / (torch.sqrt(acc) + eps)
    accum[rows] = acc


# -------------------------------------------------------------- window pairs
def window_pair_ids_ref(
    paths: torch.Tensor,  # (B, L) int paths, PAD = -1
    positions: torch.Tensor,  # (npos, 2) int (src_col, dst_col) table
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Skip-gram pair gather -> ((B, npos) int32 src, (B, npos) int32 dst).

    Mirrors ``repro/kernels/ref.py:window_pair_ids_ref``: both ids are PAD
    wherever either endpoint is PAD.
    """
    pos = positions.to(device=paths.device, dtype=torch.int64).reshape(-1, 2)
    paths = paths.to(torch.int32)
    src, dst = paths[:, pos[:, 0]], paths[:, pos[:, 1]]
    valid = (src != -1) & (dst != -1)
    pad = torch.full_like(src, -1)
    return torch.where(valid, src, pad), torch.where(valid, dst, pad)


# ----------------------------------------------------------------- topk MIPS
def chunked_topk_ref(
    queries: torch.Tensor,  # (Q, d)
    items: torch.Tensor,  # (I, d)
    k: int,
    exclude: Optional[torch.Tensor] = None,  # (Q, E) int, -1 padded
    item_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k MIPS -> ((Q, k) f32 scores, (Q, k) int32 ids).

    The merge rule of ``repro/retrieval/topk.py``: per item chunk, a stable
    descending sort over ``[running best | chunk]`` keeps k. Running entries
    hold smaller ids and ids ascend inside a chunk, so on equal scores the
    lower id wins (``torch.topk`` promises no order among ties). Excluded
    ids score -inf, and slots no surviving item fills are (-inf, -1).
    """
    Q, I = queries.shape[0], items.shape[0]
    if not 0 < k <= I:
        raise ValueError(f"k={k} must be in [1, num_items={I}]")
    if item_chunk <= 0:
        raise ValueError(f"item_chunk must be positive, got {item_chunk}")
    dev = queries.device
    q = queries.to(torch.float32)
    best_s = torch.full((Q, k), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    for lo in range(0, I, item_chunk):
        hi = min(lo + item_chunk, I)
        s = q @ items[lo:hi].to(torch.float32).T  # (Q, hi - lo)
        gid = torch.arange(lo, hi, device=dev)
        if exclude is not None:
            # excluded ids this chunk owns -> -inf; the rest land in a spare
            # column that is cut off (O(Q*E), not an O(Q*E*chunk) compare)
            ex = exclude.to(torch.int64)
            col = torch.where((ex >= lo) & (ex < hi), ex - lo, hi - lo)
            hit = torch.zeros((Q, hi - lo + 1), dtype=torch.bool, device=dev)
            hit.scatter_(1, col, True)
            s = s.masked_fill(hit[:, : hi - lo], float("-inf"))
        all_s = torch.cat([best_s, s], dim=1)
        all_i = torch.cat([best_i, gid.expand(Q, -1)], dim=1)
        order = torch.sort(all_s, dim=1, descending=True, stable=True).indices[:, :k]
        best_s = torch.gather(all_s, 1, order)
        best_i = torch.gather(all_i, 1, order)
    best_i = torch.where(torch.isneginf(best_s), torch.full_like(best_i, -1), best_i)
    return best_s, best_i.to(torch.int32)
