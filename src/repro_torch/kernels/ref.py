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
