"""Dispatcher for the port's kernels: the device decides the path.

A CUDA tensor launches the hand-written kernel (``seg_aggr``, ``topk``) or
raises: a build or launch failure is never caught to run the plain version
instead. A CPU tensor runs the plain PyTorch version in ``kernels/ref``,
which is what the CPU tests exercise. Any other device raises.

``repro``'s opt-in flags (``HeteroGNNConfig.use_kernel_aggr``,
``Graph4RecConfig.use_kernel_loss``) are kept in the port's config classes
so configs stay interchangeable, but they select nothing here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.seg_aggr import seg_aggr_cuda
from repro_torch.kernels.topk import streaming_topk_cuda


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def seg_aggr(x: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """(N, F, D), (N, F) -> (N, D) masked segment aggregation."""
    if _route(x, "seg_aggr"):
        return seg_aggr_cuda(x, mask, mode)
    return ref.seg_aggr_ref(x, mask, mode)


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
