"""Contrastive objectives (Eq. 2) and in-batch negative sampling (§3.6).

The port of ``repro.core.loss``. Eq. 2 (skip-gram with negative sampling):

    L = -log σ(y_vu) - Σ_m E_{w~P}[log σ(-y_{w u})],   y_vu = h_vᵀ h_u

In-batch variant: within a batch of P positive pairs, every other dst in the
batch serves as a negative for each src — a P×P score matrix with a
softmax-CE on the diagonal. ``inbatch_softmax_loss`` always goes through
``kernels.ops.inbatch_loss`` (the ``inbatch_loss`` kernel on the card, its
plain version on the CPU); ``use_kernel`` is kept for ``repro``'s signature
and selects nothing. The other two objectives are plain torch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def neg_sampling_loss(
    h_src: torch.Tensor,  # (P, d)
    h_dst: torch.Tensor,  # (P, d)
    h_neg: torch.Tensor,  # (P, M, d)
) -> torch.Tensor:
    """Eq. 2 with explicit random negatives."""
    pos = torch.einsum("pd,pd->p", h_src, h_dst)
    neg = torch.einsum("pd,pmd->pm", h_src, h_neg)
    return -F.logsigmoid(pos).mean() - F.logsigmoid(-neg).sum(dim=-1).mean()


def inbatch_softmax_loss(
    h_src: torch.Tensor,  # (P, d)
    h_dst: torch.Tensor,  # (P, d)
    temperature: float = 1.0,
    use_kernel: bool = False,
) -> torch.Tensor:
    """In-batch negatives: maximize diag scores vs the rest of the batch."""
    del use_kernel  # the device decides (kernels/ops.py)
    return ops.inbatch_loss(h_src, h_dst, temperature)


def inbatch_sigmoid_loss(
    h_src: torch.Tensor, h_dst: torch.Tensor, num_negatives: int = 5,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Eq. 2 shape with negatives drawn from the batch (paper's described
    variant: 'minimizing the scores of other nodes in a batch').

    ``generator=None`` takes the deterministic stride-based negatives, the
    branch ``repro`` shares (its ``key=None``); a ``torch.Generator`` draws
    them at random instead (``repro``'s ``key`` branch, other numbers).
    """
    P = h_src.shape[0]
    dev = h_src.device
    pos = torch.einsum("pd,pd->p", h_src, h_dst)
    if generator is None:
        idx = (torch.arange(P, device=dev)[:, None]
               + torch.arange(1, num_negatives + 1, device=dev)[None, :]) % P
    else:
        idx = torch.randint(0, P, (P, num_negatives), generator=generator,
                            device=generator.device).to(dev)
    neg = torch.einsum("pd,pmd->pm", h_src, h_dst[idx])
    return -F.logsigmoid(pos).mean() - F.logsigmoid(-neg).sum(dim=-1).mean()
