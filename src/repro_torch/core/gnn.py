"""GNN zoo (Graph4Rec §3.5): per-relation message-passing layers, forward only.

The PyTorch port of ``repro.core.gnn``. Every layer implements Eq. 1's
AGGREGATE/COMBINE over the dense ego layout (sampling/ego.py): self
representations ``h_self`` (B, W, d), the sampled neighbours of ONE relation
``h_nbr`` (B, W, F, d) and a validity mask (B, W, F) give the relation-wise
output (B, W, d). The relation mixture, residual and attention live one
level up in core/hetero.py.

    gcn        mean(nbr ∪ self) -> W -> relu
    sage-mean  [self ‖ mean(nbr)] -> W -> relu
    sage-sum   [self ‖ sum(nbr)]  -> W -> relu
    gat        masked softmax attention over nbr -> W
    gin        MLP((1+eps)·self + sum(nbr))
    lightgcn   mean(nbr), no transform, no nonlinearity
    ngcf       W1(self+mean) + W2(mean(nbr⊙self)), leaky relu

``masked_mean`` and ``masked_sum`` go through ``kernels.ops.seg_aggr``: the
CUDA kernel for tensors on the card, its plain version on the CPU. The
``use_kernel`` argument of ``repro`` is gone; the device decides.
Parameters are plain dicts of tensors under ``repro``'s names.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

GNN_TYPES = ("gcn", "sage-mean", "sage-sum", "gat", "gin", "lightgcn", "ngcf")


def _aggr(h_nbr: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    B, W, Fo, d = h_nbr.shape
    out = ops.seg_aggr(h_nbr.reshape(B * W, Fo, d), mask.reshape(B * W, Fo), mode)
    return out.reshape(B, W, d)


def masked_mean(h_nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B,W,F,d),(B,W,F) -> (B,W,d); zero where no valid neighbour."""
    return _aggr(h_nbr, mask, "mean")


def masked_sum(h_nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _aggr(h_nbr, mask, "sum")


# ------------------------------------------------------------------- layers
def _dense(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return torch.randn((d_in, d_out), generator=gen) * scale


def init_layer(gen: torch.Generator, gnn_type: str, dim: int) -> Params:
    """One layer's weights: ``repro``'s shapes and scales, torch's draws."""
    if gnn_type == "lightgcn":
        return {}  # parameter-free by design
    if gnn_type == "gcn":
        return {"w": _dense(gen, dim, dim)}
    if gnn_type in ("sage-mean", "sage-sum"):
        return {"w": _dense(gen, 2 * dim, dim)}
    if gnn_type == "gat":
        return {
            "w": _dense(gen, dim, dim),
            "a_self": torch.randn((dim,), generator=gen) * 0.1,
            "a_nbr": torch.randn((dim,), generator=gen) * 0.1,
        }
    if gnn_type == "gin":
        return {
            "eps": torch.zeros(()),
            "w1": _dense(gen, dim, dim),
            "w2": _dense(gen, dim, dim),
        }
    if gnn_type == "ngcf":
        return {"w1": _dense(gen, dim, dim), "w2": _dense(gen, dim, dim)}
    raise ValueError(f"unknown gnn type {gnn_type!r}; choose from {GNN_TYPES}")


def apply_layer(
    params: Params,
    gnn_type: str,
    h_self: torch.Tensor,  # (B, W, d)
    h_nbr: torch.Tensor,  # (B, W, F, d)
    mask: torch.Tensor,  # (B, W, F) bool
) -> torch.Tensor:
    if gnn_type == "lightgcn":
        return masked_mean(h_nbr, mask)
    if gnn_type == "gcn":
        agg = masked_mean(
            torch.cat([h_self[..., None, :], h_nbr], dim=-2),
            torch.cat([torch.ones_like(mask[..., :1]), mask], dim=-1),
        )
        return F.relu(agg @ params["w"])
    if gnn_type == "sage-mean":
        agg = masked_mean(h_nbr, mask)
        return F.relu(torch.cat([h_self, agg], dim=-1) @ params["w"])
    if gnn_type == "sage-sum":
        agg = masked_sum(h_nbr, mask)
        return F.relu(torch.cat([h_self, agg], dim=-1) @ params["w"])
    if gnn_type == "gat":
        wh_self = h_self @ params["w"]  # (B,W,d)
        wh_nbr = h_nbr @ params["w"]  # (B,W,F,d)
        e = F.leaky_relu(
            (wh_self * params["a_self"]).sum(-1)[..., None]
            + (wh_nbr * params["a_nbr"]).sum(-1),
            negative_slope=0.2,
        )  # (B,W,F)
        e = torch.where(mask, e, torch.full_like(e, -1e9))
        att = torch.softmax(e, dim=-1)
        att = torch.where(mask, att, torch.zeros_like(att))  # all-PAD rows -> 0
        return F.relu((att[..., None] * wh_nbr).sum(dim=-2))
    if gnn_type == "gin":
        agg = (1.0 + params["eps"]) * h_self + masked_sum(h_nbr, mask)
        return F.relu(F.relu(agg @ params["w1"]) @ params["w2"])
    if gnn_type == "ngcf":
        m = masked_mean(h_nbr, mask)
        return F.leaky_relu(
            (h_self + m) @ params["w1"] + (m * h_self) @ params["w2"],
            negative_slope=0.2,
        )
    raise ValueError(f"unknown gnn type {gnn_type!r}")
