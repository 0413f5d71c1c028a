"""Relation-wise heterogeneous aggregation — Eq. 3 of the paper (PyTorch).

    h_{v,r}^k = GNN_r(h_v^{k-1}, {h_u^{k-1} : u in N_{v,r}})
    h_v^k     = α·h_v^0 + (1-α)·Σ_r φ_r · h_{v,r}^k

The port of ``repro.core.hetero``: distinct zoo weights per relation, φ_r
uniform or GATNE attention softmax_r(wᵀ tanh(W h_{v,r})), the α residual to
the hop-0 features, and PAD rows zeroed so they contribute nothing upstream.

``HeteroGNNConfig`` is ``repro``'s, field for field, so configs stay
interchangeable. ``use_kernel_aggr`` is kept for that and selects nothing:
the aggregation runs the CUDA ``seg_aggr`` kernel for tensors on the card
and its plain version for CPU tensors (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from repro_torch.core import gnn as gnn_lib

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HeteroGNNConfig:
    gnn_type: str = "lightgcn"
    num_relations: int = 2
    num_layers: int = 2  # = number of ego hops K
    dim: int = 64
    alpha: float = 0.15  # residual weight on h^0
    relation_agg: str = "uniform"  # "uniform" | "gatne"
    use_kernel_aggr: "bool | None" = None  # kept for config parity; unused


def init_hetero_params(gen: torch.Generator, cfg: HeteroGNNConfig) -> Params:
    params: Params = {}
    for layer in range(cfg.num_layers):
        for r in range(cfg.num_relations):
            for name, val in gnn_lib.init_layer(gen, cfg.gnn_type, cfg.dim).items():
                params[f"l{layer}/r{r}/{name}"] = val
    if cfg.relation_agg == "gatne":
        params["att/W"] = torch.randn((cfg.dim, cfg.dim), generator=gen) * 0.05
        params["att/w"] = torch.randn((cfg.dim,), generator=gen) * 0.05
    return params


def _layer_params(params: Params, layer: int, r: int) -> Params:
    pre = f"l{layer}/r{r}/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def relation_mix(params: Params, cfg: HeteroGNNConfig, h_rel: torch.Tensor) -> torch.Tensor:
    """Mix per-relation outputs h_rel (B, W, R, d) -> (B, W, d) via φ_r."""
    if cfg.relation_agg == "uniform":
        return h_rel.mean(dim=-2)
    score = torch.einsum("bwrd,d->bwr", torch.tanh(h_rel @ params["att/W"]),
                         params["att/w"])
    phi = torch.softmax(score, dim=-1)
    return torch.einsum("bwr,bwrd->bwd", phi, h_rel)


def hetero_forward(
    params: Params,
    cfg: HeteroGNNConfig,
    level_feats: Sequence[torch.Tensor],  # level k: (B, W_k, d) raw embeddings
    level_masks: Sequence[torch.Tensor],  # level k: (B, W_k) bool validity
    fanouts: Sequence[int],
) -> torch.Tensor:
    """Bottom-up sampled message passing over the dense ego layout -> (B, d).

    ``child[:, :, r]`` is a strided view of level k+1; the ``seg_aggr``
    kernel reads it in place through its row stride.
    """
    K = cfg.num_layers
    R = cfg.num_relations
    if len(level_feats) != K + 1:
        raise ValueError(f"{len(level_feats)} ego levels for {K} layers")
    h: List[torch.Tensor] = list(level_feats)
    h0: List[torch.Tensor] = list(level_feats)
    masks = list(level_masks)
    for layer in range(K):
        new_h: List[torch.Tensor] = []
        for k in range(K - layer):  # levels 0..K-layer survive this layer
            B, W, d = h[k].shape
            Fo = fanouts[k]
            child = h[k + 1].reshape(B, W, R, Fo, d)
            child_mask = masks[k + 1].reshape(B, W, R, Fo)
            outs = [
                gnn_lib.apply_layer(
                    _layer_params(params, layer, r), cfg.gnn_type, h[k],
                    child[:, :, r], child_mask[:, :, r],
                )
                for r in range(R)
            ]
            mixed = relation_mix(params, cfg, torch.stack(outs, dim=-2))
            out = cfg.alpha * h0[k] + (1.0 - cfg.alpha) * mixed
            new_h.append(out * masks[k][..., None])  # PAD rows stay zero
        h = new_h
    return h[0][:, 0, :]
