"""Mixture-of-Experts layer: top-k router and capacity-based expert dispatch,
the counterpart of ``repro/models/moe.py``.

GShard / Switch semantics as ``repro`` writes them: the tokens split into
groups of ``g = min(group_size, S)`` off the sequence axis; each expert takes
at most ``C`` tokens of a group; a token's choices fill the expert slots
choice-rank first (every first choice of the group in token order, then
every second choice, ...), and a choice past ``C`` is dropped (its residual
carries the token). Dispatch and combine are dense one-hot
(G, g, E, C) tensors contracted by einsums, as in ``repro``: each slot has at
most one nonzero term, so the contractions are exact gathers and scatters,
and their backward is a matmul, deterministic on the card. The aux loss is
Switch's ``E * sum_e f_e P_e``, averaged over groups.

Top-k ties: ``jax.lax.top_k`` puts the lower index first among equal values,
and ``torch.topk`` promises no order, so the experts come from a stable
descending sort (a zero router gives uniform probabilities, and every token
picks experts ``0..K-1``). The chosen probabilities are read back through
the one-hot of the chosen experts (one nonzero product a sum, so exactly
the values), whose backward is elementwise.

``shard`` and ``router_jitter`` are kept so configs stay interchangeable
and select nothing: ``shard`` only places tensors on ``repro``'s mesh, and
``repro`` never reads ``router_jitter``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _params, init_normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 1024  # tokens per routing group
    mlp_kind: str = "swiglu"
    router_jitter: float = 0.0  # selects nothing (repro never reads it)
    shard: str = "ep"  # selects nothing (repro's mesh placement)


_MOE_NAMES = {"swiglu": ("router", "wg", "wu", "wd"), "gelu": ("router", "wu", "wd")}


class MoE(nn.Module):
    """``router`` (d, E) f32, ``wu`` (E, d, f), ``wd`` (E, f, d), and for
    SwiGLU experts ``wg`` (E, d, f)."""

    def __init__(self, cfg: MoEConfig, params: Mapping[str, torch.Tensor]):
        super().__init__()
        if cfg.mlp_kind not in _MOE_NAMES:
            raise ValueError(f"MoE mlp_kind {cfg.mlp_kind!r}")
        want = _MOE_NAMES[cfg.mlp_kind]
        if set(params) != set(want):
            raise KeyError(f"MoE params {sorted(params)} != {sorted(want)}")
        self.cfg = cfg
        _params({n: params.get(n) for n in ("router", "wg", "wu", "wd")}, self)


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype, device=None) -> MoE:
    """``repro``'s scales: router N(0, 1/d) kept in f32, ``wg``/``wu``
    N(0, 1/d), ``wd`` N(0, 1/f), drawn from ``gen``."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    sc_in, sc_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    p = {"router": init_normal(gen, (d, E), sc_in, torch.float32, device)}
    if cfg.mlp_kind == "swiglu":
        p["wg"] = init_normal(gen, (E, d, f), sc_in, dtype, device)
    p["wu"] = init_normal(gen, (E, d, f), sc_in, dtype, device)
    p["wd"] = init_normal(gen, (E, f, d), sc_out, dtype, device)
    return MoE(cfg, p)


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    """Slots an expert has in a group: ceil(g K cf / E), rounded up to a
    multiple of 4, at least 4."""
    c = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
    return max(4, -(-c // 4) * 4)


def group_size(cfg: MoEConfig, S: int) -> int:
    g = min(cfg.group_size, S)
    if S % g:
        raise ValueError(f"sequence length {S} is not a multiple of the MoE group {g}")
    return g


@dataclasses.dataclass
class Routing:
    """One group split's routing: ``probs`` (G, g, E) f32, the experts
    ``top_idx`` (G, g, K) in choice order, their renormalised weights
    ``top_vals`` (G, g, K) f32, each choice's slot ``pos`` (G, g, K) and
    whether it is ``kept`` (pos < C)."""

    probs: torch.Tensor
    top_idx: torch.Tensor
    top_vals: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    capacity: int


def route(p: MoE, cfg: MoEConfig, xt: torch.Tensor) -> Routing:
    """Routing of grouped tokens ``xt`` (G, g, d): f32 router logits,
    softmax, top-K (lower index first on ties) renormalised by
    ``max(sum, 1e-9)``, and slots assigned choice-rank first."""
    G, g, _ = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, g)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)  # (G, g, E)
    top_idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :K]
    chosen = F.one_hot(top_idx, E)  # (G, g, K, E) int
    top_vals = (chosen.to(probs.dtype) * probs[:, :, None, :]).sum(-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    # choice-rank-major running count per expert: (G, K*g, E), rank k's
    # tokens after every token of ranks < k
    order = chosen.transpose(1, 2).reshape(G, K * g, E)
    before = (order.cumsum(dim=1) - order).reshape(G, K, g, E).transpose(1, 2)
    pos = (before * chosen).sum(-1)  # (G, g, K)
    return Routing(probs, top_idx, top_vals, pos, pos < C, C)


def moe_forward(p: MoE, cfg: MoEConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss f32)."""
    B, S, d = x.shape
    g = group_size(cfg, S)
    G = B * (S // g)
    E = cfg.num_experts
    xt = x.reshape(G, g, d)
    r = route(p, cfg, xt)
    C = r.capacity
    chosen = F.one_hot(r.top_idx, E).to(x.dtype) * r.kept[..., None].to(x.dtype)  # (G,g,K,E)
    slot = F.one_hot(r.pos.clamp(max=C - 1), C).to(x.dtype)  # (G, g, K, C)
    dispatch = torch.einsum("gske,gskc->gsec", chosen, slot)
    # the combine weights rounded to x.dtype first, as repro keeps combine
    # in x.dtype (an f32 combine would upcast the residual stream)
    weighted = chosen * r.top_vals.to(x.dtype)[..., None]
    combine = torch.einsum("gske,gskc->gsec", weighted, slot)

    xe = torch.einsum("gsec,gsd->egcd", dispatch, xt)  # (E, G, C, d)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(torch.einsum("egcd,edf->egcf", xe, p.wg)) * torch.einsum(
            "egcd,edf->egcf", xe, p.wu)
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.einsum("egcd,edf->egcf", xe, p.wu), approximate="tanh")
    ye = torch.einsum("egcf,efd->egcd", h, p.wd)
    y = torch.einsum("gsec,egcd->gsd", combine, ye)

    # Switch aux loss: f_e, the share of a group's tokens kept in expert e
    f_e = ((F.one_hot(r.top_idx, E) * r.kept[..., None]).sum(2) > 0).float().mean(dim=1)
    P_e = r.probs.mean(dim=1)
    aux = (E * (f_e * P_e).sum(-1)).mean()
    return y.reshape(B, S, d), aux
