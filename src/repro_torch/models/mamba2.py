"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) mixer layer, the
counterpart of ``repro/models/mamba2.py``.

The full-sequence forward (prefill, training) is the chunked SSD as
``repro`` computes it: the sequence splits into chunks of ``Q`` tokens; inside
a chunk the recurrence is its quadratic dual form (einsums), and the
(B, H, P, N) state carries from chunk to chunk, here in a Python loop over
the ``S / Q`` chunks (``repro`` scans them, or unrolls them under
``chunk_unroll``, which selects nothing here). ``repro`` checkpoints each
chunk step for memory; that changes no value and is not mirrored (a
block under ``remat`` is checkpointed whole). The cast points are
``repro``'s: the dual-form weights, ``C`` for the inter-chunk term and the
state-update weights go to ``x.dtype`` before their einsums, and the state
stays in ``x.dtype``.

Decode keeps a constant-size state (B, H, P, N) and the depthwise conv's
last ``W - 1`` inputs (B, W - 1, Ch), both in the model's dtype, and
updates both IN PLACE (``repro`` returns a new cache). ``A_log``, ``D`` and
``dt_bias`` are f32 whatever the model's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _params, init_normal
from repro_torch.models.sharding import (constrain, copy_into, follow, like, local_apply,
                                        merge_dims, reshape, split_dim)


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    chunk_unroll: bool = False  # selects nothing (the chunks are a Python loop)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.headdim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of headdim {self.headdim}")
        return self.d_inner // self.headdim


MAMBA_NAMES = ("wz", "wx", "wB", "wC", "wdt", "wo", "conv", "A_log", "D", "dt_bias",
               "norm_scale")
F32_NAMES = ("A_log", "D", "dt_bias")  # f32 whatever the model's dtype


class Mamba2(nn.Module):
    """``wz``/``wx`` (d, di), ``wB``/``wC`` (d, N), ``wdt`` (d, H), ``wo``
    (di, d), ``conv`` (W, di + 2N), ``norm_scale`` (di,), and f32 ``A_log``,
    ``D``, ``dt_bias`` (H,)."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        if set(params) != set(MAMBA_NAMES):
            raise KeyError(f"Mamba2 params {sorted(params)} != {sorted(MAMBA_NAMES)}")
        _params({n: params[n] for n in MAMBA_NAMES}, self)


def init_mamba2(gen: torch.Generator, cfg: Mamba2Config, dtype, device=None) -> Mamba2:
    """``repro``'s distributions: N(0, 1/d) projections (1/di for ``wo``),
    conv weights 0.1 N(0, 1), ``dt_bias`` the inverse softplus of a
    log-uniform dt in [dt_min, dt_max], ``A_log = log(1..H)``, ``D = 1``,
    unit ``norm_scale``; drawn from ``gen``."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    sc = 1.0 / np.sqrt(d)
    p = {name: init_normal(gen, shape, sc, dtype, device)
         for name, shape in (("wz", (d, di)), ("wx", (d, di)), ("wB", (d, N)),
                             ("wC", (d, N)), ("wdt", (d, H)))}
    p["wo"] = init_normal(gen, (di, d), 1.0 / np.sqrt(di), dtype, device)
    p["conv"] = init_normal(gen, (cfg.conv_width, di + 2 * N), 0.1, dtype, device)
    if gen is None:  # abstract parameters: nothing drawn
        p["dt_bias"] = torch.empty((H,), dtype=torch.float32, device=device)
    else:
        u = torch.rand((H,), generator=gen, device=gen.device)
        dt = torch.exp(u * (np.log(cfg.dt_max) - np.log(cfg.dt_min)) + np.log(cfg.dt_min))
        p["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(device=device,
                                                               dtype=torch.float32)
    p["A_log"] = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=device))
    p["D"] = torch.ones((H,), dtype=torch.float32, device=device)
    p["norm_scale"] = torch.ones((di,), dtype=dtype, device=device)
    return Mamba2(p)


def _proj_xbcdt(p: Mamba2, u: torch.Tensor):
    """u (B, S, d) -> z, xbc (before the conv), dt_raw (f32)."""
    z = follow(u @ p.wz)
    xbc = torch.cat([follow(u @ p.wx), follow(u @ p.wB), follow(u @ p.wC)], dim=-1)
    return z, xbc, follow(u @ p.wdt).float()


def _causal_depthwise_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w (W, Ch), x (B, S, Ch) -> silu of the causal depthwise conv, the
    W products summed in order."""
    W, S = w.shape[0], x.shape[1]
    # the W - 1 zeros joined in front, not ``F.pad``: on torch 2.11 DTensor's
    # strategy for ``constant_pad_nd`` gives a 2-d mesh a spec of one placement
    zeros = like(torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device), x)
    pads = torch.cat([zeros, x], dim=1)
    out = pads[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + pads[:, i:i + S, :] * w[i]
    return F.silu(out)


def _split_xbc(cfg: Mamba2Config, xbc: torch.Tensor):
    di, N = cfg.d_inner, cfg.d_state
    return xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]


def _gated_norm(p: Mamba2, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y) * silu(z): mamba2's norm, then the gate."""
    var = y.float().square().mean(dim=-1, keepdim=True)
    yn = (y * torch.rsqrt(var + 1e-6).to(y.dtype)) * p.norm_scale
    return yn * F.silu(z)


def _chunk_step(h_prev, da, dt_q, xq, bq, cq, causal):
    """One SSD chunk: (B, Q, H) decay logs and dts (f32), xq (B, Q, H, P),
    bq / cq (B, Q, N) f32, state (B, H, P, N) -> (state, y (B, Q, H, P))."""
    lcum = torch.cumsum(da, dim=1)  # (B, Q, H)
    # intra-chunk: y_diag[t] = sum_{s<=t} C_t.B_s exp(l_t - l_s) dt_s x_s
    diff = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B, Q, Q, H)
    decay = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bqn,bsn->bqs", cq, bq)
    w = scores[..., None] * decay * dt_q[:, None, :, :]
    y_diag = torch.einsum("bqsh,bshp->bqhp", w.to(xq.dtype), xq)
    # inter-chunk: y_off[t] = exp(l_t) C_t.h_prev
    y_off = torch.einsum("bqn,bhpn->bqhp", cq.to(xq.dtype), h_prev) * torch.exp(
        lcum)[..., None].to(xq.dtype)
    # state update: h = exp(l_Q) h_prev + sum_s exp(l_Q - l_s) dt_s B_s (x) x_s
    decay_to_end = torch.exp(lcum[:, -1:, :] - lcum)
    wB = (decay_to_end * dt_q)[..., None] * bq[:, :, None, :]  # (B, Q, H, N)
    s_chunk = torch.einsum("bqhn,bqhp->bhpn", wB.to(xq.dtype), xq)
    h = h_prev * torch.exp(lcum[:, -1, :])[..., None, None].to(xq.dtype) + s_chunk
    return h, y_diag + y_off


_HEADS4 = ("batch", None, None, "mamba_heads")
_SCAN_IN = (_HEADS4, _HEADS4, _HEADS4 + (None,), ("batch", None, None, None),
            ("batch", None, None, None))
_SCAN_OUT = _HEADS4 + (None,)


def _ssd_scan(dA, dtc, xc, Bc, Cc):
    """The chunk loop: (B, Nc, Q, H) decay logs and dts (f32), xc (B, Nc, Q,
    H, P), Bc / Cc (B, Nc, Q, N) f32 -> y (B, Nc, Q, H, P), the state
    starting at zero in ``xc``'s dtype."""
    B, _, Q, H, P = xc.shape
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    h = torch.zeros((B, H, P, Bc.shape[-1]), dtype=xc.dtype, device=xc.device)
    ys = []
    # each chunk's slices in one op a tensor
    for da_c, dt_c, x_c, b_c, c_c in zip(*(t.unbind(1) for t in (dA, dtc, xc, Bc, Cc))):
        h, y_c = _chunk_step(h, da_c, dt_c, x_c, b_c, c_c, causal)
        ys.append(y_c)
    return torch.stack(ys, dim=1)


def mamba2_forward(p: Mamba2, cfg: Mamba2Config, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence chunked SSD: u (B, S, d_model) -> (B, S, d_model)."""
    B, S, _ = u.shape
    H, P, N, Q = cfg.n_heads, cfg.headdim, cfg.d_state, min(cfg.chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD chunk {Q}")
    Nc = S // Q

    z, xbc, dt_raw = _proj_xbcdt(p, u)
    xbc = _causal_depthwise_conv(p.conv, xbc)
    x, Bm, Cm = _split_xbc(cfg, xbc)
    x = constrain(split_dim(x, 2, H), "batch", None, "mamba_heads", None)

    dt = F.softplus(dt_raw + p.dt_bias)  # (B, S, H) f32
    A = -torch.exp(p.A_log)  # (H,) negative
    dA = reshape(dt * A, (B, Nc, Q, H))
    dtc = reshape(dt, (B, Nc, Q, H))
    xc = reshape(x, (B, Nc, Q, H, P))
    Bc = reshape(Bm, (B, Nc, Q, N)).float()
    Cc = reshape(Cm, (B, Nc, Q, N)).float()
    # batch and heads are the scan's only sharded axes: on a mesh each rank
    # scans its own shards
    yc = local_apply(_ssd_scan, _SCAN_OUT, (dA, dtc, xc, Bc, Cc), _SCAN_IN)
    y = reshape(yc, (B, S, H, P))
    y = y + x * p.D[None, None, :, None].to(x.dtype)
    return follow(_gated_norm(p, merge_dims(y, 2), z) @ p.wo)


# ------------------------------------------------------------------- decode
def init_mamba_cache(cfg: Mamba2Config, batch: int, dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.headdim, cfg.d_state), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.d_state),
                            dtype=dtype, device=device),
    }


def mamba2_decode_step(p: Mamba2, cfg: Mamba2Config, cache: Dict[str, torch.Tensor],
                       u: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, u (B, 1, d_model): the state and the conv history are
    updated IN PLACE in ``cache``, which is returned."""
    H = cfg.n_heads
    z, xbc, dt_raw = _proj_xbcdt(p, u)
    hist = torch.cat([cache["conv"], xbc], dim=1)  # (B, W, Ch)
    conv_out = F.silu((hist * p.conv[None]).sum(dim=1, keepdim=True))
    x, Bm, Cm = _split_xbc(cfg, conv_out)
    x = split_dim(x[:, 0], 1, H)  # (B, H, P)
    dt = F.softplus(dt_raw[:, 0] + p.dt_bias)  # (B, H) f32
    a = torch.exp(dt * -torch.exp(p.A_log))
    dBx = dt.to(x.dtype)[:, :, None, None] * x[..., None] * Bm[:, 0][:, None, None, :]
    h = cache["ssm"] * a[..., None, None].to(x.dtype) + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h) + x * p.D[None, :, None].to(x.dtype)
    out = _gated_norm(p, merge_dims(y, 1)[:, None], z) @ p.wo
    copy_into(cache["ssm"], h)
    copy_into(cache["conv"], hist[:, 1:, :])
    return out, cache
