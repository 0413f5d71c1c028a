"""Transformer building blocks of the LM substrate: norms, RoPE / M-RoPE,
GQA attention with full and sliding-window KV caches, MLPs.

The counterpart of ``repro/models/layers.py``. Parameters live in small
``nn.Module``s (``Norm``, ``Attention``, ``MLP``) under ``repro``'s names
and in its layouts (``x @ w``, weights (in, out)), so a ``repro`` parameter
tree converts leaf for leaf (``repro_torch.convert``). The plain functions
take such a module as ``p`` and compute what ``repro``'s functions compute,
with its cast points: ``rmsnorm`` casts the ``rsqrt`` to ``x.dtype`` before
the multiply, ``apply_rope`` casts ``cos``/``sin`` to ``x.dtype``, softmaxes
run in f32.

Full-sequence attention always goes through ``kernels.ops.flash_attention``
(the flash kernel on CUDA, its plain version on the CPU). That one call
stands in for ``repro``'s three branches (the Pallas kernel, the chunked XLA
scan and the naive einsum), which compute the same function. The sharding
knobs of ``AttnConfig`` (``block_q``, ``chunk_unroll``, ``shard_cache_seq``,
``pad_heads`` apart from the head count it implies) are kept so configs
stay interchangeable and select nothing. Cross-attention (Whisper's
decoder over the encoded audio) is ``gqa_attention``, the einsum path, as
in ``repro``: no kernel.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

NEG_INF = -1e30


def _params(names: Mapping[str, Optional[torch.Tensor]], module: nn.Module) -> None:
    for name, t in names.items():
        module.register_parameter(name, None if t is None else nn.Parameter(t))


def init_normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """``(normal(shape) * scale).astype(dtype)``, drawn in f32 on the
    generator's device, as ``repro``'s inits draw in f32 and cast."""
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


# -------------------------------------------------------------------- norms
class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``)."""

    def __init__(self, kind: str, scale: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        if (kind == "rms") != (bias is None):
            raise ValueError(f"norm {kind!r}: LayerNorm has a bias, RMSNorm none")
        self.kind = kind
        _params({"scale": scale, "bias": bias}, self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.kind, self, x)


def init_rmsnorm(dim: int, dtype, device=None) -> Norm:
    return Norm("rms", torch.ones((dim,), dtype=dtype, device=device))


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p.scale


def init_layernorm(dim: int, dtype, device=None) -> Norm:
    return Norm("ln", torch.ones((dim,), dtype=dtype, device=device),
                torch.zeros((dim,), dtype=dtype, device=device))


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p.scale + p.bias


def apply_norm(kind: str, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rms" else layernorm(p, x)


def init_norm(kind: str, dim: int, dtype, device=None) -> Norm:
    return init_rmsnorm(dim, dtype, device) if kind == "rms" else init_layernorm(dim, dtype, device)


# --------------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=64)
def _inv_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE frequencies, computed in numpy as ``repro`` computes them (so
    bitwise its own) and kept on ``device``: a decode step would otherwise
    copy them from pageable host memory, a blocking copy, in every layer."""
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def rope_cos_sin(
    positions: torch.Tensor,  # (B, S) int, or (B, S, n_sections) for M-RoPE
    head_dim: int,
    theta: float = 10000.0,
    mrope_sections: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary angle tables (B, S, head_dim/2), f32.

    M-RoPE (Qwen2-VL): the head_dim/2 frequency channels split into
    sections, each taking its angle from its own coordinate of the position
    id; identical coordinates reduce it to plain RoPE.
    """
    half = head_dim // 2
    inv_freq = _inv_freq(half, float(theta), positions.device)
    if mrope_sections is None:
        if positions.dim() != 2:
            raise ValueError(f"RoPE positions must be (B, S); got {tuple(positions.shape)}")
        ang = positions[..., None].float() * inv_freq
    else:
        if positions.dim() != 3 or positions.shape[-1] != len(mrope_sections):
            raise ValueError(f"M-RoPE positions must be (B, S, {len(mrope_sections)}); "
                             f"got {tuple(positions.shape)}")
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do not sum to {half}")
        chunks, lo = [], 0
        for si, sec in enumerate(mrope_sections):
            chunks.append(positions[..., si, None].float() * inv_freq[lo:lo + sec])
            lo += sec
        ang = torch.cat(chunks, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half convention; x (B, S, H, head_dim), cos/sin (B, S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    causal: bool = True
    sliding_window: Optional[int] = None  # None = full attention
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, ...]] = None  # Qwen2-VL
    use_rope: bool = True
    block_q: int = 256  # repro's chunked-attention block; selects nothing here
    chunk_unroll: bool = False  # selects nothing here
    shard_cache_seq: bool = False  # selects nothing here (one card)
    # pad query heads up to a multiple of 16 (repro's head-parallel layout);
    # here it only shapes the weights: padded heads have zero output rows
    pad_heads: bool = False

    @property
    def n_heads_padded(self) -> int:
        if not self.pad_heads:
            return self.n_heads
        hp = -(-self.n_heads // 16) * 16
        if hp % self.n_kv:
            raise ValueError(f"padded heads {hp} do not divide over {self.n_kv} KV heads")
        return hp


class Attention(nn.Module):
    """``wq`` (d, H*hd), ``wk``/``wv`` (d, K*hd), ``wo`` (H*hd, d), and with
    ``qkv_bias`` ``bq``/``bk``/``bv``."""

    def __init__(self, cfg: AttnConfig, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        want = {"wq", "wk", "wv", "wo"} | ({"bq", "bk", "bv"} if cfg.qkv_bias else set())
        if set(params) != want:
            raise KeyError(f"attention params {sorted(params)} != {sorted(want)}")
        _params({n: params.get(n) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}, self)


def init_attn(gen: torch.Generator, cfg: AttnConfig, dtype, device=None) -> Attention:
    d, H, K, hd = cfg.d_model, cfg.n_heads_padded, cfg.n_kv, cfg.head_dim
    sc = 1.0 / np.sqrt(d)
    p = {
        "wq": init_normal(gen, (d, H * hd), sc, torch.float32, device),
        "wk": init_normal(gen, (d, K * hd), sc, dtype, device),
        "wv": init_normal(gen, (d, K * hd), sc, dtype, device),
        "wo": init_normal(gen, (H * hd, d), 1.0 / np.sqrt(H * hd), torch.float32, device),
    }
    if H != cfg.n_heads:  # padded heads: zero output rows, so they never contribute
        p["wo"][cfg.n_heads * hd:] = 0.0
    p["wq"], p["wo"] = p["wq"].to(dtype), p["wo"].to(dtype)
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return Attention(cfg, p)


def _proj_qkv(p: Attention, cfg: AttnConfig, x: torch.Tensor):
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, cfg.n_heads_padded, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv, cfg.head_dim)
    return q, k, v


def gqa_scores_mask(S_q: int, S_kv: int, causal: bool, window: Optional[int],
                    q_offset: int = 0, device=None) -> torch.Tensor:
    """(S_q, S_kv) f32 additive mask: 0 inside the causal / window band,
    ``NEG_INF`` outside."""
    qi = torch.arange(S_q, device=device)[:, None] + q_offset
    ki = torch.arange(S_kv, device=device)[None, :]
    ok = torch.ones((S_q, S_kv), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return torch.where(ok, 0.0, NEG_INF).float()


def gqa_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    mask: Optional[torch.Tensor],  # additive, broadcastable to (B, 1, Sq, Skv)
) -> torch.Tensor:
    """Grouped-query attention as plain einsums (the decode step's path).

    The mask is added in the logits' dtype: ``repro``'s mask is a weakly
    typed f32 array, which JAX adds to bf16 logits in bf16.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)
    if mask is not None:
        mask = mask.to(logits.dtype)
        logits = logits + (mask[:, :, None, :, :] if mask.dim() == 4 else mask)
    att = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", att, v)
    return out.reshape(B, Sq, H, hd)


def attn_forward(
    p: Attention,
    cfg: AttnConfig,
    x: torch.Tensor,  # (B, S, d)
    positions: Optional[torch.Tensor] = None,  # (B, S) or (B, S, 3)
    use_flash: bool = False,  # kept for parity: every path is the flash call here
) -> torch.Tensor:
    """Full-sequence attention (prefill, the training forward)."""
    B, S, _ = x.shape
    q, k, v = _proj_qkv(p, cfg, x)
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    return out.reshape(B, S, -1) @ p.wo


# ------------------------------------------------------------------ caches
@dataclasses.dataclass
class KVCacheSpec:
    """A full cache keeps ``s_max`` slots; a sliding-window cache a ring of
    ``window`` slots. Flattened on the head axis: (B, S, n_kv * head_dim),
    as ``repro`` lays it out."""

    batch: int
    s_max: int  # capacity: the context (full) or the window (SWA ring)
    n_kv: int
    head_dim: int
    ring: bool  # True -> ring buffer indexed modulo s_max


def init_kv_cache(spec: KVCacheSpec, dtype, device=None) -> Dict[str, torch.Tensor]:
    shape = (spec.batch, spec.s_max, spec.n_kv * spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode_step(
    p: Attention,
    cfg: AttnConfig,
    cache: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d)
    t: int,  # absolute decode position, a host int
    use_flash: bool = False,  # kept for parity; decode runs the einsum path
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the KV cache (full or ring).

    Unlike ``repro``, which returns a new cache, this writes the new key and
    value into ``cache`` IN PLACE (one slot, no copy of the cache) and
    returns it. The slot is ``t % S_max`` for a ring and ``min(t, S_max -
    1)`` for a full cache; a ring slot is valid by its age.
    """
    B = x.shape[0]
    S_max = cache["k"].shape[1]
    ring = cfg.sliding_window is not None and S_max == cfg.sliding_window
    q, k_new, v_new = _proj_qkv(p, cfg, x)
    if cfg.use_rope:
        shape = (B, 1) if cfg.mrope_sections is None else (B, 1, len(cfg.mrope_sections))
        pos = torch.full(shape, t, dtype=torch.int32, device=x.device)
        cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    slot = t % S_max if ring else min(t, S_max - 1)
    kv_flat = cfg.n_kv * cfg.head_dim
    cache["k"][:, slot] = k_new.reshape(B, kv_flat)
    cache["v"][:, slot] = v_new.reshape(B, kv_flat)
    k_heads = cache["k"].view(B, S_max, cfg.n_kv, cfg.head_dim)
    v_heads = cache["v"].view(B, S_max, cfg.n_kv, cfg.head_dim)
    s_idx = torch.arange(S_max, device=x.device)
    if ring:
        valid = (slot - s_idx) % S_max <= min(t, S_max - 1)  # age 0 = newest
    else:
        valid = s_idx <= t
    mask = torch.where(valid, 0.0, NEG_INF).float()[None, None, None, :]
    out = gqa_attention(q, k_heads, v_heads, mask)  # (B, 1, H, hd)
    return out.reshape(B, 1, -1) @ p.wo, cache


# ----------------------------------------------------------- cross-attention
def init_cross_attn(gen: torch.Generator, cfg: AttnConfig, dtype, device=None) -> Attention:
    return init_attn(gen, cfg, dtype, device)


def cross_attn_forward(
    p: Attention,
    cfg: AttnConfig,
    x: torch.Tensor,  # (B, Sq, d) decoder states
    enc_kv: Tuple[torch.Tensor, torch.Tensor],  # precomputed (B, Se, K, hd) k, v
) -> torch.Tensor:
    """The decoder's queries against the encoder's keys and values, no
    mask (every query sees every frame)."""
    B, Sq, _ = x.shape
    q = x @ p.wq
    if p.bq is not None:
        q = q + p.bq
    k, v = enc_kv
    out = gqa_attention(q.reshape(B, Sq, cfg.n_heads, cfg.head_dim), k, v, None)
    return out.reshape(B, Sq, -1) @ p.wo


def encode_cross_kv(p: Attention, cfg: AttnConfig,
                    enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's keys and values of the encoder states ``enc``
    (B, Se, d) -> two (B, Se, K, hd)."""
    B, Se, _ = enc.shape
    k, v = enc @ p.wk, enc @ p.wv
    if p.bk is not None:
        k, v = k + p.bk, v + p.bv
    return (k.reshape(B, Se, cfg.n_kv, cfg.head_dim), v.reshape(B, Se, cfg.n_kv, cfg.head_dim))


# --------------------------------------------------------------------- MLPs
_MLP_NAMES = {"swiglu": ("wg", "wu", "wd"), "gelu": ("wu", "bu", "wd", "bd")}


class MLP(nn.Module):
    """SwiGLU (``wg``, ``wu``, ``wd``) or GELU (``wu``, ``bu``, ``wd``, ``bd``)."""

    def __init__(self, kind: str, params: Mapping[str, torch.Tensor]):
        super().__init__()
        if kind not in _MLP_NAMES:
            raise ValueError(kind)
        if set(params) != set(_MLP_NAMES[kind]):
            raise KeyError(f"{kind} params {sorted(params)} != {sorted(_MLP_NAMES[kind])}")
        self.kind = kind
        _params(dict(params), self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self, self.kind, x)


def init_mlp(gen: torch.Generator, kind: str, d_model: int, d_ff: int, dtype,
             device=None) -> MLP:
    sc_in, sc_out = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(d_ff)
    if kind == "swiglu":
        return MLP(kind, {
            "wg": init_normal(gen, (d_model, d_ff), sc_in, dtype, device),
            "wu": init_normal(gen, (d_model, d_ff), sc_in, dtype, device),
            "wd": init_normal(gen, (d_ff, d_model), sc_out, dtype, device),
        })
    if kind == "gelu":
        return MLP(kind, {
            "wu": init_normal(gen, (d_model, d_ff), sc_in, dtype, device),
            "bu": torch.zeros((d_ff,), dtype=dtype, device=device),
            "wd": init_normal(gen, (d_ff, d_model), sc_out, dtype, device),
            "bd": torch.zeros((d_model,), dtype=dtype, device=device),
        })
    raise ValueError(kind)


def mlp_forward(p: MLP, kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ p.wg) * (x @ p.wu)) @ p.wd
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p.wu + p.bu, approximate="tanh") @ p.wd + p.bd
