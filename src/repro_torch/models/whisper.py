"""Whisper's encoder-decoder backbone (arXiv:2212.04356): the counterpart of
``repro/models/whisper.py``.

The mel spectrogram and the conv frontend are a stub, as in ``repro``: the
caller supplies frame embeddings (B, n_frames, d_model). The transformer
that consumes them is here: a bidirectional encoder with sinusoidal
positions (``enc_pos``, a trained parameter in ``repro``, so here too) and a
causal decoder with learned positions (``dec_pos``, clamped at the last of
``max_target_positions``), cross-attention to the encoded audio and a head
tied to the embedding, whose padded columns are -1e30.

``repro`` stacks each layer kind on a leading axis and scans it; here a
``Whisper`` module holds one ``EncoderLayer`` / ``DecoderLayer`` per layer
and the forward is a Python loop (``convert`` unstacks ``repro``'s tree).
With ``remat`` and gradients recorded, each layer runs under
``torch.utils.checkpoint``, as ``repro`` wraps its scan body in
``jax.checkpoint``. The self-attention of both stacks is
``L.attn_forward``: the flash kernel on CUDA (non-causal in the encoder,
causal in the decoder), its plain version on the CPU. Cross-attention is
the einsum path.

The decode step writes one self-attention slot a layer IN PLACE and reuses
the cross-attention K/V computed once by ``init_cache``; the position ``t``
is a host int. ``repro`` returns a new cache instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.sharding import constrain, follow, like
from repro_torch.models.transformer import gold_logit, torch_dtype


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int  # encoder AND decoder layer count (tiny: 4 / 4)
    n_heads: int
    n_kv: int
    d_ff: int
    n_audio_frames: int = 1500  # post-conv frames (30 s)
    max_target_positions: int = 448
    norm: str = "ln"
    dtype: str = "bfloat16"
    remat: bool = True  # each layer under torch.utils.checkpoint while training
    scan_layers: bool = True  # selects nothing (layers are a Python loop)

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def attn_cfg(self, causal: bool) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.head_dim, qkv_bias=True, causal=causal,
            use_rope=False, chunk_unroll=not self.scan_layers,
        )


def _sinusoids(length: int, channels: int) -> np.ndarray:
    t = np.arange(length)[:, None]
    inv = np.exp(-np.log(10000.0) * np.arange(channels // 2) / (channels // 2 - 1))
    ang = t * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


# ---------------------------------------------------------------- parameters
class EncoderLayer(nn.Module):
    def __init__(self, norm1: L.Norm, attn: L.Attention, norm2: L.Norm, mlp: L.MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp


class DecoderLayer(nn.Module):
    def __init__(self, norm1: L.Norm, self_attn: L.Attention, norm_x: L.Norm,
                 cross_attn: L.Attention, norm2: L.Norm, mlp: L.MLP):
        super().__init__()
        self.norm1, self.self_attn, self.norm_x = norm1, self_attn, norm_x
        self.cross_attn, self.norm2, self.mlp = cross_attn, norm2, mlp


ENC_GROUPS = ("norm1", "attn", "norm2", "mlp")
DEC_GROUPS = ("norm1", "self_attn", "norm_x", "cross_attn", "norm2", "mlp")


class Whisper(nn.Module):
    """``enc_pos`` (n_audio_frames, d), ``dec_pos`` (max_target_positions,
    d), ``embed`` (vocab_padded, d), ``enc_layers`` and ``dec_layers`` (one
    module each per layer), ``enc_norm`` and ``dec_norm``."""

    def __init__(self, cfg: WhisperConfig, enc_pos: torch.Tensor, dec_pos: torch.Tensor,
                 embed: torch.Tensor, enc_layers: List[EncoderLayer],
                 dec_layers: List[DecoderLayer], enc_norm: L.Norm, dec_norm: L.Norm):
        super().__init__()
        if len(enc_layers) != cfg.n_layers or len(dec_layers) != cfg.n_layers:
            raise ValueError(f"{len(enc_layers)} encoder and {len(dec_layers)} decoder "
                             f"layers for {cfg.n_layers}")
        self.cfg = cfg
        self.enc_pos = nn.Parameter(enc_pos)
        self.dec_pos = nn.Parameter(dec_pos)
        self.embed = nn.Parameter(embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm, self.dec_norm = enc_norm, dec_norm


def init_whisper(gen: torch.Generator, cfg: WhisperConfig, device=None) -> Whisper:
    """Fresh weights with ``repro``'s distributions and scales (the
    sinusoids, N(0, 0.01^2) ``dec_pos``, N(0, 1/d) ``embed``, the layers as
    ``L.init_attn`` / ``L.init_mlp`` draw them, LayerNorms at one and zero),
    drawn in f32 from ``gen``, layer by layer, and cast to ``cfg.dtype`` on
    ``device``."""
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model

    def norm():
        return L.init_norm(cfg.norm, d, dtype, device)

    def mlp():
        return L.init_mlp(gen, "gelu", d, cfg.d_ff, dtype, device)

    enc = [EncoderLayer(norm(), L.init_attn(gen, cfg.attn_cfg(False), dtype, device),
                        norm(), mlp()) for _ in range(cfg.n_layers)]
    dec = [DecoderLayer(norm(), L.init_attn(gen, cfg.attn_cfg(True), dtype, device), norm(),
                        L.init_cross_attn(gen, cfg.attn_cfg(False), dtype, device), norm(),
                        mlp()) for _ in range(cfg.n_layers)]
    enc_pos = (torch.empty((cfg.n_audio_frames, d), dtype=dtype, device=device) if gen is None
               else torch.from_numpy(_sinusoids(cfg.n_audio_frames, d)).to(device=device,
                                                                           dtype=dtype))
    dec_pos = L.init_normal(gen, (cfg.max_target_positions, d), 0.01, dtype, device)
    embed = L.init_normal(gen, (cfg.vocab_padded, d), 1.0 / np.sqrt(d), dtype, device)
    return Whisper(cfg, enc_pos, dec_pos, embed, enc, dec, norm(), norm())


def param_pspecs(cfg: WhisperConfig) -> Dict[str, Any]:
    """Each parameter's mesh-axis tuple under the current rules, keyed by
    its name in ``named_parameters()`` (``repro``'s less the stacked
    leading axis of its layers)."""
    from repro_torch.models.sharding import spec as S
    from repro_torch.models.transformer import _flat, attn_pspecs, mlp_pspecs, norm_pspecs

    out = {"enc_pos": S(None, None), "dec_pos": S(None, None), "embed": S("vocab", "fsdp")}
    enc = {"norm1": norm_pspecs("ln"), "attn": attn_pspecs(True), "norm2": norm_pspecs("ln"),
           "mlp": mlp_pspecs("gelu")}
    dec = {"norm1": norm_pspecs("ln"), "self_attn": attn_pspecs(True),
           "norm_x": norm_pspecs("ln"), "cross_attn": attn_pspecs(True),
           "norm2": norm_pspecs("ln"), "mlp": mlp_pspecs("gelu")}
    for i in range(cfg.n_layers):
        _flat(f"enc_layers.{i}.", enc, out)
        _flat(f"dec_layers.{i}.", dec, out)
    _flat("enc_norm.", norm_pspecs("ln"), out)
    _flat("dec_norm.", norm_pspecs("ln"), out)
    return out


# ------------------------------------------------------------------- encode
def _enc_layer(cfg: WhisperConfig, lp: EncoderLayer, x: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg.norm, lp.norm1, x)
    x = x + L.attn_forward(lp.attn, cfg.attn_cfg(False), h)
    x = x + L.mlp_forward(lp.mlp, "gelu", L.apply_norm(cfg.norm, lp.norm2, x))
    return constrain(x, "batch", None, None)


def _dec_layer(cfg: WhisperConfig, lp: DecoderLayer, x: torch.Tensor,
               enc: torch.Tensor) -> torch.Tensor:
    acfg_x = cfg.attn_cfg(False)
    h = L.apply_norm(cfg.norm, lp.norm1, x)
    x = x + L.attn_forward(lp.self_attn, cfg.attn_cfg(True), h)
    kv = L.encode_cross_kv(lp.cross_attn, acfg_x, enc)
    h = L.apply_norm(cfg.norm, lp.norm_x, x)
    x = x + L.cross_attn_forward(lp.cross_attn, acfg_x, h, kv)
    x = x + L.mlp_forward(lp.mlp, "gelu", L.apply_norm(cfg.norm, lp.norm2, x))
    return constrain(x, "batch", None, None)


def _layers(cfg: WhisperConfig, fn, layers, x: torch.Tensor, *args) -> torch.Tensor:
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        if remat:  # the layers draw no random numbers: no RNG state to keep
            x = checkpoint(fn, cfg, lp, x, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fn(cfg, lp, x, *args)
    return x


def encode(model: Whisper, cfg: WhisperConfig, audio_embeds: torch.Tensor) -> torch.Tensor:
    """(B, n_frames, d) frame embeddings -> the encoder states."""
    x = constrain(audio_embeds + model.enc_pos[None, :audio_embeds.shape[1]], "batch", None, None)
    x = _layers(cfg, _enc_layer, model.enc_layers, x)
    return L.apply_norm(cfg.norm, model.enc_norm, x)


def tied_logits(model: Whisper, cfg: WhisperConfig, x: torch.Tensor) -> torch.Tensor:
    logits = follow(x @ model.embed.t())
    if cfg.vocab_padded == cfg.vocab:
        return logits
    pad = like(torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab, logits)
    return logits.masked_fill(pad, -1e30)


def decode_hidden(model: Whisper, cfg: WhisperConfig, enc: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's final-normed states (B, S, d) of ``tokens`` over ``enc``."""
    S = tokens.shape[1]
    pos = torch.clamp(torch.arange(S, device=tokens.device), max=cfg.max_target_positions - 1)
    # the gather's partial sums reduced first (a vocab-sharded table on a mesh)
    table = constrain(model.embed, "vocab", None)  # fsdp shards gathered, as embed_tokens
    x = follow(constrain(torch.nn.functional.embedding(tokens, table), "batch", None, None))
    x = constrain(x + model.dec_pos[like(pos, tokens)][None], "batch", None, None)
    x = _layers(cfg, _dec_layer, model.dec_layers, x, enc)
    return L.apply_norm(cfg.norm, model.dec_norm, x)


def decode_train(model: Whisper, cfg: WhisperConfig, enc: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, vocab_padded), the padded
    vocabulary's at -1e30."""
    return tied_logits(model, cfg, decode_hidden(model, cfg, enc, tokens))


def loss(model: Whisper, cfg: WhisperConfig, audio_embeds: torch.Tensor,
         tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over labels >= 0, on f32 logits."""
    enc = encode(model, cfg, audio_embeds)
    logits = constrain(decode_train(model, cfg, enc, tokens).float(), "batch", None, "vocab")
    logz = torch.logsumexp(logits, dim=-1)
    gold = gold_logit(logits, labels)
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# -------------------------------------------------------------------- decode
@torch.no_grad()
def init_cache(model: Whisper, cfg: WhisperConfig, audio_embeds: torch.Tensor,
               cache_len: int) -> Dict[str, Any]:
    """Prefill: encode the audio once, each decoder layer's cross K/V of it,
    and an empty self-attention cache of ``cache_len`` slots a layer (in
    ``cfg.dtype``, as ``repro`` allocates it); ``t`` a host int."""
    enc = encode(model, cfg, audio_embeds)
    B = audio_embeds.shape[0]
    acfg_x = cfg.attn_cfg(False)
    cross = [L.encode_cross_kv(lp.cross_attn, acfg_x, enc) for lp in model.dec_layers]
    spec = L.KVCacheSpec(B, cache_len, cfg.n_kv, cfg.head_dim, ring=False)
    return {"self": [L.init_kv_cache(spec, torch_dtype(cfg.dtype), enc.device)
                     for _ in range(cfg.n_layers)],
            "cross_k": [k for k, _ in cross], "cross_v": [v for _, v in cross], "t": 0}


def abstract_cache(cfg: WhisperConfig, batch: int, cache_len: int, device) -> Dict[str, Any]:
    """``init_cache``'s tree, empty, on ``device`` (meta, or fake under fake
    mode): built from the shapes, so nothing is encoded."""
    dtype = torch_dtype(cfg.dtype)
    spec = L.KVCacheSpec(batch, cache_len, cfg.n_kv, cfg.head_dim, ring=False)
    cross = (batch, cfg.n_audio_frames, cfg.n_kv, cfg.head_dim)
    n = cfg.n_layers
    return {"self": [L.init_kv_cache(spec, dtype, device) for _ in range(n)],
            "cross_k": [torch.empty(cross, dtype=dtype, device=device) for _ in range(n)],
            "cross_v": [torch.empty(cross, dtype=dtype, device=device) for _ in range(n)],
            "t": 0}


def cache_pspecs(cfg: WhisperConfig) -> Dict[str, Any]:
    """``init_cache``'s tree with each tensor's mesh-axis tuple: the self
    cache flattened (B, S, n_kv * head_dim), the cross K/V in head layout
    with heads replicated, as ``repro``'s (less its stacked leading axis)."""
    from repro_torch.models.sharding import spec as S

    n = cfg.n_layers
    kv = S("batch", None, "kv_heads")
    cross = S("batch", None, None, None)
    return {"self": [{"k": kv, "v": kv} for _ in range(n)], "cross_k": [cross] * n,
            "cross_v": [cross] * n, "t": ()}


@torch.no_grad()
def decode_step(model: Whisper, cfg: WhisperConfig, cache: Dict[str, Any],
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token (B, 1) -> (logits (B, vocab_padded), cache with ``t``
    advanced); each layer's self-attention slot written in place."""
    t = int(cache["t"])
    pos = min(t, cfg.max_target_positions - 1)
    x = constrain(torch.nn.functional.embedding(token, constrain(model.embed, "vocab", None)),
                  "batch", None, None)
    x = x + model.dec_pos[pos][None, None]
    acfg_self, acfg_x = cfg.attn_cfg(True), cfg.attn_cfg(False)
    for lp, sc, ck, cv in zip(model.dec_layers, cache["self"], cache["cross_k"],
                              cache["cross_v"]):
        h = L.apply_norm(cfg.norm, lp.norm1, x)
        x = x + L.attn_decode_step(lp.self_attn, acfg_self, sc, h, t)[0]
        h = L.apply_norm(cfg.norm, lp.norm_x, x)
        x = x + L.cross_attn_forward(lp.cross_attn, acfg_x, h, (ck, cv))
        x = x + L.mlp_forward(lp.mlp, "gelu", L.apply_norm(cfg.norm, lp.norm2, x))
    x = L.apply_norm(cfg.norm, model.dec_norm, x)
    cache["t"] = t + 1
    return constrain(tied_logits(model, cfg, x)[:, 0, :], "batch", "vocab"), cache
