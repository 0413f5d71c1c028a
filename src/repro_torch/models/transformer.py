"""The decoder-only LM substrate: the counterpart of
``repro/models/transformer.py``.

One ``LMConfig`` describes every family; each layer is a (mixer, ffn)
block, the mixer ``attn`` or ``mamba`` and the ffn ``dense``, ``moe`` or
``none``: dense GQA archs (SmolLM, Qwen2, StarCoder2, DeepSeek-Coder) are
``("attn", "dense")`` throughout, Mixtral and OLMoE ``("attn", "moe")``,
Mamba2 ``("mamba", "none")``, and Jamba interleaves ``mamba|attn`` with
``dense|moe`` in its 8-layer period.

``repro`` stacks each parameter per offset of the block pattern and runs
the layers with ``lax.scan`` (leaf leading dim R, layer = rep * period +
off); here an ``LM`` module holds one ``Block`` per layer in order and the
forward is a Python loop, as PyTorch runs eagerly (``convert`` unstacks
``repro``'s tree). The MoE aux losses are summed per period and the period
sums then summed, as ``repro`` sums its scan's outputs. ``remat`` runs
each block, of any kind, under ``torch.utils.checkpoint`` when gradients
are recorded, as ``repro`` wraps each period of its scan in
``jax.checkpoint``: the block's activations are recomputed in the backward
(its flash forward launches again), and no value changes. ``constrain``
stands at ``repro``'s sites (the embeddings, each block's output, the head
and the logits) with its logical axes, and places DTensors on a device mesh
(``models/sharding.py``); ``gather_head``, ``shard_cache_seq`` and
``pad_heads`` select there what they select in ``repro``. ``LMConfig``'s
other compiler knobs (``remat_policy``, ``scan_layers``, ``use_flash``,
``block_q``) are kept so configs stay interchangeable, and select nothing: the full-sequence attention is the
flash kernel on CUDA whatever they say, and ``remat_policy="dots"``
(``repro`` saves the matmul outputs) recomputes the whole block here too,
which changes no value either.

The forward follows the parameters' dtype, not ``cfg.dtype``: ``repro``'s
Adam turns a bf16 model's parameters f32 at its first step (ROADMAP C6),
and so does the port's, after which both train in f32. A bf16 model keeps
its MoE routers and Mamba2's ``A_log``, ``D`` and ``dt_bias`` in f32
(``F32_LEAVES``), as ``repro`` does.

Weights come from the port's own init (``init_lm``): ``repro``'s
distributions and scales, drawn from an explicit ``torch.Generator``, so
not ``jax.random``'s numbers; conformance starts from ``repro``'s
parameters, converted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models.sharding import constrain, follow, like

BlockSpec = Tuple[str, str]  # (mixer, ffn)

MIXERS = ("attn", "mamba")
FFNS = ("dense", "moe", "none")
# leaves kept in f32 in a model of any dtype: MoE routers, Mamba2's decay,
# skip and dt bias
F32_LEAVES = ("router",) + M.F32_NAMES


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    head_dim: int = 128
    blocks: Tuple[BlockSpec, ...] = ()  # len == n_layers; default all (attn, dense)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, ...]] = None
    sliding_window: Optional[int] = None
    mlp_kind: str = "swiglu"
    norm: str = "rms"
    moe: Optional[MOE.MoEConfig] = None
    mamba: Optional[M.Mamba2Config] = None
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True  # each block under torch.utils.checkpoint while training
    use_flash: bool = False  # selects nothing: the flash kernel always runs on CUDA
    aux_loss_weight: float = 0.01
    scan_layers: bool = True  # selects nothing (layers are a Python loop)
    block_q: int = 256  # selects nothing
    remat_policy: str = "full"  # selects nothing ("dots" recomputes in full too)
    gather_head: bool = False  # the head gathered to (d, vocab on model) first (a mesh)
    shard_cache_seq: bool = False  # the decode cache sharded on its sequence (a mesh)
    pad_heads: bool = False  # padded query heads, head-parallel attention on a mesh

    @property
    def vocab_padded(self) -> int:
        """Embedding rows, padded to a multiple of 256 as ``repro`` pads them
        for its mesh; logits past ``vocab`` are masked."""
        return -(-self.vocab // 256) * 256

    def block_list(self) -> Tuple[BlockSpec, ...]:
        return self.blocks if self.blocks else tuple([("attn", "dense")] * self.n_layers)

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.head_dim, qkv_bias=self.qkv_bias, causal=True,
            sliding_window=self.sliding_window, rope_theta=self.rope_theta,
            mrope_sections=self.mrope_sections, chunk_unroll=not self.scan_layers,
            block_q=self.block_q, shard_cache_seq=self.shard_cache_seq,
            pad_heads=self.pad_heads,
        )

    def mamba_cfg(self) -> M.Mamba2Config:
        return dataclasses.replace(self.mamba, chunk_unroll=not self.scan_layers)

    def period(self) -> int:
        """Smallest repeating period of the block pattern (``repro``'s scan
        unit: its parameters are stacked per offset of it)."""
        blocks = self.block_list()
        n = len(blocks)
        for p in range(1, n + 1):
            if n % p == 0 and all(blocks[i] == blocks[i % p] for i in range(n)):
                return p
        return n


def check_block(spec: BlockSpec) -> None:
    """Raise for a (mixer, ffn) pair outside ``MIXERS`` x ``FFNS``."""
    mixer, ffn = spec
    if mixer not in MIXERS or ffn not in FFNS:
        raise ValueError(f"block {spec}: mixer in {MIXERS}, ffn in {FFNS}")


def leaf_dtype(cfg: LMConfig, name: str) -> torch.dtype:
    """The dtype of parameter ``name`` (a ``state_dict`` key) in a fresh or
    converted model of ``cfg``: f32 for ``F32_LEAVES``, else ``cfg.dtype``."""
    return torch.float32 if name.rsplit(".", 1)[-1] in F32_LEAVES else torch_dtype(cfg.dtype)


# ---------------------------------------------------------------- parameters
class Block(nn.Module):
    """One layer: ``norm1`` and the mixer (``attn`` or ``mamba``), then,
    unless the ffn is ``"none"``, ``norm2`` and the ffn (``mlp`` or ``moe``).
    The fields of the kinds the layer does not have are None."""

    def __init__(self, norm1: L.Norm, mixer: nn.Module, norm2: Optional[L.Norm] = None,
                 ffn: Optional[nn.Module] = None):
        super().__init__()
        if (norm2 is None) != (ffn is None):
            raise ValueError("norm2 comes with an ffn and only with one")
        self.norm1 = norm1
        self.attn = mixer if isinstance(mixer, L.Attention) else None
        self.mamba = mixer if isinstance(mixer, M.Mamba2) else None
        if self.attn is None and self.mamba is None:
            raise TypeError(f"a block's mixer is Attention or Mamba2, not {type(mixer).__name__}")
        self.norm2 = norm2
        self.mlp = ffn if isinstance(ffn, L.MLP) else None
        self.moe = ffn if isinstance(ffn, MOE.MoE) else None
        if ffn is not None and self.mlp is None and self.moe is None:
            raise TypeError(f"a block's ffn is MLP or MoE, not {type(ffn).__name__}")

    def spec(self) -> BlockSpec:
        return ("attn" if self.attn is not None else "mamba",
                "dense" if self.mlp is not None else "moe" if self.moe is not None else "none")


class LM(nn.Module):
    """``embed`` (vocab_padded, d), ``final_norm``, one ``Block`` per layer
    in ``layers``, and ``lm_head`` (d, vocab_padded) unless tied."""

    def __init__(self, cfg: LMConfig, embed: torch.Tensor, final_norm: L.Norm,
                 layers: List[Block], lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} blocks for {cfg.n_layers} layers")
        for i, (spec, block) in enumerate(zip(cfg.block_list(), layers)):
            check_block(spec)
            if block.spec() != spec:
                raise ValueError(f"layer {i} is a {block.spec()} block, the config says {spec}")
        if cfg.tie_embeddings != (lm_head is None):
            raise ValueError("lm_head must be given exactly when embeddings are not tied")
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


def init_lm(gen: torch.Generator, cfg: LMConfig, device=None) -> LM:
    """Fresh weights with ``repro``'s distributions and scales: N(0, 1/d)
    projections (1/(H*hd) for ``wo``, 1/d_ff for ``wd``), unit norms, zero
    biases, N(0, 1/d) embedding and head, the MoE's and Mamba2's as
    ``init_moe`` and ``init_mamba2`` draw them; drawn in f32 from ``gen``
    (on its device), layer by layer, then cast to ``cfg.dtype`` on
    ``device`` (``F32_LEAVES`` stay f32)."""
    dtype = torch_dtype(cfg.dtype)
    layers = []
    for mixer, ffn in cfg.block_list():
        check_block((mixer, ffn))
        norm1 = L.init_norm(cfg.norm, cfg.d_model, dtype, device)
        if mixer == "attn":
            mix = L.init_attn(gen, cfg.attn_cfg(), dtype, device)
        else:
            mix = M.init_mamba2(gen, cfg.mamba, dtype, device)
        norm2 = None if ffn == "none" else L.init_norm(cfg.norm, cfg.d_model, dtype, device)
        if ffn == "dense":
            ff = L.init_mlp(gen, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dtype, device)
        elif ffn == "moe":
            ff = MOE.init_moe(gen, cfg.moe, dtype, device)
        else:
            ff = None
        layers.append(Block(norm1, mix, norm2, ff))
    scale = 1.0 / np.sqrt(cfg.d_model)
    embed = L.init_normal(gen, (cfg.vocab_padded, cfg.d_model), scale, dtype, device)
    head = None if cfg.tie_embeddings else L.init_normal(
        gen, (cfg.d_model, cfg.vocab_padded), scale, dtype, device)
    return LM(cfg, embed, L.init_norm(cfg.norm, cfg.d_model, dtype, device), layers, head)


# --------------------------------------------------------------- param specs
def _flat(prefix: str, tree: Dict[str, Any], out: Dict[str, Any]) -> Dict[str, Any]:
    for name, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{name}.", v, out)
        else:
            out[prefix + name] = v
    return out


def norm_pspecs(kind: str) -> Dict[str, Any]:
    from repro_torch.models.sharding import spec as S

    return {"scale": S(None)} if kind == "rms" else {"scale": S(None), "bias": S(None)}


def attn_pspecs(qkv_bias: bool) -> Dict[str, Any]:
    from repro_torch.models.sharding import spec as S

    d = {"wq": S("fsdp", "heads"), "wk": S("fsdp", "kv_heads"),
         "wv": S("fsdp", "kv_heads"), "wo": S("heads", "fsdp")}
    if qkv_bias:
        d.update({"bq": S("heads"), "bk": S("kv_heads"), "bv": S("kv_heads")})
    return d


def mlp_pspecs(kind: str) -> Dict[str, Any]:
    from repro_torch.models.sharding import spec as S

    if kind == "swiglu":
        return {"wg": S("fsdp", "ffn"), "wu": S("fsdp", "ffn"), "wd": S("ffn", "fsdp")}
    return {"wu": S("fsdp", "ffn"), "bu": S("ffn"), "wd": S("ffn", "fsdp"), "bd": S(None)}


def param_pspecs(cfg: LMConfig) -> Dict[str, Any]:
    """Each parameter's mesh-axis tuple (``sharding.spec``) under the current
    rules, keyed by its name in ``named_parameters()``: ``repro``'s
    ``param_pspecs`` less its stacked leading (scan) axis, layer by layer."""
    from repro_torch.models.sharding import spec as S

    def moe_specs(m: MOE.MoEConfig):
        if m.shard == "ep":  # experts over model, dims over fsdp
            d = {"router": S(None, None), "wu": S("experts", "fsdp", None),
                 "wd": S("experts", None, "fsdp")}
            if m.mlp_kind == "swiglu":
                d["wg"] = S("experts", "fsdp", None)
        else:  # tp: each expert's ffn dim over model
            d = {"router": S(None, None), "wu": S(None, "fsdp", "ffn"),
                 "wd": S(None, "ffn", "fsdp")}
            if m.mlp_kind == "swiglu":
                d["wg"] = S(None, "fsdp", "ffn")
        return d

    mamba = {"wz": S("fsdp", "mamba_heads"), "wx": S("fsdp", "mamba_heads"),
             "wB": S("fsdp", None), "wC": S("fsdp", None), "wdt": S("fsdp", None),
             "wo": S("mamba_heads", "fsdp"), "conv": S(None, None), "A_log": S(None),
             "D": S(None), "dt_bias": S(None), "norm_scale": S(None)}
    out = {"embed": S("vocab", "fsdp")}
    for i, (mixer, ffn) in enumerate(cfg.block_list()):
        d: Dict[str, Any] = {"norm1": norm_pspecs(cfg.norm)}
        d[mixer] = attn_pspecs(cfg.qkv_bias) if mixer == "attn" else dict(mamba)
        if ffn != "none":
            d["norm2"] = norm_pspecs(cfg.norm)
        if ffn == "dense":
            d["mlp"] = mlp_pspecs(cfg.mlp_kind)
        elif ffn == "moe":
            d["moe"] = moe_specs(cfg.moe)
        _flat(f"layers.{i}.", d, out)
    _flat("final_norm.", norm_pspecs(cfg.norm), out)
    if not cfg.tie_embeddings:
        out["lm_head"] = S("fsdp", "vocab")
    return out


# ------------------------------------------------------------------- forward
def embed_tokens(model: LM, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The parameter server's pull (paper §3.6): a gather from the
    vocab-sharded table, which on a mesh DTensor computes as a masked
    partial sum over the vocab shards (``ps_lookup``'s pull)."""
    # on a mesh the table's fsdp shards are gathered first (as sharded data
    # parallelism gathers a weight before its use): DTensor's masked partial
    # sum keeps the mask of the ids it was given, which an id gather on the
    # same mesh dim would outdate
    x = torch.nn.functional.embedding(tokens, constrain(model.embed, "vocab", None))
    if tokens.shape[1] > 1:  # decode steps keep S = 1 replicated
        return follow(constrain(x, "batch", "seq", None))
    return follow(constrain(x, "batch", None, None))


def _gather_seq(h: torch.Tensor) -> torch.Tensor:
    """A block's normed input with the sequence gathered, as ``repro``'s
    mixers gather it on entry from the sequence-parallel residual stream.
    On a mesh this is the all-gather GSPMD places there; DTensor would
    otherwise flatten (batch, seq) sharded on two mesh axes into one
    strided shard, whose redistributions it plans by a search over every
    placement of every mesh dim."""
    return constrain(h, "batch", None, None)


def _to_residual(y: torch.Tensor) -> torch.Tensor:
    """A mixer's or ffn's output placed as the sequence-parallel residual
    stream before the add (the reduce-scatter of its partial sums GSPMD
    places there). Explicit, so that autograd carries its gradient back
    through the redistribution: an add DTensor reshards inside would hand
    the output's sequence shards to the product's backward, whose view
    DTensor cannot flatten."""
    return constrain(y, "batch", "seq", None)


def _block_apply(cfg: LMConfig, spec: BlockSpec, bp: Block, x: torch.Tensor,
                 positions: Optional[torch.Tensor],
                 acfg: Optional[L.AttnConfig] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block -> (x, its MoE aux loss, 0 without a MoE)."""
    mixer, ffn = spec
    aux = like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    h = _gather_seq(L.apply_norm(cfg.norm, bp.norm1, x))
    if mixer == "attn":
        y = L.attn_forward(bp.attn, acfg or cfg.attn_cfg(), h, positions, cfg.use_flash)
    else:
        y = M.mamba2_forward(bp.mamba, cfg.mamba_cfg(), h)
    x = x + _to_residual(y)
    if ffn == "dense":
        y = L.mlp_forward(bp.mlp, cfg.mlp_kind, _gather_seq(L.apply_norm(cfg.norm, bp.norm2, x)))
        x = x + _to_residual(y)
    elif ffn == "moe":
        y, aux = MOE.moe_forward(bp.moe, cfg.moe,
                                 _gather_seq(L.apply_norm(cfg.norm, bp.norm2, x)))
        x = x + _to_residual(y)
    # the sequence-parallel residual stream: seq sharded over the model axis
    return constrain(x, "batch", "seq", None), aux


def hidden_states(model: LM, cfg: LMConfig, tokens: Optional[torch.Tensor] = None,
                  inputs_embeds: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer and the final norm -> ((B, S, d), aux_loss). With
    ``cfg.remat`` and gradients recorded, each block is checkpointed. The
    aux loss sums each period's blocks from zero, then the period sums."""
    x = inputs_embeds if inputs_embeds is not None else embed_tokens(model, cfg, tokens)
    acfg = cfg.attn_cfg()
    zero = like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    period = cfg.period()
    remat = cfg.remat and torch.is_grad_enabled()
    period_aux = []
    for i, (spec, bp) in enumerate(zip(cfg.block_list(), model.layers)):
        if i % period == 0:
            period_aux.append(zero)
        if remat:  # the blocks draw no random numbers: no RNG state to keep
            x, a = checkpoint(_block_apply, cfg, spec, bp, x, positions, acfg,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _block_apply(cfg, spec, bp, x, positions, acfg)
        period_aux[-1] = period_aux[-1] + a
    return _gather_seq(L.apply_norm(cfg.norm, model.final_norm, x)), torch.stack(period_aux).sum()


def forward(model: LM, cfg: LMConfig, tokens: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, vocab_padded), aux_loss)."""
    x, aux = hidden_states(model, cfg, tokens, inputs_embeds, positions)
    logits = _mask_padded_vocab(cfg, follow(x @ head(model, cfg)))
    return constrain(logits, "batch", None, "vocab"), aux


def head(model: LM, cfg: LMConfig) -> torch.Tensor:
    """The (d, vocab_padded) head; with ``gather_head`` pulled to (d
    replicated, vocab on model) before the product, as ``repro`` does: one
    weight all-gather in place of the logits' all-reduce."""
    w = model.head()
    return constrain(w, None, "vocab") if cfg.gather_head else w


def _mask_padded_vocab(cfg: LMConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab:
        return logits
    pad = like(torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab, logits)
    return logits.masked_fill(pad, -1e30)


def gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit, as ``repro``'s compare-select-reduce form."""
    hit = like(torch.arange(logits.shape[-1], device=logits.device), logits) == labels[..., None]
    return torch.where(hit, logits, 0.0).sum(dim=-1)


def lm_loss(model: LM, cfg: LMConfig, tokens: torch.Tensor, labels: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over labels >= 0 (+ the aux loss),
    differentiable in every parameter (the flash attention's backward is a
    kernel on CUDA, its plain version on the CPU)."""
    logits, aux = forward(model, cfg, tokens, inputs_embeds, positions)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = gold_logit(logits, labels)
    mask = (labels >= 0).float()
    ce = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + cfg.aux_loss_weight * aux


# -------------------------------------------------------------------- decode
def init_cache(cfg: LMConfig, batch: int, cache_len: int, device=None) -> Dict[str, Any]:
    """One cache per layer, {"k", "v"} for an attention layer and {"ssm",
    "conv"} for a Mamba2 one, and the position ``t`` (a host int).
    ``cache_len`` is the context for dense archs; SWA archs keep a ring of
    ``min(cache_len, window)`` slots."""
    dtype = torch_dtype(cfg.dtype)
    caches = []
    for mixer, ffn in cfg.block_list():
        check_block((mixer, ffn))
        if mixer == "mamba":
            caches.append(M.init_mamba_cache(cfg.mamba, batch, dtype, device))
            continue
        s_max = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
        caches.append(L.init_kv_cache(
            L.KVCacheSpec(batch, s_max, cfg.n_kv, cfg.head_dim,
                          ring=cfg.sliding_window is not None), dtype, device))
    return {"layers": caches, "t": 0}


def cache_pspecs(cfg: LMConfig) -> Dict[str, Any]:
    """``init_cache``'s tree with each tensor's mesh-axis tuple under the
    current rules (``repro``'s less its stacked leading axis, layer by
    layer); ``t``, a host int, has the empty tuple."""
    from repro_torch.models.sharding import spec as S

    out = []
    for mixer, _ in cfg.block_list():
        if mixer == "attn":  # the flattened (B, S, n_kv * head_dim) layout
            seq_ax = "cache_seq" if cfg.shard_cache_seq else None
            kv_ax = None if cfg.shard_cache_seq else "kv_heads"
            out.append({"k": S("batch", seq_ax, kv_ax), "v": S("batch", seq_ax, kv_ax)})
        else:  # the conv channels mix x, B and C: replicated on the channel dim
            out.append({"ssm": S("batch", "mamba_heads", None, None),
                        "conv": S("batch", None, None)})
    return {"layers": out, "t": ()}


@torch.no_grad()
def decode_step(model: LM, cfg: LMConfig, cache: Dict[str, Any],
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token serve step -> (logits (B, vocab_padded), cache).

    The cache is updated IN PLACE (one KV slot, or the state and conv
    history, per layer) and returned with ``t`` advanced; ``repro`` returns
    a new cache instead. A MoE layer routes the token as a group of one
    (g 1, C 4: no drops).
    """
    x = embed_tokens(model, cfg, token)
    t = int(cache["t"])
    acfg = cfg.attn_cfg()
    for (mixer, ffn), bp, c in zip(cfg.block_list(), model.layers, cache["layers"]):
        h = L.apply_norm(cfg.norm, bp.norm1, x)
        if mixer == "attn":
            y, _ = L.attn_decode_step(bp.attn, acfg, c, h, t)
        else:
            y, _ = M.mamba2_decode_step(bp.mamba, cfg.mamba, c, h)
        x = x + y
        if ffn == "dense":
            x = x + L.mlp_forward(bp.mlp, cfg.mlp_kind, L.apply_norm(cfg.norm, bp.norm2, x))
        elif ffn == "moe":
            x = x + MOE.moe_forward(bp.moe, cfg.moe, L.apply_norm(cfg.norm, bp.norm2, x))[0]
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    logits = _mask_padded_vocab(cfg, x @ head(model, cfg))[:, 0, :]
    cache["t"] = t + 1
    return constrain(logits, "batch", "vocab"), cache
