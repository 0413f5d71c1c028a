"""Weights across the two packages, and ``repro``'s flat-npz checkpoints.

``repro`` keeps parameters as a flat dict of arrays under path-like keys:
``emb/node``, ``emb/slot:<name>``, ``gnn/l{L}/r{R}/<w|w1|w2|eps|a_self|a_nbr>``,
``gnn/att/W`` and ``gnn/att/w``. ``params_from_numpy`` builds a
``Graph4RecModel`` from such a dict (checking every key and shape against
the config) and ``model_to_numpy`` is its inverse. ``load_params`` reads a
``repro.train.checkpoint`` ``.npz``; the save/load rules of that module
(``|``-joined keys for nested dicts, the ``.npz`` suffix) are copied here.

``init_params`` draws fresh parameters from a ``torch.Generator`` for runs
without a checkpoint. It cannot reproduce ``jax.random``'s draws, so every
conformance check starts from parameters ``repro`` made, converted.

An IVF index crosses as its numpy fields: ``ivf_index_from_numpy`` makes
the port's ``IVFIndex`` on a device from ``repro``'s (or any object with
the same fields), so both packages can search the very same index.

The LM substrate's weights cross as ``repro``'s parameter tree of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``):
``lm_params_from_numpy`` unstacks its per-offset ``layers`` (leaf leading
dim R, layer = rep * period + off) into the port's per-layer blocks, of
any (mixer, ffn) kind, and ``lm_model_to_numpy`` stacks them back. bf16
arrives as an ``ml_dtypes`` array; it is recognised by its dtype's name and
moved as its 16 bits, so the round trip is bitwise. Each leaf must be in
``cfg.dtype``, except ``transformer.F32_LEAVES`` (MoE routers, Mamba2's
``A_log``, ``D``, ``dt_bias``), which must be f32. Qwen2-VL's tree is an
LM tree and goes the same way. Whisper's (``whisper_params_from_numpy`` /
``whisper_model_to_numpy``) stacks each layer kind on a leading axis of
``n_layers`` (``enc_layers``, ``dec_layers``), which the port unstacks into
one module a layer; every leaf is in ``cfg.dtype``.

Optimizer states cross the same way: ``state_to_numpy`` turns the trainer's
state (``RowAdagradState.accum``, ``AdamState`` step/mu/nu, nested in
tuples and dicts as ``repro`` nests them) into numpy, and
``state_from_numpy`` rebuilds the port's state from such a tree, whichever
package made it: a NamedTuple maps by its field names.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.model import Graph4RecConfig, Graph4RecModel, init_model_params
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.retrieval.ivf import IVFConfig, IVFIndex


def expected_shapes(cfg: Graph4RecConfig) -> Dict[str, tuple]:
    """Every parameter key of ``cfg`` with its shape (no draws made)."""
    # the inits take a generator, but on the meta device they draw nothing:
    # the seed reaches no value
    gen = torch.Generator().manual_seed(0)  # repro_torch: lint-ignore[D004]
    with torch.device("meta"):
        params = init_model_params(gen, cfg)
    return {k: tuple(v.shape) for k, v in params.items()}


def params_from_numpy(
    flat: Mapping[str, np.ndarray], cfg: Graph4RecConfig, device: DeviceLike = None
) -> Graph4RecModel:
    """``repro``-keyed arrays -> a ``Graph4RecModel`` on ``device``."""
    dev = resolve_device(device)
    want = expected_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"params do not match the config: missing {missing}, "
                       f"unexpected {extra}")
    bad = {k: (tuple(np.shape(flat[k])), s) for k, s in want.items()
           if tuple(np.shape(flat[k])) != s}
    if bad:
        raise ValueError(f"param shapes (got, want) differ from the config: {bad}")
    tensors = {
        k: torch.from_numpy(np.array(flat[k], dtype=np.float32)).to(dev) for k in want
    }
    return Graph4RecModel(cfg, tensors)


def model_to_numpy(model: Graph4RecModel) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: host float32 arrays."""
    return {k: v.detach().cpu().numpy() for k, v in model.params.items()}


def init_params(cfg: Graph4RecConfig, seed: int = 0, device: DeviceLike = None) -> Graph4RecModel:
    """Fresh parameters from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    params = init_model_params(torch.Generator().manual_seed(int(seed)), cfg)
    return Graph4RecModel(cfg, {k: v.to(dev) for k, v in params.items()})


# ----------------------------------------------------------------- IVF index
def ivf_index_from_numpy(index: Any, device: DeviceLike = None) -> IVFIndex:
    """An IVF index's fields (``config`` with ``IVFConfig``'s fields,
    ``centroids``, ``order``, ``offsets``, ``codes``, ``scales``, ``items``,
    ``lpad``, ``spilled_items``) -> the port's ``IVFIndex`` on ``device``,
    uploaded there once. Takes ``repro.retrieval.IVFIndex`` as it is."""
    cfg = IVFConfig(**{f.name: getattr(index.config, f.name)
                       for f in dataclasses.fields(IVFConfig)})
    cfg.validate()
    arrays = {name: np.array(getattr(index, name), dtype=dtype) for name, dtype in (
        ("centroids", np.float32), ("order", np.int32), ("offsets", np.int32),
        ("codes", np.int8), ("scales", np.float32), ("items", np.float32))}
    return IVFIndex(config=cfg, lpad=int(index.lpad),
                    spilled_items=int(index.spilled_items), device=device, **arrays)


# ----------------------------------------------------------------- LM weights
def _lm_tensor(a: Any) -> torch.Tensor:
    """A numpy leaf -> a CPU tensor; bf16 (``ml_dtypes``) by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _lm_array(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a host numpy array; bf16 as ``np.dtype("bfloat16")``
    where numpy knows that name (``ml_dtypes`` imported by some other
    module), else as its raw uint16 bits."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
    try:
        return bits.view(np.dtype("bfloat16"))
    except TypeError:
        return bits


_BLOCK_GROUPS = ("norm1", "attn", "mamba", "norm2", "mlp", "moe")


def _lm_block_params(cfg: T.LMConfig, spec: T.BlockSpec, layer: Dict[str, Any],
                     rep: int) -> T.Block:
    mixer, ffn = spec
    want = {"norm1", mixer} | (set() if ffn == "none" else
                               {"norm2", "mlp" if ffn == "dense" else "moe"})
    if set(layer) != want:
        raise KeyError(f"a {spec} block has groups {sorted(want)}, the tree {sorted(layer)}")

    def group(name):
        return {k: _lm_tensor(np.asarray(v)[rep]) for k, v in layer[name].items()}

    def norm(name):
        g = group(name)
        if not set(g) <= {"scale", "bias"}:
            raise KeyError(f"{name} params {sorted(g)}: a norm has scale and bias only")
        return L.Norm(cfg.norm, g["scale"], g.get("bias"))

    mix = (L.Attention(cfg.attn_cfg(), group("attn")) if mixer == "attn"
           else M.Mamba2(group("mamba")))
    if ffn == "none":
        return T.Block(norm("norm1"), mix)
    ff = L.MLP(cfg.mlp_kind, group("mlp")) if ffn == "dense" else MOE.MoE(cfg.moe, group("moe"))
    return T.Block(norm("norm1"), mix, norm("norm2"), ff)


def lm_params_from_numpy(cfg: T.LMConfig, tree: Mapping[str, Any],
                         device: DeviceLike = None) -> T.LM:
    """``repro``'s LM parameter tree (numpy leaves) -> an ``LM`` on
    ``device``. Every name, shape and dtype is checked against ``cfg``."""
    dev = resolve_device(device)
    specs = cfg.block_list()
    for spec in specs:
        T.check_block(spec)
    p = cfg.period()
    R = cfg.n_layers // p
    stacked = tree["layers"]
    if len(stacked) != p:
        raise ValueError(f"{len(stacked)} stacked offsets for a block period of {p}")
    blocks = [_lm_block_params(cfg, specs[i], stacked[i % p], i // p)
              for i in range(cfg.n_layers)]
    for off, layer in enumerate(stacked):
        for name, group in layer.items():
            for leaf, a in group.items():
                if np.shape(a)[0] != R:
                    raise ValueError(f"layers[{off}].{name}.{leaf}: leading dim "
                                     f"{np.shape(a)[0]}, want {R} repetitions")
    fn = {k: _lm_tensor(v) for k, v in tree["final_norm"].items()}
    head = tree.get("lm_head")
    model = T.LM(cfg, _lm_tensor(tree["embed"]), L.Norm(cfg.norm, fn["scale"], fn.get("bias")),
                 blocks, None if head is None else _lm_tensor(head))
    want = lm_param_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"LM params do not match the config: {bad[:8]}")
    wrong = sorted(f"{k} {v.dtype} (want {T.leaf_dtype(cfg, k)})"
                   for k, v in model.state_dict().items() if v.dtype != T.leaf_dtype(cfg, k))
    if wrong:
        raise TypeError(f"LM params of the wrong dtype: {wrong[:8]}")
    return model.to(dev)


def lm_param_shapes(cfg: T.LMConfig) -> Dict[str, tuple]:
    """Every parameter of ``cfg``'s ``LM`` (``state_dict`` names) with its shape."""
    a = cfg.attn_cfg()
    d, H, K, hd, ff = cfg.d_model, a.n_heads_padded, cfg.n_kv, cfg.head_dim, cfg.d_ff
    norm = {"scale": (d,)} if cfg.norm == "rms" else {"scale": (d,), "bias": (d,)}
    attn = {"wq": (d, H * hd), "wk": (d, K * hd), "wv": (d, K * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(H * hd,), bk=(K * hd,), bv=(K * hd,))
    mlp = ({"wg": (d, ff), "wu": (d, ff), "wd": (ff, d)} if cfg.mlp_kind == "swiglu"
           else {"wu": (d, ff), "bu": (ff,), "wd": (ff, d), "bd": (d,)})
    groups = {"norm1": norm, "attn": attn, "norm2": norm, "mlp": mlp}
    if cfg.moe is not None:
        m = cfg.moe
        E, mf = m.num_experts, m.d_ff
        groups["moe"] = {"router": (d, E), "wu": (E, d, mf), "wd": (E, mf, d)}
        if m.mlp_kind == "swiglu":
            groups["moe"]["wg"] = (E, d, mf)
    if cfg.mamba is not None:
        mc = cfg.mamba
        di, N, Hm = mc.d_inner, mc.d_state, mc.n_heads
        groups["mamba"] = {"wz": (d, di), "wx": (d, di), "wB": (d, N), "wC": (d, N),
                           "wdt": (d, Hm), "wo": (di, d), "conv": (mc.conv_width, di + 2 * N),
                           "A_log": (Hm,), "D": (Hm,), "dt_bias": (Hm,), "norm_scale": (di,)}
    out = {"embed": (cfg.vocab_padded, d)}
    for i, (mixer, ffn) in enumerate(cfg.block_list()):
        names = ["norm1", mixer] + ([] if ffn == "none" else
                                    ["norm2", "mlp" if ffn == "dense" else "moe"])
        for gname in names:
            out.update({f"layers.{i}.{gname}.{k}": s for k, s in groups[gname].items()})
    out.update({f"final_norm.{k}": s for k, s in norm.items()})
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_padded)
    return out


def lm_model_to_numpy(model: T.LM) -> Dict[str, Any]:
    """The inverse of ``lm_params_from_numpy``: ``repro``'s tree, per-offset
    stacked, as host arrays (bf16 as ``_lm_array`` gives it)."""
    cfg = model.cfg
    p = cfg.period()
    R = cfg.n_layers // p

    def module_leaves(m):
        return {k: v for k, v in m.named_parameters(recurse=False)}

    stacked = []
    for off in range(p):
        layer = {}
        for gname in _BLOCK_GROUPS:
            if getattr(model.layers[off], gname) is None:
                continue
            names = module_leaves(getattr(model.layers[off], gname))
            layer[gname] = {
                k: np.stack([_lm_array(getattr(getattr(model.layers[rep * p + off], gname), k))
                             for rep in range(R)])
                for k in names}
        stacked.append(layer)
    tree = {"embed": _lm_array(model.embed),
            "final_norm": {k: _lm_array(v) for k, v in module_leaves(model.final_norm).items()},
            "layers": stacked}
    if model.lm_head is not None:
        tree["lm_head"] = _lm_array(model.lm_head)
    return tree


def whisper_param_shapes(cfg: W.WhisperConfig) -> Dict[str, tuple]:
    """Every parameter of ``cfg``'s ``Whisper`` (``state_dict`` names) with its shape."""
    d, H, K, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_ff
    norm = {"scale": (d,), "bias": (d,)}
    attn = {"wq": (d, H * hd), "wk": (d, K * hd), "wv": (d, K * hd), "wo": (H * hd, d),
            "bq": (H * hd,), "bk": (K * hd,), "bv": (K * hd,)}
    mlp = {"wu": (d, ff), "bu": (ff,), "wd": (ff, d), "bd": (d,)}
    groups = {"norm1": norm, "attn": attn, "self_attn": attn, "cross_attn": attn,
              "norm_x": norm, "norm2": norm, "mlp": mlp}
    out = {"enc_pos": (cfg.n_audio_frames, d), "dec_pos": (cfg.max_target_positions, d),
           "embed": (cfg.vocab_padded, d)}
    for stack, names in (("enc_layers", W.ENC_GROUPS), ("dec_layers", W.DEC_GROUPS)):
        for i in range(cfg.n_layers):
            for g in names:
                out.update({f"{stack}.{i}.{g}.{k}": s for k, s in groups[g].items()})
    for n in ("enc_norm", "dec_norm"):
        out.update({f"{n}.{k}": s for k, s in norm.items()})
    return out


def whisper_params_from_numpy(cfg: W.WhisperConfig, tree: Mapping[str, Any],
                              device: DeviceLike = None) -> W.Whisper:
    """``repro``'s Whisper parameter tree (numpy leaves, each layer kind
    stacked on a leading axis) -> a ``Whisper`` on ``device``. Every name,
    shape and dtype is checked against ``cfg``."""
    dev = resolve_device(device)
    acfg = {"attn": cfg.attn_cfg(False), "self_attn": cfg.attn_cfg(True),
            "cross_attn": cfg.attn_cfg(False)}

    def layer(stacked: Mapping[str, Any], names, i: int) -> list:
        if set(stacked) != set(names):
            raise KeyError(f"layer groups {sorted(stacked)}, want {sorted(names)}")
        out = []
        for g in names:
            leaves = {k: _lm_tensor(np.asarray(v)[i]) for k, v in stacked[g].items()}
            if g in acfg:
                out.append(L.Attention(acfg[g], leaves))
            elif g == "mlp":
                out.append(L.MLP("gelu", leaves))
            else:
                out.append(L.Norm(cfg.norm, leaves["scale"], leaves.get("bias")))
        return out

    def norm(g):
        return L.Norm(cfg.norm, *(_lm_tensor(g[k]) for k in ("scale", "bias")))

    enc = [W.EncoderLayer(*layer(tree["enc_layers"], W.ENC_GROUPS, i))
           for i in range(cfg.n_layers)]
    dec = [W.DecoderLayer(*layer(tree["dec_layers"], W.DEC_GROUPS, i))
           for i in range(cfg.n_layers)]
    model = W.Whisper(cfg, _lm_tensor(tree["enc_pos"]), _lm_tensor(tree["dec_pos"]),
                      _lm_tensor(tree["embed"]), enc, dec, norm(tree["enc_norm"]),
                      norm(tree["dec_norm"]))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = whisper_param_shapes(cfg)
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"Whisper params do not match the config: {bad[:8]}")
    for stack in ("enc_layers", "dec_layers"):
        for gname, group in tree[stack].items():
            for leaf, a in group.items():
                if np.shape(a)[0] != cfg.n_layers:
                    raise ValueError(f"{stack}.{gname}.{leaf}: leading dim {np.shape(a)[0]}, "
                                     f"want {cfg.n_layers} layers")
    dtype = T.torch_dtype(cfg.dtype)
    wrong = sorted(f"{k} {v.dtype}" for k, v in model.state_dict().items() if v.dtype != dtype)
    if wrong:
        raise TypeError(f"Whisper params not in {dtype}: {wrong[:8]}")
    return model.to(dev)


def whisper_model_to_numpy(model: W.Whisper) -> Dict[str, Any]:
    """The inverse of ``whisper_params_from_numpy``: ``repro``'s tree, each
    layer kind stacked on a leading axis, as host arrays."""
    def leaves(m):
        return {k: _lm_array(v) for k, v in m.named_parameters(recurse=False)}

    def stacked(layers, names):
        per = [{g: leaves(getattr(lp, g)) for g in names} for lp in layers]
        return {g: {k: np.stack([p[g][k] for p in per]) for k in per[0][g]} for g in names}

    return {"enc_pos": _lm_array(model.enc_pos), "dec_pos": _lm_array(model.dec_pos),
            "embed": _lm_array(model.embed),
            "enc_layers": stacked(model.enc_layers, W.ENC_GROUPS),
            "dec_layers": stacked(model.dec_layers, W.DEC_GROUPS),
            "enc_norm": leaves(model.enc_norm), "dec_norm": leaves(model.dec_norm)}


# ------------------------------------------------------- optimizer states
def state_to_numpy(tree: Any) -> Any:
    """An optimizer state (NamedTuples, tuples, dicts of tensors) -> the
    same structure of host numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return _lm_array(tree)  # bf16 moments as their bits (an LM's, sgd's, adagrad's)
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(state_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_to_numpy(v) for v in tree)
    return tree


def _state_types() -> Dict[tuple, type]:
    from repro_torch.embedding.optimizer import RowAdagradState
    from repro_torch.train.optimizer import AdamState

    return {AdamState._fields: AdamState, RowAdagradState._fields: RowAdagradState}


def state_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """The inverse of ``state_to_numpy`` onto ``device``; also takes
    ``repro``'s states (``RowAdagradState``, ``AdamState``) as numpy."""
    dev = resolve_device(device)
    types = _state_types()

    def conv(t):
        if isinstance(t, (np.ndarray, np.generic)):
            return _lm_tensor(t).to(dev)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            cls = types.get(tuple(t._fields))
            if cls is None:
                raise TypeError(f"no port optimizer state has fields {t._fields}")
            return cls(*(conv(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return t

    return conv(tree)


# ------------------------------------------- repro.train.checkpoint's format
def normalize_path(path: str) -> str:
    """np.savez appends ``.npz`` when the suffix is missing."""
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}|"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}|"))
    else:
        out[prefix.rstrip("|")] = np.asarray(tree)
    return out


def save(path: str, tree: Any) -> str:
    """Flatten a dict pytree with ``|``-joined keys into one ``.npz``."""
    path = normalize_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    return path


def load_flat(path: str) -> Dict[str, np.ndarray]:
    if not os.path.exists(path):
        path = normalize_path(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_dict(path: str) -> Dict[str, Any]:
    """Restore a (possibly nested-by-'|') dict pytree."""
    out: Dict[str, Any] = {}
    for key, val in load_flat(path).items():
        parts = key.split("|")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return out


def load_params(path: str) -> Dict[str, np.ndarray]:
    """A ``repro`` params checkpoint (``checkpoint.save(path, params)``) ->
    the flat ``repro``-keyed dict that ``params_from_numpy`` takes."""
    tree = load_dict(path)
    bad = sorted(k for k, v in tree.items() if isinstance(v, dict))
    if bad:
        raise ValueError(f"{path}: nested entries {bad} are not model params")
    return tree
