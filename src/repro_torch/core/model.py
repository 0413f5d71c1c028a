"""The Graph4Rec encoder in PyTorch: embeddings + relation-wise GNN.

The port of the serving half of ``repro.core.model``: a node is embedded
from its ID row plus side-info slots, and a GNN model runs the relation-wise
ego-graph forward on top (``encode_ego``); a walk-based model's output is
the embedding itself (``encode_ids``). ``Graph4RecModel`` holds the tables
and the per-layer, per-relation weights under ``repro``'s key names
(``emb/node``, ``gnn/l0/r1/w``, ...), so checkpoints move between the two
packages (``repro_torch.convert``).

``Graph4RecConfig`` is ``repro``'s, field for field; ``use_kernel_loss`` is
kept for that and selects nothing here (the device decides the path).
Training (losses, host batches for pairs) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.hetero import HeteroGNNConfig, hetero_forward, init_hetero_params
from repro_torch.embedding import table as emb
from repro_torch.sampling.ego import EgoBatch

log = logging.getLogger("repro_torch.model")

PAD = -1
Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Graph4RecConfig:
    embedding: emb.EmbeddingConfig
    gnn: Optional[HeteroGNNConfig]  # None -> walk-based (DeepWalk/metapath2vec)
    fanouts: Tuple[int, ...] = ()
    relations: Tuple[str, ...] = ()  # relation order used for ego sampling
    use_side_info: bool = False
    slot_mode: str = "bag"  # bag | values
    bag_vocab_limit: int = 32768  # a larger bag-mode vocab uses 'values'
    loss: str = "inbatch_softmax"
    temperature: float = 1.0
    use_kernel_loss: bool = False  # kept for config parity; unused

    @property
    def is_walk_based(self) -> bool:
        return self.gnn is None


_bag_fallback_warned: set = set()


def _split_slot_specs(
    cfg: Graph4RecConfig,
) -> Tuple[Tuple[emb.SlotSpec, ...], Tuple[emb.SlotSpec, ...]]:
    """(bag-mode specs, values-mode specs) after the bag vocab guard."""
    if not cfg.use_side_info or not cfg.embedding.slots:
        return (), ()
    if cfg.slot_mode == "values":
        return (), tuple(cfg.embedding.slots)
    if cfg.slot_mode != "bag":
        raise ValueError(f"unknown slot_mode {cfg.slot_mode!r}")
    bag, values = [], []
    for spec in cfg.embedding.slots:
        if cfg.bag_vocab_limit and spec.vocab_size > cfg.bag_vocab_limit:
            key = (spec.name, spec.vocab_size, cfg.bag_vocab_limit)
            if key not in _bag_fallback_warned:
                _bag_fallback_warned.add(key)
                log.warning(
                    "slot %r vocab %d exceeds bag_vocab_limit=%d; using "
                    "slot_mode='values' for this slot", spec.name,
                    spec.vocab_size, cfg.bag_vocab_limit,
                )
            values.append(spec)
        else:
            bag.append(spec)
    return tuple(bag), tuple(values)


def init_model_params(generator: torch.Generator, cfg: Graph4RecConfig) -> Dict[str, torch.Tensor]:
    """Fresh CPU parameters under ``repro``'s key names, from ``generator``."""
    params = {f"emb/{k}": v for k, v in emb.init_params(generator, cfg.embedding).items()}
    if cfg.gnn is not None:
        for k, v in init_hetero_params(generator, cfg.gnn).items():
            params[f"gnn/{k}"] = v
    return params


def split_params(params: Params) -> Tuple[Params, Params]:
    e = {k[4:]: v for k, v in params.items() if k.startswith("emb/")}
    g = {k[4:]: v for k, v in params.items() if k.startswith("gnn/")}
    return e, g


# ------------------------------------------------------------------ encoding
def encode_ids(
    params: Params,
    cfg: Graph4RecConfig,
    ids: torch.Tensor,
    slots: Optional[Mapping[str, torch.Tensor]] = None,
    slot_counts: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Walk-based encoder: the embedding row (+ side info) IS the output."""
    e, _ = split_params(params)
    return emb.embed_nodes_mixed(e, ids, slot_values=slots, slot_counts=slot_counts,
                                 pad_id=PAD)


def encode_ego(
    params: Params,
    cfg: Graph4RecConfig,
    levels: Sequence[torch.Tensor],  # level k ids (B, W_k), int64
    level_slots: Optional[Sequence[Optional[Mapping[str, torch.Tensor]]]] = None,
    slot_counts: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """GNN encoder over a batched relation-wise ego graph -> (B, d)."""
    e, g = split_params(params)
    feats, masks = [], []
    for k, ids in enumerate(levels):
        slots = level_slots[k] if level_slots else None
        feats.append(emb.embed_nodes_mixed(e, ids, slot_values=slots,
                                           slot_counts=slot_counts, pad_id=PAD))
        masks.append(ids >= 0)
    return hetero_forward(g, cfg.gnn, feats, masks, list(cfg.fanouts))


def encode(params: Params, cfg: Graph4RecConfig, sample,
           slot_counts: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    if cfg.is_walk_based:
        ids, slots = sample
        return encode_ids(params, cfg, ids, slots, slot_counts)
    levels, slots = sample
    return encode_ego(params, cfg, levels, slots, slot_counts)


class Graph4RecModel(nn.Module):
    """The encoder's parameters under ``repro``'s key names, and its forward.

    ``forward(sample, slot_counts)`` is ``encode``: ``sample`` is
    ``(levels, level_slots)`` for a GNN model or ``(ids, slots)`` for a
    walk-based one, as tensors on the model's device. Inference only: the
    parameters do not require grad.
    """

    def __init__(self, cfg: Graph4RecConfig, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in params.items()}
        )

    def flat(self) -> Dict[str, torch.Tensor]:
        return dict(self.params.items())

    def forward(self, sample, slot_counts: Optional[Mapping[str, torch.Tensor]] = None):
        return encode(self.flat(), self.cfg, sample, slot_counts)


# (graph -> {(specs, device) -> count tensors}); weak keys so graphs can be GC'd
_slot_count_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def slot_count_arrays(graph, cfg: Graph4RecConfig, device) -> Dict[str, torch.Tensor]:
    """Count matrices of the bag-mode slots, on ``device``, cached per graph."""
    per_graph = _slot_count_cache.setdefault(graph, {})
    specs = _split_slot_specs(cfg)[0]
    key = (specs, str(device))
    if key not in per_graph:
        per_graph[key] = {
            spec.name: torch.from_numpy(
                emb.slot_count_matrix(
                    graph.slots[spec.name].indptr, graph.slots[spec.name].values,
                    graph.num_nodes, spec.vocab_size, spec.max_values,
                )
            ).to(device)
            for spec in specs
        }
    return per_graph[key]


# --------------------------------------------------------- host-side batching
def _slots_for_ids(graph, ids: np.ndarray,
                   slot_specs: Sequence[emb.SlotSpec]) -> Dict[str, np.ndarray]:
    out = {}
    for spec in slot_specs:
        sf = graph.slots[spec.name]
        out[spec.name] = emb.pad_slot_values(
            sf.indptr, sf.values, ids.reshape(-1), spec.max_values, pad_id=PAD
        ).reshape(ids.shape + (spec.max_values,))
    return out


def _ego_arrays_np(graph, ego: EgoBatch, cfg: Graph4RecConfig):
    """One ego part as host numpy arrays: (levels, per-level value slots)."""
    levels = list(ego.levels)
    slots = None
    vspecs = _split_slot_specs(cfg)[1]
    if vspecs:
        slots = [_slots_for_ids(graph, l, vspecs) for l in ego.levels]
    return levels, slots


def to_device(tree, device):
    """numpy arrays (in lists, tuples and dicts) -> tensors on ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree
