"""The Graph4Rec model in PyTorch: embeddings + relation-wise GNN + loss.

The port of ``repro.core.model``: a node is embedded from its ID row plus
side-info slots, and a GNN model runs the relation-wise ego-graph forward on
top (``encode_ego``); a walk-based model's output is the embedding itself
(``encode_ids``). ``Graph4RecModel`` holds the tables and the per-layer,
per-relation weights under ``repro``'s key names (``emb/node``,
``gnn/l0/r1/w``, ...), so checkpoints move between the two packages
(``repro_torch.convert``).

The training half: ``loss_fn`` scores a batch of pairs under the configured
objective, and ``host_batch`` / ``sparse_host_batch`` turn a pipeline
``TrainBatch`` into a host numpy pytree (the sparse form remapped onto
gathered sub-tables, with each table's touched ids under ``uniq``);
``pin`` and ``to_device`` move it to the card, and ``device_batch`` /
``sparse_device_batch`` do both steps at once. ``encode_all_nodes`` embeds
every node through ``repro_torch.infer``.

``Graph4RecConfig`` is ``repro``'s, field for field; ``use_kernel_loss`` is
kept for that and selects nothing here (the device decides the path).
"""
from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import loss as loss_lib
from repro_torch.core.hetero import HeteroGNNConfig, hetero_forward, init_hetero_params
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding import table as emb
from repro_torch.sampling.ego import EgoBatch
from repro_torch.sampling.pipeline import TrainBatch

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


def bag_slot_specs(cfg: Graph4RecConfig) -> Tuple[emb.SlotSpec, ...]:
    return _split_slot_specs(cfg)[0]


def value_slot_specs(cfg: Graph4RecConfig) -> Tuple[emb.SlotSpec, ...]:
    return _split_slot_specs(cfg)[1]


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


def sparse_dense_split(params: Params) -> Tuple[Params, Params]:
    """Sparse (PS-resident ``emb/*``) vs dense (GNN) parameters."""
    sparse = {k: v for k, v in params.items() if k.startswith("emb/")}
    dense = {k: v for k, v in params.items() if not k.startswith("emb/")}
    return sparse, dense


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


# ---------------------------------------------------------------------- loss
def loss_fn(params: Params, cfg: Graph4RecConfig, batch: Mapping) -> torch.Tensor:
    """The training objective of one device batch -> a scalar tensor."""
    slot_counts = batch.get("slot_counts")
    if "shared" in batch:
        # Shared-tower layout: encode the unique ego towers once, then
        # gather per-pair embeddings by index (the encoder is row-independent).
        # F.embedding, not h_all[sel]: its backward sums repeated rows in
        # parallel segments, deterministically (see embedding.table.lookup)
        h_all = encode(params, cfg, batch["shared"], slot_counts)
        h_src = F.embedding(batch["src_sel"], h_all)
        h_dst = F.embedding(batch["dst_sel"], h_all)
    else:
        h_src = encode(params, cfg, batch["src"], slot_counts)
        h_dst = encode(params, cfg, batch["dst"], slot_counts)
    if cfg.loss == "inbatch_softmax":
        return loss_lib.inbatch_softmax_loss(h_src, h_dst, cfg.temperature,
                                             use_kernel=cfg.use_kernel_loss)
    if cfg.loss == "inbatch_sigmoid":
        return loss_lib.inbatch_sigmoid_loss(h_src, h_dst)
    if cfg.loss == "neg_sampling":
        h_neg = encode(params, cfg, batch["neg"], slot_counts)
        P = h_src.shape[0]
        return loss_lib.neg_sampling_loss(h_src, h_dst,
                                          h_neg.reshape(P, -1, h_neg.shape[-1]))
    raise ValueError(f"unknown loss {cfg.loss!r}")


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
            spec.name: to_device(
                emb.slot_count_matrix(
                    graph.slots[spec.name].indptr, graph.slots[spec.name].values,
                    graph.num_nodes, spec.vocab_size, spec.max_values,
                ), device)
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


def host_batch(
    graph,
    batch: TrainBatch,
    cfg: Graph4RecConfig,
    slot_counts: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict:
    """A ``TrainBatch`` -> a HOST pytree of numpy arrays (the dense step's).

    Everything a batch needs except the H2D copy, which the trainer's
    stager makes. In 'bag' slot mode side info rides along as the per-graph
    count matrices (``slot_counts``, built on the CPU when not given).
    """
    out: Dict = {}
    bspecs, vspecs = _split_slot_specs(cfg)
    if bspecs and slot_counts is None:
        slot_counts = slot_count_arrays(graph, cfg, "cpu")
    if cfg.is_walk_based:
        for name, ids in (("src", batch.src_ids), ("dst", batch.dst_ids)):
            slots = _slots_for_ids(graph, ids, vspecs) if vspecs else None
            out[name] = (ids, slots)
        if batch.neg_ids is not None:
            ids = batch.neg_ids.reshape(-1)
            slots = _slots_for_ids(graph, ids, vspecs) if vspecs else None
            out["neg"] = (ids, slots)
    else:
        out["src"] = _ego_arrays_np(graph, batch.src_ego, cfg)
        out["dst"] = _ego_arrays_np(graph, batch.dst_ego, cfg)
        if batch.neg_ego is not None:
            out["neg"] = _ego_arrays_np(graph, batch.neg_ego, cfg)
    if bspecs:
        out["slot_counts"] = dict(slot_counts)
    return out


def stage(host: Dict, device: torch.device) -> Dict:
    """The one H2D copy of a host pytree: fresh pinned buffers on CUDA,
    then ``to_device``'s ``non_blocking`` copies."""
    return to_device(pin(host) if device.type == "cuda" else host, device)


def device_batch(
    graph,
    batch: TrainBatch,
    cfg: Graph4RecConfig,
    slot_counts: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Dict:
    """``host_batch`` + one H2D transfer of the whole pytree to ``device``
    (None is CUDA)."""
    return stage(host_batch(graph, batch, cfg, slot_counts), resolve_device(device))


def sparse_host_batch(
    graph,
    batch: TrainBatch,
    cfg: Graph4RecConfig,
    buckets: Optional[Dict[str, int]] = None,
) -> Dict:
    """``host_batch`` under the gather→step→scatter contract.

    The same structure, so ``loss_fn`` runs unchanged, but every id is
    remapped onto rows of a per-table gathered sub-table, and
    ``out["uniq"]`` carries each table's global touched ids (PAD-padded in
    front to a power-of-two bucket; ``embedding.table.unique_pad_ids``). In
    'bag' slot mode ``out["slot_counts"]`` is a per-batch
    (node_bucket, value_bucket) sub count matrix, so the step never touches
    O(num_nodes) state. ``buckets`` (table key -> width) is updated in place;
    the caller keeps it across batches. A copy of ``repro``'s.
    """
    if buckets is None:
        buckets = {}
    out: Dict = {}
    bspecs, vspecs = _split_slot_specs(cfg)
    vm = bool(vspecs)
    bag = bool(bspecs)

    if cfg.is_walk_based:
        parts: Dict[str, object] = {"src": batch.src_ids, "dst": batch.dst_ids}
        if batch.neg_ids is not None:
            parts["neg"] = batch.neg_ids.reshape(-1)
        id_arrays = list(parts.values())
    else:
        parts = {"src": batch.src_ego, "dst": batch.dst_ego}
        if batch.neg_ego is not None:
            parts["neg"] = batch.neg_ego
        id_arrays = [l for ego in parts.values() for l in ego.levels]

    uniq_node = emb.unique_pad_ids(id_arrays, buckets.get("node", 0))
    buckets["node"] = len(uniq_node)
    uniq: Dict[str, np.ndarray] = {"node": uniq_node}

    # Per-slot global value lists. 'values': the padded per-id lists that the
    # batch itself consumes. 'bag': each touched node's max_values-truncated
    # value set — exactly the nonzero columns of its count-matrix row.
    slot_globals: Dict[str, List[np.ndarray]] = (
        {s.name: [] for s in cfg.embedding.slots} if (vm or bag) else {}
    )
    part_slots: Dict[str, object] = {}
    if vm:
        for pname, p in parts.items():
            if cfg.is_walk_based:
                s = _slots_for_ids(graph, np.asarray(p).reshape(-1), vspecs)
                part_slots[pname] = s
                for sn, arr in s.items():
                    slot_globals[sn].append(arr)
            else:
                per_level = [_slots_for_ids(graph, l, vspecs) for l in p.levels]
                part_slots[pname] = per_level
                for lv in per_level:
                    for sn, arr in lv.items():
                        slot_globals[sn].append(arr)
    if bag:
        real_nodes = uniq_node[uniq_node >= 0]
        for spec in bspecs:
            sf = graph.slots[spec.name]
            slot_globals[spec.name].append(
                emb.pad_slot_values(sf.indptr, sf.values, real_nodes, spec.max_values,
                                    pad_id=PAD)
            )
    for spec in cfg.embedding.slots:
        if not slot_globals:
            break
        key = f"slot:{spec.name}"
        uniq[key] = emb.unique_pad_ids(slot_globals[spec.name], buckets.get(key, 0))
        buckets[key] = len(uniq[key])

    if cfg.is_walk_based:
        for pname, ids in parts.items():
            local = emb.remap_ids(uniq_node, ids)
            slots = None
            if vm:
                slots = {sn: emb.remap_ids(uniq[f"slot:{sn}"], arr)
                         for sn, arr in part_slots[pname].items()}
            out[pname] = (local, slots)
    else:
        for pname, ego in parts.items():
            levels = [emb.remap_ids(uniq_node, l) for l in ego.levels]
            slots = None
            if vm:
                slots = [{sn: emb.remap_ids(uniq[f"slot:{sn}"], arr)
                          for sn, arr in lv.items()}
                         for lv in part_slots[pname]]
            out[pname] = (levels, slots)

    if bag:
        out["slot_counts"] = {}
        n_bucket = len(uniq_node)
        offset = n_bucket - int((uniq_node >= 0).sum())
        for spec in bspecs:
            u = uniq[f"slot:{spec.name}"]
            vals = slot_globals[spec.name][0]  # (n_real, max_values) global ids
            cmat = np.zeros((n_bucket, len(u)), np.float32)
            valid = vals >= 0
            if valid.any():
                rows = offset + np.broadcast_to(np.arange(vals.shape[0])[:, None],
                                                vals.shape)
                cols = emb.remap_ids(u, vals)
                np.add.at(cmat, (rows[valid], cols[valid]), 1.0)
            out["slot_counts"][spec.name] = cmat

    out["uniq"] = dict(uniq)
    return out


def sparse_device_batch(
    graph,
    batch: TrainBatch,
    cfg: Graph4RecConfig,
    buckets: Optional[Dict[str, int]] = None,
    device: DeviceLike = None,
) -> Dict:
    """``sparse_host_batch`` + one H2D transfer of the pytree to ``device``
    (None is CUDA)."""
    return stage(sparse_host_batch(graph, batch, cfg, buckets), resolve_device(device))


# ------------------------------------------------------------- full inference
def encode_all_nodes(
    params: Params,
    cfg: Graph4RecConfig,
    engine,
    rng: np.random.Generator,
    graph,
    batch_size: int = 1024,
    device: DeviceLike = None,
) -> np.ndarray:
    """Embed every node for recall evaluation (paper §4.2) -> (num_nodes,
    dim) float32 on the host.

    A wrapper around ``repro_torch.infer.embed_all_nodes``, as ``repro``'s
    is, drawing the ego samples from ``rng``. ``device`` None is CUDA.
    Imported lazily: ``infer`` imports this module."""
    from repro_torch.infer import embed_all_nodes

    return embed_all_nodes(Graph4RecModel(cfg, params), engine, graph,
                           batch_size=batch_size, rng=rng, device=device)


def _map_tree(fn, tree):
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return tree


def pin(tree):
    """numpy arrays (in lists, tuples and dicts) -> FRESH pinned host
    tensors, the source of an asynchronous H2D copy. Fresh per batch: a
    pinned buffer reused while a ``non_blocking`` copy from it is in flight
    would corrupt that batch (the caching host allocator holds a freed
    block back until the copies recorded on it complete)."""
    return _map_tree(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
        if isinstance(a, np.ndarray) else a, tree)


def to_device(tree, device):
    """numpy arrays and host tensors -> tensors on ``device``, copied with
    ``non_blocking=True`` (asynchronous from pinned memory)."""
    def move(a):
        t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        return t.to(device, non_blocking=True)
    return _map_tree(move, tree)
