"""Full-graph batched inference on the card: every node -> its embedding.

The port of ``repro.infer.embed``. Recall serving (§4.2) needs the
embedding of *every* node, so the whole id space streams through the
encoder in fixed-size chunks (the last one PAD-padded):

- a GNN model samples an inference-time ego graph per chunk on the host
  (``sample_ego_batch`` over any engine the numpy layer has); the draws
  follow ``repro``'s stream, so one seed gives both packages the same egos;
- the ego levels go to the device and through ``encode_ego`` — the
  ``seg_aggr`` kernel on CUDA;
- results fill a (num_nodes, dim) float32 matrix on the device, copied to
  the host once at the end.

``export_embeddings`` / ``load_embeddings`` keep ``repro``'s sharded npz
format, so either package reads the other's exports.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import model as model_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.lint.sanitizer import host_array
from repro_torch.sampling.ego import EgoConfig, sample_ego_batch

PAD = -1


@torch.inference_mode()
def embed_all_nodes(
    model: "model_lib.Graph4RecModel",
    engine,
    graph,
    batch_size: int = 1024,
    seed: int = 0,
    device: DeviceLike = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Embed every node of ``graph`` -> (num_nodes, dim) float32 on the host.

    ``engine`` is anything ``engine_sample_many`` accepts (HeteroGraph or
    DistributedGraphEngine); walk-based models never touch it. ``seed``
    seeds the ego sampling stream; ``rng`` overrides it for callers that
    thread their own stream (``core.model.encode_all_nodes``).
    ``device=None`` is CUDA and raises without one; the model is moved
    there.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    cfg = model.cfg
    N = graph.num_nodes
    batch_size = int(batch_size)
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    batch_size = min(batch_size, N)
    rng = rng if rng is not None else np.random.default_rng(seed)
    bspecs, vspecs = model_lib._split_slot_specs(cfg)
    slot_counts = model_lib.slot_count_arrays(graph, cfg, dev) if bspecs else None
    if not cfg.is_walk_based:
        rels = list(cfg.relations) or graph.relation_names()[: cfg.gnn.num_relations]
        ego_cfg = EgoConfig(relations=rels, fanouts=list(cfg.fanouts))

    out: Optional[torch.Tensor] = None
    for lo in range(0, N, batch_size):
        n_real = min(batch_size, N - lo)
        ids = np.full(batch_size, PAD, dtype=np.int64)
        ids[:n_real] = np.arange(lo, lo + n_real, dtype=np.int64)
        if cfg.is_walk_based:
            slots = model_lib._slots_for_ids(graph, ids, vspecs) if vspecs else None
            sample = (ids, slots)
        else:
            ego = sample_ego_batch(rng, engine, ids, ego_cfg)
            sample = model_lib._ego_arrays_np(graph, ego, cfg)
        h = model(model_lib.to_device(sample, dev), slot_counts)
        if out is None:
            out = torch.empty((N, h.shape[-1]), dtype=torch.float32, device=dev)
        out[lo : lo + n_real] = h[:n_real]
    return host_array(out)


# ------------------------------------------------------------------- export
def export_embeddings(path: str, emb: np.ndarray, num_shards: int = 1,
                      meta: Optional[Dict] = None) -> str:
    """Shard a (num_nodes, dim) matrix row-wise into one ``.npz``.

    Shards are contiguous row ranges (``np.array_split``), the unit a
    serving replica loads. Returns the normalized path.
    """
    emb = host_array(emb)
    num_shards = max(1, min(int(num_shards), emb.shape[0] or 1))
    tree = {
        "meta": {
            "num_nodes": np.int64(emb.shape[0]),
            "dim": np.int64(emb.shape[1]),
            "num_shards": np.int64(num_shards),
            **(meta or {}),
        },
        "shards": {
            f"{i:05d}": shard
            for i, shard in enumerate(np.array_split(emb, num_shards, axis=0))
        },
    }
    return convert.save(path, tree)


def load_embeddings(path: str) -> np.ndarray:
    """Reassemble an ``export_embeddings`` file -> (num_nodes, dim)."""
    tree = convert.load_dict(path)
    shards = tree["shards"]
    emb = np.concatenate([shards[k] for k in sorted(shards)], axis=0)
    meta = tree["meta"]
    n, d = int(host_array(meta["num_nodes"])), int(host_array(meta["dim"]))
    if (n, d) != emb.shape:
        raise ValueError(
            f"embedding checkpoint corrupt: meta says ({n}, {d}), shards sum to "
            f"{emb.shape}"
        )
    return emb
