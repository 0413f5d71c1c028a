"""Relation-wise ego-graph sampling (Graph4Rec §3.3).

An ego graph of a central node v is the subgraph induced by v's K-hop
neighborhood; with multiple edge types Graph4Rec samples *relation-wise*:
``G_v = {G_{v,r} : r in R}``, so each relation keeps its own neighbor set and
the GNN can aggregate them with per-relation weights (Eq. 3).

Dense batched layout (accelerator-friendly — this is the hardware
adaptation of the paper's message-passing subgraphs): with R relations and
per-hop fanouts (F_1..F_K),

    level 0: (B, 1)            the centers
    level k: (B, W_k)          W_k = W_{k-1} * R * F_k

and the neighbors of level-(k-1) slot j under relation r occupy the slice
``level_k[:, j*R*F_k + r*F_k : j*R*F_k + (r+1)*F_k]``. PAD (-1) marks missing
neighbors; aggregation masks them. Everything downstream (GNN zoo, Pallas
seg_aggr kernel) consumes this layout, which keeps the device graph static —
the same trick the paper uses to decouple GNN compute from the graph engine.

Verbatim copy of ``repro.sampling.ego`` for the PyTorch port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.graph.engine import engine_sample_many

PAD = -1


@dataclasses.dataclass
class EgoConfig:
    relations: Sequence[str]  # relation names, fixed order
    fanouts: Sequence[int]  # neighbors sampled per relation per hop, len = K hops

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)

    @property
    def num_relations(self) -> int:
        return len(self.relations)

    def level_width(self, k: int) -> int:
        w = 1
        for f in self.fanouts[:k]:
            w *= self.num_relations * f
        return w


@dataclasses.dataclass
class EgoBatch:
    """Batched relation-wise ego graphs: one (B, W_k) array per level."""

    config: EgoConfig
    levels: List[np.ndarray]  # levels[0]: (B, 1) centers; levels[k]: (B, W_k)

    @property
    def batch_size(self) -> int:
        return int(self.levels[0].shape[0])

    @property
    def centers(self) -> np.ndarray:
        return self.levels[0][:, 0]

    def num_sampled_nodes(self) -> int:
        return int(sum(l.size for l in self.levels[1:]))

    def take(self, idx: np.ndarray) -> "EgoBatch":
        """Row-select ego graphs (used by ego-first pair generation)."""
        return EgoBatch(self.config, [l[idx] for l in self.levels])

    def concat(self, other: "EgoBatch") -> "EgoBatch":
        return EgoBatch(
            self.config,
            [np.concatenate([a, b], axis=0) for a, b in zip(self.levels, other.levels)],
        )


def sample_ego_batch(
    rng: np.random.Generator,
    engine,  # HeteroGraph or DistributedGraphEngine (same sample_neighbors API)
    centers: np.ndarray,
    config: EgoConfig,
) -> EgoBatch:
    """Sample relation-wise ego graphs for ``centers``.

    Per hop k, issues ONE ``sample_many`` query group covering every
    relation's batched neighbor request for all frontier nodes — matching
    the engine's batched RPC (a single pipelined round-trip per worker on
    the mp backend). PAD frontier slots propagate PAD children.
    """
    centers = np.asarray(centers, dtype=np.int64).reshape(-1)
    B = len(centers)
    levels: List[np.ndarray] = [centers[:, None]]
    frontier = levels[0]  # (B, W)
    R = config.num_relations
    for k, fanout in enumerate(config.fanouts):
        W = frontier.shape[1]
        nxt = np.full((B, W, R, fanout), PAD, dtype=np.int64)
        flat = frontier.reshape(-1)
        valid = flat != PAD
        if valid.any():
            # ONE frontier array shared by every relation's query: the mp
            # client routes queries with identical node arrays once (its
            # cache is keyed by array identity)
            frontier_nodes = flat[valid]
            queries = [
                (frontier_nodes, rel, fanout, PAD) for rel in config.relations
            ]
            for ri, sampled in enumerate(engine_sample_many(engine, rng, queries)):
                block = np.full((B * W, fanout), PAD, dtype=np.int64)
                block[valid] = sampled
                nxt[:, :, ri, :] = block.reshape(B, W, fanout)
        levels.append(nxt.reshape(B, W * R * fanout))
        frontier = levels[-1]
    return EgoBatch(config, levels)
