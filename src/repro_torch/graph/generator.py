"""Synthetic heterogeneous recsys datasets (schema-faithful stand-ins).

The paper evaluates on RetailRocket / Rec15 / Tmall / UB — multi-behavior
user--item interaction logs. Those dumps are not available offline, so we
synthesize graphs with the same *shape*: power-law item popularity, per-user
session behavior, multiple edge types (click / buy / cart / fav), timestamps,
and an 80/10/10 per-user temporal split (paper §4.1). Cluster structure is
planted (users/items grouped into latent interest clusters) so that recall@K
is a meaningful signal: a model that learns the latent structure scores far
above chance, which lets us reproduce the paper's *relative* claims.

NumPy copy of ``repro.graph.generator`` for the PyTorch port: one seed gives
the same arrays in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np

from repro_torch.graph.hetero_graph import HeteroGraph, SlotFeature


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Scale knobs for a synthetic multi-behavior dataset."""

    name: str
    num_users: int
    num_items: int
    num_clusters: int
    # interactions per behavior (approximate totals)
    behaviors: Mapping[str, int]
    # probability a user interacts inside their own cluster
    affinity: float = 0.85
    # zipf exponent for item popularity inside a cluster
    zipf_a: float = 1.3
    num_side_slots: int = 2
    side_vocab: int = 64


# Small-scale analogues of the paper's four datasets (Table 1), shrunk to run
# on CPU in seconds. Ratios between behaviors follow the originals.
RETAILROCKET = DatasetSpec(
    "retailrocket", num_users=2000, num_items=3000, num_clusters=20,
    behaviors={"click": 18000, "buy": 600, "cart": 1500},
)
REC15 = DatasetSpec(
    "rec15", num_users=5000, num_items=1200, num_clusters=24,
    behaviors={"click": 52000, "buy": 2000},
)
TMALL = DatasetSpec(
    "tmall", num_users=3000, num_items=6000, num_clusters=30,
    behaviors={"click": 60000, "buy": 3600, "cart": 30, "fav": 4000},
)
UB = DatasetSpec(
    "ub", num_users=8000, num_items=20000, num_clusters=40,
    behaviors={"click": 120000, "buy": 2400, "cart": 6600, "fav": 3700},
)
TOY = DatasetSpec(
    "toy", num_users=200, num_items=300, num_clusters=8,
    behaviors={"click": 3000, "buy": 300},
)

SPECS: Dict[str, DatasetSpec] = {
    s.name: s for s in (RETAILROCKET, REC15, TMALL, UB, TOY)
}


@dataclasses.dataclass
class RecsysDataset:
    """A generated dataset: train graph + held-out (user, item) interactions."""

    spec: DatasetSpec
    graph: HeteroGraph  # built from TRAIN interactions only
    train_edges: Dict[str, Tuple[np.ndarray, np.ndarray]]  # behavior -> (u, i) local ids
    val_pairs: np.ndarray  # (Nv, 2) local (user, item)
    test_pairs: np.ndarray  # (Nt, 2) local (user, item)
    user_clusters: np.ndarray
    item_clusters: np.ndarray

    @property
    def num_users(self) -> int:
        return self.spec.num_users

    @property
    def num_items(self) -> int:
        return self.spec.num_items


def generate(spec: DatasetSpec, seed: int = 0) -> RecsysDataset:
    rng = np.random.default_rng(seed)
    user_clusters = rng.integers(0, spec.num_clusters, size=spec.num_users)
    item_clusters = rng.integers(0, spec.num_clusters, size=spec.num_items)
    items_by_cluster: List[np.ndarray] = [
        np.flatnonzero(item_clusters == c) for c in range(spec.num_clusters)
    ]
    # guarantee every cluster has items
    for c, arr in enumerate(items_by_cluster):
        if len(arr) == 0:
            items_by_cluster[c] = rng.integers(0, spec.num_items, size=4)

    all_events: List[Tuple[int, int, str, int]] = []  # (u, i, behavior, t)
    t = 0
    for behavior, total in spec.behaviors.items():
        if total <= 0:
            continue
        users = rng.integers(0, spec.num_users, size=total)
        in_cluster = rng.random(total) < spec.affinity
        items = np.empty(total, dtype=np.int64)
        for k in range(total):
            pool = (
                items_by_cluster[user_clusters[users[k]]]
                if in_cluster[k]
                else None
            )
            if pool is not None and len(pool):
                # zipf-ish rank sampling inside the cluster
                rank = int(rng.zipf(spec.zipf_a)) - 1
                items[k] = pool[min(rank, len(pool) - 1)]
            else:
                items[k] = rng.integers(0, spec.num_items)
        times = rng.integers(0, 1_000_000, size=total)
        all_events.extend(
            (int(u), int(i), behavior, int(tt)) for u, i, tt in zip(users, items, times)
        )

    # per-user temporal 80/10/10 split (paper §4.1)
    by_user: Dict[int, List[Tuple[int, int, str, int]]] = {}
    for ev in all_events:
        by_user.setdefault(ev[0], []).append(ev)
    train_ev: List[Tuple[int, int, str]] = []
    val_pairs: List[Tuple[int, int]] = []
    test_pairs: List[Tuple[int, int]] = []
    for u, evs in by_user.items():
        evs.sort(key=lambda e: e[3])
        n = len(evs)
        n_tr = max(1, int(0.8 * n))
        n_va = max(0, int(0.1 * n))
        for e in evs[:n_tr]:
            train_ev.append((e[0], e[1], e[2]))
        for e in evs[n_tr : n_tr + n_va]:
            val_pairs.append((e[0], e[1]))
        for e in evs[n_tr + n_va :]:
            test_pairs.append((e[0], e[1]))

    train_edges: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for behavior in spec.behaviors:
        us = np.array([e[0] for e in train_ev if e[2] == behavior], dtype=np.int64)
        is_ = np.array([e[1] for e in train_ev if e[2] == behavior], dtype=np.int64)
        if len(us):
            train_edges[behavior] = (us, is_)

    slots = _make_side_slots(spec, rng, item_clusters, user_clusters)
    graph = HeteroGraph.from_edges(
        node_counts={"u": spec.num_users, "i": spec.num_items},
        edges={f"u2{b}2i": e for b, e in train_edges.items()},
        symmetry=True,
        slots=slots,
    )
    return RecsysDataset(
        spec=spec,
        graph=graph,
        train_edges=train_edges,
        val_pairs=np.array(val_pairs, dtype=np.int64).reshape(-1, 2),
        test_pairs=np.array(test_pairs, dtype=np.int64).reshape(-1, 2),
        user_clusters=user_clusters,
        item_clusters=item_clusters,
    )


def _make_side_slots(
    spec: DatasetSpec,
    rng: np.random.Generator,
    item_clusters: np.ndarray,
    user_clusters: np.ndarray,
) -> Dict[str, SlotFeature]:
    """Side info correlated with the latent clusters (category/brand/profile).

    Slot 0 ("category") is the item's cluster id plus noise — informative.
    Slot 1+ are weakly-informative tags with variable length (1..3 values),
    exercising the paper's multi-value slot support.
    """
    num_nodes = spec.num_users + spec.num_items
    slots: Dict[str, SlotFeature] = {}
    for s in range(spec.num_side_slots):
        lengths = rng.integers(1, 4, size=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(lengths, out=indptr[1:])
        values = rng.integers(0, spec.side_vocab, size=int(indptr[-1])).astype(np.int32)
        if s == 0:
            # category slot: first value is cluster id (noisy 10%)
            for u in range(spec.num_users):
                if rng.random() > 0.1:
                    values[indptr[u]] = user_clusters[u] % spec.side_vocab
            for i in range(spec.num_items):
                v = spec.num_users + i
                if rng.random() > 0.1:
                    values[indptr[v]] = item_clusters[i] % spec.side_vocab
        slots[f"slot{s}"] = SlotFeature(
            indptr=indptr, values=values, vocab_size=spec.side_vocab
        )
    return slots
