"""Multi-metapath random walk generation (Graph4Rec §3.2), host side.

A metapath is a sequence of relation names assembled head-to-tail with a
hyphen, e.g. ``"u2click2i - i2click2u"``; walks repeat the metapath until the
requested walk length is reached (metapath2vec semantics). Multiple metapaths
may be given ("multi-metapaths random walk"): each walk draws one of them.
A homogeneous random walk (DeepWalk) is the degenerate metapath ``"u2u - u2u"``.

Two implementations, as in ``repro.walk.metapath``:

- ``MetapathWalker``, a copy of the numpy walker: it draws the same
  ``np.random.Generator`` stream, so walks are bitwise equal to ``repro``'s
  from one seed.
- ``walk_multi_from_bits`` / ``walk_from_bits``, the device walker of the
  fused sampler (``sampling/fused.py``), the counterparts of ``jax_walk_multi``
  / ``jax_walk``. The random draw is split from the walk: the walk is a pure
  function of a ``(walk_len - 1, B)`` tensor of integers in ``[0, 2**32)``,
  held as int64, so ``bits % max(deg, 1)`` is JAX's uint32 modulo and the
  tests can feed it the very bits ``repro`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph.engine import engine_sample_many
from repro_torch.graph.hetero_graph import Relation

PAD = -1


def parse_metapath(mp: str) -> List[str]:
    """``"u2click2i - i2click2u"`` -> ["u2click2i", "i2click2u"]; validates chaining."""
    rels = [p.strip() for p in mp.split("-") if p.strip()]
    if not rels:
        raise ValueError(f"empty metapath {mp!r}")
    parsed = [Relation.parse(r) for r in rels]
    for a, b in zip(parsed, parsed[1:]):
        if a.dst_type != b.src_type:
            raise ValueError(
                f"metapath {mp!r}: {a.name} ends at type {a.dst_type!r} but "
                f"{b.name} starts at {b.src_type!r}"
            )
    return [p.name for p in parsed]


@dataclasses.dataclass
class WalkConfig:
    metapaths: Sequence[str]  # e.g. ("u2click2i - i2click2u", "u2buy2i - i2buy2u")
    walk_len: int = 8  # number of nodes per walk (path length)
    walks_per_node: int = 1


class MetapathWalker:
    """Host-side multi-metapath walker (paper-faithful data pipeline stage)."""

    def __init__(self, graph_or_engine, config: WalkConfig):
        self.g = graph_or_engine
        self.config = config
        self.paths = [parse_metapath(mp) for mp in config.metapaths]
        if not self.paths:
            raise ValueError("need at least one metapath")
        # construction-time state only, so build the per-step relation
        # schedule once instead of on every sampling round
        self._rel_names, self._rel_sched = self._relation_schedule()

    def start_nodes(self, rng: np.random.Generator, path_idx: int, n: int) -> np.ndarray:
        """Uniform start nodes of the metapath's source type."""
        first = Relation.parse(self.paths[path_idx][0])
        graph = self.g.graph if hasattr(self.g, "graph") else self.g
        start, count = graph.node_type_ranges[first.src_type]
        return rng.integers(start, start + count, size=n).astype(np.int64)

    def walk(
        self, rng: np.random.Generator, starts: np.ndarray, path_idx: int = 0
    ) -> np.ndarray:
        """Walk from ``starts``: (B,) -> (B, walk_len), PAD after a dead end."""
        path_of = np.full(len(starts), path_idx, dtype=np.int64)
        return self._walk_batched(rng, np.asarray(starts, dtype=np.int64), path_of)

    def _relation_schedule(self) -> Tuple[List[str], np.ndarray]:
        """(relation names, (num_paths, walk_len-1) relation-id schedule)."""
        rel_names = sorted({r for p in self.paths for r in p})
        rel_id = {r: i for i, r in enumerate(rel_names)}
        L = self.config.walk_len
        sched = np.empty((len(self.paths), max(L - 1, 1)), dtype=np.int64)
        for pi, rels in enumerate(self.paths):
            for s in range(max(L - 1, 1)):
                sched[pi, s] = rel_id[rels[s % len(rels)]]
        return rel_names, sched

    def _walk_batched(
        self, rng: np.random.Generator, starts: np.ndarray, path_of: np.ndarray
    ) -> np.ndarray:
        """Advance walks of ALL metapaths together: per step, the frontier is
        grouped by relation and ALL relation groups are issued as one
        ``sample_many`` query group — a single engine round per step (one
        pipelined request round-trip per worker on the mp backend) instead of
        one call per metapath."""
        L = self.config.walk_len
        B = len(starts)
        out = np.full((B, L), PAD, dtype=np.int64)
        out[:, 0] = starts
        cur = starts.copy()
        alive = np.ones(B, dtype=bool)
        rel_names, sched = self._rel_names, self._rel_sched
        for step in range(1, L):
            if not alive.any():
                break
            step_rel = sched[path_of, step - 1]
            nxt = np.full(B, PAD, dtype=np.int64)
            step_rids = np.unique(step_rel[alive])
            sels = [alive & (step_rel == ri) for ri in step_rids]
            queries = [
                (cur[sel], rel_names[int(ri)], 1, PAD)
                for ri, sel in zip(step_rids, sels)
            ]
            for sel, sampled in zip(sels, engine_sample_many(self.g, rng, queries)):
                nxt[sel] = sampled[:, 0]
            alive = alive & (nxt != PAD)
            out[alive, step] = nxt[alive]
            cur = np.where(alive, nxt, cur)
        return out

    def generate(self, rng: np.random.Generator, num_walks: int) -> np.ndarray:
        """Round-robin over metapaths; returns (num_walks, walk_len).

        All metapaths advance in ONE batched walk (see ``_walk_batched``);
        rows stay grouped by metapath index, matching the chunked layout of
        the per-metapath implementation.
        """
        per = max(1, num_walks // len(self.paths))
        counts = []
        for pi in range(len(self.paths)):
            n = per if pi < len(self.paths) - 1 else num_walks - per * (len(self.paths) - 1)
            counts.append(max(0, n))
        starts = [
            self.start_nodes(rng, pi, n) for pi, n in enumerate(counts) if n > 0
        ]
        path_of = np.repeat(
            np.arange(len(self.paths), dtype=np.int64), np.asarray(counts, dtype=np.int64)
        )
        return self._walk_batched(rng, np.concatenate(starts), path_of)


# ------------------------------------------------------------------- device
def walk_multi_from_bits(
    bits: torch.Tensor,  # (max(walk_len - 1, 1), B) int64 in [0, 2**32)
    adj: torch.Tensor,  # (R, num_nodes, max_degree) padded adjacency per relation
    degree: torch.Tensor,  # (R, num_nodes)
    starts: torch.Tensor,  # (B,)
    sched: torch.Tensor,  # (num_paths, walk_len - 1) relation id per step
    path_of: torch.Tensor,  # (B,) metapath index of each walk
    walk_len: int,
) -> torch.Tensor:
    """Multi-metapath random walk on the device -> (B, walk_len) int64.

    Each walk ``b`` follows its own metapath ``path_of[b]``: at step ``t`` it
    takes neighbor ``bits[t - 1, b] % max(deg, 1)`` under relation
    ``sched[path_of[b], t - 1]`` of the stacked padded adjacency. Dead ends
    self-loop and are masked to PAD in the output, so PAD is suffix-only,
    matching ``MetapathWalker``. A PAD (or degree-0) start emits PAD from
    step 1 on. ``walk_len`` is small and static: a Python loop over the
    steps, as ``repro`` unrolls its scan.
    """
    starts = starts.to(torch.int64)
    step_rels = sched[path_of].T.to(torch.int64)  # (walk_len - 1, B)
    cur = starts.clamp(min=0)
    alive = starts >= 0
    cols = [starts]
    for t in range(walk_len - 1):
        rel = step_rels[t]
        deg = degree[rel, cur].to(torch.int64)
        off = bits[t] % deg.clamp(min=1)
        nxt = adj[rel, cur, off].to(torch.int64)
        alive = alive & (deg > 0)
        cur = torch.where(alive, nxt, cur)
        cols.append(torch.where(alive, nxt, PAD))
    return torch.stack(cols, dim=1)


def walk_from_bits(
    bits: torch.Tensor,  # (max(walk_len - 1, 1), B) int64 in [0, 2**32)
    adj: torch.Tensor,  # (num_nodes, max_degree) padded adjacency of ONE relation chain
    degree: torch.Tensor,  # (num_nodes,)
    starts: torch.Tensor,  # (B,)
    walk_len: int,
) -> torch.Tensor:
    """Homogeneous (or relation-collapsed) walk: the single-relation case
    of ``walk_multi_from_bits``, as ``jax_walk`` is of ``jax_walk_multi``."""
    B = starts.shape[0]
    sched = torch.zeros((1, max(walk_len - 1, 1)), dtype=torch.int64, device=starts.device)
    path_of = torch.zeros((B,), dtype=torch.int64, device=starts.device)
    return walk_multi_from_bits(bits, adj[None], degree[None], starts, sched, path_of,
                                walk_len)
