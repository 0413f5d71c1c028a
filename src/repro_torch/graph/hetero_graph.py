"""Heterogeneous graph structure (Graph4Rec §3.1).

A heterogeneous graph is decomposed into bipartite directed relations. A
relation is named by a triple string ``"<src>2<etype>2<dst>"`` — e.g.
``"u2click2i"`` is user --click--> item, and when ``symmetry=True`` the
reverse relation ``"i2click2u"`` is added automatically, exactly as the paper
describes. A homogeneous graph is the degenerate case ``"u2u"`` /
``"u2u2u"``.

Node ids are global integers. Each node type owns a contiguous id range so
that type-partitioned embedding tables and per-type metrics are cheap.
Adjacency is stored per relation in CSR over the *global* id space (indptr of
length num_nodes+1; rows for nodes that are not of the relation's source type
are empty). This uniform layout keeps every sampler branch-free.

Side information (paper §3.5 "configurable sparse features with multiple
slots", variable length per node) is stored per slot as a ragged
(indptr, values) pair.

NumPy copy of ``repro.graph.hetero_graph`` for the PyTorch port, the dense
padded-adjacency export of the fused device sampler included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.utils.ragged import ragged_row_offsets

DELIM = "2"  # the paper uses "2" as the triple delimiter


@dataclasses.dataclass(frozen=True)
class Relation:
    """Parsed relation triple (source type, edge type, destination type)."""

    name: str
    src_type: str
    etype: str
    dst_type: str

    @staticmethod
    def parse(name: str) -> "Relation":
        parts = name.split(DELIM)
        if len(parts) == 2:  # homogeneous shorthand "u2u"
            src, dst = parts
            etype = "link"
        elif len(parts) == 3:
            src, etype, dst = parts
        else:
            raise ValueError(
                f"relation {name!r} must be '<src>2<dst>' or '<src>2<etype>2<dst>'"
            )
        return Relation(name=name, src_type=src, etype=etype, dst_type=dst)

    @property
    def reverse_name(self) -> str:
        return f"{self.dst_type}{DELIM}{self.etype}{DELIM}{self.src_type}"


@dataclasses.dataclass
class CSR:
    """Compact adjacency for one relation over the global node id space."""

    indptr: np.ndarray  # int64 (num_nodes + 1,)
    indices: np.ndarray  # int32 (num_edges,)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, node: int) -> np.ndarray:
        return self.indices[self.indptr[node] : self.indptr[node + 1]]


@dataclasses.dataclass
class SlotFeature:
    """Ragged per-node sparse feature slot (variable-length values)."""

    indptr: np.ndarray  # int64 (num_nodes + 1,)
    values: np.ndarray  # int32 (total_values,) — ids into the slot's vocab
    vocab_size: int

    def values_of(self, node: int) -> np.ndarray:
        return self.values[self.indptr[node] : self.indptr[node + 1]]


class HeteroGraph:
    """In-memory heterogeneous graph with per-relation CSR adjacency."""

    def __init__(
        self,
        node_type_ranges: Mapping[str, Tuple[int, int]],
        relations: Mapping[str, CSR],
        slots: Optional[Mapping[str, SlotFeature]] = None,
    ):
        self.node_type_ranges = dict(node_type_ranges)  # type -> (start, count)
        self.num_nodes = int(
            max(start + count for start, count in node_type_ranges.values())
        )
        self.relations: Dict[str, CSR] = dict(relations)
        self.relation_meta: Dict[str, Relation] = {
            name: Relation.parse(name) for name in relations
        }
        self.slots: Dict[str, SlotFeature] = dict(slots or {})
        for name, csr in self.relations.items():
            if csr.indptr.shape[0] != self.num_nodes + 1:
                raise ValueError(
                    f"relation {name}: indptr length {csr.indptr.shape[0]} != "
                    f"num_nodes+1 ({self.num_nodes + 1})"
                )

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_edges(
        node_counts: Mapping[str, int],
        edges: Mapping[str, Tuple[np.ndarray, np.ndarray]],
        symmetry: bool = True,
        slots: Optional[Mapping[str, SlotFeature]] = None,
    ) -> "HeteroGraph":
        """Build from per-relation (src_local, dst_local) edge arrays.

        ``src_local``/``dst_local`` are ids *local to their node type*; this
        constructor lays node types into contiguous global ranges in the
        iteration order of ``node_counts`` and offsets the edges accordingly.
        With ``symmetry=True`` the reverse relation is added for every
        relation whose reverse is not explicitly given (paper §3.1).
        """
        ranges: Dict[str, Tuple[int, int]] = {}
        offset = 0
        for ntype, count in node_counts.items():
            ranges[ntype] = (offset, int(count))
            offset += int(count)
        num_nodes = offset

        # Globalize edges, optionally add reverses.
        glob_edges: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for name, (src, dst) in edges.items():
            rel = Relation.parse(name)
            s_off = ranges[rel.src_type][0]
            d_off = ranges[rel.dst_type][0]
            gsrc = np.asarray(src, dtype=np.int64) + s_off
            gdst = np.asarray(dst, dtype=np.int64) + d_off
            glob_edges[rel.name] = (gsrc, gdst)
        if symmetry:
            for name in list(glob_edges):
                rel = Relation.parse(name)
                rname = rel.reverse_name
                if rname not in glob_edges:
                    gsrc, gdst = glob_edges[name]
                    glob_edges[rname] = (gdst.copy(), gsrc.copy())

        rels = {
            name: _csr_from_pairs(num_nodes, gsrc, gdst)
            for name, (gsrc, gdst) in glob_edges.items()
        }
        return HeteroGraph(ranges, rels, slots=slots)

    # ----------------------------------------------------------------- access
    def node_type_of(self, node: int) -> str:
        for ntype, (start, count) in self.node_type_ranges.items():
            if start <= node < start + count:
                return ntype
        raise KeyError(node)

    def nodes_of_type(self, ntype: str) -> np.ndarray:
        start, count = self.node_type_ranges[ntype]
        return np.arange(start, start + count, dtype=np.int64)

    def relation_names(self) -> List[str]:
        return list(self.relations)

    @property
    def num_edges(self) -> int:
        return sum(csr.num_edges for csr in self.relations.values())

    def degrees(self, relation: str) -> np.ndarray:
        return self.relations[relation].degrees()

    # --------------------------------------------------------------- sampling
    def sample_neighbors(
        self,
        rng: np.random.Generator,
        nodes: np.ndarray,
        relation: str,
        num_samples: int,
        pad_id: int = -1,
    ) -> np.ndarray:
        """Uniform with-replacement neighbor sampling.

        Returns (len(nodes), num_samples) int64, padded with ``pad_id`` where
        a node has no neighbors under ``relation``. This is the single
        primitive the distributed engine (graph/engine.py) distributes.
        """
        csr = self.relations[relation]
        nodes = np.asarray(nodes, dtype=np.int64)
        starts = csr.indptr[nodes]
        degs = csr.indptr[nodes + 1] - starts
        out = np.full((len(nodes), num_samples), pad_id, dtype=np.int64)
        has = degs > 0
        if has.any():
            offs = rng.integers(
                0, np.maximum(degs[has][:, None], 1), size=(int(has.sum()), num_samples)
            )
            out[has] = csr.indices[starts[has][:, None] + offs]
        return out

    # ------------------------------------------------- dense device export
    def padded_adjacency(
        self, relation: str, max_degree: int, pad_id: int = -1, seed: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-width adjacency (num_nodes, max_degree) + clipped degrees.

        The table of the fused device sampler: wide rows are truncated
        (uniform subsample), short rows padded. Returns (adj, degree).

        The subsample is keyed by ``[seed, node id]`` (the partition_rng
        spawn-key idiom), so two builds with the same seed are bitwise
        identical while the caller's seed still reaches every draw.
        """
        csr = self.relations[relation]
        adj = np.full((self.num_nodes, max_degree), pad_id, dtype=np.int64)
        degs = csr.degrees()
        # rows that fit: one vectorized ragged-to-padded scatter
        clipped = np.minimum(degs, max_degree).astype(np.int64)
        starts = np.asarray(csr.indptr[:-1], dtype=np.int64)
        if clipped.sum():
            row_of, col = ragged_row_offsets(clipped)
            adj[row_of, col] = csr.indices[starts[row_of] + col]
        # over-wide rows: per-row uniform subsample without replacement,
        # keyed by (seed, node id): stable across calls and derived from
        # the caller's seed, never the node id alone
        for v in np.flatnonzero(degs > max_degree):
            adj[v] = np.random.default_rng([seed, int(v)]).choice(
                csr.neighbors(v), max_degree, replace=False
            )
        return adj, clipped


def _csr_from_pairs(num_nodes: int, src: np.ndarray, dst: np.ndarray) -> CSR:
    order = np.argsort(src, kind="stable")
    src_sorted = src[order]
    dst_sorted = dst[order].astype(np.int32)
    counts = np.bincount(src_sorted, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr=indptr, indices=dst_sorted)
